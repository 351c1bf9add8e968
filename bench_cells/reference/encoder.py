"""The plain PyTorch forward pass of every encoder family the benchmark's
configurations name, in float32 with TF32 off. Each family's layers, written
from its published description and the Hugging Face checkpoint layout, are
its module's ``forward`` (``bench_cells/families/<family>.py``), built from
the pieces here: projections, LayerNorm, softmax attention over the valid
keys inside a layer's window, the rotate-half rotary embedding. The pooled
state is L2-normalised here.

``quant`` exists for the control (a lower precision put in
the program's place); the reference itself is float32. Nothing here
imports the measured program.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..families import family

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and convolutions inside the block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale a row (the last
    dimension), returned in float32."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Encoder:
    """The reference forward over a dict of Hugging Face-named tensors."""

    def __init__(self, dims: dict, weights: dict, device, quant: str | None = None):
        self.dims = dims
        self.family = family(dims["family"])
        self.device = device
        self.quant = quant
        self.w = {k: v.to(device=device, dtype=torch.float32) for k, v in weights.items()}
        if quant == "fp8":
            self.w = {k: fp8_round(v) if v.dim() == 2 else v for k, v in self.w.items()}

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x) if self.quant == "fp8" else x

    def _lin(self, x, name, bias=True):
        y = self._act(x) @ self.w[name + ".weight"].T
        return y + self.w[name + ".bias"] if bias else y

    def _ln(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.w[name + ".weight"], self.w[name + ".bias"],
                            self.dims["eps"])

    def _attend(self, q, k, v, mask, window: int = 0):
        """q, k, v [B, H, S, Dh]; mask [B, S] of 0/1. A ``window`` w keeps
        the keys with |i - j| <= w // 2; 0 keeps them all."""
        dh = q.shape[-1]
        s = (self._act(q) @ self._act(k).transpose(-1, -2)) / dh ** 0.5
        hide = mask[:, None, None, :] == 0
        if window:
            i = torch.arange(s.shape[-1], device=s.device)
            hide = hide | ((i[:, None] - i[None, :]).abs() > window // 2)
        p = torch.softmax(s.masked_fill(hide, float("-inf")), dim=-1)
        if window:
            # a padding row whose window holds no valid key: zeros, not NaN
            # (a padding state is never pooled, but its NaN would reach the
            # valid rows through the next layer's zero-weighted keys)
            p = p.nan_to_num(0.0)
        return self._act(p) @ self._act(v)

    def _heads(self, t):
        """[B, S, hidden] -> [B, H, S, Dh]."""
        b, s, _ = t.shape
        nh = self.dims["heads"]
        return t.view(b, s, nh, self.dims["hidden"] // nh).transpose(1, 2)

    def _merge(self, t):
        """[B, H, S, Dh] -> [B, S, hidden]."""
        b, _, s, _ = t.shape
        return t.transpose(1, 2).reshape(b, s, self.dims["hidden"])

    def _rope(self, x, base):
        """Rotate-half rotary embedding over [B, H, S, Dh]."""
        s, dh = x.shape[2], x.shape[3]
        inv = 1.0 / (base ** (torch.arange(0, dh, 2, dtype=torch.float64, device=x.device) / dh))
        ang = torch.outer(torch.arange(s, dtype=torch.float64, device=x.device), inv)
        ang = torch.cat([ang, ang], dim=-1)
        cos, sin = ang.cos().float(), ang.sin().float()
        x1, x2 = x.chunk(2, dim=-1)
        return x * cos + torch.cat([-x2, x1], dim=-1) * sin

    @torch.no_grad()
    def encode(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[B, S] token ids and 0/1 mask -> [B, hidden] unit vectors."""
        with exact_float32():
            return self._encode(ids.to(self.device).long(), mask.to(self.device).float())

    def _encode(self, ids, mask):
        return F.normalize(self.family.forward(self, ids, mask), dim=-1)


def pad_batch(rows: list[list[int]]) -> tuple[torch.Tensor, torch.Tensor]:
    """Token id lists -> ([B, S] ids, [B, S] mask), S the longest row."""
    s = max(len(r) for r in rows)
    ids = torch.zeros(len(rows), s, dtype=torch.long)
    mask = torch.zeros(len(rows), s)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = torch.as_tensor(r)
        mask[i, :len(r)] = 1
    return ids, mask


def encode_texts(enc: Encoder, rows: list[list[int]], batch_tokens: int = 1 << 15):
    """Embeddings [N, hidden] of token id rows, in blocks of rows of similar
    length holding about ``batch_tokens`` padded tokens each."""
    order = sorted(range(len(rows)), key=lambda i: len(rows[i]))
    out = torch.zeros(len(rows), enc.dims["hidden"])
    i = 0
    while i < len(order):
        j = i + 1
        while j < len(order) and (j - i + 1) * len(rows[order[j]]) <= batch_tokens:
            j += 1
        take = order[i:j]
        ids, mask = pad_batch([rows[t] for t in take])
        out[take] = enc.encode(ids, mask).float().cpu()
        i = j
    return out
