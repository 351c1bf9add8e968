"""Plain PyTorch forward passes of the two encoder families the benchmark's
configurations name, written from their published descriptions and the
Hugging Face checkpoint layout, in float32 with TF32 off:

- BERT (BAAI/bge-small-en-v1.5): word + learned position + token-type 0
  embeddings, LayerNorm; post-norm layers of biased Q, K, V projections,
  softmax attention over the valid keys, output projection, residual and
  LayerNorm, then an exact-GELU MLP, residual and LayerNorm; the [CLS]
  state, L2-normalised.
- NomicBERT (nomic-ai/nomic-embed-text-v1.5): word + token-type 0
  embeddings, LayerNorm; post-norm layers of a bias-free fused QKV
  projection, rotary position embedding (rotate-half, base
  ``rotary_emb_base``, over the whole head), attention, bias-free output
  projection, residual and LayerNorm, then the SwiGLU MLP
  ``fc2(fc11(x) * silu(fc12(x)))``, residual and LayerNorm; the mean of the
  valid states, L2-normalised.

``quant`` exists for the control (a lower precision put in
the program's place); the reference itself is float32. Nothing here
imports the measured program.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

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
        self.family = dims["family"]
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

    def _attend(self, q, k, v, mask):
        """q, k, v [B, H, S, Dh]; mask [B, S] of 0/1."""
        dh = q.shape[-1]
        s = (self._act(q) @ self._act(k).transpose(-1, -2)) / dh ** 0.5
        s = s.masked_fill(mask[:, None, None, :] == 0, float("-inf"))
        return self._act(torch.softmax(s, dim=-1)) @ self._act(v)

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
        dims = self.dims
        b, s = ids.shape
        h = dims["hidden"]
        nh = dims["heads"]
        dh = h // nh
        w = self.w
        x = w["embeddings.word_embeddings.weight"][ids]
        x = x + w["embeddings.token_type_embeddings.weight"][0]

        def heads(t):
            return t.view(b, s, nh, dh).transpose(1, 2)

        def merge(t):
            return t.transpose(1, 2).reshape(b, s, h)

        if self.family == "bert":
            x = x + w["embeddings.position_embeddings.weight"][:s][None]
            x = self._ln(x, "embeddings.LayerNorm")
            for i in range(dims["layers"]):
                p = f"encoder.layer.{i}."
                q = heads(self._lin(x, p + "attention.self.query"))
                k = heads(self._lin(x, p + "attention.self.key"))
                v = heads(self._lin(x, p + "attention.self.value"))
                a = self._lin(merge(self._attend(q, k, v, mask)), p + "attention.output.dense")
                x = self._ln(x + a, p + "attention.output.LayerNorm")
                m = F.gelu(self._lin(x, p + "intermediate.dense"))
                x = self._ln(x + self._lin(m, p + "output.dense"), p + "output.LayerNorm")
            pooled = x[:, 0]
        else:
            x = self._ln(x, "emb_ln")
            base = dims["rope_base"]
            for i in range(dims["layers"]):
                p = f"encoder.layers.{i}."
                qkv = self._lin(x, p + "attn.Wqkv", bias=False)
                q, k, v = (heads(t) for t in qkv.split(h, dim=-1))
                q, k = self._rope(q, base), self._rope(k, base)
                a = self._lin(merge(self._attend(q, k, v, mask)), p + "attn.out_proj", bias=False)
                x = self._ln(x + a, p + "norm1")
                y = self._lin(x, p + "mlp.fc11", bias=False)
                gate = self._lin(x, p + "mlp.fc12", bias=False)
                x = self._ln(x + self._lin(y * F.silu(gate), p + "mlp.fc2", bias=False),
                             p + "norm2")
            pooled = (x * mask[:, :, None]).sum(1) / mask.sum(1, keepdim=True).clamp(min=1.0)
        return F.normalize(pooled, dim=-1)


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
