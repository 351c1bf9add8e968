"""Encoder attention: the port of ``codesearch_tpu/ops/attention.py``.

Non-causal multi-head attention over ``[B, H, S, Dh]`` with a ``[B, S]``
padding mask (1 = valid key) added to the scores as ``(1 - m) * -1e30``, so
a fully masked row stays finite. The JAX package's layout is kept at every
public function.

- ``reference_attention``: the plain version of the XLA reference, with the
  ``window`` (sliding window) and ``bias2d`` (ALiBi) options.
- ``attention_full`` (kernel d, ``pallas_attention_full``): the whole
  sequence per (batch, head), single-pass softmax, ``p`` rounded to V's
  dtype before ``p @ V``, the sum divided after. Beside it its plain twin.
- ``attention_flash`` (kernel e, ``pallas_attention``): the same function
  with K and V streamed in blocks of 64 keys under an online softmax, all in
  f32. Beside it its plain twin.
- ``fused_encoder_attention``: the encoder's entry point.

A CPU tensor takes a kernel's plain twin; a CUDA tensor launches the
hand-written kernel of ``csrc/attention_kernels.cu`` or raises. The CUDA
kernels take bf16 Q, K, V with Dh 32 or 64, any S, and views whose last
dimension is contiguous and whose other strides are multiples of 8
elements, so the encoder hands over slices of its fused QKV projection
without copies; their output is a ``[B, H, S, Dh]`` view of a
``[B, S, H, Dh]`` tensor, the order the next projection reads. Kernel d
keeps K and V of the whole sequence in shared memory, which bounds its S by
what a block may use; the kernel library reports that bound for the card
(``full_max_seq``: on an H100, 227 KB a block, 1552 at Dh=32 and 832 at
Dh=64); longer sequences go to e. The TPU dispatch
(XLA for S <= 128, d up to 1024, S a multiple of 128) was measured on a TPU
and is not carried over. The attention backward is not ported: a CUDA
input with ``requires_grad`` raises. ``launch_counts`` counts kernel
launches only (``launches_by_seq`` the same launches by sequence length).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import numpy as np
import torch

from . import _build

NEG_INF = -1e30          # the additive mask value of the JAX package
FLASH_BLOCK_K = 64       # keys per streamed tile of kernel e
HEAD_DIMS = (32, 64)     # head sizes the CUDA kernels are built for
# kernel d's bound on S on an H100 (``cs_attention_full_max_seq`` there):
# CPU tensors take the plain twin of the kernel that card would launch, and
# head sizes without a kernel the Dh=64 bound
H100_FULL_MAX_SEQ = {32: 1552, 64: 832}

launch_counts = {"attention_full": 0, "attention_flash": 0}
launches_by_seq: collections.Counter = collections.Counter()   # (kernel, S) -> launches


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    launches_by_seq.clear()


def full_max_seq(dh: int, device=None) -> int:
    """Kernel d's bound on S at head size ``dh``: on a CUDA ``device`` the
    kernel library's, the longest sequence whose K and V fit the shared
    memory a block of that card may use; otherwise ``H100_FULL_MAX_SEQ``."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return H100_FULL_MAX_SEQ.get(dh, H100_FULL_MAX_SEQ[64])
    if dh not in HEAD_DIMS:
        raise ValueError(f"head size {dh}: the CUDA attention kernels take {HEAD_DIMS}")
    index = torch.cuda.current_device() if device.index is None else device.index
    return _card_full_max_seq(dh, index)


@functools.lru_cache(maxsize=None)
def _card_full_max_seq(dh: int, index: int) -> int:
    with torch.cuda.device(index):
        bound = _build.load().cs_attention_full_max_seq(dh)
    if bound < 16:
        raise RuntimeError(f"cs_attention_full_max_seq({dh}) failed on cuda:{index} ({bound})")
    return bound


def _sm_scale(dh: int) -> float:
    """1/sqrt(Dh) as the float32 the JAX kernels multiply by."""
    return float(np.float32(1.0 / dh ** 0.5))


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, S] mask -> [B, 1, 1, S] additive f32 bias."""
    return ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, tests, and the card's comparisons)
# ---------------------------------------------------------------------------

def reference_attention(q, k, v, mask, window: int = 0, bias2d=None):
    """The XLA reference: f32 scores / sqrt(Dh), the mask bias, an optional
    per-head [H, S, S] bias and a band |i - j| <= window // 2, softmax, and
    probabilities cast to V's dtype before ``p @ V``."""
    dh = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh)
    scores = scores + _mask_bias(mask)
    if bias2d is not None:
        scores = scores + bias2d.float()[None]
    if window:
        idx = torch.arange(q.shape[2], device=q.device)
        band = (idx[:, None] - idx[None, :]).abs() <= window // 2
        scores = torch.where(band[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)


def attention_full_plain(q, k, v, mask):
    """``_full_kernel``'s arithmetic: f32 scores times 1/sqrt(Dh), exact row
    max, ``p = exp(s - max)``, its f32 sum, ``p`` cast to V's dtype for an f32
    ``p @ V``, then the division."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _sm_scale(q.shape[-1])
    s = s + _mask_bias(mask)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / denom).to(q.dtype)


def attention_flash_plain(q, k, v, mask):
    """``_flash_kernel``'s arithmetic: q in f32 times 1/sqrt(Dh), then per
    block of ``FLASH_BLOCK_K`` keys an online softmax (running max from
    -1e30, running sum) and an f32 ``p @ V``; the output divides by
    max(sum, 1e-30). A shorter last block is taken as it is."""
    b, h, s, dh = q.shape
    qs = q.float() * _sm_scale(dh)
    bias = _mask_bias(mask)
    acc = torch.zeros(b, h, s, v.shape[-1], dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l_sum = torch.zeros(b, h, s, 1, dtype=torch.float32, device=q.device)
    for a in range(0, s, FLASH_BLOCK_K):
        kb = k[:, :, a:a + FLASH_BLOCK_K].float()
        vb = v[:, :, a:a + FLASH_BLOCK_K].float()
        sc = torch.matmul(qs, kb.transpose(-1, -2)) + bias[..., a:a + FLASH_BLOCK_K]
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vb)
        m = m_new
    return (acc / torch.clamp(l_sum, min=1e-30)).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _on_cpu(*tensors) -> bool:
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in tensors if t is not None}) != 1:
        raise ValueError(f"attention inputs must share one CPU or CUDA device, got {devs}")
    return False


def _check_cuda_inputs(q, k, v, mask) -> tuple[int, int, int, int]:
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the attention backward is not ported: run the encoder under "
            "torch.inference_mode() (ROADMAP.md Queue 1)")
    b, h, s, dh = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA attention kernels take bf16, got {t.dtype}")
        if tuple(t.shape) != (b, h, s, dh):
            raise ValueError(f"{name}: expected shape {(b, h, s, dh)}, got {tuple(t.shape)}")
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: the last dimension must be contiguous, the other "
                             "strides multiples of 8 elements and the data 16-byte aligned")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head size {dh}: the CUDA attention kernels take {HEAD_DIMS}")
    if tuple(mask.shape) != (b, s):
        raise ValueError(f"mask: expected shape {(b, s)}, got {tuple(mask.shape)}")
    return b, h, s, dh


def _launch(entry: str, q, k, v, mask, *ints):
    """Launch ``entry`` on q, k, v (strided views) and the mask; ``ints``
    follow the head size in its argument list (kernel f's ``pack``)."""
    b, h, s, dh = q.shape
    maskf = mask.to(torch.float32).contiguous()
    # [B, H, S, Dh] view of a [B, S, H, Dh] tensor: the encoder's next
    # projection reads it as [B, S, H * Dh] without a copy
    o = torch.empty(b, s, h, dh, dtype=torch.bfloat16, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, o) for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        lib = _build.load()
        rc = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), maskf.data_ptr(), o.data_ptr(),
            strides, b, h, s, dh, *ints, _sm_scale(dh), torch.cuda.current_stream().cuda_stream)
        _build.check(lib, rc, entry)
    return o


def attention_full(q, k, v, mask):
    """Kernel d -> [B, H, S, Dh]. On CUDA, S at most ``full_max_seq(Dh)``."""
    if _on_cpu(q, k, v, mask):
        return attention_full_plain(q, k, v, mask)
    _, _, s, dh = _check_cuda_inputs(q, k, v, mask)
    if s > full_max_seq(dh, q.device):
        raise ValueError(f"S={s} exceeds kernel d's bound {full_max_seq(dh, q.device)} "
                         f"at Dh={dh}")
    o = _launch("cs_attention_full", q, k, v, mask)
    launch_counts["attention_full"] += 1
    launches_by_seq["attention_full", q.shape[2]] += 1
    return o


def attention_flash(q, k, v, mask):
    """Kernel e -> [B, H, S, Dh], any S."""
    if _on_cpu(q, k, v, mask):
        return attention_flash_plain(q, k, v, mask)
    _check_cuda_inputs(q, k, v, mask)
    o = _launch("cs_attention_flash", q, k, v, mask)
    launch_counts["attention_flash"] += 1
    launches_by_seq["attention_flash", q.shape[2]] += 1
    return o


def fused_encoder_attention(q, k, v, mask, window: int = 0, bias2d=None):
    """The encoder's attention: kernel d while the sequence fits its shared
    memory, kernel e beyond, for every S (CPU tensors take their plain
    twins). Windowed and biased attention have no kernel yet: on the CPU they
    take ``reference_attention``, on CUDA they raise."""
    if window or bias2d is not None:
        if not _on_cpu(q, k, v, mask, bias2d):
            raise NotImplementedError(
                "windowed (ModernBERT) and biased (ALiBi) attention have no CUDA "
                "kernel yet (ROADMAP.md Queue 1)")
        return reference_attention(q, k, v, mask, window=window, bias2d=bias2d)
    if q.shape[2] <= full_max_seq(q.shape[3], q.device):
        return attention_full(q, k, v, mask)
    return attention_flash(q, k, v, mask)
