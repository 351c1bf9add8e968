"""Encoder attention: the port of ``codesearch_tpu/ops/attention.py``.

Non-causal multi-head attention over ``[B, H, S, Dh]`` with a ``[B, S]``
padding mask (1 = valid key) added to the scores as ``(1 - m) * -1e30``, so
a fully masked row stays finite. The JAX package's layout is kept at every
public function.

- ``reference_attention``: the plain version of the XLA reference, with the
  ``window`` (sliding window) and ``bias2d`` (ALiBi) options.
- ``attention_full`` (kernel d, ``pallas_attention_full``): the whole
  sequence per (batch, head), exact softmax in two sweeps over the keys,
  ``p`` rounded to V's dtype before ``p @ V``, the sum divided after.
  Beside it its plain twin.
- ``attention_flash`` (kernel e, ``pallas_attention``): the same function
  with K and V streamed in blocks of 64 keys under an online softmax, all in
  f32. Beside it its plain twin.
- ``attention_window`` (the windowed kernel, ModernBERT's local layers):
  kernel d's arithmetic over the keys with |i - j| <= window // 2 of each
  query row; a row whose band holds no valid key (a padding row) reads 0.
  Beside it its plain twin. It replaces no Pallas kernel: the JAX package
  composes windowed attention in XLA (``reference_attention``).
- ``fused_encoder_attention``: the encoder's entry point.
- ``alibi_bias``: the symmetric ALiBi bias [H, S, S] of the JAX package.

A CPU tensor takes a kernel's plain twin; a CUDA tensor launches the
hand-written kernel of ``csrc/attention_kernels.cu`` or raises. The CUDA
kernels take bf16 Q, K, V with Dh 32 or 64, any S, and views whose last
dimension is contiguous and whose other strides are multiples of 8
elements, so the encoder hands over slices of its fused QKV projection
without copies; their output is a ``[B, H, S, Dh]`` view of a
``[B, S, H, Dh]`` tensor, the order the next projection reads.

The mask holds 0 and 1 only (the encoder's masks are such). Kernel d (and
kernel f of ``ops/packed_attention.py``) skips the keys past a row's last
valid one, which is exact for such masks: beside a valid key a key of bias
-1e30 adds exactly 0. Both stream K and V, so shared memory does not bound
S; ``full_max_seq`` is the route's threshold: ``fused_encoder_attention``
sends S up to ``FULL_MAX_SEQ[Dh]`` to d and longer sequences to e, and d
refuses longer ones. The TPU dispatch
(XLA for S <= 128, d up to 1024, S a multiple of 128) was measured on a TPU
and is not carried over. ``launch_counts`` counts kernel launches only
(``launches_by_seq`` the same launches by sequence length). The windowed
kernel takes any S and visits only the key tiles its rows' bands meet.

The backward (``_fused_attention_bwd`` of the JAX package) is not a Pallas
kernel: JAX recomputes the forward through the XLA ``reference_attention``
and differentiates that. ``fused_encoder_attention`` does the same when q,
k or v requires grad and grad mode is on: ``KernelAttention``, a
``torch.autograd.Function``, runs kernel d or e forward (the plain twin on
the CPU) and saves q, k, v and the mask; its backward recomputes
``reference_attention`` with grad enabled, one extra forward, and returns
its gradients (none for the mask). Each recompute on CUDA counts in
``composed_counts["backward"]``. The kernel wrappers themselves have no
backward and refuse, on CUDA, inputs that require grad while grad mode is
on.

Windowed (ModernBERT's local layers) and biased (ALiBi) attention have no
Pallas kernel: JAX composes them in XLA on every backend. On CUDA outside
autograd a windowed call launches the windowed kernel; under autograd
(training) it and every biased call run ``reference_attention``, a torch
composition like the port's other XLA compositions, differentiated as it
is, and each such call on CUDA counts in ``composed_counts`` (by option),
apart from the kernel launches. CPU tensors take ``reference_attention``
for both. The windowed layers' two routes on CUDA are also program
counters (``utils.tracing``: ``attention.window_kernel``,
``attention.window_composed``; ``WINDOW_COUNTERS`` names them by the count
each follows, so a CUDA graph's replay re-adds them).
"""

from __future__ import annotations

import collections
import ctypes
import math

import numpy as np
import torch

from ..utils.tracing import count
from . import _build

NEG_INF = -1e30          # the additive mask value of the JAX package
FLASH_BLOCK_K = 64       # keys per streamed tile of kernel e
HEAD_DIMS = (32, 64)     # head sizes the CUDA kernels are built for
# the d/e route: S up to this goes to kernel d, longer sequences to e (head
# sizes without a kernel take the Dh=64 value)
FULL_MAX_SEQ = {32: 1552, 64: 832}

launch_counts = {"attention_full": 0, "attention_flash": 0, "attention_window": 0}
launches_by_seq: collections.Counter = collections.Counter()   # (kernel, S) -> launches
# calls of the composed route on CUDA: a call with a bias counts as "bias2d",
# a recompute of the autograd route's backward as "backward"
composed_counts = {"window": 0, "bias2d": 0, "backward": 0}
# the program counter that follows each windowed route, by its count's key
# (``launch_counts["attention_window"]``, ``composed_counts["window"]``)
WINDOW_COUNTERS = {"attention_window": "attention.window_kernel",
                   "window": "attention.window_composed"}


def reset_launch_counts() -> None:
    """Set the kernel launch counts and the composed route's counts to 0."""
    for counts in (launch_counts, composed_counts):
        for name in counts:
            counts[name] = 0
    launches_by_seq.clear()


def full_max_seq(dh: int) -> int:
    """The longest S that ``fused_encoder_attention`` sends to kernel d at
    head size ``dh`` (and that d takes on CUDA)."""
    return FULL_MAX_SEQ.get(dh, FULL_MAX_SEQ[64])


def _sm_scale(dh: int) -> float:
    """1/sqrt(Dh) as the float32 the JAX kernels multiply by."""
    return float(np.float32(1.0 / dh ** 0.5))


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, S] mask -> [B, 1, 1, S] additive f32 bias."""
    return ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]


def alibi_bias(heads: int, seq: int, device=None) -> torch.Tensor:
    """Symmetric (bidirectional-encoder) ALiBi bias [H, S, S] f32 on
    ``device``: -m_h * |i - j| with the geometric slopes 2**(-8 (h + 1) / H)
    (JinaBERT-v2 / MosaicBERT style), as the JAX package builds it."""
    slopes = 2.0 ** (-8.0 * (torch.arange(heads, dtype=torch.float32, device=device) + 1.0)
                     / heads)
    idx = torch.arange(seq, device=device)
    dist = (idx[:, None] - idx[None, :]).abs().to(torch.float32)
    return -slopes[:, None, None] * dist[None]


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, tests, and the card's comparisons)
# ---------------------------------------------------------------------------

def reference_attention(q, k, v, mask, window: int = 0, bias2d=None):
    """The XLA reference: f32 scores / sqrt(Dh), the mask bias, an optional
    per-head [H, S, S] bias and a band |i - j| <= window // 2, softmax, and
    probabilities cast to V's dtype before ``p @ V``. The [B, H, S, S]
    scores are updated in place (they are the route's memory)."""
    dh = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh)
    scores += _mask_bias(mask)
    if bias2d is not None:
        scores += bias2d.float()[None]
    if window:
        idx = torch.arange(q.shape[2], device=q.device)
        band = (idx[:, None] - idx[None, :]).abs() <= window // 2
        scores.masked_fill_(~band[None, None], NEG_INF)
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
    max(sum, 1e-30). A shorter last block is taken as it is; the blocks
    cover K's length, which may be shorter than Q's."""
    b, h, s, dh = q.shape
    qs = q.float() * _sm_scale(dh)
    bias = _mask_bias(mask)
    acc = torch.zeros(b, h, s, v.shape[-1], dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l_sum = torch.zeros(b, h, s, 1, dtype=torch.float32, device=q.device)
    for a in range(0, k.shape[2], FLASH_BLOCK_K):
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


def attention_window_plain(q, k, v, mask, window: int):
    """The windowed kernel's arithmetic: d's (f32 scores times 1/sqrt(Dh),
    the mask bias, exact row max, ``p`` cast to V's dtype for an f32 ``p @
    V``, the f32 sum divided after) over the keys with |i - j| <= window //
    2; a query row whose band holds no valid key reads 0."""
    idx = torch.arange(q.shape[2], device=q.device)
    band = ((idx[:, None] - idx[None, :]).abs() <= window // 2)[None, None]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _sm_scale(q.shape[-1])
    s = (s + _mask_bias(mask)).masked_fill(~band, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))   # key i is in row i's band
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / p.sum(dim=-1, keepdim=True)
    seen = (band & (mask[:, None, None, :] != 0)).any(dim=-1, keepdim=True)
    return o.masked_fill(~seen, 0.0).to(q.dtype)


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the attention kernels have no backward: fused_encoder_attention "
            "differentiates kernels d and e through its autograd route")
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
    """Kernel d -> [B, H, S, Dh]. On CUDA, S at most ``full_max_seq(Dh)``
    and a mask of 0 and 1 only."""
    if _on_cpu(q, k, v, mask):
        return attention_full_plain(q, k, v, mask)
    _, _, s, dh = _check_cuda_inputs(q, k, v, mask)
    if s > full_max_seq(dh):
        raise ValueError(f"S={s} exceeds kernel d's bound {full_max_seq(dh)} at Dh={dh}")
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


def attention_window(q, k, v, mask, window: int):
    """The windowed kernel -> [B, H, S, Dh], any S, ``window`` >= 1: each
    query row over the keys with |i - j| <= window // 2 (the route of
    ``fused_encoder_attention(window=w)`` on CUDA outside autograd); a row
    whose band holds no valid key reads 0."""
    if window < 1:
        raise ValueError(f"window={window}: the windowed kernel takes a window of 1 or more")
    if _on_cpu(q, k, v, mask):
        return attention_window_plain(q, k, v, mask, window)
    _check_cuda_inputs(q, k, v, mask)
    o = _launch("cs_attention_window", q, k, v, mask, window)
    launch_counts["attention_window"] += 1
    launches_by_seq["attention_window", q.shape[2]] += 1
    count(WINDOW_COUNTERS["attention_window"])
    return o


def _kernel_route(q, k, v, mask):
    """Kernel d up to ``full_max_seq(Dh)``, kernel e beyond."""
    if q.shape[2] <= full_max_seq(q.shape[3]):
        return attention_full(q, k, v, mask)
    return attention_flash(q, k, v, mask)


class KernelAttention(torch.autograd.Function):
    """Kernels d and e under autograd: the forward launches them (grad mode
    is off inside it), the backward recomputes ``reference_attention`` and
    differentiates it, as the JAX package's ``custom_vjp`` does."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return _kernel_route(q, k, v, mask)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, mask = ctx.saved_tensors
        if not _on_cpu(q, k, v, mask):
            composed_counts["backward"] += 1
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = reference_attention(*inputs, mask)
            dq, dk, dv = torch.autograd.grad(out, inputs, grad)
        return dq, dk, dv, None


def fused_encoder_attention(q, k, v, mask, window: int = 0, bias2d=None):
    """The encoder's attention: kernel d up to ``full_max_seq(Dh)``, kernel
    e beyond (CPU tensors take their plain twins), through ``KernelAttention``
    when q, k or v requires grad and grad mode is on. A windowed call on
    CUDA outside autograd launches the windowed kernel. Biased attention,
    and windowed attention on the CPU or under autograd, take
    ``reference_attention``, as JAX sends them to its XLA composition on
    every backend, and differentiate as they are; on CUDA each such call
    counts in ``composed_counts``."""
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if window or bias2d is not None:
        if _on_cpu(q, k, v, mask, bias2d):
            return reference_attention(q, k, v, mask, window=window, bias2d=bias2d)
        if bias2d is None and not grad:
            return attention_window(q, k, v, mask, window)
        route = "bias2d" if bias2d is not None else "window"
        composed_counts[route] += 1
        if route in WINDOW_COUNTERS:
            count(WINDOW_COUNTERS[route])
        return reference_attention(q, k, v, mask, window=window, bias2d=bias2d)
    if grad:
        return KernelAttention.apply(q, k, v, mask)
    return _kernel_route(q, k, v, mask)
