"""Head-packed attention (kernel f): the port of ``packed_attention`` in
``examples/ablate_head_packing.py``, the JAX package's head-packing ablation.

The same function as ``ops/attention.py``'s kernels (non-causal attention
over ``[B, H, S, D]`` with a ``[B, S]`` padding mask added as
``(1 - m) * -1e30``), computed P heads at a time, with the arithmetic of
``_packed_kernel``: f32 scores ``q . k`` times 1/sqrt(D), the mask bias, the
per-head row max and ``exp``, the probabilities normalised in f32 first
(``e / max(sum, 1e-30)``), then rounded to bf16 for an f32-accumulated
``p @ V`` whose result is cast to bf16. Kernel d instead multiplies bf16(p)
by V and divides afterwards, so the two round differently. The TPU kernel's
block-diagonal construction adds exact zeros only, so the function is
per-head attention with these roundings.

- ``attention_packed_plain``: the plain version, step by step as above.
- ``attention_packed``: a CPU tensor takes the plain version; a CUDA tensor
  launches ``cs_attention_packed`` of ``csrc/attention_kernels.cu`` or
  raises (not bf16, D other than 32, H not a multiple of ``pack``, S above
  ``PACKED_MAX_SEQ``, ``requires_grad``). On CUDA the output is a
  ``[B, H, S, D]`` view of a ``[B, S, H, D]`` tensor, as kernel d's is.
  ``launch_counts`` counts kernel launches only.
"""

from __future__ import annotations

import torch

from .attention import _check_cuda_inputs, _launch, _mask_bias, _on_cpu, _sm_scale

PACKS = (2, 4)           # heads a CTA: the ablation's P values
PACKED_HEAD_DIM = 32     # bge-small's head size, the only one the kernel takes
# The kernel streams K and V, so shared memory does not bound S; this is the
# longest sequence it is held to against its plain version on the card.
PACKED_MAX_SEQ = 4096

launch_counts = {"attention_packed": 0}


def reset_launch_counts() -> None:
    launch_counts["attention_packed"] = 0


def _check_pack(h: int, pack: int) -> None:
    if pack not in PACKS:
        raise ValueError(f"pack={pack}: the kernel packs {PACKS} heads")
    if h % pack:
        raise ValueError(f"H={h} is not a multiple of pack={pack}")


def attention_packed_plain(q, k, v, mask, pack: int = 4):
    """``_packed_kernel``'s arithmetic per head: f32 scores times
    1/sqrt(D), the mask bias, ``e = exp(s - max)``, ``p = e / max(sum,
    1e-30)`` in f32, then bf16(p) @ V in f32, cast to bf16."""
    _check_pack(q.shape[1], pack)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _sm_scale(q.shape[-1])
    s = s + _mask_bias(mask)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def attention_packed(q, k, v, mask, pack: int = 4):
    """Kernel f -> [B, H, S, D] bf16, ``pack`` heads a CTA."""
    if _on_cpu(q, k, v, mask):
        return attention_packed_plain(q, k, v, mask, pack)
    _, h, s, dh = _check_cuda_inputs(q, k, v, mask)
    _check_pack(h, pack)
    if dh != PACKED_HEAD_DIM:
        raise ValueError(f"head size {dh}: kernel f takes {PACKED_HEAD_DIM}")
    if s > PACKED_MAX_SEQ:
        raise ValueError(f"S={s} exceeds kernel f's bound {PACKED_MAX_SEQ}")
    o = _launch("cs_attention_packed", q, k, v, mask, pack)
    launch_counts["attention_packed"] += 1
    return o
