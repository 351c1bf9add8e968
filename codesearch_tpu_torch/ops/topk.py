"""Exact brute-force cosine top-k over a device-resident corpus (port of
``codesearch_tpu/ops/topk.py``).

A CPU tensor scores with the plain PyTorch version; a CUDA tensor goes to
the hand-written kernels of ``fused_topk`` whatever the number of queries
(the JAX package's ``q >= 8`` gate was a TPU measurement) and whatever k,
where the JAX dispatch sends k above 256 to XLA ``top_k``: no k goes to the
plain version on the card. A corpus sharded over a device mesh
(``parallel.sharded_search.ShardedTensor``) takes the sharded top-k: the
kernel on every shard, one exact merge.
"""

from __future__ import annotations

import torch

from . import fused_topk
from .fused_topk import quantize_rows_int8

__all__ = ["cosine_topk", "cosine_topk_int8", "quantize_rows_int8"]


def cosine_topk(queries, corpus, valid, k: int):
    """Exact cosine top-k -> (scores [Q, k] f32, indices [Q, k] i32)."""
    if isinstance(corpus, torch.Tensor):
        return fused_topk.fused_cosine_topk(queries, corpus, valid, k)
    from ..parallel.sharded_search import sharded_topk
    return sharded_topk(fused_topk.fused_cosine_topk, queries, k, corpus, valid)


def cosine_topk_int8(queries, corpus_q, row_scale, valid, k: int):
    """int8 exact top-k (queries quantized per row, as the corpus is)."""
    if isinstance(corpus_q, torch.Tensor):
        return fused_topk.fused_cosine_topk_int8(queries, corpus_q, row_scale, valid, k)
    from ..parallel.sharded_search import sharded_topk
    return sharded_topk(fused_topk.fused_cosine_topk_int8, queries, k, corpus_q, row_scale,
                        valid)
