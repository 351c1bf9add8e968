"""Exact fused top-k: the port of ``codesearch_tpu/ops/pallas_topk.py``.

Three wrappers, each beside its plain PyTorch version:

- ``fused_cosine_topk``: bf16 cosine scores of [Q, d] queries against an
  [N, d] bf16 corpus (f32 accumulation), invalid rows at -3e38, exact top-k;
- ``fused_cosine_topk_int8``: the same over an int8 row-quantized corpus,
  queries quantized per row (absmax/127, round half to even, clip ±127),
  int8 x int8 -> int32, then ``(s * q_scale) * row_scale`` in f32;
- ``fused_scores_topk``: selection only over precomputed [B, N] f32 scores,
  x3 where ``slot_meta == boost_kid[b]``, -3e38 where ``slot_meta`` is the
  dead slot.

Ties keep the lowest index. A tensor on the CPU takes the plain version; a
tensor on a CUDA device launches the hand-written kernels of
``csrc/topk_kernels.cu`` or raises, for any 1 <= k <= N. Kernel c is an
exact radix select over the boosted scores (five launches). a and b are a
tensor-core score pass over the streamed corpus (which also rounds or
quantizes the f32 queries), then the same radix select over its score rows.
``launch_counts`` counts wrapper calls that launched their kernels.
"""

from __future__ import annotations

import torch

from . import _build

NEG_INF = -3.0e38       # score of an invalid row / dead slot (Pallas' sentinel)

launch_counts = {
    "fused_cosine_topk": 0,
    "fused_cosine_topk_int8": 0,
    "fused_scores_topk": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def quantize_rows_int8(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization -> (q [N, d] int8, scale [N] f32):
    scale = max(absmax, 1e-12) / 127, round half to even, clip to +-127.
    Used for the corpus and, as the Pallas wrapper does before its kernel,
    for the queries (kernel b repeats it on the card). The scale divides by a
    tensor: CUDA divides a tensor by a Python scalar as a product with the
    scalar's f32 reciprocal, one ulp off the division now and then."""
    c = rows.float()
    scale = torch.clamp(c.abs().amax(dim=1), min=1e-12) / c.new_tensor(127.0)
    q = torch.clamp(torch.round(c / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def select_topk_plain(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis, equal scores in ascending index order
    (a stable descending sort; ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# plain versions (CPU tensors and tests)
# ---------------------------------------------------------------------------

def fused_cosine_topk_plain(queries, corpus, valid, k):
    q = queries.to(torch.bfloat16).float()
    scores = q @ corpus.float().T
    scores = torch.where(valid[None, :], scores, NEG_INF)
    return select_topk_plain(scores, k)


def fused_cosine_topk_int8_plain(queries, corpus_q, row_scale, valid, k):
    q_i8, q_scale = quantize_rows_int8(queries)
    # exact in f32: |q . c| <= d * 127 * 127 < 2**24 for d <= 1024
    s = q_i8.float() @ corpus_q.float().T
    scores = s * q_scale[:, None] * row_scale[None, :]
    scores = torch.where(valid[None, :], scores, NEG_INF)
    return select_topk_plain(scores, k)


def fused_scores_topk_plain(scores, slot_meta, boost_kid, k, dead_slot):
    meta = slot_meta[None, :]
    boost = torch.where(meta == boost_kid[:, None], 3.0, 1.0)
    s = torch.where(meta == dead_slot, NEG_INF, scores * boost)
    return select_topk_plain(s, k)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _on_cpu(*tensors: torch.Tensor) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"top-k inputs must share one CPU or CUDA device, got {devs}")
    return False


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_k(k: int, n: int) -> None:
    if not 1 <= k <= n:
        raise ValueError(f"k={k} outside [1, {n}], the selectable columns")


def _outputs(lib, nq: int, n: int, k: int, score_rows: bool, device):
    """Scratch and the outputs. c's select histograms are zeroed here; a's
    and b's score pass zeroes them itself."""
    part = torch.empty(lib.cs_scratch_entries(nq, n, k, int(score_rows), 0),
                       dtype=torch.int64, device=device)
    zero = (torch.empty if score_rows else torch.zeros)(
        lib.cs_scratch_entries(nq, n, k, int(score_rows), 1), dtype=torch.int64, device=device)
    vals = torch.empty((nq, k), dtype=torch.float32, device=device)
    idx = torch.empty((nq, k), dtype=torch.int32, device=device)
    return part, zero, vals, idx


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def fused_cosine_topk(queries, corpus, valid, k: int):
    """Exact bf16 cosine top-k -> (scores [Q, k] f32, indices [Q, k] i32)."""
    if _on_cpu(queries, corpus, valid):
        return fused_cosine_topk_plain(queries, corpus, valid, k)
    n, d = corpus.shape
    # the kernel rounds f32 queries to bf16; other types round here first
    q = queries if queries.dtype == torch.float32 else queries.to(torch.bfloat16).float()
    q = q.contiguous()
    nq = q.shape[0]
    _require(q, "queries", torch.float32, (nq, d))
    _require(corpus, "corpus", torch.bfloat16, (n, d))
    _require(valid, "valid", torch.bool, (n,))
    _check_k(k, n)
    with torch.cuda.device(corpus.device):
        lib = _build.load()
        part, zero, vals, idx = _outputs(lib, nq, n, k, True, corpus.device)
        rc = lib.cs_cosine_topk_bf16(
            q.data_ptr(), corpus.data_ptr(), valid.data_ptr(), nq, n, d, k, part.data_ptr(),
            zero.data_ptr(), vals.data_ptr(), idx.data_ptr(), _stream())
        _build.check(lib, rc, "fused_cosine_topk")
    launch_counts["fused_cosine_topk"] += 1
    return vals, idx


def fused_cosine_topk_int8(queries, corpus_q, row_scale, valid, k: int):
    """Exact int8 cosine top-k -> (scores [Q, k] f32, indices [Q, k] i32);
    the kernel quantizes the f32 queries as ``quantize_rows_int8`` does."""
    if _on_cpu(queries, corpus_q, row_scale, valid):
        return fused_cosine_topk_int8_plain(queries, corpus_q, row_scale, valid, k)
    n, d = corpus_q.shape
    q = queries.float().contiguous()
    nq = q.shape[0]
    _require(q, "queries", torch.float32, (nq, d))
    _require(corpus_q, "corpus_q", torch.int8, (n, d))
    _require(row_scale, "row_scale", torch.float32, (n,))
    _require(valid, "valid", torch.bool, (n,))
    _check_k(k, n)
    with torch.cuda.device(corpus_q.device):
        lib = _build.load()
        part, zero, vals, idx = _outputs(lib, nq, n, k, True, corpus_q.device)
        rc = lib.cs_cosine_topk_int8(
            q.data_ptr(), corpus_q.data_ptr(), row_scale.data_ptr(), valid.data_ptr(), nq, n,
            d, k, part.data_ptr(), zero.data_ptr(), vals.data_ptr(), idx.data_ptr(), _stream())
        _build.check(lib, rc, "fused_cosine_topk_int8")
    launch_counts["fused_cosine_topk_int8"] += 1
    return vals, idx


def fused_scores_topk(scores, slot_meta, boost_kid, k: int, dead_slot: int):
    """Exact boosted top-k over precomputed score rows -> ([B, k] f32,
    [B, k] i32)."""
    if _on_cpu(scores, slot_meta, boost_kid):
        return fused_scores_topk_plain(scores, slot_meta, boost_kid, k, dead_slot)
    nb, n = scores.shape
    _require(scores, "scores", torch.float32, (nb, n))
    _require(slot_meta, "slot_meta", torch.int32, (n,))
    _require(boost_kid, "boost_kid", torch.int32, (nb,))
    _check_k(k, n)
    with torch.cuda.device(scores.device):
        lib = _build.load()
        part, zero, vals, idx = _outputs(lib, nb, n, k, False, scores.device)
        rc = lib.cs_scores_topk(
            scores.data_ptr(), slot_meta.data_ptr(), boost_kid.data_ptr(), nb,
            n, k, dead_slot, part.data_ptr(), zero.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), _stream())
        _build.check(lib, rc, "fused_scores_topk")
    launch_counts["fused_scores_topk"] += 1
    return vals, idx
