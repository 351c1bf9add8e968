"""Reciprocal Rank Fusion (behavioral parity with src/rerank/mod.rs).

score = Σ 1/(k + rank) per ranking list; default k=20, exact-match list
k=5 (stronger boost). Three-way fusion merges vector, BM25, and exact
identifier matches; ``fts_score`` reports (fts+exact)/2 when both present.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DEFAULT_RRF_K = 20.0
EXACT_MATCH_RRF_K = 5.0


@dataclass(slots=True)
class FusedResult:
    chunk_id: int
    rrf_score: float
    vector_score: float | None = None
    fts_score: float | None = None
    vector_rank: int | None = None
    fts_rank: int | None = None


def rrf_fusion(vector_results, fts_results, k: float = DEFAULT_RRF_K) -> list[FusedResult]:
    """vector_results: [(chunk_id, score)], fts_results: [(chunk_id, score)]."""
    acc: dict[int, FusedResult] = {}
    for rank, (cid, score) in enumerate(vector_results):
        e = acc.setdefault(cid, FusedResult(chunk_id=cid, rrf_score=0.0))
        e.rrf_score += 1.0 / (k + rank + 1.0)
        e.vector_score = score
        e.vector_rank = rank + 1
    for rank, (cid, score) in enumerate(fts_results):
        e = acc.setdefault(cid, FusedResult(chunk_id=cid, rrf_score=0.0))
        e.rrf_score += 1.0 / (k + rank + 1.0)
        e.fts_score = score
        e.fts_rank = rank + 1
    return sorted(acc.values(), key=lambda r: -r.rrf_score)


def vector_only(vector_results) -> list[FusedResult]:
    return [
        FusedResult(
            chunk_id=cid,
            rrf_score=score,
            vector_score=score,
            vector_rank=rank + 1,
        )
        for rank, (cid, score) in enumerate(vector_results)
    ]


def rrf_fusion_with_exact(
    vector_results,
    fts_results,
    exact_results,
    vector_k: float = DEFAULT_RRF_K,
    fts_k: float = DEFAULT_RRF_K,
    exact_k: float = EXACT_MATCH_RRF_K,
) -> list[FusedResult]:
    """Vectorized 3-way RRF: one np.unique merge + scatter-accumulated
    reciprocal ranks over all three lists (the dict-of-dicts merge cost
    ~2.2 ms/query at fetch≈400 on one host core — this is the hot line of
    batched serving's host share). Semantics match the per-entry loop:
    within a list a duplicate cid contributes every rank's RRF term and
    keeps the LAST score/rank; fts_score reports (fts+exact)/2 when both
    lists hit."""
    nv, nf, ne = len(vector_results), len(fts_results), len(exact_results)
    total = nv + nf + ne
    if not total:
        return []
    parts = [
        np.asarray(r, np.float64).reshape(-1, 2)
        for r in (vector_results, fts_results, exact_results)
    ]
    flat = np.concatenate(parts) if total else np.empty((0, 2))
    all_c = flat[:, 0].astype(np.int64)
    all_s = flat[:, 1]
    uniq, inv = np.unique(all_c, return_inverse=True)
    n = len(uniq)
    recip = np.concatenate([
        1.0 / (vector_k + np.arange(1, nv + 1, dtype=np.float64)),
        1.0 / (fts_k + np.arange(1, nf + 1, dtype=np.float64)),
        1.0 / (exact_k + np.arange(1, ne + 1, dtype=np.float64)),
    ])
    rrf = np.bincount(inv, weights=recip, minlength=n)

    v_score = np.full(n, np.nan)
    v_rank = np.zeros(n, np.int64)
    v_score[inv[:nv]] = all_s[:nv]
    v_rank[inv[:nv]] = np.arange(1, nv + 1)
    f_score = np.full(n, np.nan)
    f_rank = np.zeros(n, np.int64)
    f_score[inv[nv:nv + nf]] = all_s[nv:nv + nf]
    f_rank[inv[nv:nv + nf]] = np.arange(1, nf + 1)
    e_score = np.full(n, np.nan)
    e_rank = np.zeros(n, np.int64)
    e_score[inv[nv + nf:]] = all_s[nv + nf:]
    e_rank[inv[nv + nf:]] = np.arange(1, ne + 1)

    has_f = ~np.isnan(f_score)
    has_e = ~np.isnan(e_score)
    fts_out = np.where(has_f & has_e, (f_score + e_score) / 2.0,
                       np.where(has_f, f_score, e_score))
    fr_out = np.where(f_rank > 0, f_rank, e_rank)

    order = np.argsort(-rrf, kind="stable")
    # positional construction off plain Python lists (NaN → None for
    # absent scores, rank 0 → None): ~2× cheaper than kwargs at fetch≈400
    mk = FusedResult
    return [
        mk(c, r, None if v != v else v, None if ft != ft else ft,
           vr or None, fr or None)
        for c, r, v, ft, vr, fr in zip(
            uniq[order].tolist(), rrf[order].tolist(),
            v_score[order].tolist(), fts_out[order].tolist(),
            v_rank[order].tolist(), fr_out[order].tolist(),
        )
    ]
