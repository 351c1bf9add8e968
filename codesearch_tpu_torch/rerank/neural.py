"""Neural reranking on torch (port of ``codesearch_tpu/rerank/neural.py``;
behavioral parity with src/rerank/neural.rs).

Cross-encoder scores are sigmoid-normalized and blended 57.5/42.5 with
min-max-normalized RRF scores (neural.rs:12-13, 77-122). All candidate pairs
score in one batched device forward instead of per-pair CPU calls.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.cross_encoder import CrossEncoder
from ..utils.constants import get_global_models_cache_dir

RERANK_WEIGHT = 0.575
RRF_WEIGHT = 0.425
# Confidence gate: blend only when the cross-encoder discriminates within
# this candidate list. When its sigmoid scores are nearly flat across the
# candidates (spread below this floor) the model has no signal for the
# query, and blending would only add noise to an informative retrieval
# order. The reference always blends (neural.rs:77-122).
CONFIDENCE_SPREAD_FLOOR = 0.10


@dataclass
class RerankedResult:
    chunk_id: int
    final_score: float
    rerank_score: float
    rrf_score: float


class NeuralReranker:
    """Reranks candidates with ``cross_encoder``, by default the models
    cache's reranker on ``device``. ``gate_calls``/``gate_open`` count the
    blends and how many of them the confidence gate opened."""

    def __init__(self, cross_encoder: CrossEncoder | None = None, device=None):
        self.model = cross_encoder or CrossEncoder(get_global_models_cache_dir(),
                                                   device=device)
        self.gate_calls = 0
        self.gate_open = 0

    def rerank(self, query: str, docs: list[tuple[int, str]]) -> list[tuple[int, float]]:
        """(chunk_id, text) pairs → (chunk_id, sigmoid score) sorted desc."""
        if not docs:
            return []
        scores = self.model.score_pairs(query, [t for _, t in docs])
        ranked = sorted(zip((cid for cid, _ in docs), scores), key=lambda x: -x[1])
        return [(cid, float(s)) for cid, s in ranked]

    def rerank_and_blend(
        self,
        query: str,
        docs: list[tuple[int, str]],
        rrf_scores: dict[int, float],
    ) -> list[RerankedResult]:
        """Blend cross-encoder scores with min-max-normalized RRF (a stable
        sort: equal final scores keep the candidates' order)."""
        if not docs:
            return []
        scores = np.asarray(self.model.score_pairs(query, [t for _, t in docs]), np.float64)
        rrf_vals = np.asarray([rrf_scores.get(cid, 0.0) for cid, _ in docs], np.float64)
        lo, hi = float(rrf_vals.min()), float(rrf_vals.max())
        rrf_norm = (rrf_vals - lo) / (hi - lo) if hi > lo else np.ones_like(rrf_vals)
        spread = float(scores.max() - scores.min()) if len(scores) else 0.0
        opened = spread >= CONFIDENCE_SPREAD_FLOOR
        self.gate_calls += 1
        self.gate_open += opened
        # flat CE scores: keep the retrieval order
        w_ce, w_rrf = (RERANK_WEIGHT, RRF_WEIGHT) if opened else (0.0, 1.0)
        out = [
            RerankedResult(chunk_id=cid, final_score=float(w_ce * s + w_rrf * rn),
                           rerank_score=float(s), rrf_score=float(rrf_scores.get(cid, 0.0)))
            for (cid, _), s, rn in zip(docs, scores, rrf_norm)
        ]
        out.sort(key=lambda r: -r.final_score)
        return out
