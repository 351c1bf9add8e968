"""Ranking: RRF fusion (the neural cross-encoder reranker is not ported yet)."""

from .fusion import (  # noqa: F401
    DEFAULT_RRF_K,
    EXACT_MATCH_RRF_K,
    FusedResult,
    rrf_fusion,
    rrf_fusion_with_exact,
    vector_only,
)
