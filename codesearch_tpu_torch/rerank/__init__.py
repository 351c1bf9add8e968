"""Ranking: RRF fusion and neural cross-encoder reranking."""

from .fusion import (  # noqa: F401
    DEFAULT_RRF_K,
    EXACT_MATCH_RRF_K,
    FusedResult,
    rrf_fusion,
    rrf_fusion_with_exact,
    vector_only,
)
from .neural import NeuralReranker  # noqa: F401
