"""Models: registry, tokenizers, the BERT encoder and the weights-free hash
embedder."""

from .registry import (  # noqa: F401
    DEFAULT_MODEL,
    MODELS,
    ArchConfig,
    ModelSpec,
    all_models,
    parse_model,
)
