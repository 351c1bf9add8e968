"""Embedding service (hash and BERT-family models on torch). ``Chunk`` and
``ChunkKind``, the chunker's types that ``embed_chunks_matrix*`` take, are
re-exported for callers."""

from ..chunker import Chunk, ChunkKind  # noqa: F401
from .service import EmbeddingService, clean_docstring, prepare_text  # noqa: F401
