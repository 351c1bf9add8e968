"""Embedding service (hash models on torch). ``Chunk`` and ``ChunkKind``, the
chunker's types that ``embed_chunks*`` take, are re-exported for callers."""

from codesearch_tpu.chunker import Chunk, ChunkKind  # noqa: F401
from codesearch_tpu.embed.service import EmbeddedChunk, clean_docstring, prepare_text  # noqa: F401

from .service import EmbeddingService  # noqa: F401
