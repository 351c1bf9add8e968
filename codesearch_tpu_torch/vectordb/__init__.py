"""Device-resident vector store (torch)."""

from codesearch_tpu.vectordb.store import ChunkMetadata, SearchResult, StoreStats  # noqa: F401

from .store import VectorStore  # noqa: F401
