"""Device-resident vector store (torch)."""

from .store import ChunkMetadata, SearchResult, StoreStats, VectorStore  # noqa: F401
