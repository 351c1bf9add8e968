"""Device-resident vector store (torch)."""

from .store import ChunkMetadata, SearchResult, VectorStore  # noqa: F401
