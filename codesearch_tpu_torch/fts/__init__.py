"""BM25 full-text store with resident device scoring (torch)."""

from .store import FtsResult, FtsStore  # noqa: F401
