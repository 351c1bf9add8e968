"""Search pipeline (torch)."""

from .pipeline import SearchOptions, SearchResponse, SearchSession, search  # noqa: F401
