"""Search pipeline (torch)."""

from .pipeline import (  # noqa: F401
    SearchOptions,
    SearchResponse,
    SearchSession,
    search,
    search_all,
)
