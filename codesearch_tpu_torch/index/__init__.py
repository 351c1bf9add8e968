"""Indexing pipeline (torch)."""

from codesearch_tpu.index.pipeline import read_metadata, write_metadata  # noqa: F401

from .pipeline import IndexOptions, IndexStats, index  # noqa: F401
