"""Indexing pipeline (torch): pipeline, discovery, file manifest."""

from .db_discovery import register_repo, resolve_database_with_message  # noqa: F401
from .file_meta import FileMetaStore  # noqa: F401
from .pipeline import IndexOptions, IndexStats, index, read_metadata, write_metadata  # noqa: F401
