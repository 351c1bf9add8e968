"""Indexing pipeline (torch): pipeline, discovery, file manifest."""

from .db_discovery import (  # noqa: F401
    find_databases,
    register_repo,
    registered_repos,
    resolve_database_with_message,
    unregister_repo,
)
from .file_meta import FileMetaStore  # noqa: F401
from .pipeline import (  # noqa: F401
    IndexOptions,
    IndexStats,
    clear_database,
    db_stats,
    index,
    index_quiet,
    read_metadata,
    write_metadata,
)
