"""Live index freshness: filesystem watcher + git HEAD poller."""

from .watcher import (  # noqa: F401
    EventKind,
    FileEvent,
    FileWatcher,
    GitHeadWatcher,
    HeadChange,
    is_watchable,
)
