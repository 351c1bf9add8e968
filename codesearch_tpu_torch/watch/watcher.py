"""Filesystem watcher and git-HEAD poller.

The reference uses the notify crate (OS-native inotify/FSEvents) with a 2s
debounced batcher (src/watch/mod.rs). Here:

- ``InotifyBackend`` — Linux inotify via ctypes syscalls (no dependencies):
  recursive watch registration, event decode, new-directory auto-watch.
- ``PollingBackend`` — portable mtime-scan fallback.
- ``FileWatcher`` — debounced draining with event coalescing (modify wins
  over nothing, delete wins over modify; renames surface as delete+modify),
  filtering mirrors the walker rules (watch/mod.rs:132-163).
- ``GitHeadWatcher`` — worktree-aware `.git/HEAD` resolution and cheap
  content-compare polling (watch/mod.rs:304-405).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import struct
import threading
import time
from dataclasses import dataclass
from enum import Enum
from pathlib import Path

from ..utils.constants import (
    ALWAYS_EXCLUDED_DIRS,
    ALWAYS_SKIP_EXTENSIONS,
    ALWAYS_SKIP_FILENAME_SUFFIXES,
    DEFAULT_FSW_DEBOUNCE_MS,
)
from ..fileio.language import detect_language
from ..utils.logger import get_logger

log = get_logger("watch")


class EventKind(Enum):
    MODIFIED = "modified"
    DELETED = "deleted"


@dataclass(frozen=True)
class FileEvent:
    kind: EventKind
    path: Path


@dataclass
class HeadChange:
    old_head: str
    new_head: str


def is_watchable(path: Path) -> bool:
    """Mirror the walker's filter rules for watch events."""
    for part in path.parts:
        if part in ALWAYS_EXCLUDED_DIRS:
            return False
        if part.startswith(".") and part not in (".", "..", ".github"):
            return False
    name = path.name.lower()
    ext = name.rsplit(".", 1)[-1] if "." in name else ""
    if ext in ALWAYS_SKIP_EXTENSIONS:
        return False
    if any(name.endswith(s) for s in ALWAYS_SKIP_FILENAME_SUFFIXES):
        return False
    return detect_language(path).is_indexable()


# ---------------------------------------------------------------------------
# inotify backend (Linux, ctypes — native watching without dependencies)
# ---------------------------------------------------------------------------

_IN_CREATE = 0x00000100
_IN_DELETE = 0x00000200
_IN_MODIFY = 0x00000002
_IN_CLOSE_WRITE = 0x00000008
_IN_MOVED_FROM = 0x00000040
_IN_MOVED_TO = 0x00000080
_IN_ISDIR = 0x40000000
_IN_MASK = (
    _IN_CREATE | _IN_DELETE | _IN_CLOSE_WRITE | _IN_MODIFY
    | _IN_MOVED_FROM | _IN_MOVED_TO
)
_EVENT_STRUCT = struct.Struct("iIII")


class InotifyBackend:
    def __init__(self, root: Path):
        self.root = Path(root)
        libc_name = ctypes.util.find_library("c") or "libc.so.6"
        self._libc = ctypes.CDLL(libc_name, use_errno=True)
        self._fd = self._libc.inotify_init1(os.O_NONBLOCK)
        if self._fd < 0:
            raise OSError("inotify_init1 failed")
        self._wd_to_dir: dict[int, Path] = {}
        self._watch_tree(self.root)

    def _watch_dir(self, d: Path) -> None:
        wd = self._libc.inotify_add_watch(
            self._fd, str(d).encode(), _IN_MASK
        )
        if wd >= 0:
            self._wd_to_dir[wd] = d

    def _watch_tree(self, root: Path) -> None:
        for dirpath, dirnames, _ in os.walk(root):
            dirnames[:] = [
                n for n in dirnames
                if n not in ALWAYS_EXCLUDED_DIRS and not n.startswith(".")
            ]
            self._watch_dir(Path(dirpath))

    def drain(self) -> list[FileEvent]:
        events: list[FileEvent] = []
        try:
            data = os.read(self._fd, 65536)
        except BlockingIOError:
            return events
        except OSError:
            return events
        offset = 0
        while offset + _EVENT_STRUCT.size <= len(data):
            wd, mask, _cookie, name_len = _EVENT_STRUCT.unpack_from(data, offset)
            offset += _EVENT_STRUCT.size
            name = data[offset : offset + name_len].split(b"\x00", 1)[0].decode(
                "utf-8", errors="replace"
            )
            offset += name_len
            base = self._wd_to_dir.get(wd)
            if base is None or not name:
                continue
            path = base / name
            if mask & _IN_ISDIR:
                if mask & (_IN_CREATE | _IN_MOVED_TO):
                    if path.name not in ALWAYS_EXCLUDED_DIRS and not path.name.startswith("."):
                        self._watch_tree(path)
                continue
            if mask & (_IN_DELETE | _IN_MOVED_FROM):
                events.append(FileEvent(EventKind.DELETED, path))
            elif mask & (_IN_CREATE | _IN_MODIFY | _IN_CLOSE_WRITE | _IN_MOVED_TO):
                events.append(FileEvent(EventKind.MODIFIED, path))
        return events

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass


class PollingBackend:
    """Portable fallback: scan mtimes on each drain."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self._snapshot = self._scan()

    def _scan(self) -> dict[Path, float]:
        out: dict[Path, float] = {}
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = [
                n for n in dirnames
                if n not in ALWAYS_EXCLUDED_DIRS and not n.startswith(".")
            ]
            for fn in filenames:
                p = Path(dirpath) / fn
                try:
                    out[p] = p.stat().st_mtime
                except OSError:
                    pass
        return out

    def drain(self) -> list[FileEvent]:
        new = self._scan()
        events: list[FileEvent] = []
        for p, m in new.items():
            old = self._snapshot.get(p)
            if old is None or old != m:
                events.append(FileEvent(EventKind.MODIFIED, p))
        for p in self._snapshot:
            if p not in new:
                events.append(FileEvent(EventKind.DELETED, p))
        self._snapshot = new
        return events

    def close(self) -> None:
        pass


class FileWatcher:
    """Debounced, coalescing watcher (parity with watch/mod.rs:52-297)."""

    def __init__(
        self,
        root: str | Path,
        debounce_ms: int = DEFAULT_FSW_DEBOUNCE_MS,
        backend: str = "auto",
    ):
        self.root = Path(root)
        self.debounce_s = debounce_ms / 1000.0
        self._pending: dict[Path, FileEvent] = {}
        self._first_pending_at: float | None = None
        self._lock = threading.Lock()
        if backend == "polling":
            self._backend = PollingBackend(self.root)
        elif backend == "inotify":
            self._backend = InotifyBackend(self.root)
        else:
            try:
                self._backend = InotifyBackend(self.root)
            except Exception as e:
                log.info("inotify unavailable (%s); using polling watcher", e)
                self._backend = PollingBackend(self.root)

    def poll(self) -> list[FileEvent]:
        """Drain backend into the pending buffer; return a batch if the
        debounce window has elapsed, else []."""
        with self._lock:
            for ev in self._backend.drain():
                if not is_watchable(ev.path):
                    continue
                prev = self._pending.get(ev.path)
                # delete wins over modify for the same path
                if prev is None or ev.kind is EventKind.DELETED:
                    self._pending[ev.path] = ev
                if self._first_pending_at is None:
                    self._first_pending_at = time.time()
            if (
                self._pending
                and self._first_pending_at is not None
                and time.time() - self._first_pending_at >= self.debounce_s
            ):
                batch = list(self._pending.values())
                self._pending.clear()
                self._first_pending_at = None
                return batch
            return []

    def flush(self) -> list[FileEvent]:
        """Immediately return whatever is pending (tests / shutdown)."""
        with self._lock:
            self._backend_drain_into_pending()
            batch = list(self._pending.values())
            self._pending.clear()
            self._first_pending_at = None
            return batch

    def _backend_drain_into_pending(self) -> None:
        for ev in self._backend.drain():
            if not is_watchable(ev.path):
                continue
            prev = self._pending.get(ev.path)
            if prev is None or ev.kind is EventKind.DELETED:
                self._pending[ev.path] = ev

    def close(self) -> None:
        self._backend.close()


# ---------------------------------------------------------------------------
# git HEAD watcher
# ---------------------------------------------------------------------------

class GitHeadWatcher:
    def __init__(self, repo_root: str | Path):
        self.repo_root = Path(repo_root)
        self.head_path = self._resolve_head_path()
        self._last: str | None = self._read_head()

    def _resolve_head_path(self) -> Path | None:
        git = self.repo_root / ".git"
        if git.is_dir():
            return git / "HEAD"
        if git.is_file():
            # worktree: gitdir: <path> (watch/mod.rs:329-353)
            try:
                line = git.read_text().splitlines()[0]
            except (OSError, IndexError):
                return None
            gitdir = line.removeprefix("gitdir: ").strip()
            p = (git.parent / gitdir).resolve() if not os.path.isabs(gitdir) else Path(gitdir)
            return p / "HEAD"
        return None

    def _read_head(self) -> str | None:
        if self.head_path is None:
            return None
        try:
            return self.head_path.read_text()
        except OSError:
            return None

    def check(self) -> HeadChange | None:
        """Cheap content-compare poll (watch/mod.rs:364-396)."""
        cur = self._read_head()
        if cur is None:
            return None
        if self._last is not None and cur != self._last:
            change = HeadChange(old_head=self._last, new_head=cur)
            self._last = cur
            return change
        self._last = cur
        return None
