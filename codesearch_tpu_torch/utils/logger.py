"""Daily-rotated per-database file logging with retention cleanup.

Reference behavior (src/logger/mod.rs): logs live under
``<db>/.codesearch.db/logs/codesearch.log.YYYY-MM-DD``; retention is bounded
both by age (days) and by file count, env-tunable; noisy third-party loggers
are filtered down; quiet mode logs to file only, otherwise stderr + file.
"""

from __future__ import annotations

import datetime as _dt
import logging
import os
import re
import sys
import threading
from pathlib import Path

from .constants import (
    DEFAULT_LOG_MAX_FILES,
    DEFAULT_LOG_RETENTION_DAYS,
    LOG_DIR_NAME,
    LOG_FILE_NAME,
)

_LOG_SUFFIX_RE = re.compile(r"\.(\d{4}-\d{2}-\d{2})$")
_CONFIGURED = False
_LOCK = threading.Lock()


class _DailyFileHandler(logging.Handler):
    """Writes to ``codesearch.log.YYYY-MM-DD``, switching files at midnight."""

    def __init__(self, log_dir: Path):
        super().__init__()
        self.log_dir = log_dir
        self._current_date: str | None = None
        self._stream = None

    def _ensure_stream(self) -> None:
        today = _dt.date.today().isoformat()
        if self._current_date != today or self._stream is None:
            if self._stream is not None:
                self._stream.close()
            self.log_dir.mkdir(parents=True, exist_ok=True)
            path = self.log_dir / f"{LOG_FILE_NAME}.{today}"
            self._stream = open(path, "a", encoding="utf-8")
            self._current_date = today

    def emit(self, record: logging.LogRecord) -> None:
        try:
            with self.lock:  # type: ignore[union-attr]
                self._ensure_stream()
                assert self._stream is not None
                self._stream.write(self.format(record) + "\n")
                self._stream.flush()
        except Exception:
            self.handleError(record)

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None
        super().close()


def log_retention_settings() -> tuple[int, int]:
    max_files = int(os.environ.get("CODESEARCH_LOG_MAX_FILES", DEFAULT_LOG_MAX_FILES))
    retention_days = int(
        os.environ.get("CODESEARCH_LOG_RETENTION_DAYS", DEFAULT_LOG_RETENTION_DAYS)
    )
    return max_files, retention_days


def cleanup_old_logs(log_dir: Path, today: _dt.date | None = None) -> int:
    """Delete dated log files beyond retention (by age AND by count).

    Returns the number of files removed. Reference: logger/mod.rs:122-204.
    """
    if not log_dir.is_dir():
        return 0
    max_files, retention_days = log_retention_settings()
    today = today or _dt.date.today()
    dated: list[tuple[_dt.date, Path]] = []
    for p in log_dir.iterdir():
        if not p.name.startswith(LOG_FILE_NAME):
            continue
        m = _LOG_SUFFIX_RE.search(p.name)
        if not m:
            continue
        try:
            d = _dt.date.fromisoformat(m.group(1))
        except ValueError:
            continue
        dated.append((d, p))
    dated.sort(reverse=True)  # newest first

    removed = 0
    for i, (d, p) in enumerate(dated):
        too_old = (today - d).days > retention_days
        too_many = i >= max_files
        if too_old or too_many:
            try:
                p.unlink()
                removed += 1
            except OSError:
                pass
    return removed


_NOISY_LOGGERS = ("jax", "jaxlib", "absl", "urllib3", "filelock", "asyncio")


def init_logger(
    db_path: Path | None = None,
    level: str = "info",
    quiet: bool = False,
) -> None:
    """Install root logging: stderr (unless quiet) + daily file (if db known)."""
    global _CONFIGURED
    with _LOCK:
        root = logging.getLogger("codesearch")
        root.handlers.clear()
        root.setLevel(getattr(logging, level.upper(), logging.INFO))
        fmt = logging.Formatter(
            "%(asctime)s %(levelname)-5s %(name)s: %(message)s", "%Y-%m-%dT%H:%M:%S"
        )
        if not quiet:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(fmt)
            root.addHandler(h)
        if db_path is not None:
            log_dir = Path(db_path) / LOG_DIR_NAME
            fh = _DailyFileHandler(log_dir)
            fh.setFormatter(fmt)
            root.addHandler(fh)
            cleanup_old_logs(log_dir)
        for name in _NOISY_LOGGERS:
            logging.getLogger(name).setLevel(logging.WARNING)
        root.propagate = False
        _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"codesearch.{name}")


def start_cleanup_task(db_path: Path, interval_hours: float | None = None) -> threading.Thread:
    """Periodic old-log cleanup for long-lived servers
    (reference: logger/mod.rs:290-330; CODESEARCH_LOG_CLEANUP_INTERVAL_HOURS)."""
    interval = interval_hours or float(
        os.environ.get("CODESEARCH_LOG_CLEANUP_INTERVAL_HOURS", 24)
    )
    log_dir = Path(db_path) / LOG_DIR_NAME

    def _loop() -> None:
        import time

        while True:
            time.sleep(interval * 3600)
            try:
                removed = cleanup_old_logs(log_dir)
                if removed:
                    get_logger("logger").info("cleaned %d old log files", removed)
            except Exception:
                pass

    t = threading.Thread(target=_loop, daemon=True, name="codesearch-log-cleanup")
    t.start()
    return t
