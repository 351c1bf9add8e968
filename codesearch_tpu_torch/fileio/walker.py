"""Repository file discovery.

Behavioral parity with the reference FileWalker (src/file/mod.rs:73-199):
recursive walk honoring ``.gitignore`` per directory plus repo-level
``.codesearchignore``/``.osgrepignore``; hard-excluded directory names pruned
before descent; skips 0-byte files, always-skip extensions, always-skip
filename suffixes, binary files; collects per-language walk stats.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path

from ..utils.constants import (
    ALWAYS_EXCLUDED_DIRS,
    ALWAYS_SKIP_EXTENSIONS,
    ALWAYS_SKIP_FILENAME_SUFFIXES,
    IGNORE_FILE_NAMES,
)
from .binary import is_binary_file
from .ignore import IgnoreFile, IgnoreStack
from .language import Language, detect_language


@dataclass
class FileInfo:
    path: Path
    language: Language
    size: int


@dataclass
class WalkStats:
    total_seen: int = 0
    indexed: int = 0
    skipped_ignored: int = 0
    skipped_binary: int = 0
    skipped_extension: int = 0
    skipped_empty: int = 0
    skipped_unknown_language: int = 0
    by_language: dict[str, int] = field(default_factory=dict)

    def note_language(self, lang: Language) -> None:
        self.by_language[lang.display_name] = self.by_language.get(lang.display_name, 0) + 1


def _always_skipped_name(name: str) -> bool:
    lower = name.lower()
    ext = lower.rsplit(".", 1)[-1] if "." in lower else ""
    if ext in ALWAYS_SKIP_EXTENSIONS:
        return True
    return any(lower.endswith(suf) for suf in ALWAYS_SKIP_FILENAME_SUFFIXES)


class FileWalker:
    """Walks a repo root and returns indexable files + stats."""

    def __init__(
        self,
        root: str | Path,
        extra_excludes: list[str] | None = None,
        follow_symlinks: bool = False,
    ):
        self.root = Path(root).resolve()
        self.extra_excludes = set(extra_excludes or [])
        self.follow_symlinks = follow_symlinks

    def _root_stack(self) -> IgnoreStack:
        stack = IgnoreStack()
        for name in (".gitignore",) + IGNORE_FILE_NAMES:
            f = IgnoreFile.load(self.root / name)
            if f is not None:
                stack.push(self.root, f)
        return stack

    def walk(self) -> tuple[list[FileInfo], WalkStats]:
        stats = WalkStats()
        files: list[FileInfo] = []
        # Iterative DFS carrying the ignore stack per directory.
        todo: list[tuple[Path, IgnoreStack]] = [(self.root, self._root_stack())]
        while todo:
            d, stack = todo.pop()
            try:
                entries = sorted(os.scandir(d), key=lambda e: e.name)
            except OSError:
                continue
            # Nested .gitignore (non-root; root ones already loaded)
            if d != self.root:
                gi = IgnoreFile.load(d / ".gitignore")
                if gi is not None:
                    stack = stack.pushed_copy(d, gi)
            for entry in entries:
                name = entry.name
                p = Path(entry.path)
                try:
                    is_dir = entry.is_dir(follow_symlinks=self.follow_symlinks)
                    is_file = entry.is_file(follow_symlinks=self.follow_symlinks)
                except OSError:
                    continue
                if is_dir:
                    if name in ALWAYS_EXCLUDED_DIRS or name in self.extra_excludes:
                        continue
                    if name.endswith(".egg-info"):
                        continue
                    if name.startswith(".") and name not in (".github",):
                        # hidden dirs skipped pre-descent (walker behavior)
                        continue
                    if stack.is_ignored(p, is_dir=True):
                        continue
                    todo.append((p, stack))
                    continue
                if not is_file:
                    continue
                stats.total_seen += 1
                if _always_skipped_name(name):
                    stats.skipped_extension += 1
                    continue
                if stack.is_ignored(p, is_dir=False):
                    stats.skipped_ignored += 1
                    continue
                try:
                    size = entry.stat(follow_symlinks=self.follow_symlinks).st_size
                except OSError:
                    continue
                if size == 0:
                    stats.skipped_empty += 1
                    continue
                lang = detect_language(p)
                if not lang.is_indexable():
                    stats.skipped_unknown_language += 1
                    continue
                if is_binary_file(p):
                    stats.skipped_binary += 1
                    continue
                stats.indexed += 1
                stats.note_language(lang)
                files.append(FileInfo(path=p, language=lang, size=size))
        files.sort(key=lambda f: f.path)
        return files, stats
