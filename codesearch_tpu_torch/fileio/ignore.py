"""Gitignore-style pattern matching (self-contained; no external deps).

Implements the gitignore semantics the walker needs (the reference delegates
to the ``ignore`` crate, src/file/mod.rs:89-199): per-directory ``.gitignore``
plus repo-level ``.codesearchignore`` / ``.osgrepignore`` overlays, with

- ``#`` comments and blank lines ignored,
- ``!`` negation (last match wins),
- leading/embedded ``/`` anchoring to the ignore file's directory,
- trailing ``/`` restricting a pattern to directories,
- ``*`` (no slash), ``?``, ``[...]`` and ``**`` globbing.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path


def _glob_to_regex(pat: str) -> str:
    """Translate one gitignore glob (already de-anchored) to a regex."""
    out: list[str] = []
    i, n = 0, len(pat)
    while i < n:
        c = pat[i]
        if c == "*":
            if pat[i : i + 2] == "**":
                # '**/' or '/**' or '**' — match across directories
                if pat[i : i + 3] == "**/":
                    out.append(r"(?:[^/]+/)*")
                    i += 3
                    continue
                out.append(r".*")
                i += 2
                continue
            out.append(r"[^/]*")
            i += 1
        elif c == "?":
            out.append(r"[^/]")
            i += 1
        elif c == "[":
            j = i + 1
            if j < n and pat[j] in "!^":
                j += 1
            if j < n and pat[j] == "]":
                j += 1
            while j < n and pat[j] != "]":
                j += 1
            if j < n:
                cls = pat[i + 1 : j]
                if cls.startswith("!"):
                    cls = "^" + cls[1:]
                out.append("[" + cls.replace("\\", "\\\\") + "]")
                i = j + 1
            else:
                out.append(re.escape(c))
                i += 1
        else:
            out.append(re.escape(c))
            i += 1
    return "".join(out)


@dataclass
class _Rule:
    regex: re.Pattern
    negated: bool
    dir_only: bool


def compile_rule(line: str) -> _Rule | None:
    line = line.rstrip("\n")
    if not line.strip() or line.lstrip().startswith("#"):
        return None
    negated = False
    if line.startswith("!"):
        negated = True
        line = line[1:]
    # trailing spaces are ignored unless escaped
    line = re.sub(r"(?<!\\) +$", "", line)
    if not line:
        return None
    dir_only = line.endswith("/")
    if dir_only:
        line = line.rstrip("/")
    anchored = line.startswith("/") or "/" in line[:-1] if line else False
    line = line.lstrip("/")
    body = _glob_to_regex(line)
    if anchored:
        pattern = rf"^{body}(/.*)?$"
    else:
        pattern = rf"(^|/){body}(/.*)?$" if not dir_only else rf"(^|/){body}(/.*)?$"
    try:
        rx = re.compile(pattern)
    except re.error:
        return None
    return _Rule(rx, negated, dir_only)


class IgnoreFile:
    """Rules from one ignore file, matched against paths relative to its dir."""

    def __init__(self, rules: list[_Rule]):
        self.rules = rules

    @classmethod
    def parse(cls, text: str) -> "IgnoreFile":
        rules = [r for line in text.splitlines() if (r := compile_rule(line))]
        return cls(rules)

    @classmethod
    def load(cls, path: Path) -> "IgnoreFile | None":
        try:
            return cls.parse(path.read_text(encoding="utf-8", errors="replace"))
        except OSError:
            return None

    def match(self, rel_path: str, is_dir: bool) -> bool | None:
        """Return True=ignored, False=whitelisted, None=no rule matched."""
        verdict: bool | None = None
        for rule in self.rules:
            if rule.dir_only and not is_dir:
                # dir-only patterns still ignore files *under* a matched dir;
                # that case is handled because parents are pruned first.
                continue
            if rule.regex.search(rel_path):
                verdict = not rule.negated
        return verdict


class IgnoreStack:
    """Stack of (base_dir, IgnoreFile) applied innermost-last (closest wins)."""

    def __init__(self) -> None:
        self._layers: list[tuple[Path, IgnoreFile]] = []

    def push(self, base: Path, f: IgnoreFile) -> None:
        self._layers.append((base, f))

    def pushed_copy(self, base: Path, f: IgnoreFile | None) -> "IgnoreStack":
        s = IgnoreStack()
        s._layers = list(self._layers)
        if f is not None:
            s.push(base, f)
        return s

    def is_ignored(self, path: Path, is_dir: bool) -> bool:
        verdict = False
        for base, f in self._layers:
            try:
                rel = path.relative_to(base).as_posix()
            except ValueError:
                continue
            m = f.match(rel, is_dir)
            if m is not None:
                verdict = m
        return verdict
