"""Binary file detection: extension blacklist + content heuristics.

Behavioral parity with the reference (src/file/binary.rs:12-97): known
binary extensions; then on the first 8KB — null bytes ⇒ binary; >30%
non-printable and invalid UTF-8 ⇒ binary; >80% non-printable even if valid
UTF-8 ⇒ binary.
"""

from __future__ import annotations

from pathlib import Path

_BINARY_EXTENSIONS = frozenset(
    [
        "exe", "dll", "so", "dylib", "a", "o", "lib", "bin",
        "zip", "tar", "gz", "bz2", "xz", "7z", "rar", "tgz",
        "png", "jpg", "jpeg", "gif", "bmp", "ico", "svg", "webp",
        "mp4", "avi", "mov", "wmv", "flv", "mkv", "webm",
        "mp3", "wav", "ogg", "flac", "aac", "wma",
        "pdf", "doc", "docx", "xls", "xlsx", "ppt", "pptx",
        "wasm", "pyc", "class", "jar", "war",
        "lock",
    ]
)

_SNIFF_BYTES = 8192


def is_binary_by_extension(path: str | Path) -> bool:
    p = Path(path)
    ext = p.suffix[1:].lower() if p.suffix else ""
    return ext in _BINARY_EXTENSIONS


def _is_printable_or_whitespace(b: int) -> bool:
    return b in (0x09, 0x0A, 0x0D) or 0x20 <= b < 0x7F


def is_binary_content(data: bytes) -> bool:
    """Heuristic binary check on a content prefix (typically first 8KB)."""
    if not data:
        return False
    if b"\x00" in data:
        return True
    non_printable = sum(1 for b in data if not _is_printable_or_whitespace(b))
    ratio = non_printable / len(data)
    if ratio > 0.30:
        try:
            data.decode("utf-8")
        except UnicodeDecodeError:
            return True
        if ratio > 0.80:
            return True
    return False


def is_binary_file(path: str | Path) -> bool:
    if is_binary_by_extension(path):
        return True
    try:
        with open(path, "rb") as f:
            return is_binary_content(f.read(_SNIFF_BYTES))
    except OSError:
        return False
