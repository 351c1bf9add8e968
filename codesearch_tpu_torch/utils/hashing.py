"""Content hashing helpers (SHA-256 hex, matching the reference's chunk/file hashing)."""

from __future__ import annotations

import hashlib
from pathlib import Path


def sha256_hex(data: str | bytes) -> str:
    if isinstance(data, str):
        data = data.encode("utf-8", errors="replace")
    return hashlib.sha256(data).hexdigest()


def sha256_file(path: Path, chunk_size: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk_size)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def stable_u64(s: str | bytes) -> int:
    """Deterministic 64-bit FNV-1a hash (for postings/vocab bucket ids).

    FNV-1a is implemented byte-identically in the native C++ tier
    (native/cs_native.cpp) so host featurization can run in either.
    """
    if isinstance(s, str):
        s = s.encode("utf-8", errors="replace")
    h = _FNV_OFFSET
    for b in s:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h
