"""Native tier: ctypes bindings to cs_native.cpp (built on demand with g++).

Python fallbacks exist for every function; the native path is a drop-in
speedup for the host hot loops (masking, featurization) with byte-identical
output. Disable with CODESEARCH_NO_NATIVE=1. The source is a copy of the
JAX package's; the library builds under its own name, ``cs_native_torch.so``
in ``<config dir>/native``, so the two packages never rebuild each other's
file.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..utils.logger import get_logger

log = get_logger("native")

_SRC = Path(__file__).parent / "cs_native.cpp"
_FAMILY_IDS = {"c": 0, "cpp": 0, "csharp": 0, "java": 0,
               "rust": 1, "go": 2, "js": 3, "ts": 3, "python": 4}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build_dir() -> Path:
    from ..utils.constants import get_config_dir

    d = get_config_dir() / "native"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("CODESEARCH_NO_NATIVE"):
            return None
        try:
            so = _build_dir() / "cs_native_torch.so"
            if (not so.exists()
                    or so.stat().st_mtime < _SRC.stat().st_mtime):
                tmp = so.with_suffix(".so.tmp")
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     "-o", str(tmp), str(_SRC)],
                    check=True, capture_output=True, timeout=120,
                    stdin=subprocess.DEVNULL,
                )
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            lib.cs_mask.restype = ctypes.c_int32
            lib.cs_mask.argtypes = [ctypes.c_int32, ctypes.c_char_p,
                                    ctypes.c_long, ctypes.c_char_p]
            lib.cs_featurize.restype = ctypes.c_long
            lib.cs_featurize.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
                ctypes.c_long,
            ]
            lib.cs_token_hashes.restype = ctypes.c_long
            lib.cs_token_hashes.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
            ]
            lib.cs_featurize_batch.restype = ctypes.c_long
            lib.cs_featurize_batch.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                ctypes.c_long, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
                ctypes.c_long, ctypes.POINTER(ctypes.c_long),
            ]
            lib.cs_token_hashes_batch.restype = ctypes.c_long
            lib.cs_token_hashes_batch.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                ctypes.c_long, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_long, ctypes.POINTER(ctypes.c_long),
            ]
            lib.cs_scatter_runs.restype = ctypes.c_long
            lib.cs_scatter_runs.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_long, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_int16), ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
            ]
            _lib = lib
            log.info("native tier loaded: %s", so)
        except Exception as e:
            log.info("native tier unavailable (%s); using Python paths", e)
            _lib = None
        return _lib


def mask_native(family: str, src: str) -> str | None:
    lib = _load()
    if lib is None:
        return None
    fam = _FAMILY_IDS.get(family)
    if fam is None:
        return None
    raw = src.encode("utf-8", errors="surrogatepass")
    # byte-level masking requires char==byte positions only for the masked
    # copy; multi-byte chars are never masked delimiters, so decode is safe
    out = ctypes.create_string_buffer(len(raw))
    rc = lib.cs_mask(fam, raw, len(raw), out)
    if rc != 0:
        return None
    return out.raw.decode("utf-8", errors="surrogatepass")


def _featurize_impl(text: str) -> tuple[np.ndarray, np.ndarray] | None:
    lib = _load()
    if lib is None:
        return None
    from ..models.hash_embedder import VOCAB_BUCKETS

    raw = text.encode("utf-8", errors="replace")
    cap = 2 * len(raw) + 16
    ids = np.empty(cap, np.int64)
    ws = np.empty(cap, np.float64)
    n = lib.cs_featurize(
        raw, len(raw), VOCAB_BUCKETS,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ws.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cap,
    )
    if n < 0:
        return None
    return ids[:n].copy(), ws[:n].astype(np.float32)


def token_hashes_native(text: str, buckets: int = 0) -> np.ndarray | None:
    """Ordered token bucket ids (duplicates kept) for FTS tf counting."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode("utf-8", errors="replace")
    cap = len(raw) + 16
    ids = np.empty(cap, np.int64)
    n = lib.cs_token_hashes(
        raw, len(raw), buckets,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
    )
    if n < 0:
        return None
    return ids[:n].copy()


def featurize_batch_native(
    texts: list[str],
) -> list[tuple[np.ndarray, np.ndarray]] | None:
    """Featurize a slab of texts in ONE native call (byte-identical per-text
    results to featurize_native; amortizes ctypes marshaling)."""
    lib = _load()
    if lib is None:
        return None
    from ..models.hash_embedder import VOCAB_BUCKETS

    raws = [t.encode("utf-8", errors="replace") for t in texts]
    offs = np.zeros(len(raws) + 1, dtype=np.int64 if ctypes.sizeof(
        ctypes.c_long) == 8 else np.int32)
    total = 0
    for i, r in enumerate(raws):
        total += len(r)
        offs[i + 1] = total
    buf = b"".join(raws)
    cap = 2 * total + 16 * max(len(raws), 1)
    ids = np.empty(cap, np.int64)
    ws = np.empty(cap, np.float64)
    counts = np.zeros(len(raws), offs.dtype)
    n = lib.cs_featurize_batch(
        buf, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), len(raws),
        VOCAB_BUCKETS,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ws.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cap,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    if n < 0:
        return None
    out = []
    pos = 0
    for c in counts:
        c = int(c)
        out.append((ids[pos:pos + c].copy(), ws[pos:pos + c].astype(np.float32)))
        pos += c
    return out


def is_available() -> bool:
    return _load() is not None


# public: None when the library can't load (callers fall back to Python)
def featurize_native(text: str):
    return _featurize_impl(text)


if os.environ.get("CODESEARCH_NO_NATIVE"):
    featurize_native = None  # type: ignore[assignment]


def scatter_runs_native(
    pos: np.ndarray, counts: np.ndarray, cursor: np.ndarray,
    dnums: np.ndarray, tfc: np.ndarray, tfs: np.ndarray,
    out_d: np.ndarray, out_c: np.ndarray, out_s: np.ndarray,
) -> bool:
    """Copy one segment's term runs into the merged posting arrays at
    ``cursor[pos]`` (advancing ``cursor`` in place) — the hot inner loop
    of FtsStore._merge_segments as one native call instead of numpy's
    arange/repeat/fancy-index scatter. ``dnums`` must already match
    ``out_d``'s dtype; all arrays must be C-contiguous. Returns False
    (caller falls back to numpy) when the library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    i64 = ctypes.POINTER(ctypes.c_int64)
    i16 = ctypes.POINTER(ctypes.c_int16)
    n = lib.cs_scatter_runs(
        pos.ctypes.data_as(i64), counts.ctypes.data_as(i64), len(pos),
        cursor.ctypes.data_as(i64), out_d.dtype.itemsize,
        dnums.ctypes.data_as(ctypes.c_void_p),
        tfc.ctypes.data_as(i16), tfs.ctypes.data_as(i16),
        out_d.ctypes.data_as(ctypes.c_void_p),
        out_c.ctypes.data_as(i16), out_s.ctypes.data_as(i16),
    )
    return n >= 0


def token_hashes_batch_native(
    texts: list[str], buckets: int = 0,
) -> list[np.ndarray] | None:
    """Token bucket ids for a slab of texts in ONE native call — the FTS
    ingest analog of featurize_batch_native (byte-identical per-text
    results to token_hashes_native; amortizes ctypes marshaling)."""
    lib = _load()
    if lib is None:
        return None
    raws = [t.encode("utf-8", errors="replace") for t in texts]
    offs = np.zeros(len(raws) + 1, dtype=np.int64 if ctypes.sizeof(
        ctypes.c_long) == 8 else np.int32)
    total = 0
    for i, r in enumerate(raws):
        total += len(r)
        offs[i + 1] = total
    buf = b"".join(raws)
    cap = total + 16 * max(len(raws), 1)
    ids = np.empty(cap, np.int64)
    counts = np.zeros(len(raws), offs.dtype)
    n = lib.cs_token_hashes_batch(
        buf, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), len(raws),
        buckets,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cap,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    if n < 0:
        return None
    out = []
    pos = 0
    for c in counts:
        c = int(c)
        out.append(ids[pos:pos + c].copy())
        pos += c
    return out
