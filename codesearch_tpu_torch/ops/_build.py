"""Build and load the port's CUDA kernels.

The sources under ``codesearch_tpu_torch/csrc/`` have a plain C interface.
At first use each is compiled with ``nvcc`` for ``sm_90a`` (one compiler
process per source, all started together), and the objects are linked into
one shared library under ``build/torch_kernels/`` (next to the package,
keyed by a hash of the sources, so an edited source rebuilds), which is
loaded with ``ctypes``. Nothing here runs at import time; a missing ``nvcc``
or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LLP = ctypes.POINTER(ctypes.c_longlong)
# argtypes of every entry point: pointers and the stream as c_void_p, ints
# as c_int (ctypes would otherwise pass a pointer as a 32-bit int)
_SIGNATURES = {
    "cs_cosine_topk_bf16": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "cs_cosine_topk_int8": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "cs_scores_topk": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "cs_attention_full": [_P, _P, _P, _P, _P, _LLP, _I, _I, _I, _I, _F, _P],
    "cs_attention_flash": [_P, _P, _P, _P, _P, _LLP, _I, _I, _I, _I, _F, _P],
    "cs_attention_packed": [_P, _P, _P, _P, _P, _LLP, _I, _I, _I, _I, _I, _F, _P],
    "cs_attention_window": [_P, _P, _P, _P, _P, _LLP, _I, _I, _I, _I, _I, _F, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log: dict = {}   # source hash, library path, seconds, compiler output


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(procs: list[tuple[str, subprocess.Popen]]) -> str:
    """Wait for every compiler process; raise on the first that failed."""
    output, failed = "", None
    for name, proc in procs:
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failed = failed or f"nvcc timed out on {name}"
        output += out
        if proc.returncode != 0:
            failed = failed or f"nvcc failed on {name} ({proc.returncode})"
    if failed:
        raise RuntimeError(f"{failed}:\n{output}")
    return output


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library of the same sources exists;
    returns its path. ``verbose`` adds ``-Xptxas -v`` (registers, shared
    memory and spills per kernel) to a fresh build's recorded output."""
    sources = _sources()
    digest = _source_hash(sources)
    out = BUILD_DIR / f"cs_kernels-{digest}.so"
    build_log.update(hash=digest, path=str(out), seconds=0.0, output="")
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    tag = f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in sources]
    t0 = time.perf_counter()
    output = _run([
        (src.name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
             "-c", "-o", str(obj), str(src)],
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
        for src, obj in zip(sources, objs)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    output += _run([("link", subprocess.Popen(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))])
    build_log.update(seconds=time.perf_counter() - t0, output=output)
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink(missing_ok=True)
    return out


def bind(path: Path) -> ctypes.CDLL:
    """Load a kernel library, declare its entry points' signatures and set
    the top-k kernels' shared-memory limits on the current CUDA device (once
    a library, not on every call)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cs_error_string.argtypes = [ctypes.c_int]
    lib.cs_error_string.restype = ctypes.c_char_p
    lib.cs_scratch_entries.argtypes = [_I, _I, _I, _I, _I]
    lib.cs_scratch_entries.restype = ctypes.c_longlong
    lib.cs_cosine_ctas_per_sm.argtypes = [_I, _I]
    lib.cs_cosine_ctas_per_sm.restype = ctypes.c_int
    lib.cs_topk_init.argtypes = []
    lib.cs_topk_init.restype = ctypes.c_int
    check(lib, lib.cs_topk_init(), "cs_topk_init")
    return lib


def load(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build(verbose))
        return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel entry point returned an error code."""
    if rc != 0:
        msg = lib.cs_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what} failed: {msg} (code {rc})")
