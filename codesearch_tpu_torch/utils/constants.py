"""Central constants for codesearch_tpu configuration.

Behavioral parity with the reference's ``src/constants.rs`` (skip lists,
directory names, cache limits, debounce timings), re-expressed for the
TPU-native design: there is no LMDB map sizing — the analogous knobs are the
device-matrix capacity growth schedule and snapshot cadence.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

# ---------------------------------------------------------------------------
# Shutdown coordination (reference: constants.rs:17-33).
# The indexing pipeline is largely synchronous (host chunking + device embed
# batches); this event is checked between files and between device batches so
# CTRL-C is honored within a few seconds even during heavy work.
# ---------------------------------------------------------------------------
SHUTDOWN_REQUESTED = threading.Event()


def is_shutdown_requested() -> bool:
    return SHUTDOWN_REQUESTED.is_set()


def request_shutdown() -> None:
    SHUTDOWN_REQUESTED.set()


def reset_shutdown() -> None:
    SHUTDOWN_REQUESTED.clear()


# ---------------------------------------------------------------------------
# Directory / file names (reference: constants.rs:36-56, 88-127)
# ---------------------------------------------------------------------------
DB_DIR_NAME = ".codesearch.db"
CONFIG_DIR_NAME = ".codesearch"
FILE_META_DB_NAME = "file_meta.json"
METADATA_FILE_NAME = "metadata.json"
LOG_DIR_NAME = "logs"
LOG_FILE_NAME = "codesearch.log"
REPOS_CONFIG_FILE = "repos.json"
WRITER_LOCK_FILE = ".writer.lock"

# Vector store on-disk layout (replaces the reference's LMDB/arroy files)
VEC_EMBED_FILE = "embeddings.bin"       # raw row-major matrix, mmap-able
VEC_META_FILE = "chunkmeta.msgpack"     # chunk metadata sidecar
VEC_MANIFEST_FILE = "vectors.json"      # dtype/shape/tombstones manifest
FTS_DIR_NAME = "fts"

DEFAULT_LOG_MAX_FILES = 5
DEFAULT_LOG_RETENTION_DAYS = 5

IGNORE_FILE_NAMES = (".codesearchignore", ".osgrepignore")

# ---------------------------------------------------------------------------
# Cache limits (reference: constants.rs:104-120)
# ---------------------------------------------------------------------------
DEFAULT_EMBEDDING_CACHE_MAX_ENTRIES = int(
    os.environ.get("CODESEARCH_EMBEDDING_CACHE_MAX_ENTRIES", 200_000)
)
DEFAULT_CACHE_MAX_MEMORY_MB = int(os.environ.get("CODESEARCH_CACHE_MAX_MEMORY", 100))
DEFAULT_QUERY_CACHE_MAX_MEMORY_MB = 50

# File watcher debounce (reference: constants.rs:123)
DEFAULT_FSW_DEBOUNCE_MS = 2000
FSW_POLL_INTERVAL_MS = 100

# Device matrix capacity schedule: preallocate in row blocks so incremental
# inserts are dynamic_update_slice into an existing buffer, growing by
# doubling when full (analog of the reference's LMDB map auto-resize,
# vectordb/store.rs:252-328).
VEC_INITIAL_CAPACITY = int(os.environ.get("CODESEARCH_VEC_INITIAL_CAPACITY", 8192))
VEC_MAX_CAPACITY = int(os.environ.get("CODESEARCH_VEC_MAX_CAPACITY", 16_777_216))

# Tombstone ratio above which save() compacts into a fresh generation
# (matches the doctor's bloat threshold; below it, saves are O(change)
# appends — the analog of LMDB's incremental commit txns).
VEC_COMPACT_RATIO = float(os.environ.get("CODESEARCH_VEC_COMPACT_RATIO", 0.25))

# Below this many stored rows the hash-model read plane scores on HOST
# numpy instead of the fused device dispatch: tracing + loading the fused
# executable costs >1 s PER PROCESS (measured: 1.3 s even on all-cache-hit
# loads), while a [V,384]×[384,N] fp32 matmul at N≤8192 is single-digit ms
# on one core — one-shot CLI invocations and small-repo serving skip the
# device entirely. 0 disables the host path.
HOST_PATH_ROWS = int(os.environ.get("CODESEARCH_HOST_PATH_ROWS", 8192))

# ---------------------------------------------------------------------------
# Skip lists (reference: constants.rs:131-218)
# ---------------------------------------------------------------------------
ALWAYS_SKIP_EXTENSIONS = frozenset(
    [
        # Temporary / scratch files
        "tmp", "temp", "bak", "swp", "swo",
        # Source maps
        "map",
        # Lock files / manifest locks
        "lock", "sum",
        # Compiled / bytecode output
        "pyc", "pyo", "pyd", "class", "o", "obj", "a", "lib", "so", "dll",
        "exe", "pdb", "ilk",
        # Archives
        "zip", "tar", "gz", "bz2", "xz", "7z", "rar",
        # Images / media
        "png", "jpg", "jpeg", "gif", "bmp", "ico", "svg", "webp", "tiff",
        "mp3", "mp4", "wav", "ogg", "avi", "mov", "mkv",
        # Fonts
        "woff", "woff2", "ttf", "otf", "eot",
        # Database / binary data
        "db", "sqlite", "sqlite3", "mdb", "ldb",
        # Document formats
        "pdf", "doc", "docx", "xls", "xlsx", "ppt", "pptx",
        # Certificates / keys
        "pem", "crt", "cer", "key", "p12", "pfx",
        # Generated protobuf
        "pb",
    ]
)

ALWAYS_SKIP_FILENAME_SUFFIXES = (
    ".min.js", ".min.css", ".min.mjs",
    ".bundle.js", ".chunk.js", ".esm.js",
    ".d.ts", ".d.mts", ".d.cts",
    ".pb.go", ".pb.cc", ".pb.h", "_pb2.py",
    "_grpc.pb.go", "_grpc_pb.js",
    ".generated.ts", ".generated.graphql",
    ".snap",
    ".orig",
)

ALWAYS_EXCLUDED_DIRS = frozenset(
    [
        ".codesearch", ".codesearch.db", ".codesearch.dbs",
        "fastembed_cache",
        ".git", ".svn", ".hg",
        "node_modules", "target", "dist", "build", "out",
        "__pycache__", ".pytest_cache", ".tox", "venv", ".venv",
        "vendor", ".bundle",
        ".gradle", ".m2",
        ".idea", ".vscode", ".vs",
        "coverage", ".nyc_output", ".cache",
    ]
)


def get_config_dir() -> Path:
    """Global config dir (~/.codesearch), created on demand."""
    base = Path(os.environ.get("CODESEARCH_HOME", Path.home() / CONFIG_DIR_NAME))
    base.mkdir(parents=True, exist_ok=True)
    return base


def get_global_models_cache_dir() -> Path:
    """Shared model-weights cache (~/.codesearch/models)."""
    d = get_config_dir() / "models"
    d.mkdir(parents=True, exist_ok=True)
    return d


# Version of the host featurization/tokenization/index-format pipeline.
# Indexes from different versions are NOT comparable/loadable (v2: token
# hashing blake2b → FNV-1a; v3: FTS postings → columnar CSR npz; v4: native
# whole-identifier flag counts UTF-8 code points like Python, not bytes —
# weights change for indexes with non-ASCII identifiers); a mismatch forces
# full re-embedding, like the reference's model-change invalidation
# (cache/file_meta.rs:86-92). NOTE: the hash table's bf16 VALUES are part
# of this contract — make_table pins the historical threefry stream
# (a Philox regeneration was ablated and ranks worse; see its docstring).
EMBEDDER_VERSION = 4


def get_embedding_cache_dir(model_name: str) -> Path:
    """Persistent embedding cache root for one model (version-scoped)."""
    d = get_config_dir() / "embedding_cache" / f"{model_name}-v{EMBEDDER_VERSION}"
    d.mkdir(parents=True, exist_ok=True)
    return d
