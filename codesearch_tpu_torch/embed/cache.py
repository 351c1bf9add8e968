"""Three-layer embedding cache.

Reference design (src/embed/cache.rs): (a) in-memory bytes-weighted LRU,
(b) persistent on-disk cache keyed by SHA-256 content hash shared across
branches, (c) query LRU. The persistent layer replaces LMDB with an
append-only fixed-record vector file + a msgpack hash index and atomic
index rewrites; eviction keeps the newest entries when over capacity
(reference evicts above 200k entries, cache.rs:374-434).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from pathlib import Path

import msgpack
import numpy as np

from ..utils.constants import (
    DEFAULT_CACHE_MAX_MEMORY_MB,
    DEFAULT_EMBEDDING_CACHE_MAX_ENTRIES,
    DEFAULT_QUERY_CACHE_MAX_MEMORY_MB,
)


class LruBytesCache:
    """Bytes-weighted LRU (reference: Moka cache, embed/cache.rs:17-129)."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._data: OrderedDict[str, np.ndarray] = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> np.ndarray | None:
        with self._lock:
            v = self._data.get(key)
            if v is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return v

    def put(self, key: str, value: np.ndarray) -> None:
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            if value.base is not None:
                # never cache a VIEW: a 1.5 KB row view pins its (multi-MB)
                # batch base array, so the bytes accounting undercounts by
                # orders of magnitude
                value = value.copy()
            self._data[key] = value
            self._bytes += value.nbytes
            while self._bytes > self.max_bytes and self._data:
                _, ev = self._data.popitem(last=False)
                self._bytes -= ev.nbytes

    def __len__(self) -> int:
        return len(self._data)

    @property
    def size_bytes(self) -> int:
        return self._bytes

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._bytes = 0


class PersistentEmbeddingCache:
    """On-disk hash → embedding store (replaces the LMDB cache).

    Layout in ``dir``:
      - ``vectors.f32`` — append-only fixed-size fp32 records
      - ``index.msgpack`` — {hash: row} snapshot, rewritten atomically
    """

    INDEX_FILE = "index.msgpack"
    VEC_FILE = "vectors.f32"
    LOCK_FILE = ".lock"

    def __init__(
        self,
        directory: Path,
        dims: int,
        max_entries: int | None = None,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.dims = dims
        self.max_entries = max_entries or DEFAULT_EMBEDDING_CACHE_MAX_ENTRIES
        self._lock = threading.Lock()
        self._index: dict[str, int] = {}
        self._rows = 0
        self._index_stat: tuple[int, int] | None = None  # (mtime_ns, size)
        self.hits = 0
        self.misses = 0
        self._load()

    def _file_lock(self, shared: bool = False):
        """Cross-process flock on the cache dir: the cache is SHARED between
        concurrent codesearch processes of the same model — without this, two
        writers append with independently computed row counters and their
        index offsets silently point at each other's vectors."""
        import contextlib
        import fcntl

        @contextlib.contextmanager
        def _ctx():
            fh = open(self.dir / self.LOCK_FILE, "w")
            try:
                fcntl.flock(fh, fcntl.LOCK_SH if shared else fcntl.LOCK_EX)
                yield
            finally:
                with contextlib.suppress(OSError):
                    fcntl.flock(fh, fcntl.LOCK_UN)
                fh.close()

        return _ctx()

    def _reload_if_changed(self) -> None:
        """Re-read the index snapshot when another process flushed one."""
        try:
            st = self._index_path.stat()
            cur = (st.st_mtime_ns, st.st_size)
        except OSError:
            cur = None
        if cur != self._index_stat:
            self._load()

    # -- files ---------------------------------------------------------------

    @property
    def _vec_path(self) -> Path:
        return self.dir / self.VEC_FILE

    @property
    def _index_path(self) -> Path:
        return self.dir / self.INDEX_FILE

    def _load(self) -> None:
        self._index = {}
        self._rows = 0
        self._index_stat = None
        if self._index_path.exists():
            try:
                st = self._index_path.stat()
                with open(self._index_path, "rb") as f:
                    raw = msgpack.unpack(f, raw=False)
                if raw.get("dims") == self.dims:
                    self._index = dict(raw.get("index", {}))
                    self._rows = int(raw.get("rows", 0))
                    self._index_stat = (st.st_mtime_ns, st.st_size)
                else:
                    # model dims changed → invalidate
                    self._vec_path.unlink(missing_ok=True)
            except Exception:
                self._index = {}
                self._rows = 0
        # sanity: file length must cover rows
        if self._vec_path.exists():
            have = self._vec_path.stat().st_size // (4 * self.dims)
            if have < self._rows:
                self._index = {h: r for h, r in self._index.items() if r < have}
                self._rows = have

    def _flush_index(self) -> None:
        tmp = self._index_path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            msgpack.pack(
                {"dims": self.dims, "rows": self._rows, "index": self._index}, f
            )
        os.replace(tmp, self._index_path)
        try:
            st = self._index_path.stat()
            self._index_stat = (st.st_mtime_ns, st.st_size)
        except OSError:
            self._index_stat = None

    # -- API -----------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._index)

    def get_batch(self, hashes: list[str]) -> dict[str, np.ndarray]:
        """Fetch any cached embeddings among ``hashes``.

        Holds a SHARED flock across (index freshness check + row reads) so a
        concurrent writer's evict/compact can't swap the vector file between
        our index lookup and the read."""
        with self._lock, self._file_lock(shared=True):
            self._reload_if_changed()
            wanted = [(h, self._index[h]) for h in hashes if h in self._index]
            if not wanted or not self._vec_path.exists():
                self.misses += len(hashes)
                return {}
            mm = np.memmap(self._vec_path, dtype=np.float32, mode="r").reshape(
                -1, self.dims
            )
            have = mm.shape[0]
            out = {h: np.array(mm[row]) for h, row in wanted if row < have}
            self.hits += len(out)
            self.misses += len(hashes) - len(out)
            return out

    def put_batch(self, items: dict[str, np.ndarray]) -> None:
        if not items:
            return
        with self._lock, self._file_lock():
            # under the exclusive lock: pick up any other writer's snapshot
            # and recompute the append base from the ACTUAL file size, so
            # concurrent processes never assign overlapping rows
            self._reload_if_changed()
            new = {h: v for h, v in items.items() if h not in self._index}
            if not new:
                return
            base = (
                self._vec_path.stat().st_size // (4 * self.dims)
                if self._vec_path.exists() else 0
            )
            block = np.stack([v.astype(np.float32) for v in new.values()])
            with open(self._vec_path, "ab") as f:
                block.tofile(f)
            for i, h in enumerate(new.keys()):
                self._index[h] = base + i
            self._rows = base + len(new)
            if len(self._index) > self.max_entries:
                self._evict_locked()
            self._flush_index()

    def _evict_locked(self) -> None:
        """Keep the newest max_entries rows; compact the vector file."""
        keep = sorted(self._index.items(), key=lambda kv: kv[1])[-self.max_entries:]
        mm = np.memmap(self._vec_path, dtype=np.float32, mode="r").reshape(
            -1, self.dims
        )
        rows = np.array([r for _, r in keep], dtype=np.int64)
        data = np.array(mm[rows])
        del mm
        tmp = self._vec_path.with_suffix(".tmp")
        data.tofile(tmp)
        os.replace(tmp, self._vec_path)
        self._index = {h: i for i, (h, _) in enumerate(keep)}
        self._rows = len(keep)

    def stats(self) -> dict:
        return {
            "entries": len(self._index),
            "disk_bytes": self._vec_path.stat().st_size if self._vec_path.exists() else 0,
            "hits": self.hits,
            "misses": self.misses,
        }

    def clear(self) -> None:
        with self._lock, self._file_lock():
            self._index = {}
            self._rows = 0
            self._vec_path.unlink(missing_ok=True)
            self._flush_index()


def default_memory_cache() -> LruBytesCache:
    return LruBytesCache(DEFAULT_CACHE_MAX_MEMORY_MB * 1024 * 1024)


def default_query_cache() -> LruBytesCache:
    return LruBytesCache(DEFAULT_QUERY_CACHE_MAX_MEMORY_MB * 1024 * 1024)
