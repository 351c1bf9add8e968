"""Device-resident vector store on torch (the port of
``codesearch_tpu/vectordb/store.py``).

The corpus is one preallocated ``[capacity, dims]`` tensor on ``device``
(bf16, or int8 with per-row scales) plus a validity mask, searched by one
exact fused matmul + top-k (kernels a and b on CUDA) — so ``build_index``
is O(1), insert is an in-place slab write, and delete clears validity
bits. Score = cosine similarity (reference's ``1 - distance``,
store.rs:478). There is no device mesh: the port runs on one device.

Host persistence has the same O(change) cost as the reference's
incremental write txns (store.rs:618-651): per generation, an append-only
fp16 row file plus an append-only msgpack op log (add/delete records), with
a tiny JSON manifest recording the valid byte prefix of both. ``save()``
appends only what changed and then atomically renames the manifest — one
rename flips the whole snapshot (a crash mid-append leaves extra bytes past
the manifest's prefix, which the loader ignores). Compaction (rewriting a
new generation without tombstones) runs only when the tombstone ratio
crosses ``VEC_COMPACT_RATIO``. The files are byte for byte those of the
JAX package, so either package opens the other's index.

Product-scale design (10M+ chunks on one host core, the analog of LMDB's
streamed reads, store.rs:183-250, 529-543):

- Chunk metadata is NEVER memory-resident in bulk. Each row keeps only a
  (byte offset, length) into the op log plus an interned path id, all in
  numpy columns (24 bytes/row); ``get_chunk`` is a lazy ``pread`` + msgpack
  decode through a small LRU. Unflushed rows live in a bounded pending map.
- Embedding rows live in the generation file, read back through a
  ``np.memmap`` (OS page cache decides residency); only the unspilled tail
  (≤ ``SPILL_ROWS``) is a host array. Inserts auto-spill to disk past the
  threshold WITHOUT flipping the manifest — crash-safe because the loader
  trusts only the manifest's prefixes.
- Open is sidecar-driven: a fixed-width ``rowidx`` file + packed validity
  bitmap + interned path table load with three vectorized reads — no
  msgpack replay (legacy v1/v2 layouts still replay once and migrate on
  the next save).
- cid→row lookup is a sorted numpy index + a bounded dict of recent
  appends — no 10M-entry Python dict.
- Full device uploads stream in ``UPLOAD_BLOCK``-row slabs written in
  place, so host RSS stays bounded by the slab (not the corpus).
"""

from __future__ import annotations

import io
import json
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path

import msgpack
import numpy as np
import torch

from ..ops.query_pipeline import (
    bert_embed_hybrid_search,
    bert_embed_hybrid_search_int8,
    bert_embed_search,
    bert_embed_search_int8,
    hash_embed_hybrid_search,
    hash_embed_hybrid_search_int8,
    hash_embed_search,
    hash_embed_search_int8,
)
from ..ops.topk import cosine_topk, cosine_topk_int8
from ..utils.device import resolve_device, to_host
from ..utils.constants import (
    HOST_PATH_ROWS,
    VEC_COMPACT_RATIO,
    VEC_EMBED_FILE,
    VEC_INITIAL_CAPACITY,
    VEC_MANIFEST_FILE,
    VEC_MAX_CAPACITY,
    VEC_META_FILE,
)
from ..utils.errors import DatabaseError
from ..utils.growbuf import GrowBuf
from ..utils.logger import get_logger
from . import device_ops

log = get_logger("vectordb")

# rows buffered in host RAM before auto-spilling to the generation files
SPILL_ROWS = int(os.environ.get("CODESEARCH_VEC_SPILL_ROWS", 65536))
# lazily-decoded ChunkMetadata LRU entries
META_LRU_ENTRIES = int(os.environ.get("CODESEARCH_VEC_META_LRU", 8192))
# host→device staging slab for full uploads / bulk incremental syncs
UPLOAD_BLOCK = 1 << 17
# recent-append cid→row dict entries before folding into the sorted index
EXTRAS_MAX = 1 << 18

# fixed-width sidecar record: one per row, appended in row order
ROWIDX_DTYPE = np.dtype(
    [("cid", "<i8"), ("off", "<i8"), ("len", "<i4"), ("pid", "<i4")]
)

_NOT_PORTED = "batched (wave) search paths are not ported yet (ROADMAP.md Queue 1)"


@dataclass
class ChunkMetadata:
    path: str
    content: str
    start_line: int
    end_line: int
    kind: str
    context: list[str] = field(default_factory=list)
    signature: str | None = None
    docstring: str | None = None
    hash: str = ""
    language: str | None = None

    def to_msgpack(self) -> dict:
        return self.__dict__

    @classmethod
    def from_msgpack(cls, d: dict) -> "ChunkMetadata":
        return cls(**d)


@dataclass
class SearchResult:
    chunk_id: int
    score: float
    metadata: ChunkMetadata


def _fsync_file(fh) -> None:
    fh.flush()
    os.fsync(fh.fileno())


def _fsync_dir(path: Path) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


class VectorStore:
    """Single-device store; ``device`` as for ``resolve_device``."""

    def __init__(
        self,
        db_path: str | Path,
        dims: int,
        readonly: bool = False,
        int8: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        self.db_path = Path(db_path)
        self.dims = dims
        self.readonly = readonly
        self.int8 = int8
        # small-corpus host fast path threshold (instance knob for tests)
        self.host_path_rows = HOST_PATH_ROWS
        self._lock = threading.RLock()

        # row-indexed numpy columns (never Python dicts at corpus scale)
        self._cids = GrowBuf(np.int64)     # row → chunk id
        self._m_off = GrowBuf(np.int64)    # row → log byte offset (-1: pending)
        self._m_len = GrowBuf(np.int32)    # row → log record length
        self._m_path = GrowBuf(np.int32)   # row → interned path id
        self._valid = GrowBuf(bool)        # row → liveness
        self._path_vocab: dict[str, int] = {}
        self._path_names: list[str] = []
        self._next_id = 0
        self._max_cid = -1

        # cid → row lookup: sorted base index + bounded recent-append dict
        self._sorted_cids: np.ndarray | None = None
        self._sorted_rows: np.ndarray | None = None
        self._extras: dict[int, int] = {}

        # lazy metadata: pending (unflushed) rows + decoded LRU
        self._pending_meta: dict[int, ChunkMetadata] = {}
        self._meta_lru: OrderedDict[int, ChunkMetadata] = OrderedDict()

        # embedding rows: memmap'd generation file + bounded host tail
        self._tail = np.zeros((0, dims), np.float16)
        self._tail_rows = 0
        self._file_rows = 0                # f16 rows physically in the file
        self._rows = 0                     # total rows (file + tail)
        self._mm_arr: np.ndarray | None = None
        self._mm_covers: tuple | None = None
        self._log_fd_cache: tuple[int, int] | None = None   # (gen, fd)

        # persistence cursors: manifest-covered vs physically-written
        self._generation = 0
        self._valid_seq = 0                # bitmap sequence (manifest-selected)
        self._persisted_rows = 0           # manifest rows
        self._file_log_bytes = 0           # bytes physically in the log
        self._persisted_log_bytes = 0      # manifest log bytes
        self._idx_rows = 0                 # rows covered by rowidx sidecar
        self._file_paths = 0               # path names in the paths sidecar
        self._paths_bytes = 0              # committed byte prefix of paths file
        self._pending_log: list[tuple[bytes, int | None]] = []  # (rec, row)
        self._needs_rewrite = False

        # device state: matrix + validity mask kept in sync incrementally
        self._device = None                # (kind, mat, scale, valid)
        self._dev_rows = 0
        self._dev_pending_del: list[int] = []
        self.full_uploads = 0              # diagnostics (tests assert
        self.incremental_updates = 0       # no full re-upload per edit)
        # monotone content-change counter: any insert/delete/clear bumps it,
        # so higher layers (response caches) can key on store freshness
        self.mutation_count = 0
        self._n_valid_cache: tuple[int, int] = (-1, 0)

        if self.db_path.exists():
            self._load()
            self._cleanup_stale_files()
        else:
            if readonly:
                raise DatabaseError(f"database not found: {self.db_path}")
            self.db_path.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------
    # row / path helpers
    # ------------------------------------------------------------------

    def _used_valid(self) -> np.ndarray:
        return self._valid.view()

    def _n_valid(self) -> int:
        """Live-row count, memoized on ``mutation_count``: every query needs
        it, and the O(rows) bool reduction is several ms of single-core host
        time at 10M slots if recomputed per search. All liveness mutations
        ride insert/delete/clear (which bump the counter); compaction keeps
        the live count unchanged."""
        mc, nv = self._n_valid_cache
        if mc != self.mutation_count:
            nv = int(self._valid.view().sum())
            self._n_valid_cache = (self.mutation_count, nv)
        return nv

    def _path_id(self, path: str) -> int:
        pid = self._path_vocab.get(path)
        if pid is None:
            pid = len(self._path_names)
            self._path_vocab[path] = pid
            self._path_names.append(path)
        return pid

    def _rebuild_sorted(self) -> None:
        cids = self._cids.view()
        order = np.argsort(cids, kind="stable").astype(np.int64)
        self._sorted_cids = cids[order].copy()
        self._sorted_rows = order
        self._extras = {}

    def _current_row(self, cid: int) -> int | None:
        """The (single) valid row holding this chunk id, else None."""
        if cid > self._max_cid:
            return None
        row = self._extras.get(cid)
        if row is not None:
            return row if self._valid.a[row] else None
        if self._sorted_cids is None:
            self._rebuild_sorted()
        i = int(np.searchsorted(self._sorted_cids, cid))
        valid = self._valid.view()
        while i < len(self._sorted_cids) and self._sorted_cids[i] == cid:
            r = int(self._sorted_rows[i])
            if r < len(valid) and valid[r]:
                return r
            i += 1
        return None

    def _note_append(self, cid: int, row: int) -> None:
        self._extras[cid] = row
        if cid > self._max_cid:
            self._max_cid = cid
        if len(self._extras) > EXTRAS_MAX:
            # defer the argsort to the next LOOKUP: fresh-id indexing never
            # looks rows up (the cid > _max_cid fast path short-circuits),
            # so a 10M-row run skips ~40 eager full-column argsorts
            self._sorted_cids = None
            self._sorted_rows = None
            self._extras = {}

    # ------------------------------------------------------------------
    # embedding row access (memmap + tail)
    # ------------------------------------------------------------------

    def _mm(self) -> np.ndarray:
        key = (self._generation, self._file_rows)
        if self._mm_arr is None or self._mm_covers != key:
            p = self._embed_path(self._generation)
            if self._file_rows and p.exists():
                self._mm_arr = np.memmap(
                    p, np.float16, mode="r",
                    shape=(self._file_rows, self.dims),
                )
            else:
                self._mm_arr = np.zeros((0, self.dims), np.float16)
            self._mm_covers = key
        return self._mm_arr

    def _rows_range(self, a: int, b: int) -> np.ndarray:
        """Rows [a, b) as float32, stitched from the memmap'd file and the
        in-memory tail. O(b - a) — never materializes the whole corpus."""
        parts = []
        if a < self._file_rows:
            hi = min(b, self._file_rows)
            parts.append(np.asarray(self._mm()[a:hi]))
        if b > self._file_rows:
            ta = max(a - self._file_rows, 0)
            tb = b - self._file_rows
            parts.append(self._tail[ta:tb])
        if not parts:
            return np.zeros((0, self.dims), np.float32)
        if len(parts) == 1:
            return parts[0].astype(np.float32)
        return np.concatenate(parts).astype(np.float32)

    def _read_rows_io(self, a: int, b: int) -> np.ndarray:
        """Rows [a, b) as float32 via plain file reads (NOT the memmap):
        bulk passes (full device uploads) would otherwise leave every
        touched mmap page resident in this process's RSS; read() transients
        free immediately and only populate the (reclaimable) page cache."""
        parts = []
        if a < self._file_rows:
            hi = min(b, self._file_rows)
            try:
                with open(self._embed_path(self._generation), "rb") as f:
                    f.seek(a * self.dims * 2)
                    flat = np.fromfile(f, np.float16, (hi - a) * self.dims)
                if flat.size == (hi - a) * self.dims:
                    parts.append(flat.reshape(hi - a, self.dims))
                else:
                    parts.append(np.asarray(self._mm()[a:hi]))
            except OSError:
                parts.append(np.asarray(self._mm()[a:hi]))
        if b > self._file_rows:
            ta = max(a - self._file_rows, 0)
            tb = b - self._file_rows
            parts.append(self._tail[ta:tb])
        if not parts:
            return np.zeros((0, self.dims), np.float32)
        if len(parts) == 1:
            return parts[0].astype(np.float32)
        return np.concatenate(parts).astype(np.float32)

    def _tail_append(self, rows_f16: np.ndarray) -> None:
        need = self._tail_rows + len(rows_f16)
        if need > len(self._tail):
            cap = max(need, 2 * len(self._tail), 1024)
            grown = np.zeros((cap, self.dims), np.float16)
            grown[: self._tail_rows] = self._tail[: self._tail_rows]
            self._tail = grown
        self._tail[self._tail_rows : need] = rows_f16
        self._tail_rows = need

    # ------------------------------------------------------------------
    # lazy metadata
    # ------------------------------------------------------------------

    def _log_fd(self) -> int:
        if self._log_fd_cache is None or self._log_fd_cache[0] != self._generation:
            if self._log_fd_cache is not None:
                try:
                    os.close(self._log_fd_cache[1])
                except OSError:
                    pass
            fd = os.open(self._log_path(self._generation), os.O_RDONLY)
            self._log_fd_cache = (self._generation, fd)
        return self._log_fd_cache[1]

    def _fetch_meta(self, row: int) -> ChunkMetadata | None:
        """Metadata for a row: pending map → LRU → pread from the op log."""
        m = self._pending_meta.get(row)
        if m is not None:
            return m
        m = self._meta_lru.get(row)
        if m is not None:
            self._meta_lru.move_to_end(row)
            return m
        off = int(self._m_off.a[row])
        ln = int(self._m_len.a[row])
        if off < 0 or ln <= 0:
            return None
        try:
            raw = os.pread(self._log_fd(), ln, off)
            rec = msgpack.unpackb(raw, raw=False, strict_map_key=False)
            m = ChunkMetadata.from_msgpack(rec[2])
        except Exception as e:
            log.warning("corrupt chunk record at row %d: %s", row, e)
            return None
        self._meta_lru[row] = m
        while len(self._meta_lru) > META_LRU_ENTRIES:
            self._meta_lru.popitem(last=False)
        return m

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    @property
    def _manifest_path(self) -> Path:
        return self.db_path / VEC_MANIFEST_FILE

    def _embed_path(self, gen: int) -> Path:
        return self.db_path / f"embeddings.{gen}.bin"

    def _log_path(self, gen: int) -> Path:
        return self.db_path / f"chunkmeta.{gen}.log"

    def _rowidx_path(self, gen: int) -> Path:
        return self.db_path / f"rowidx.{gen}.bin"

    def _paths_path(self, gen: int) -> Path:
        return self.db_path / f"paths.{gen}.txt"

    def _valid_path(self, gen: int, seq: int | None = None) -> Path:
        # sequence-stamped: each save writes a FRESH bitmap file and the
        # manifest rename selects it — one atomic commit point (overwriting
        # valid.<gen>.bin in place would commit kills of replaced rows
        # before the manifest commits their replacement rows)
        if seq is None:
            seq = self._valid_seq
        return self.db_path / f"valid.{gen}.{seq}.bin"

    def _cleanup_stale_files(self) -> None:
        """Remove atomic-write temp files and data files from generations no
        longer referenced by the manifest (crashed saves/compactions — the
        analog of the reference's stale .del cleanup, store.rs:799-824)."""
        if self.readonly:
            return
        gen = self._generation
        keep = {
            self._embed_path(gen).name, self._log_path(gen).name,
            self._rowidx_path(gen).name, self._paths_path(gen).name,
            self._valid_path(gen).name,
            self._valid_path(gen, self._valid_seq - 1).name,  # concurrent readers
            f"valid.{gen}.bin",   # pre-stamp layout until the next save
        }
        pats = ("*.tmp*", "embeddings.*.bin", "chunkmeta.*.log",
                "rowidx.*.bin", "paths.*.txt", "valid.*.bin")
        for pat in pats:
            for p in self.db_path.glob(pat):
                if p.name in keep:
                    continue
                try:
                    p.unlink()
                except OSError:
                    pass

    @staticmethod
    def _pack_add(cid: int, meta: ChunkMetadata) -> bytes:
        return msgpack.packb(("a", cid, meta.to_msgpack()), use_bin_type=True)

    @staticmethod
    def _pack_del(cid: int) -> bytes:
        return msgpack.packb(("d", cid), use_bin_type=True)

    def _load(self) -> None:
        if not self._manifest_path.exists():
            return
        try:
            manifest = json.loads(self._manifest_path.read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise DatabaseError(f"corrupt manifest at {self._manifest_path}: {e}")
        if manifest.get("dims") != self.dims:
            raise DatabaseError(
                f"dimension mismatch: store has {manifest.get('dims')}, "
                f"requested {self.dims}"
            )
        version = manifest.get("version", 1)
        if version < 2:
            self._load_v1(manifest)
            return
        self._next_id = int(manifest.get("next_id", 0))
        self._generation = int(manifest.get("generation", 0))
        self._valid_seq = int(manifest.get("valid_seq", 0))
        self._paths_bytes = int(manifest.get("paths_bytes", 0))
        rows = int(manifest.get("rows", 0))
        log_bytes = int(manifest.get("log_bytes", 0))

        ep = self._embed_path(self._generation)
        if rows and ep.exists():
            have = ep.stat().st_size // (self.dims * 2)
            rows = min(rows, have)
        else:
            rows = 0
        lp = self._log_path(self._generation)
        if version >= 3 and self._load_v3_sidecars(manifest, rows):
            pass
        else:
            # v2 layout (or damaged sidecars): one-time op-log replay;
            # sidecars get written on the next save
            self._replay_log(lp, log_bytes, rows)
        self._file_rows = rows
        self._rows = rows
        self._persisted_rows = rows
        self._file_log_bytes = min(
            log_bytes, lp.stat().st_size if lp.exists() else 0
        )
        self._persisted_log_bytes = self._file_log_bytes
        if self._cids.n:
            self._max_cid = int(self._cids.view().max())

    def _load_v3_sidecars(self, manifest: dict, rows: int) -> bool:
        """Vectorized open: rowidx + validity bitmap + path table. Returns
        False (→ log replay) when any sidecar is missing or short."""
        gen = self._generation
        n_paths = int(manifest.get("n_paths", 0))
        try:
            idx = np.fromfile(self._rowidx_path(gen), ROWIDX_DTYPE, count=rows) \
                if rows else np.zeros(0, ROWIDX_DTYPE)
            if len(idx) < rows:
                return False
            vp = self._valid_path(gen)
            if not vp.exists():
                vp = self.db_path / f"valid.{gen}.bin"   # pre-stamp layout
            vbits = np.fromfile(vp, np.uint8)
            valid = np.unpackbits(vbits)[:rows].astype(bool)
            if len(valid) < rows:
                return False
            names: list[str] = []
            if n_paths:
                with open(self._paths_path(gen), "rb") as f:
                    raw_paths = f.read(self._paths_bytes) if self._paths_bytes \
                        else f.read()
                for line in raw_paths.decode("utf-8").splitlines():
                    names.append(json.loads(line))
                    if len(names) >= n_paths:
                        break
            if len(names) < n_paths:
                return False
            if not self._paths_bytes and n_paths:
                self._paths_bytes = self._paths_path(gen).stat().st_size
        except (OSError, ValueError, json.JSONDecodeError):
            return False
        self._cids.extend(idx["cid"].astype(np.int64))
        self._m_off.extend(idx["off"].astype(np.int64))
        self._m_len.extend(idx["len"].astype(np.int32))
        self._m_path.extend(idx["pid"].astype(np.int32))
        self._valid.extend(valid)
        self._path_names = names
        self._path_vocab = {p: i for i, p in enumerate(names)}
        self._idx_rows = rows
        self._file_paths = len(names)
        return True

    def _replay_log(self, lp: Path, log_bytes: int, max_rows: int) -> None:
        """Legacy/recovery open: rebuild the row columns (offsets included)
        from the op log prefix. Add records map 1:1, in order, onto rows of
        the embedding file. Metadata content is NOT retained — only the
        record's (offset, length)."""
        if not (log_bytes and lp.exists()):
            self._valid.extend(np.zeros(max_rows, bool))
            self._cids.extend(np.zeros(max_rows, np.int64))
            self._m_off.extend(np.full(max_rows, -1, np.int64))
            self._m_len.extend(np.zeros(max_rows, np.int32))
            self._m_path.extend(np.zeros(max_rows, np.int32))
            return
        with open(lp, "rb") as f:
            raw = f.read(log_bytes)
        unpacker = msgpack.Unpacker(io.BytesIO(raw), raw=False,
                                    strict_map_key=False)
        pos = 0
        row = 0
        for rec in unpacker:
            end = unpacker.tell()
            if rec[0] == "a":
                if row >= max_rows:
                    break  # add records past the usable matrix prefix
                cid = int(rec[1])
                old = self._current_row(cid)
                if old is not None:
                    self._valid.a[old] = False
                d = rec[2]
                self._cids.append(cid)
                self._m_off.append(pos)
                self._m_len.append(end - pos)
                self._m_path.append(self._path_id(d.get("path", "")))
                self._valid.append(True)
                self._note_append(cid, row)
                row += 1
            else:
                cid = int(rec[1])
                old = self._current_row(cid)
                if old is not None:
                    self._valid.a[old] = False
            pos = end
        # rows in the embed file with no surviving log record (shouldn't
        # happen, but keep the columns row-aligned)
        while row < max_rows:
            self._cids.append(0)
            self._m_off.append(-1)
            self._m_len.append(0)
            self._m_path.append(0)
            self._valid.append(False)
            row += 1

    def _load_v1(self, manifest: dict) -> None:
        """Legacy round-1 layout (monolithic rewrite-on-save files); migrated
        to the generational layout on the next save. Rows load into the tail
        (v1 dbs are small) so the migration compaction can stream them."""
        rows = int(manifest.get("rows", 0))
        self._next_id = int(manifest.get("next_id", 0))
        ep = self.db_path / VEC_EMBED_FILE
        data = np.zeros((0, self.dims), np.float16)
        if rows and ep.exists():
            flat = np.fromfile(ep, dtype=np.float16)
            have = flat.size // self.dims
            rows = min(rows, have)
            data = flat[: rows * self.dims].reshape(rows, self.dims)
        else:
            rows = 0
        id_of = [int(i) for i in manifest.get("row_ids", [])][:rows]
        metas: dict[int, ChunkMetadata] = {}
        mp = self.db_path / VEC_META_FILE
        if mp.exists():
            with open(mp, "rb") as f:
                raw = msgpack.unpack(f, raw=False, strict_map_key=False)
            metas = {int(k): ChunkMetadata.from_msgpack(v) for k, v in raw.items()}
        self._tail_append(data[: len(id_of)])
        for row, cid in enumerate(id_of):
            meta = metas.get(cid)
            self._cids.append(cid)
            self._m_off.append(-1)
            self._m_len.append(0)
            self._m_path.append(self._path_id(meta.path if meta else ""))
            self._valid.append(meta is not None)
            if meta is not None:
                self._pending_meta[row] = meta
                self._pending_log.append((self._pack_add(cid, meta), row))
                self._note_append(cid, row)
        self._rows = len(id_of)
        self._needs_rewrite = True

    def save(self) -> None:
        """Persist. O(change) append + manifest flip normally; a full
        compacting generation rewrite only when the tombstone ratio crosses
        ``VEC_COMPACT_RATIO`` (or after clear/migration)."""
        if self.readonly:
            return
        with self._lock:
            nv = int(self._used_valid().sum()) if self._rows else 0
            tomb = self._rows - nv
            if (
                self._needs_rewrite
                or (self._rows and tomb / self._rows > VEC_COMPACT_RATIO)
                or (not self._embed_path(self._generation).exists()
                    and self._file_rows > 0)
            ):
                self._save_rewrite()
            else:
                self._save_append()

    def _write_manifest(self, rows: int, log_bytes: int) -> None:
        manifest = {
            "version": 3,
            "dims": self.dims,
            "dtype": "float16",
            "generation": self._generation,
            "rows": rows,
            "log_bytes": log_bytes,
            "next_id": self._next_id,
            "n_paths": len(self._path_names),
            "valid_seq": self._valid_seq,
            "paths_bytes": self._paths_bytes,
        }
        tmpj = self._manifest_path.with_suffix(".tmpj")
        with open(tmpj, "w") as f:
            f.write(json.dumps(manifest))
            _fsync_file(f)
        os.replace(tmpj, self._manifest_path)
        _fsync_dir(self.db_path)

    def _spill(self, fsync: bool = False) -> None:
        """Flush the host tail + pending log records to the generation
        files WITHOUT flipping the manifest. Bounded host RAM during bulk
        indexing; invisible to readers until save() commits the prefix."""
        if self.readonly:
            return
        gen = self._generation
        if self._tail_rows:
            self.db_path.mkdir(parents=True, exist_ok=True)
            ep = self._embed_path(gen)
            mode = "r+b" if ep.exists() else "wb"
            with open(ep, mode) as f:
                f.seek(self._file_rows * self.dims * 2)
                self._tail[: self._tail_rows].tofile(f)
                if fsync:
                    _fsync_file(f)
            self._file_rows += self._tail_rows
            self._tail_rows = 0
            self._mm_covers = None
        if self._pending_log:
            self.db_path.mkdir(parents=True, exist_ok=True)
            lp = self._log_path(gen)
            mode = "r+b" if lp.exists() else "wb"
            with open(lp, mode) as f:
                f.seek(self._file_log_bytes)
                off = self._file_log_bytes
                for rec, row in self._pending_log:
                    f.write(rec)
                    if row is not None:
                        self._m_off.a[row] = off
                        self._m_len.a[row] = len(rec)
                    off += len(rec)
                if fsync:
                    _fsync_file(f)
            self._file_log_bytes = off
            self._pending_log = []
            self._pending_meta.clear()
        # sidecar appends stay in lockstep with the data files
        if self._file_rows > self._idx_rows:
            lo, hi = self._idx_rows, self._file_rows
            arr = np.empty(hi - lo, ROWIDX_DTYPE)
            arr["cid"] = self._cids.view()[lo:hi]
            arr["off"] = self._m_off.view()[lo:hi]
            arr["len"] = self._m_len.view()[lo:hi]
            arr["pid"] = self._m_path.view()[lo:hi]
            ip = self._rowidx_path(gen)
            mode = "r+b" if ip.exists() else "wb"
            with open(ip, mode) as f:
                f.seek(lo * ROWIDX_DTYPE.itemsize)
                arr.tofile(f)
                if fsync:
                    _fsync_file(f)
            self._idx_rows = hi
        if len(self._path_names) > self._file_paths:
            # seek to the committed byte prefix so a crashed append's stale
            # tail is overwritten, never appended after (line→id mapping)
            pp = self._paths_path(gen)
            mode = "r+b" if pp.exists() and self._paths_bytes else "wb"
            with open(pp, mode) as f:
                f.seek(self._paths_bytes)
                for p in self._path_names[self._file_paths:]:
                    f.write((json.dumps(p) + "\n").encode("utf-8"))
                f.truncate()
                if fsync:
                    _fsync_file(f)
                self._paths_bytes = f.tell()
            self._file_paths = len(self._path_names)

    def _write_valid_bitmap(self, gen: int) -> None:
        self._valid_seq += 1
        vb = np.packbits(self._valid.view())
        tmp = self._valid_path(gen).with_suffix(".tmpv")
        with open(tmp, "wb") as f:
            vb.tofile(f)
            _fsync_file(f)
        os.replace(tmp, self._valid_path(gen))

    def _save_append(self) -> None:
        self._spill(fsync=True)
        self._write_valid_bitmap(self._generation)
        self._persisted_rows = self._file_rows
        self._persisted_log_bytes = self._file_log_bytes
        self._write_manifest(self._persisted_rows, self._persisted_log_bytes)
        # manifest flipped — superseded bitmaps are garbage, EXCEPT the
        # immediately previous sequence (a concurrent reader holding the
        # prior manifest must still find the bitmap it references)
        keep = {self._valid_path(self._generation).name,
                self._valid_path(self._generation, self._valid_seq - 1).name}
        for q in self.db_path.glob(f"valid.{self._generation}.*"):
            if q.name not in keep:
                try:
                    q.unlink()
                except OSError:
                    pass

    def _save_rewrite(self) -> None:
        """Compact into a fresh generation, streaming in UPLOAD_BLOCK-row
        slabs (host RAM stays bounded at 10M rows); the manifest rename is
        the single atomic commit point, after which stale generations are
        deleted."""
        self._spill(fsync=False)
        old_gen = self._generation
        gen = old_gen + 1
        keep = np.nonzero(self._used_valid())[0]
        n_keep = len(keep)
        # 1. embeddings: gather kept rows slab by slab
        with open(self._embed_path(gen), "wb") as f:
            mm = self._mm()
            for b in range(0, n_keep, UPLOAD_BLOCK):
                sel = keep[b : b + UPLOAD_BLOCK]
                np.asarray(mm[sel]).tofile(f)
            _fsync_file(f)
        # 2. metadata: copy raw log records verbatim (no msgpack decode)
        new_off = np.zeros(n_keep, np.int64)
        new_len = np.zeros(n_keep, np.int32)
        off = 0
        old_fd = self._log_fd() if self._file_log_bytes else None
        with open(self._log_path(gen), "wb") as f:
            for i, row in enumerate(keep):
                row = int(row)
                o, ln = int(self._m_off.a[row]), int(self._m_len.a[row])
                if o >= 0 and ln > 0 and old_fd is not None:
                    rec = os.pread(old_fd, ln, o)
                else:
                    m = self._pending_meta.get(row) or self._fetch_meta(row)
                    rec = self._pack_add(int(self._cids.a[row]), m) if m else b""
                f.write(rec)
                new_off[i] = off
                new_len[i] = len(rec)
                off += len(rec)
            _fsync_file(f)
        # 3. rebuild the row columns for the compacted layout
        new_cids = self._cids.view()[keep].copy()
        new_pid = self._m_path.view()[keep].copy()
        self._cids = GrowBuf(np.int64)
        self._m_off = GrowBuf(np.int64)
        self._m_len = GrowBuf(np.int32)
        self._m_path = GrowBuf(np.int32)
        self._valid = GrowBuf(bool)
        self._cids.extend(new_cids)
        self._m_off.extend(new_off)
        self._m_len.extend(new_len)
        self._m_path.extend(new_pid)
        self._valid.extend(np.ones(n_keep, bool))
        self._sorted_cids = None
        self._extras = {}
        self._pending_meta.clear()
        self._pending_log = []
        self._meta_lru.clear()
        self._tail_rows = 0
        self._generation = gen
        self._file_rows = n_keep
        self._rows = n_keep
        self._file_log_bytes = off
        self._persisted_rows = n_keep
        self._persisted_log_bytes = off
        self._mm_covers = None
        self._needs_rewrite = False
        # 4. sidecars for the new generation
        arr = np.empty(n_keep, ROWIDX_DTYPE)
        arr["cid"] = new_cids
        arr["off"] = new_off
        arr["len"] = new_len
        arr["pid"] = new_pid
        with open(self._rowidx_path(gen), "wb") as f:
            arr.tofile(f)
            _fsync_file(f)
        with open(self._paths_path(gen), "w", encoding="utf-8") as f:
            for p in self._path_names:
                f.write(json.dumps(p) + "\n")
            _fsync_file(f)
        self._paths_bytes = self._paths_path(gen).stat().st_size
        self._idx_rows = n_keep
        self._file_paths = len(self._path_names)
        self._write_valid_bitmap(gen)
        self._write_manifest(n_keep, off)
        # 5. rows renumbered → device matrix re-uploads on next use
        self._device = None
        self._dev_rows = 0
        self._dev_pending_del = []
        stale = [
            self._embed_path(old_gen), self._log_path(old_gen),
            self._rowidx_path(old_gen), self._paths_path(old_gen),
            self.db_path / VEC_EMBED_FILE, self.db_path / VEC_META_FILE,
        ] + list(self.db_path.glob(f"valid.{old_gen}.*"))
        for p in stale:
            try:
                p.unlink()
            except OSError:
                pass

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------

    def next_id(self) -> int:
        return self._next_id

    def insert_chunks_with_ids(
        self,
        embeddings: np.ndarray,          # [n, dims] (normalized)
        metadatas: list[ChunkMetadata],
        ids: list[int] | None = None,
    ) -> list[int]:
        if self.readonly:
            raise DatabaseError("store opened readonly")
        n = embeddings.shape[0]
        if n != len(metadatas):
            raise ValueError("embeddings/metadata length mismatch")
        if n == 0:
            return []
        if embeddings.shape[1] != self.dims:
            raise DatabaseError(
                f"dimension mismatch: got {embeddings.shape[1]}, store is {self.dims}"
            )
        with self._lock:
            if ids is None:
                ids = list(range(self._next_id, self._next_id + n))
            self._next_id = max(self._next_id, max(ids) + 1)
            # replace semantics: tombstone any existing row for these ids
            for cid in ids:
                row = self._current_row(cid)
                if row is not None:
                    self._valid.a[row] = False
                    self._dev_pending_del.append(row)
            base = self._rows
            if base + n > VEC_MAX_CAPACITY:
                raise DatabaseError("vector store at max capacity")
            self._tail_append(embeddings.astype(np.float16))
            self._valid.extend(np.ones(n, bool))
            self._cids.extend(np.asarray(ids, np.int64))
            self._m_off.extend(np.full(n, -1, np.int64))
            self._m_len.extend(np.zeros(n, np.int32))
            for i, (cid, meta) in enumerate(zip(ids, metadatas)):
                row = base + i
                self._m_path.append(self._path_id(meta.path))
                self._pending_meta[row] = meta
                self._pending_log.append((self._pack_add(cid, meta), row))
                self._note_append(cid, row)
            self._rows = base + n
            self.mutation_count += 1
            if self._tail_rows >= SPILL_ROWS or len(self._pending_log) >= SPILL_ROWS:
                self._spill()
            return ids

    def delete_chunks(self, ids: list[int]) -> int:
        if self.readonly:
            raise DatabaseError("store opened readonly")
        removed = 0
        with self._lock:
            for cid in ids:
                row = self._current_row(cid)
                if row is not None:
                    self._valid.a[row] = False
                    self._dev_pending_del.append(row)
                    self._pending_meta.pop(row, None)
                    self._meta_lru.pop(row, None)
                    removed += 1
                    self._pending_log.append((self._pack_del(cid), None))
            if removed:
                self.mutation_count += 1
                if len(self._pending_log) >= SPILL_ROWS:
                    self._spill()
        return removed

    def clear(self) -> None:
        with self._lock:
            self._cids = GrowBuf(np.int64)
            self._m_off = GrowBuf(np.int64)
            self._m_len = GrowBuf(np.int32)
            self._m_path = GrowBuf(np.int32)
            self._valid = GrowBuf(bool)
            self._path_vocab = {}
            self._path_names = []
            self._sorted_cids = None
            self._extras = {}
            self._max_cid = -1
            self._pending_meta = {}
            self._meta_lru.clear()
            self._pending_log = []
            self._tail_rows = 0
            self._file_rows = 0
            self._rows = 0
            self._file_log_bytes = 0
            self._file_paths = 0
            self._paths_bytes = 0
            self._idx_rows = 0
            self._mm_covers = None
            self._next_id = 0
            self._needs_rewrite = True
            self._device = None
            self._dev_rows = 0
            self._dev_pending_del = []
            self.mutation_count += 1
            self.save()

    def build_index(self) -> None:
        """O(1): flush staged rows to device. (Parity shim for the
        reference's arroy tree build, which brute-force search obviates.)"""
        with self._lock:
            self._ensure_device()

    # ------------------------------------------------------------------
    # device state + search
    # ------------------------------------------------------------------

    def _zeros(self, shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _device_cap(self, n: int) -> int:
        """Padded device capacity: a power of two, at least
        VEC_INITIAL_CAPACITY, so appends rarely force a full upload."""
        return max(VEC_INITIAL_CAPACITY, 1 << max(0, (n - 1).bit_length()))

    def _upload_full(self):
        """Full upload at padded capacity, streamed in UPLOAD_BLOCK-row slabs
        so host memory stays bounded by one slab."""
        n = self._rows
        cap = self._device_cap(n)
        valid_all = self._used_valid()
        vmask = self._zeros((cap,), torch.bool)
        if self.int8:
            mat = self._zeros((cap, self.dims), torch.int8)
            scale = self._zeros((cap,), torch.float32)
            for b in range(0, n, UPLOAD_BLOCK):
                hi = min(b + UPLOAD_BLOCK, n)
                mat, scale, vmask = device_ops.insert_rows_int8(
                    mat, scale, vmask, self._read_rows_io(b, hi), valid_all[b:hi], b)
            self._device = ("int8", mat, scale, vmask)
        else:
            mat = self._zeros((cap, self.dims), torch.bfloat16)
            for b in range(0, n, UPLOAD_BLOCK):
                hi = min(b + UPLOAD_BLOCK, n)
                mat, vmask = device_ops.insert_rows(
                    mat, vmask, self._read_rows_io(b, hi), valid_all[b:hi], b)
            self._device = ("bf16", mat, None, vmask)
        self._dev_rows = n
        self._dev_pending_del = []
        self.full_uploads += 1
        return self._device

    def _ensure_device(self):
        """Sync device state with the host: appended rows are written in
        place, deletes clear validity bits; a full upload happens only when
        capacity overflows or after compaction."""
        with self._lock:
            if self._device is None:
                return self._upload_full()
            kind, mat, scale, valid = self._device
            cap = mat.shape[0]
            new = self._rows - self._dev_rows
            if new and self._dev_rows + new > cap:
                return self._upload_full()
            if new:
                valid_all = self._used_valid()
                for b in range(self._dev_rows, self._rows, UPLOAD_BLOCK):
                    hi = min(b + UPLOAD_BLOCK, self._rows)
                    rows, vr = self._rows_range(b, hi), valid_all[b:hi]
                    if kind == "int8":
                        mat, scale, valid = device_ops.insert_rows_int8(
                            mat, scale, valid, rows, vr, b)
                    else:
                        mat, valid = device_ops.insert_rows(mat, valid, rows, vr, b)
                self._dev_rows = self._rows
                self.incremental_updates += 1
            if self._dev_pending_del:
                valid = device_ops.invalidate_rows(valid, self._dev_pending_del, cap)
                self.incremental_updates += 1
                self._dev_pending_del = []
            self._device = (kind, mat, scale, valid)
            return self._device

    def search_batch(self, query_vecs: np.ndarray, limit: int) -> list[list[SearchResult]]:
        """Exact multi-query search of embedded query vectors."""
        if query_vecs.ndim == 1:
            query_vecs = query_vecs[None, :]
        with self._lock:
            n_valid = self._n_valid()
            if n_valid == 0:
                return self._empty(query_vecs.shape[0], raw=False)
            dev = self._ensure_device()
            k = min(limit, max(1, n_valid))
            q = self._dev_tensor(query_vecs.astype(np.float32))
            if dev[0] == "int8":
                vals, idx = cosine_topk_int8(q, dev[1], dev[2], dev[3], k)
            else:
                vals, idx = cosine_topk(q, dev[1], dev[3], k)
        return self._materialize(vals, idx)

    def rows_to_ids(self, vals, idx) -> tuple[np.ndarray, np.ndarray]:
        """(scores, row indices) -> (chunk ids [V, k] int64 with -1 for dead
        or padding rows, scores [V, k] f32)."""
        vals, idx = to_host(vals, idx)
        with self._lock:
            id_map = self._cids.view()
            n = len(id_map)
            if n == 0:
                return np.full(idx.shape, -1, np.int64), vals
            cids = id_map[np.clip(idx, 0, n - 1)]
        bad = (idx >= n) | (idx < 0) | (vals < -1e29)
        return np.where(bad, -1, cids), vals

    def _materialize(self, vals, idx) -> list[list[SearchResult]]:
        vals, idx = to_host(vals, idx)
        out: list[list[SearchResult]] = []
        with self._lock:
            cids = self._cids.view()
            valid = self._valid.view()
            for qi in range(vals.shape[0]):
                results: list[SearchResult] = []
                for score, row in zip(vals[qi], idx[qi]):
                    if score < -1e29 or row >= len(cids) or not valid[row]:
                        continue
                    meta = self._fetch_meta(int(row))
                    if meta is not None:
                        results.append(SearchResult(
                            chunk_id=int(cids[row]), score=float(score), metadata=meta))
                out.append(results)
        return out

    def _empty(self, nq: int, raw: bool):
        if raw:
            return np.zeros((nq, 0), np.int64), np.zeros((nq, 0), np.float32)
        return [[] for _ in range(nq)]

    def _dev_tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def search_featurized(self, table, ids: np.ndarray, weights: np.ndarray,
                          limit: int, raw: bool = False):
        """Featurized hash-model queries -> embed + exact top-k in one call."""
        with self._lock:
            n_valid = self._n_valid()
            if n_valid == 0:
                return self._empty(ids.shape[0], raw)
            dev = self._ensure_device()
            k = min(limit, max(1, n_valid))
            ids_t, w_t = self._dev_tensor(ids), self._dev_tensor(weights)
            if dev[0] == "int8":
                vals, idx = hash_embed_search_int8(table, ids_t, w_t, dev[1], dev[2], dev[3], k)
            else:
                vals, idx = hash_embed_search(table, ids_t, w_t, dev[1], dev[3], k)
        if raw:
            return self.rows_to_ids(vals, idx)
        return self._materialize(vals, idx)

    def wants_host_path(self) -> bool:
        """Should queries score on host? True for corpora small enough that
        numpy beats the per-process trace/load cost of the fused device
        executable (constants.HOST_PATH_ROWS; instance knob for tests)."""
        return 0 < self._rows <= self.host_path_rows

    def search_featurized_auto(
        self, model, ids: np.ndarray, weights: np.ndarray, limit: int,
        raw: bool = False,
    ):
        """ONE routing point between the fused device dispatch and the
        small-corpus host twin, shared by every read surface (session
        pipeline, wave paths, server read plane) so the host/device
        decision cannot drift between them. ``model`` is the hash embedder
        (provides both `.table` and `.table_np()`)."""
        if self.wants_host_path():
            return self.search_featurized_host(
                model.table_np(), ids, weights, limit, raw=raw
            )
        return self.search_featurized(model.table, ids, weights, limit, raw=raw)

    def search_featurized_host(
        self, table_np: np.ndarray, ids: np.ndarray, weights: np.ndarray,
        limit: int, raw: bool = False,
    ):
        """Pure-HOST twin of search_featurized for small corpora: hash
        embedding + exact cosine + top-k in numpy — zero jit, zero device
        state. A one-shot CLI search pays >1 s tracing and loading the
        fused executable even on all-cache-hit warm starts (measured on the
        CPU backend); at ≤HOST_PATH_ROWS rows the [V,384]×[384,N] fp32
        matmul is single-digit milliseconds on one core. Scores accumulate
        in fp32 where the device path's matmul is bf16 (int8 stores: the
        fp16 source rows, i.e. higher precision than the quantized device
        matrix) — equality of RANKING is what the equivalence tests pin."""
        with self._lock:
            n_valid = self._n_valid()
            if n_valid == 0:
                if raw:
                    shape = (ids.shape[0], 0)
                    return np.zeros(shape, np.int64), np.zeros(shape, np.float32)
                return [[] for _ in range(ids.shape[0])]
            rows = self._rows_range(0, self._rows)            # [N, d] fp32
            dead = ~self._used_valid()[: self._rows]
            gathered = table_np[ids].astype(np.float32)       # [V, T, d]
            qv = np.einsum("btd,bt->bd", gathered,
                           weights.astype(np.float32))
            qv /= np.maximum(
                np.linalg.norm(qv, axis=-1, keepdims=True), 1e-12
            )
            scores = qv @ rows.T                              # [V, N]
            if dead.any():
                scores[:, dead] = -1e30   # rows_to_ids drops < -1e29
            k = min(limit, max(1, n_valid), scores.shape[1])
            if k < scores.shape[1]:
                part = np.argpartition(-scores, k - 1, axis=1)[:, :k]
            else:
                part = np.broadcast_to(
                    np.arange(scores.shape[1]), scores.shape
                ).copy()
            pvals = np.take_along_axis(scores, part, axis=1)
            order = np.argsort(-pvals, axis=1, kind="stable")
            idx = np.take_along_axis(part, order, axis=1).astype(np.int32)
            vals = np.take_along_axis(pvals, order, axis=1).astype(np.float32)
        if raw:
            return self.rows_to_ids(vals, idx)
        return self._materialize(vals, idx)

    def search_encoded(self, encoder, ids: np.ndarray, mask: np.ndarray, limit: int,
                       raw: bool = False):
        """Tokenized BERT-family queries -> encoder forward + exact top-k in
        one call (the JAX store's ``params, cfg`` are ``encoder``)."""
        with self._lock:
            n_valid = self._n_valid()
            if n_valid == 0:
                return self._empty(ids.shape[0], raw)
            dev = self._ensure_device()
            k = min(limit, max(1, n_valid))
            ids_t, m_t = self._dev_tensor(ids), self._dev_tensor(mask)
            if dev[0] == "int8":
                vals, idx = bert_embed_search_int8(encoder, ids_t, m_t, dev[1], dev[2], dev[3], k)
            else:
                vals, idx = bert_embed_search(encoder, ids_t, m_t, dev[1], dev[3], k)
        if raw:
            return self.rows_to_ids(vals, idx)
        return self._materialize(vals, idx)

    def hybrid_search_featurized(self, table, ids: np.ndarray, weights: np.ndarray,
                                 limit: int, bm_args, raw: bool = False,
                                 defer: bool = False):
        """The hybrid read plane: variant embedding + exact vector top-k +
        resident BM25 top-k in one call. ``bm_args`` comes from the port's
        ``FtsStore.device_query_args``. With ``defer`` the four result
        tensors stay on the device for the caller to read back together."""
        return self._hybrid(hash_embed_hybrid_search, hash_embed_hybrid_search_int8,
                            table, ids, weights, limit, bm_args, raw, defer)

    def hybrid_search_encoded(self, encoder, ids: np.ndarray, mask: np.ndarray,
                              limit: int, bm_args, raw: bool = False, defer: bool = False):
        """The hybrid read plane of BERT-family models: encoder forward +
        exact vector top-k + resident BM25 top-k in one call; the contract of
        ``hybrid_search_featurized``."""
        return self._hybrid(bert_embed_hybrid_search, bert_embed_hybrid_search_int8,
                            encoder, ids, mask, limit, bm_args, raw, defer)

    def _hybrid(self, fn_bf16, fn_int8, model, ids, aux, limit, bm_args, raw, defer):
        fts_dev, cs, cl, ci, kid, kb, kbpre, imax, b_pw, b_planes = bm_args
        with self._lock:
            n_valid = self._n_valid()
            if n_valid == 0:
                if defer:
                    nq = ids.shape[0]
                    return (np.zeros((nq, 0), np.float32), np.zeros((nq, 0), np.int32),
                            np.zeros(0, np.float32), np.zeros(0, np.int32))
                return self._empty(ids.shape[0], raw), None, None
            dev = self._ensure_device()
            kv = min(limit, max(1, n_valid))
            ids_t, aux_t = self._dev_tensor(ids), self._dev_tensor(aux)
            bm = (fts_dev[0], fts_dev[1], fts_dev[2], self._dev_tensor(cs),
                  self._dev_tensor(cl), self._dev_tensor(ci), int(kid), kb, kbpre, imax)
            dense = {}
            if b_planes is not None:
                dense = {"pw": self._dev_tensor(b_pw), "planes": b_planes}
            if dev[0] == "int8":
                out = fn_int8(model, ids_t, aux_t, dev[1], dev[2], dev[3], kv, *bm, **dense)
            else:
                out = fn_bf16(model, ids_t, aux_t, dev[1], dev[3], kv, *bm, **dense)
        if defer:
            return out
        vv, vi, bv, bi = to_host(*out)
        if raw:
            return self.rows_to_ids(vv, vi), bv, bi
        return self._materialize(vv, vi), bv, bi

    def hybrid_search_featurized_many(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)

    def hybrid_search_encoded_many(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED)

    def search(self, query_vec: np.ndarray, limit: int) -> list[SearchResult]:
        return self.search_batch(query_vec, limit)[0]

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------

    def get_chunk(self, chunk_id: int) -> ChunkMetadata | None:
        with self._lock:
            row = self._current_row(chunk_id)
            if row is None:
                return None
            return self._fetch_meta(row)

    def iter_chunks(self):
        """Lazy (chunk_id, ChunkMetadata) iteration over live chunks,
        ordered by log offset (sequential reads). Streams — never holds
        the full metadata set in memory."""
        with self._lock:
            valid = self._valid.view()
            rows = np.nonzero(valid)[0]
            order = np.argsort(self._m_off.view()[rows], kind="stable")
            rows = rows[order]
            cids = self._cids.view()[rows].copy()
        for row, cid in zip(rows, cids):
            with self._lock:
                m = self._fetch_meta(int(row))
            if m is not None:
                yield int(cid), m

    def __len__(self) -> int:
        with self._lock:
            return int(self._valid.view().sum())
