"""BM25 full-text store — segmented, with device scoring on torch (the
port of ``codesearch_tpu/fts/store.py``).

An LSM-style columnar postings engine built for 10M-doc corpora on one
host core:

- Writes accumulate in growable buffers; ``commit`` sorts ONLY the new
  postings into an immutable CSR *segment* (O(new log new)) and merges
  segments geometrically (tantivy-style), so a full index run costs
  O(n log n) total instead of re-sorting everything per commit. Segments
  past MERGE_MAX_POSTINGS are SEALED out of the merge pool, bounding
  merge transients at any corpus size (tantivy's log-structured levels).
- Documents get monotonically increasing internal numbers (``dnum``);
  re-adding a chunk id mints a fresh dnum, so stale postings in old
  segments reference dead dnums and are filtered by liveness — no
  tombstone rescans; exactly Lucene/tantivy's doc-id discipline.
- The doc store is columnar (parallel numpy buffers, interned path ids —
  no per-doc Python objects); cid→slot is a sorted index with a bounded
  recent-append overlay, dnum→slot a bisect on the monotone dnum column.
- Persistence: segments are per-array ``.npy`` files whose posting bulk
  (int32 dnums, int16 tfs) memory-maps on reload; the doc store persists
  as vectorized sidecars (fixed-width ``docidx.bin`` appends + a packed
  liveness bitmap + a json-lines path table) so reopening never replays
  per-record logs. A tiny JSON manifest rename is the atomic commit
  point; crash leftovers are pruned. The files are byte for byte those of
  the JAX package, so either package opens the other's index.
- Scoring: the postings (``p_pos``, ``p_w``) and the packed kind|liveness
  table (``slot_meta``) live resident as torch tensors on ``device`` (on a
  corpus mesh: its lead device), grow by in-place writes, and are scored
  by ``ops/bm25.py`` (kernel c on CUDA); a query ships only its terms'
  CHUNK-aligned CSR intervals. High-df terms score through resident score
  planes built by ``plane_write_rows``. Small corpora score on host
  (np.bincount). The routing rules, capacity triggers and plane memory
  knobs keep the JAX store's values.

Query semantics parity:
- ``search``: BM25 with signature terms boosted ×2 and a ×3 score boost for
  chunks matching a structural-intent kind (tantivy_store.rs:394-458).
- ``search_exact``: identifier term matched in signature (boost ×3) ∪
  content, AND-ed with kind when provided (tantivy_store.rs:460-524);
  an exact signature-first fast path bounds high-df scans.

Fusion consumes ranks (RRF), so absolute score scale differences from
tantivy are immaterial.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import threading
from dataclasses import dataclass
from pathlib import Path

import msgpack
import numpy as np
import torch

from ..models.tokenizer import code_tokens
from ..parallel.mesh import mesh_for
from ..utils.hashing import stable_u64
from ..utils.logger import get_logger
from ..ops.bm25 import (
    CHUNK,
    DEAD_SLOT,
    PACK_PAD,
    SLOT_BITS,
    bm25_resident_topk,
    plane_write_rows,
)
from ..utils.device import resolve_device, to_host
from ..utils.growbuf import GrowBuf as _GrowBuf
from ..vectordb import device_ops


log = get_logger("fts")

_K1 = 1.2
_B = 0.75
_SIG_BOOST = 2.0
_KIND_BOOST = 3.0
_EXACT_SIG_BOOST = 3.0

MAX_SEGMENTS = 12          # cap on the UNSEALED pool — past it the two smallest merge
MERGE_RATIO = 2.0          # similar-size segments merge eagerly
# segments at/above this posting count are SEALED: they never merge again,
# bounding merge transients to ~2×MERGE_MAX postings (~0.5 GB) regardless of
# corpus size — the 10M-doc configuration would otherwise concatenate+argsort
# 100M+ postings in one merge (tantivy's log-structured levels, same idea)
MERGE_MAX_POSTINGS = int(os.environ.get("CODESEARCH_FTS_MERGE_MAX", 1 << 23))
DEVICE_MIN_DOCS = 50_000   # below this, host bincount beats a dispatch
# recent-append cid→slot dict entries before folding into the sorted index
EXTRAS_MAX = 1 << 18

# fixed-width doc-store sidecar record, one per slot, appended in slot order
DOCIDX_DTYPE = np.dtype(
    [("dnum", "<i8"), ("cid", "<i8"), ("len", "<i4"), ("kid", "<i2"),
     ("pid", "<i4")]
)
# Terms matching more than this fraction of the corpus are skipped: their
# idf is ~log(1 + (N-df)/df) ≈ 0 (zero ranking signal) while their postings
# dominate gather cost — measured 3.1M of 3.3M selected postings at 1M docs
# came from stopword-class terms ("the"/"return"/...).
MAX_DF_RATIO = 0.4
# device-path cap on (term x segment) intervals: the kernel's run reduction
# is a log2(imax)-pass segmented scan (ops/bm25.py), so even many-term ×
# many-segment queries stay cheap (256 intervals = 8 passes); the cap is a
# safety valve, not a routing decision — crossing it is logged per query
MAX_DEVICE_INTERVALS = 256
# post-sync tombstones tolerated on device before a full resync: queries
# oversample their BM25 top-k by the live tombstone count (ops/bm25.py kpre),
# so this bounds the oversample at pow2(k + DEAD_RESYNC_MAX)
DEAD_RESYNC_MAX = 2048
# exact-identifier impact tier: terms whose total df exceeds EXACT_TIER_DF
# are served from a per-(segment, term) candidate tier — the top
# EXACT_TIER_CAP postings by build-time score, cached LRU. The full-scan
# cost at df 2.6M (the 10M-corpus "config"/"util" class) is ~110 ms of
# random len/liveness gathers per query (measured, probe r3); the tier
# makes warm queries ~200k-row vectorized work. Exactness is preserved by
# a score bound (see _exact_tier) with full-scan fallback when it fails —
# the host analog of tantivy's block-max skipping (tantivy_store.rs:460).
EXACT_TIER_DF = int(os.environ.get("CODESEARCH_EXACT_TIER_DF", 1 << 16))
EXACT_TIER_CAP = int(os.environ.get("CODESEARCH_EXACT_TIER_CAP", 1 << 14))
EXACT_TIER_CACHE = 64      # cached tiers (~200 KB each at the default cap)
# per-segment df at which a term's tier is PERSISTED alongside the segment
# at commit time (segments are immutable once written, so the sidecar is
# built exactly once). A fresh process then mmaps candidates instead of
# paying the first-query posting scan; terms below the threshold rebuild
# on demand over ranges that are ≤ this many rows — microseconds. Disk
# analog of tantivy's on-disk block-max structures (tantivy_store.rs:460).
EXACT_TIER_PREWARM_DF = int(
    os.environ.get("CODESEARCH_EXACT_TIER_PREWARM_DF", 1 << 13))
# tier sidecar columns, persisted per segment (plus a json carrying the
# build-time avg_len for the exactness bound)
_XTIER_ARRAYS = ("keys", "off", "tail", "dn", "tfc", "tfs", "lens")

# RESIDENT SCORE PLANES (ops/bm25.py plane_write_rows/_merge_dense): a term whose
# df exceeds this floor — or whose chunk footprint would blow the per-query
# sparse budget below — scores through a cached per-term dense [N] column
# instead of per-query chunk gathers. Without planes a df-2.6M term costs
# every query ~2,560 chunk DMAs plus a multi-million-row sort (and each new
# pow2 chunk-table bucket compiles another executable — the r3 10M bench
# measured a 618 s first identifier query and 428 ms warm); with planes the
# per-query cost is one [B, H]×[H, N] matmul row + the gated top-k,
# identical for every query shape. Building a plane costs one O(df) gather
# + scatter per (term, device epoch) — cached LRU in HBM.
PLANE_DF_FLOOR = int(os.environ.get("CODESEARCH_PLANE_DF_FLOOR", 1 << 16))
# HBM budget for the plane buffer; rows = clamp(budget/(4·ncap), 4, 32).
# 2 GB = 32 rows at 16.7M slots. The budget must cover the serving
# working set of dense terms: an LRU smaller than the hot-term set
# rebuilds planes on every query (each rebuild = one O(df) gather+scatter
# AND one transient full-buffer functional copy — the buffer is never
# donated, see ops/bm25.py plane_write_rows). Peak-at-10M-int8 math:
# 6.4 GB matrix + ~1 GB postings + 2×2 GB planes during a build +
# ~0.3 GB dense-merge sub-batch (ops/bm25.py _MERGE_SUB) ≈ 12 GB of 16.
# (An earlier r4 shape OOM'd at 1 GB budget — the cause was per-term
# buffer copies and an unbounded [B, N] wave transient, both fixed, not
# the steady buffer size.)
PLANE_HBM_MB = int(os.environ.get("CODESEARCH_PLANE_HBM_MB", 2048))
# Row cap doubles as H in the dense-leg [B, H]×[H, N] matmul, so it is a
# compute knob as much as a memory one. 64 lets a ≤8M-row corpus hold its
# ENTIRE plane-eligible working set resident (the r5 1M bench corpus has
# ~36 eligible terms — at 32 rows the prewarm filled the buffer and the
# timed queries thrashed the LRU: 18 in-query builds); above ~8M rows the
# HBM budget caps rows at 32 anyway and the LRU does its job.
PLANE_ROWS_MAX = 64
# plane builds batch into ≤this many rows per dispatch: each group
# materializes [R, ncap] scatter columns (R×67 MB at 16.7M slots), so a
# cold 32-term prep stays ~0.5 GB transient instead of 2.1 GB
PLANE_BUILD_ROWS = 8
# per-query cap on the sparse leg's chunk table: terms are promoted to
# planes (largest footprint first) until the query fits, bounding both the
# sort length and the run-end dense gather in ops/bm25.py _merge_dense
SPARSE_CHUNK_BUDGET = int(os.environ.get("CODESEARCH_SPARSE_CHUNK_BUDGET", 64))


def _to_i64(h: int) -> int:
    """Unsigned 64-bit hash → signed-int64 key (matches the native tier)."""
    return h - (1 << 64) if h >= (1 << 63) else h


def term_keys(text: str) -> np.ndarray:
    """Ordered token term keys (int64, duplicates kept). Native when
    available; byte-identical Python fallback."""
    from ..native import token_hashes_native

    keys = token_hashes_native(text)
    if keys is not None:
        return keys
    toks = code_tokens(text)
    if not toks:
        return np.zeros(0, np.int64)
    return np.asarray([_to_i64(stable_u64(t)) for t in toks], np.int64)


def query_term_keys(query: str) -> np.ndarray:
    """Unique term keys for BM25 query scoring. Operators are stripped
    first — an excluded term must not SELECT the candidates it exists to
    reject, and phrase quotes are transparent — then interrogative
    queries reduce to their content core ("how do we detect binary
    files" → "detect binary files"): scaffolding terms select prose
    chunks and dilute the per-doc score mass (search/analysis)."""
    from ..search.analysis import parse_operators, strip_question

    retrieval, _phrases, _exclusions = parse_operators(query)
    core = strip_question(retrieval)
    return np.unique(term_keys(core if core is not None else retrieval))


def term_keys_batch(texts: list[str]) -> list[np.ndarray]:
    """Ordered token term keys for a slab of texts: ONE native call when
    available (per-text ctypes marshaling dominates at ingest rates —
    measured 2.1 s of 15.7 s indexing 65k chunks); per-text results are
    byte-identical to term_keys."""
    from ..native import token_hashes_batch_native

    keys = token_hashes_batch_native(texts)
    if keys is not None:
        return keys
    return [term_keys(t) for t in texts]


def _pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def stack_query_args(args_list: list) -> tuple:
    """Stack B per-query ``device_query_args`` tuples (same store, same
    device epoch) into the batched call's shapes: interval tables padded to
    the batch-max chunk count, the batch axis padded to ``max(4, pow2(B))``
    fully-masked rows (clen=0, kid=-1; the dense leg then splits the batch
    into ``ops/bm25._MERGE_SUB``-row sub-batches above 8), k/kpre/imax taken
    as batch maxima (each query's own bound is at most the max, and kpre >=
    k + dead-since-sync still holds for the largest k). Callers trim each
    query's results back to its own k on the host.

    Raises ValueError when the tuples span different device epochs: a
    rebuild of the resident postings or a score-plane build between preps
    (each replaces the tensor object) would make the batched offsets or
    plane weights index the wrong layout; callers re-prep or fall back to
    per-query calls."""
    dev = args_list[0][0]
    planes = None
    for a in args_list:
        if a[0][0] is not dev[0]:
            raise ValueError("device epoch changed between query preps")
        if a[9] is not None:
            if planes is None:
                planes = a[9]
            elif planes is not a[9]:
                raise ValueError("plane epoch changed between query preps")
    cmax = max(a[1].shape[0] for a in args_list)
    bpad = max(4, _pow2(len(args_list)))
    cs = np.zeros((bpad, cmax), np.int32)
    cl = np.zeros((bpad, cmax), np.int32)
    ci = np.zeros((bpad, cmax), np.float32)
    kid = np.full(bpad, -1, np.int32)
    pw = None
    if planes is not None:
        pw = np.zeros((bpad, planes.shape[0]), np.float32)
    for row, a in enumerate(args_list):
        _, cs_a, cl_a, ci_a, kid_a = a[:5]
        m = cs_a.shape[0]
        cs[row, :m] = cs_a
        cl[row, :m] = cl_a
        ci[row, :m] = ci_a
        kid[row] = kid_a
        if pw is not None and a[8] is not None:
            pw[row] = a[8]
    k = max(a[5] for a in args_list)
    kpre = max(max(a[6] for a in args_list), k)
    imax = max(a[7] for a in args_list)
    return dev, cs, cl, ci, kid, k, kpre, imax, pw, planes


def stack_wave(fts, plans: list, args_list: list):
    """(per-query args, stacked args) for a wave's BM25 legs, ``plans``
    being each query's ``device_query_args`` arguments. When the epoch moved
    between preps (a cold wave's plane builds each replace the buffer, or a
    rebuild of the resident postings) the preps run once more, the builds
    cached now; None when the epoch moves again or a leg leaves the device,
    and the caller then runs the queries one by one."""
    try:
        return args_list, stack_query_args(args_list)
    except ValueError:
        args_list = [fts.device_query_args(*p) for p in plans]
        if any(a is None for a in args_list):
            return None
        try:
            return args_list, stack_query_args(args_list)
        except ValueError:
            return None


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}


def _chunk_table(ranges) -> tuple[list[int], list[int]]:
    """Split absolute CSR ranges into CHUNK-aligned (start, live length)
    slices; a slice never straddles two ranges."""
    cstart, clen = [], []
    for rlo, rln in ranges:
        for off in range(0, rln, CHUNK):
            cstart.append(rlo + off)
            clen.append(min(CHUNK, rln - off))
    return cstart, clen


@dataclass(slots=True)
class FtsResult:
    chunk_id: int
    score: float
    path: str
    kind: str



class Segment:
    """Immutable CSR postings block: unique sorted terms + offsets into
    parallel (dnum, tf_content, tf_signature) arrays."""

    __slots__ = ("name", "terms", "offsets", "dnums", "tfc", "tfs", "seq")

    def __init__(self, terms, offsets, dnums, tfc, tfs, name: str | None = None):
        self.name = name           # npz filename once persisted; None = memory-only
        self.seq = -1              # store-unique id (assigned on adoption)
        self.terms = terms
        self.offsets = offsets
        self.dnums = dnums
        self.tfc = tfc
        self.tfs = tfs

    def __len__(self) -> int:
        return int(len(self.dnums))

    def term_range(self, key: int) -> tuple[int, int]:
        i = int(np.searchsorted(self.terms, key))
        if i >= len(self.terms) or self.terms[i] != key:
            return 0, 0
        return int(self.offsets[i]), int(self.offsets[i + 1])

    @classmethod
    def from_triples(cls, terms, dnums, tfc, tfs) -> "Segment":
        order = np.argsort(terms, kind="stable")
        terms, dnums = terms[order], dnums[order]
        tfc, tfs = tfc[order], tfs[order]
        # run-boundary unique on the now-sorted terms: np.unique would sort
        # AGAIN (its flatten+sort was 17 s of a 59 s commit phase at 1M docs)
        if len(terms):
            starts = np.empty(len(terms), bool)
            starts[0] = True
            np.not_equal(terms[1:], terms[:-1], out=starts[1:])
            idx = np.flatnonzero(starts)
            uniq = terms[idx]
            offsets = np.concatenate([idx, [len(terms)]]).astype(np.int64)
        else:
            uniq = terms[:0]
            offsets = np.zeros(1, np.int64)
        # compact posting dtypes (10M-doc scale: 16 B/posting instead of 24):
        # dnums fit int32 (dnum space is bounded by total adds), tf saturates
        # in BM25 anyway so int16 loses nothing
        if len(dnums) and int(dnums.max()) < (1 << 31):
            dnums = dnums.astype(np.int32)
        tfc = np.clip(tfc, 0, 32767).astype(np.int16)
        tfs = np.clip(tfs, 0, 32767).astype(np.int16)
        return cls(uniq, offsets, dnums, tfc, tfs)

    def flat_terms(self) -> np.ndarray:
        return np.repeat(self.terms, np.diff(self.offsets))


class FtsStore:
    MANIFEST_FILE = "fts.json"
    DOCIDX_FILE = "docidx.bin"
    DOCVALID_FILE = "docvalid.bin"
    PATHS_FILE = "paths.txt"
    # legacy layouts, auto-migrated on first commit
    DOCLOG_FILE = "docs.log"               # v3 (round-2): msgpack doc log
    LEGACY_INDEX_FILE = "index.msgpack"    # v2 (round-1)
    LEGACY_POSTINGS_FILE = "postings.npz"

    def __init__(self, directory: str | Path, readonly: bool = False, device=None):
        self.device = resolve_device(device)
        self.dir = Path(directory)
        self.readonly = readonly
        self._lock = threading.RLock()
        # columnar doc store, indexed by slot (append-only; len -1 = dead).
        # Scale discipline (10M docs): NO per-doc Python objects — paths are
        # interned ids, cid→slot is a sorted index + bounded append overlay,
        # dnum→slot is a searchsorted on the (monotone) dnum column.
        self._doc_dnum = _GrowBuf(np.int64)
        self._doc_len = _GrowBuf(np.int32)
        self._doc_kid = _GrowBuf(np.int32)
        self._doc_cid = _GrowBuf(np.int64)
        self._doc_pid = _GrowBuf(np.int32)     # interned path id
        self._path_vocab: dict[str, int] = {}
        self._path_names: list[str] = []
        self._sorted_cids: np.ndarray | None = None
        self._sorted_slots: np.ndarray | None = None
        self._extras: dict[int, int] = {}      # recent cid → slot
        self._max_cid = -1                     # fresh-cid lookup short-circuit
        self._n_live = 0
        self._kind_vocab: dict[str, int] = {}
        self._kind_names: list[str] = []
        self._next_dnum = 0
        self._next_seg = 0
        self._segments: list[Segment] = []
        # uncommitted postings (appended since last flush)
        self._new_terms = _GrowBuf(np.int64)
        self._new_dnums = _GrowBuf(np.int64)
        self._new_tfc = _GrowBuf(np.int32)
        self._new_tfs = _GrowBuf(np.int32)
        self._dead_since_flush: set[int] = set()
        # persistence cursors (sidecar-covered prefixes)
        self._idx_slots = 0                    # slots in docidx.bin
        self._file_paths = 0                   # names in paths.txt
        self._paths_bytes = 0                  # committed byte prefix of paths.txt
        self._valid_seq = 0                    # bitmap sequence (manifest-selected)
        # dense scoring view: SLOT-indexed (append-only, never compacted —
        # slot positions are stable so resident device postings stay valid
        # across doc adds/deletes; liveness is a mask)
        self._dense_dirty = True
        self._dnums_sorted = np.zeros(0, np.int64)   # full slot view (sorted)
        self._len_arr = np.zeros(0, np.float32)
        self._live_arr = np.zeros(0, bool)
        self._kind_arr = np.zeros(0, np.int32)
        self._cid_arr = np.zeros(0, np.int64)
        self._avg_len = 1.0
        # device view: resident postings + kind/valid arrays, synced
        # INCREMENTALLY (new segments DUS-append; deletes scatter the valid
        # mask; full rebuild only on capacity/garbage/avg-len triggers)
        self._dev = None
        self._dev_state: dict | None = None
        self._dev_pending_dead: list[int] = []       # slots killed since sync
        self._seg_seq = 0
        self.device_min_docs = DEVICE_MIN_DOCS
        # resident score planes (instance knobs so tests can force routing)
        self.plane_df_floor = PLANE_DF_FLOOR
        self.sparse_chunk_budget = SPARSE_CHUNK_BUDGET
        self.planes_enabled = True
        self.plane_prewarm = True
        self.plane_builds = 0                        # diagnostics for tests
        self.plane_evictions = 0
        self.plane_prewarms = 0
        self.fts_full_uploads = 0                    # diagnostics for tests
        self.fts_incremental_updates = 0
        # exact-identifier impact tiers: (seg.seq, term key) → candidate
        # arrays (see _exact_tier). Instance-level knobs so tests can
        # exercise the tier on small corpora.
        self.exact_tier_df = EXACT_TIER_DF
        self.exact_tier_cap = EXACT_TIER_CAP
        self.exact_tier_prewarm_df = EXACT_TIER_PREWARM_DF
        self._xtier_cache: dict[tuple[int, int], tuple] = {}
        self._xtier_disk: dict[int, dict | None] = {}  # seg.seq → sidecar
        self.exact_tier_hits = 0                     # diagnostics for tests
        self.exact_tier_fallbacks = 0
        self.exact_tier_disk_hits = 0
        # monotone content-change counter (see VectorStore.mutation_count)
        self.mutation_count = 0
        if self.dir.exists():
            self._load()
        elif not readonly:
            self.dir.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------
    # doc store helpers
    # ------------------------------------------------------------------

    def _kind_id(self, kind: str) -> int:
        kid = self._kind_vocab.get(kind)
        if kid is None:
            kid = len(self._kind_names)
            self._kind_vocab[kind] = kid
            self._kind_names.append(kind)
        return kid

    def _path_id(self, path: str) -> int:
        pid = self._path_vocab.get(path)
        if pid is None:
            pid = len(self._path_names)
            self._path_vocab[path] = pid
            self._path_names.append(path)
        return pid

    def _path_of_slot(self, slot: int) -> str:
        return self._path_names[int(self._doc_pid.a[slot])]

    def _slot_of_dnum(self, dnum: int) -> int | None:
        """dnums are assigned monotonically and appended in order, so the
        dnum column IS sorted — slot lookup is one bisect, no dict."""
        v = self._doc_dnum.view()
        i = int(np.searchsorted(v, dnum))
        if i < len(v) and v[i] == dnum:
            return i
        return None

    def _dnum_identity(self) -> bool:
        """True when slot == dnum for every slot (the common case: every
        add mints the next dnum and appends the next slot, so the column is
        exactly arange(n); only legacy migrations can break this). Lets all
        bulk dnum→slot mappings skip their searchsorted — the dominant cost
        of multi-M-posting gathers at 10M docs."""
        n = self._doc_dnum.n
        return bool(
            n and int(self._doc_dnum.a[0]) == 0
            and int(self._doc_dnum.a[n - 1]) == n - 1
        )

    def _slot_positions(self, dnums: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized dnum→slot mapping against the dense view. Returns
        (pos clipped into range, found mask). O(m) identity fast path;
        O(m log n) searchsorted otherwise."""
        n = self._dnums_sorted.size
        if n == 0:
            z = np.zeros(len(dnums), np.int64)
            return z, np.zeros(len(dnums), bool)
        if self._dnum_identity():
            pos = dnums.astype(np.int64)
            found = (pos >= 0) & (pos < n)
            return np.clip(pos, 0, n - 1), found
        pos = np.searchsorted(self._dnums_sorted, dnums).clip(0, n - 1)
        return pos, self._dnums_sorted[pos] == dnums

    def _rebuild_sorted(self) -> None:
        cids = self._doc_cid.view()
        order = np.argsort(cids, kind="stable").astype(np.int64)
        self._sorted_cids = cids[order].copy()
        self._sorted_slots = order
        self._extras = {}

    def _current_slot(self, cid: int) -> int | None:
        """The (single) LIVE slot holding this chunk id, else None."""
        if cid > self._max_cid:
            # fresh id — cannot exist; keeps bulk indexing from ever
            # paying the lazy sorted-index rebuild
            return None
        slot = self._extras.get(cid)
        if slot is not None:
            return slot if self._doc_len.a[slot] >= 0 else None
        if self._sorted_cids is None:
            self._rebuild_sorted()
        i = int(np.searchsorted(self._sorted_cids, cid))
        lens = self._doc_len.view()
        while i < len(self._sorted_cids) and self._sorted_cids[i] == cid:
            s = int(self._sorted_slots[i])
            if s < len(lens) and lens[s] >= 0:
                return s
            i += 1
        return None

    def _add_doc(self, dnum: int, cid: int, length: int, kind: str, path: str) -> None:
        old = self._current_slot(cid)
        if old is not None:
            self._kill_dnum(int(self._doc_dnum.a[old]))
        slot = self._doc_dnum.append(dnum)
        self._doc_len.append(length)
        self._doc_kid.append(self._kind_id(kind))
        self._doc_cid.append(cid)
        self._doc_pid.append(self._path_id(path))
        self._extras[cid] = slot
        if cid > self._max_cid:
            self._max_cid = cid
        if len(self._extras) > EXTRAS_MAX:
            # defer the argsort to the next lookup (see vectordb/store.py)
            self._sorted_cids = None
            self._sorted_slots = None
            self._extras = {}
        self._n_live += 1
        self._dense_dirty = True

    def _add_docs_fresh(
        self,
        dnums: np.ndarray,
        cids: np.ndarray,
        doc_lens: np.ndarray,
        rows: list[tuple[int, str, str, str | None, str]],
    ) -> None:
        """Bulk ``_add_doc`` for slabs where every chunk id is FRESH
        (> ``_max_cid``, no intra-slab duplicates — the bulk-indexing common
        case, asserted by the caller): no replace detection, one columnar
        extend per column, one dict.update for the id overlay."""
        base = self._doc_dnum.n
        kids = np.empty(len(rows), np.int32)
        pids = np.empty(len(rows), np.int32)
        last_kind: str | None = None
        last_kid = -1
        last_path: str | None = None
        last_pid = -1
        for i, (_cid, _content, path, _sig, kind) in enumerate(rows):
            # kinds and paths repeat in runs (64 chunks/file is typical) —
            # re-intern only on change
            if kind != last_kind:
                last_kid = self._kind_id(kind)
                last_kind = kind
            kids[i] = last_kid
            if path != last_path:
                last_pid = self._path_id(path)
                last_path = path
            pids[i] = last_pid
        self._doc_dnum.extend(dnums)
        self._doc_len.extend(doc_lens)
        self._doc_kid.extend(kids)
        self._doc_cid.extend(cids)
        self._doc_pid.extend(pids)
        self._extras.update(
            zip(cids.tolist(), range(base, base + len(rows)))
        )
        self._max_cid = max(self._max_cid, int(cids.max()))
        if len(self._extras) > EXTRAS_MAX:
            # defer the argsort to the next lookup (see vectordb/store.py)
            self._sorted_cids = None
            self._sorted_slots = None
            self._extras = {}
        self._n_live += len(rows)
        self._dense_dirty = True

    def _kill_dnum(self, dnum: int) -> None:
        slot = self._slot_of_dnum(dnum)
        if slot is not None and self._doc_len.a[slot] >= 0:
            self._doc_len.a[slot] = -1
            self._n_live -= 1
            self._dead_since_flush.add(dnum)
            self._dev_pending_dead.append(slot)
            self._dense_dirty = True

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------

    @staticmethod
    def _sig_text(path: str, signature: str | None) -> str:
        """Signature-field text: the declared signature plus the chunk's
        PATH tokens (separators → spaces; code_tokens splits the rest).
        Filename/directory names are a classic code-search relevance
        signal the reference never indexes (its tantivy path field is a
        raw STRING used for deletes, tantivy_store.rs:72) — "where is the
        main entry point" should surface main.rs. Ubiquitous segments
        ("src", extensions) carry near-zero IDF; measured +1 top-1 on the
        reference labeled set, no change on the self set."""
        ptoks = path.replace("/", " ").replace(".", " ").replace("\\", " ")
        return ((signature or "") + " " + ptoks).strip()

    def add_chunk(
        self,
        chunk_id: int,
        content: str,
        path: str,
        signature: str | None = None,
        kind: str = "",
    ) -> None:
        with self._lock:
            dnum = self._next_dnum
            self._next_dnum += 1
            c_keys = term_keys(content)
            s_keys = term_keys(self._sig_text(path, signature))
            doc_len = max(len(c_keys) + len(s_keys), 1)
            self._add_doc(dnum, chunk_id, doc_len, kind, path)
            self.mutation_count += 1
            all_keys = np.concatenate([c_keys, s_keys]) if len(s_keys) else c_keys
            if len(all_keys):
                uniq, inv = np.unique(all_keys, return_inverse=True)
                tfc = np.zeros(len(uniq), np.int32)
                tfs = np.zeros(len(uniq), np.int32)
                np.add.at(tfc, inv[: len(c_keys)], 1)
                if len(s_keys):
                    np.add.at(tfs, inv[len(c_keys):], 1)
                self._new_terms.extend(uniq)
                self._new_dnums.extend(np.full(len(uniq), dnum, np.int64))
                self._new_tfc.extend(tfc)
                self._new_tfs.extend(tfs)

    def add_chunks(
        self,
        rows: list[tuple[int, str, str, str | None, str]],
    ) -> None:
        """Batch ingest of ``(chunk_id, content, path, signature, kind)``
        rows. Identical semantics to per-row ``add_chunk`` but the per-doc
        (term, tf) aggregation is ONE vectorized lexsort + run-length
        reduction over the whole slab instead of a numpy-fixed-cost
        ``np.unique`` per chunk — measured 3-4× on the indexing write plane
        (the per-chunk path spent ~50 µs/chunk in small-array numpy calls)."""
        if not rows:
            return
        with self._lock:
            texts: list[str] = []
            for _cid, content, path, signature, _kind in rows:
                texts.append(content)
                texts.append(self._sig_text(path, signature))
            all_keys = term_keys_batch(texts)
            nrows = len(rows)
            lens = np.fromiter(
                (len(k) for k in all_keys), np.int64, len(all_keys)
            )
            doc_lens = np.maximum(
                lens.reshape(-1, 2).sum(axis=1), 1
            ).astype(np.int32)
            cids = np.fromiter((r[0] for r in rows), np.int64, nrows)
            row_dnums = np.arange(
                self._next_dnum, self._next_dnum + nrows, dtype=np.int64
            )
            self._next_dnum += nrows
            if (
                self._max_cid >= 0 and int(cids.min()) <= self._max_cid
            ) or len(np.unique(cids)) != nrows:
                # re-adds or intra-slab duplicate ids: the per-doc path
                # handles replace ordering exactly (kill old, then append)
                for i, (cid, _content, path, _sig, kind) in enumerate(rows):
                    self._add_doc(
                        int(row_dnums[i]), cid, int(doc_lens[i]), kind, path
                    )
            else:
                # bulk indexing: every id is fresh — one columnar append
                # per column instead of 5 numpy scalar appends + dict ops
                # per doc (measured ~20 µs/doc of pure Python at 10M scale)
                self._add_docs_fresh(row_dnums, cids, doc_lens, rows)
            self.mutation_count += nrows
            if not int(lens.sum()):
                return
            keys = np.concatenate(all_keys)
            # per-text dnum/flag expanded once over the whole slab: texts
            # alternate (content, signature) per row
            dnums = np.repeat(np.repeat(row_dnums, 2), lens)
            sflag = np.repeat(np.tile(np.array([0, 1], np.int32), nrows), lens)
            order = np.lexsort((keys, dnums))      # dnum-major, key-minor
            k_s, d_s, f_s = keys[order], dnums[order], sflag[order]
            new_run = np.empty(len(k_s), bool)
            new_run[0] = True
            new_run[1:] = (k_s[1:] != k_s[:-1]) | (d_s[1:] != d_s[:-1])
            starts = np.flatnonzero(new_run)
            tfs = np.add.reduceat(f_s, starts).astype(np.int32)
            tfc = (np.add.reduceat(np.ones_like(f_s), starts) - tfs).astype(np.int32)
            self._new_terms.extend(k_s[starts])
            self._new_dnums.extend(d_s[starts])
            self._new_tfc.extend(tfc)
            self._new_tfs.extend(tfs)

    def delete_chunk(self, chunk_id: int) -> None:
        with self._lock:
            slot = self._current_slot(chunk_id)
            if slot is None:
                return
            self._kill_dnum(int(self._doc_dnum.a[slot]))
            self.mutation_count += 1

    def clear(self) -> None:
        with self._lock:
            self.__init_empty()
            self.mutation_count += 1
            self.commit()

    def __init_empty(self) -> None:
        self._doc_dnum = _GrowBuf(np.int64)
        self._doc_len = _GrowBuf(np.int32)
        self._doc_kid = _GrowBuf(np.int32)
        self._doc_cid = _GrowBuf(np.int64)
        self._doc_pid = _GrowBuf(np.int32)
        self._path_vocab = {}
        self._path_names = []
        self._sorted_cids = None
        self._sorted_slots = None
        self._extras = {}
        self._max_cid = -1
        self._n_live = 0
        self._segments = []
        self._new_terms = _GrowBuf(np.int64)
        self._new_dnums = _GrowBuf(np.int64)
        self._new_tfc = _GrowBuf(np.int32)
        self._new_tfs = _GrowBuf(np.int32)
        self._dead_since_flush = set()
        self._idx_slots = 0
        self._file_paths = 0
        self._paths_bytes = 0
        self._dense_dirty = True
        self._dev = None
        self._dev_state = None
        self._dev_pending_dead = []
        self._xtier_cache = {}
        self._xtier_disk = {}

    # ------------------------------------------------------------------
    # segment lifecycle
    # ------------------------------------------------------------------

    def _flush_mem(self) -> None:
        """Sort uncommitted postings into a memory-only segment, dropping
        postings whose dnum died since they were buffered. O(new log new) —
        never touches committed segments or the dense view."""
        if self._new_terms.n == 0:
            self._dead_since_flush.clear()
            return
        terms = self._new_terms.view().copy()
        dnums = self._new_dnums.view().copy()
        tfc = self._new_tfc.view().copy()
        tfs = self._new_tfs.view().copy()
        self._new_terms = _GrowBuf(np.int64)
        self._new_dnums = _GrowBuf(np.int64)
        self._new_tfc = _GrowBuf(np.int32)
        self._new_tfs = _GrowBuf(np.int32)
        if self._dead_since_flush:
            dead = np.fromiter(self._dead_since_flush, np.int64,
                               len(self._dead_since_flush))
            live = ~np.isin(dnums, dead)
            terms, dnums = terms[live], dnums[live]
            tfc, tfs = tfc[live], tfs[live]
        self._dead_since_flush.clear()
        if len(terms):
            self._segments.append(self._adopt(Segment.from_triples(terms, dnums, tfc, tfs)))

    def _liveness(self, dnums: np.ndarray) -> np.ndarray:
        """Vectorized live-dnum mask against the dense view (exact)."""
        self._ensure_dense()
        if self._dnums_sorted.size == 0:
            return np.zeros(len(dnums), bool)
        pos, found = self._slot_positions(dnums)
        return found & self._live_arr[pos]

    def _merge_segments(self, victims: list[Segment]) -> Segment:
        """Run-level k-way merge of term-sorted segments, dropping dead
        postings. The merged term table is the union of the victims'
        term tables; each term's posting run is the victims' runs
        concatenated in victim order — byte-identical to the old
        concatenate+stable-resort output, but O(postings) scatter
        instead of an O(n log n) per-posting re-sort (profiled at 1M
        docs: 51 s → the flat_terms expansion, np.unique's second sort,
        and redundant clip/astype dominated the commit phase). The
        liveness gather is skipped entirely while the store has never
        killed a doc (the bulk-index common case; it was 23 s of that
        51 s)."""
        parts = []  # (terms, counts, dnums, tfc, tfs) per victim, live-only
        has_dead = self._doc_dnum.n != self._n_live
        for s in victims:
            terms = np.asarray(s.terms)
            counts = np.diff(s.offsets).astype(np.int64)
            dnums, tfc, tfs = s.dnums, s.tfc, s.tfs
            if has_dead and len(dnums):
                live = self._liveness(np.asarray(dnums))
                if not live.all():
                    cum = np.concatenate([[0], np.cumsum(live)])
                    counts = (cum[s.offsets[1:]] - cum[s.offsets[:-1]]).astype(np.int64)
                    dnums = np.asarray(dnums)[live]
                    tfc, tfs = np.asarray(tfc)[live], np.asarray(tfs)[live]
                    keep = counts > 0
                    terms, counts = terms[keep], counts[keep]
            # legacy on-disk segments may carry pre-compaction tf dtypes
            if tfc.dtype != np.int16:
                tfc = np.clip(tfc, 0, 32767).astype(np.int16)
            if tfs.dtype != np.int16:
                tfs = np.clip(tfs, 0, 32767).astype(np.int16)
            parts.append((terms, counts, dnums, tfc, tfs))
        uniq = parts[0][0]
        for terms, *_ in parts[1:]:
            uniq = np.union1d(uniq, terms)
        total = np.zeros(len(uniq), np.int64)
        pos_per_part = []
        for terms, counts, *_ in parts:
            pos = np.searchsorted(uniq, terms)
            pos_per_part.append(pos)
            total[pos] += counts  # pos unique within a part
        offsets = np.zeros(len(uniq) + 1, np.int64)
        np.cumsum(total, out=offsets[1:])
        n_total = int(offsets[-1])
        maxd = max(
            (int(np.asarray(p[2]).max()) for p in parts if len(p[2])),
            default=-1,
        )
        out_d = np.empty(n_total, np.int32 if maxd < (1 << 31) else np.int64)
        out_c = np.empty(n_total, np.int16)
        out_s = np.empty(n_total, np.int16)
        cursor = offsets[:-1].copy()
        from ..native import scatter_runs_native

        for (terms, counts, dnums, tfc, tfs), pos in zip(parts, pos_per_part):
            if not len(dnums):
                continue
            dnums = np.ascontiguousarray(dnums, dtype=out_d.dtype)
            tfc = np.ascontiguousarray(tfc, dtype=np.int16)
            tfs = np.ascontiguousarray(tfs, dtype=np.int16)
            pos = np.ascontiguousarray(pos, dtype=np.int64)
            counts = np.ascontiguousarray(counts, dtype=np.int64)
            # native memcpy-per-run (advances cursor in place); numpy
            # scatter fallback is byte-identical (tests/test_native.py)
            if scatter_runs_native(pos, counts, cursor, dnums, tfc, tfs,
                                   out_d, out_c, out_s):
                continue
            run_starts = np.zeros(len(counts), np.int64)
            np.cumsum(counts[:-1], out=run_starts[1:])
            within = np.arange(len(dnums), dtype=np.int64) - np.repeat(
                run_starts, counts)
            dest = np.repeat(cursor[pos], counts) + within
            out_d[dest] = dnums
            out_c[dest] = tfc
            out_s[dest] = tfs
            cursor[pos] += counts
        return Segment(uniq, offsets, out_d, out_c, out_s)

    def _maybe_merge(self) -> None:
        """Geometric merge policy: similar-sized segments merge (ratio 2),
        and the two smallest always merge past the pool cap — amortized
        O(n log n) over any insert sequence (replaces tantivy's background
        merge machinery, tantivy_store.rs:154-189, minus the crashy thread).
        Segments at MERGE_MAX_POSTINGS are SEALED and leave the merge pool:
        merge transients stay bounded (~2×MERGE_MAX postings) at any corpus
        size; queries bisect a few more segments, which is noise."""
        while True:
            pool = sorted(
                (s for s in self._segments if len(s) < MERGE_MAX_POSTINGS),
                key=len, reverse=True,
            )
            if len(pool) < 2:
                break
            s1, s2 = pool[-1], pool[-2]
            if len(pool) > MAX_SEGMENTS or len(s1) * MERGE_RATIO >= len(s2):
                merged = self._adopt(self._merge_segments([s2, s1]))
                self._segments = [
                    s for s in self._segments if s is not s1 and s is not s2
                ] + [merged]
            else:
                break

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    @property
    def _manifest_path(self) -> Path:
        return self.dir / self.MANIFEST_FILE

    @property
    def _doclog_path(self) -> Path:
        return self.dir / self.DOCLOG_FILE

    _SEG_ARRAYS = ("terms", "offsets", "dnums", "tfc", "tfs")

    def _write_segment(self, seg: Segment) -> None:
        """Persist one immutable segment as a set of .npy files (one per
        array) so reopening can memory-map the posting bulk instead of
        loading it — at 10M docs the postings are GBs that should live in
        page cache, not the heap."""
        for arr_name in self._SEG_ARRAYS:
            tmp = self.dir / f"{seg.name}.{arr_name}.tmp.npy"
            np.save(tmp, np.ascontiguousarray(getattr(seg, arr_name)))
            os.replace(tmp, self.dir / f"{seg.name}.{arr_name}.npy")

    def _mmap_segment(self, seg: Segment) -> None:
        """Swap the posting bulk (dnums/tfc/tfs) for read-only memmaps of
        the just-written files; terms/offsets stay in memory (bisect-hot,
        comparatively tiny)."""
        try:
            seg.dnums = np.load(self.dir / f"{seg.name}.dnums.npy", mmap_mode="r")
            seg.tfc = np.load(self.dir / f"{seg.name}.tfc.npy", mmap_mode="r")
            seg.tfs = np.load(self.dir / f"{seg.name}.tfs.npy", mmap_mode="r")
        except OSError:
            pass  # keep the in-memory arrays (still correct)

    def _load_segment(self, name: str) -> Segment | None:
        if name.endswith(".npz"):
            p = self.dir / name
            if not p.exists():
                return None
            data = np.load(p)
            return Segment(data["terms"], data["offsets"], data["dnums"],
                           data["tfc"], data["tfs"], name=name)
        paths = {a: self.dir / f"{name}.{a}.npy" for a in self._SEG_ARRAYS}
        if not all(p.exists() for p in paths.values()):
            return None
        seg = Segment(
            np.load(paths["terms"]), np.load(paths["offsets"]),
            np.load(paths["dnums"], mmap_mode="r"),
            np.load(paths["tfc"], mmap_mode="r"),
            np.load(paths["tfs"], mmap_mode="r"),
            name=name,
        )
        return seg

    def commit(self) -> None:
        """Flush new postings to a segment, run the merge policy, persist
        changed segments + doc-store sidecar deltas, flip the manifest
        atomically. Doc metadata persists as vectorized sidecars (fixed-
        width docidx + packed liveness bitmap + interned path table) — NO
        per-record msgpack, so reopening a 10M-doc store is three
        np.fromfile calls."""
        if self.readonly:
            return
        with self._lock:
            self._flush_mem()
            self._maybe_merge()
            self.dir.mkdir(parents=True, exist_ok=True)
            # 1. write any memory-only segments, then mmap their bulk
            for seg in self._segments:
                if seg.name is None:
                    seg.name = f"seg-{self._next_seg}"
                    self._next_seg += 1
                    self._write_segment(seg)
                    self._write_tier_sidecar(seg)
                    self._mmap_segment(seg)
            # 2. docidx append (slot order; crash-safe: the manifest's slot
            # count is the valid prefix, stale bytes get overwritten)
            n = self._doc_dnum.n
            if n < self._idx_slots:
                self._idx_slots = 0  # store shrank (clear) — rewrite prefix
            if n > self._idx_slots:
                lo, hi = self._idx_slots, n
                arr = np.empty(hi - lo, DOCIDX_DTYPE)
                arr["dnum"] = self._doc_dnum.view()[lo:hi]
                arr["cid"] = self._doc_cid.view()[lo:hi]
                # docs killed before their first commit write len=1 (the
                # original length is gone once the -1 sentinel lands, and a
                # dead dnum is never revived — liveness is the bitmap's job;
                # writing -1 would poison the reload's len column)
                arr["len"] = np.abs(self._doc_len.view()[lo:hi])
                arr["kid"] = np.clip(self._doc_kid.view()[lo:hi], 0, 32767)
                arr["pid"] = self._doc_pid.view()[lo:hi]
                ip = self.dir / self.DOCIDX_FILE
                mode = "r+b" if ip.exists() else "wb"
                with open(ip, mode) as f:
                    f.seek(lo * DOCIDX_DTYPE.itemsize)
                    arr.tofile(f)
                    f.flush()
                    os.fsync(f.fileno())
                self._idx_slots = n
            # 3. liveness bitmap (full rewrite — 10M docs = 1.25 MB),
            # written to a FRESH sequence-stamped file so the manifest
            # rename stays the ONE commit point (overwriting docvalid.bin
            # in place would commit kills of replaced docs before the
            # manifest commits their replacement slots)
            self._valid_seq += 1
            valid_name = f"docvalid.{self._valid_seq}.bin"
            vb = np.packbits(self._doc_len.view() >= 0)
            tmpv = self.dir / (valid_name + ".tmpv")
            with open(tmpv, "wb") as f:
                vb.tofile(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmpv, self.dir / valid_name)
            # 4. path table append (json-lines, id = line number)
            if self._file_paths > len(self._path_names):
                self._file_paths = 0
                self._paths_bytes = 0
            if len(self._path_names) > self._file_paths:
                # seek to the COMMITTED byte prefix (manifest-recorded), so a
                # crashed append's stale tail is overwritten, never appended
                # after — line-number → path-id mapping stays exact
                pp = self.dir / self.PATHS_FILE
                mode = "r+b" if pp.exists() and self._paths_bytes else "wb"
                with open(pp, mode) as f:
                    f.seek(self._paths_bytes)
                    for p in self._path_names[self._file_paths:]:
                        f.write((json.dumps(p) + "\n").encode("utf-8"))
                    f.truncate()
                    f.flush()
                    os.fsync(f.fileno())
                    self._paths_bytes = f.tell()
                self._file_paths = len(self._path_names)
            # 5. manifest rename = the commit point
            manifest = {
                "version": 4,
                "segments": [s.name for s in self._segments],
                "slots": n,
                "n_paths": len(self._path_names),
                "kind_names": self._kind_names,
                "next_dnum": self._next_dnum,
                "next_seg": self._next_seg,
                "valid_file": valid_name,
                "valid_seq": self._valid_seq,
                "paths_bytes": self._paths_bytes,
            }
            tmpj = self._manifest_path.with_suffix(".tmpj")
            with open(tmpj, "w") as f:
                f.write(json.dumps(manifest))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmpj, self._manifest_path)
            # 6. prune files no longer referenced (merged-away segments,
            # legacy layouts, crashed tmp files)
            keep = set()
            for s in self._segments:
                if s.name.endswith(".npz"):
                    keep.add(s.name)
                else:
                    keep.update(f"{s.name}.{a}.npy" for a in self._SEG_ARRAYS)
                    keep.update(f"{s.name}.xtier.{a}.npy"
                                for a in _XTIER_ARRAYS)
                    keep.add(f"{s.name}.xtier.json")
            for p in (list(self.dir.glob("seg-*.npz"))
                      + list(self.dir.glob("seg-*.npy"))
                      + list(self.dir.glob("seg-*.xtier.json*"))):
                if p.name not in keep:
                    with contextlib.suppress(OSError):
                        p.unlink()
            live_seqs = {s.seq for s in self._segments}
            self._xtier_disk = {k: v for k, v in self._xtier_disk.items()
                                if k in live_seqs}
            for name in (self.LEGACY_INDEX_FILE, self.LEGACY_POSTINGS_FILE,
                         self.DOCLOG_FILE):
                with contextlib.suppress(OSError):
                    (self.dir / name).unlink()
            keep_valid = {valid_name, f"docvalid.{self._valid_seq - 1}.bin"}
            for q in self.dir.glob("docvalid*.bin"):
                # keep the PREVIOUS sequence too: a concurrent reader that
                # already loaded the prior manifest must still find the
                # bitmap it references
                if q.name not in keep_valid:
                    with contextlib.suppress(OSError):
                        q.unlink()
            for p in self.dir.glob("*.tmp*"):
                with contextlib.suppress(OSError):
                    p.unlink()

    def _load(self) -> None:
        mp = self._manifest_path
        if mp.exists():
            try:
                manifest = json.loads(mp.read_text())
            except (OSError, json.JSONDecodeError) as e:
                log.warning("corrupt fts manifest, starting empty: %s", e)
                return
            self._next_dnum = int(manifest.get("next_dnum", 0))
            self._next_seg = int(manifest.get("next_seg", 0))
            for name in manifest.get("segments", []):
                try:
                    seg = self._load_segment(name)
                except Exception as e:
                    log.warning("corrupt fts segment %s — skipped: %s", name, e)
                    continue
                if seg is None:
                    log.warning("missing fts segment %s — skipped", name)
                    continue
                self._segments.append(self._adopt(seg))
            if int(manifest.get("version", 3)) >= 4:
                self._load_doc_sidecars(manifest)
            else:
                self._load_doclog_v3(manifest)
            self._dead_since_flush.clear()
            return
        # ---- legacy round-1 layout (single CSR npz + msgpack doc dict) ----
        lp = self.dir / self.LEGACY_INDEX_FILE
        if lp.exists():
            try:
                with open(lp, "rb") as f:
                    raw = msgpack.unpack(f, raw=False, strict_map_key=False)
                if raw.get("version") == 2:
                    # dnum == chunk id for migrated docs (appended in dnum order)
                    for cid in sorted(int(c) for c in raw["docs"]):
                        v = raw["docs"][cid] if cid in raw["docs"] else raw["docs"][str(cid)]
                        self._add_doc(cid, cid, int(v[0]), v[1], v[2])
                    self._next_dnum = (
                        int(self._doc_dnum.view().max()) + 1
                        if self._doc_dnum.n else 0
                    )
            except Exception as e:
                log.warning("corrupt legacy fts doc store, starting empty: %s", e)
        pz = self.dir / self.LEGACY_POSTINGS_FILE
        if pz.exists():
            try:
                data = np.load(pz)
                self._segments.append(self._adopt(Segment(
                    data["uniq_terms"], data["offsets"], data["p_docs"],
                    data["p_tfc"], data["p_tfs"],
                )))
            except Exception as e:
                log.warning("corrupt legacy fts postings, starting empty: %s", e)
        self._dead_since_flush.clear()

    def _load_doc_sidecars(self, manifest: dict) -> None:
        """v4 open: three vectorized reads — fixed-width docidx, packed
        liveness bitmap, json-lines path table. No per-record decode."""
        slots = int(manifest.get("slots", 0))
        n_paths = int(manifest.get("n_paths", 0))
        self._valid_seq = int(manifest.get("valid_seq", 0))
        self._paths_bytes = int(manifest.get("paths_bytes", 0))
        self._kind_names = list(manifest.get("kind_names", []))
        self._kind_vocab = {k: i for i, k in enumerate(self._kind_names)}
        if not slots:
            self._file_paths = 0
            return
        try:
            idx = np.fromfile(self.dir / self.DOCIDX_FILE, DOCIDX_DTYPE,
                              count=slots)
            vp = self.dir / manifest.get("valid_file", self.DOCVALID_FILE)
            if not vp.exists():
                vp = self.dir / self.DOCVALID_FILE   # pre-stamp layout
            vbits = np.fromfile(vp, np.uint8)
            live = np.unpackbits(vbits)[:slots].astype(bool)
            if len(idx) < slots or len(live) < slots:
                raise ValueError("short doc sidecars")
            names: list[str] = []
            if n_paths:
                with open(self.dir / self.PATHS_FILE, "rb") as f:
                    raw_paths = f.read(self._paths_bytes) if self._paths_bytes \
                        else f.read()
                for line in raw_paths.decode("utf-8").splitlines():
                    names.append(json.loads(line))
                    if len(names) >= n_paths:
                        break
            if len(names) < n_paths:
                raise ValueError("short path table")
            if not self._paths_bytes:
                # pre-cursor manifests: adopt the current file size
                self._paths_bytes = (self.dir / self.PATHS_FILE).stat().st_size \
                    if n_paths else 0
        except (OSError, ValueError, json.JSONDecodeError) as e:
            log.warning("corrupt fts doc sidecars, starting empty: %s", e)
            self.__init_empty()
            return
        self._doc_dnum.extend(idx["dnum"].astype(np.int64))
        # dead docs reload with the -1 sentinel (liveness is authoritative)
        self._doc_len.extend(
            np.where(live, idx["len"].astype(np.int32), -1)
        )
        self._doc_kid.extend(idx["kid"].astype(np.int32))
        self._doc_cid.extend(idx["cid"].astype(np.int64))
        self._doc_pid.extend(idx["pid"].astype(np.int32))
        self._path_names = names
        self._path_vocab = {p: i for i, p in enumerate(names)}
        self._n_live = int(live.sum())
        self._idx_slots = slots
        self._file_paths = n_paths
        if slots:
            self._max_cid = int(idx["cid"].max())
        self._dense_dirty = True

    def _load_doclog_v3(self, manifest: dict) -> None:
        """Legacy v3 (round-2) msgpack doc-log replay — one-time migration;
        the next commit writes the v4 sidecars and deletes the log."""
        log_bytes = int(manifest.get("log_bytes", 0))
        lp = self._doclog_path
        if not (log_bytes and lp.exists()):
            return
        with open(lp, "rb") as f:
            raw = f.read(log_bytes)
        unpacker = msgpack.Unpacker(io.BytesIO(raw), raw=False,
                                    strict_map_key=False)
        for rec in unpacker:
            if rec[0] == "a":
                _, dnum, cid, ln, kind, path = rec
                self._add_doc(int(dnum), int(cid), int(ln), kind, path)
            else:
                self._kill_dnum(int(rec[1]))
        self._idx_slots = 0   # force a full docidx write at next commit

    # ------------------------------------------------------------------
    # dense view + device state
    # ------------------------------------------------------------------

    def _adopt(self, seg: Segment) -> Segment:
        seg.seq = self._seg_seq
        self._seg_seq += 1
        return seg

    def _ensure_dense(self) -> None:
        """Refresh the SLOT-indexed scoring view: O(n) vectorized array
        views (dnums are assigned monotonically and appended in order, so
        the slot view is already sorted — no argsort). Slots are never
        compacted: positions stay stable for the resident device postings;
        liveness is the mask."""
        if not self._dense_dirty:
            return
        lens = self._doc_len.view()
        self._dnums_sorted = self._doc_dnum.view()
        self._live_arr = lens >= 0
        self._len_arr = np.where(self._live_arr, lens, 1).astype(np.float32)
        self._kind_arr = self._doc_kid.view()
        self._cid_arr = self._doc_cid.view()
        n_live = int(self._live_arr.sum())
        self._avg_len = (
            float(self._len_arr[self._live_arr].mean()) if n_live else 1.0
        )
        self._dense_dirty = False

    # ---- placement -----------------------------------------------------------

    def _resident_device(self) -> torch.device:
        """Where the resident arrays live: ``device``, or the lead device of
        the corpus mesh when there is one (BM25 runs once, there; the JAX
        package replicates them over the mesh only to read them inside one
        SPMD program)."""
        mesh = mesh_for(self.device)
        return self.device if mesh is None else mesh.lead

    def _place_repl(self, host_arr: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(host_arr)).to(self._resident_device())

    def _full_repl(self, shape, fill, dtype):
        return torch.full(shape, fill, dtype=_TORCH_DTYPES[np.dtype(dtype)],
                          device=self._resident_device())

    def _seg_bulk(self, seg: Segment):
        """(dnums, tfc, tfs) for a whole segment. For file-backed segments,
        read via np.load WITHOUT mmap: a full pass through an mmap would
        leave every touched page in this process's RSS (ru_maxrss counts
        them), where plain file reads land in anon transients that free."""
        if seg.name and not seg.name.endswith(".npz") \
                and isinstance(seg.dnums, np.memmap):
            try:
                return (
                    np.load(self.dir / f"{seg.name}.dnums.npy"),
                    np.load(self.dir / f"{seg.name}.tfc.npy"),
                    np.load(self.dir / f"{seg.name}.tfs.npy"),
                )
            except OSError:
                pass
        return seg.dnums, seg.tfc, seg.tfs

    def _segment_posting_block(self, seg):
        """(p_pos, p_w) for one immutable segment against the current slot
        view: the posting value packs the doc's kind above its slot; postings
        dead at sync map to PACK_PAD with weight 0."""
        n = self._dnums_sorted.size
        dnums, tfc, tfs = self._seg_bulk(seg)
        pos, found = self._slot_positions(dnums)
        live = (found & self._live_arr[pos]) if n else np.zeros(len(dnums), bool)
        tfb = tfc.astype(np.float32) + _SIG_BOOST * tfs.astype(np.float32)
        len_norm = _K1 * (1.0 - _B + _B * self._len_arr[pos] / self._avg_len) \
            if n else np.ones(len(dnums), np.float32)
        w = tfb * (_K1 + 1.0) / (tfb + len_norm)
        packed = pos.astype(np.int64) | (
            self._kind_arr[pos].astype(np.int64) << SLOT_BITS
        ) if n else pos.astype(np.int64)
        return (np.where(live, packed, PACK_PAD).astype(np.int32),
                np.where(live, w, 0.0).astype(np.float32))

    def _device_rebuild(self):
        """Full resident build: posting arrays at pow2 capacity filled segment
        by segment, plus the packed kind|liveness table."""
        n = self._dnums_sorted.size
        ncap = max(_pow2(n), 1024)
        meta = np.full(ncap, DEAD_SLOT, np.int32)
        meta[:n] = np.where(self._live_arr, self._kind_arr, DEAD_SLOT)
        seg_base: dict[int, int] = {}
        used = 0
        need = CHUNK
        for seg in self._segments:
            seg_base[seg.seq] = used
            # room for a pow2-padded append and a whole CHUNK window past
            # the last posting (the JAX store's capacity rule, kept)
            need = max(need, used + _pow2(max(len(seg), 1)), used + len(seg) + CHUNK)
            used += len(seg)
        pcap = max(_pow2(need), 2048)
        p_pos = self._full_repl((pcap,), PACK_PAD, np.int32)
        p_w = self._full_repl((pcap,), 0.0, np.float32)
        for seg in self._segments:
            bp, bw = self._segment_posting_block(seg)
            p_pos = device_ops.update_1d(p_pos, bp, seg_base[seg.seq])
            p_w = device_ops.update_1d(p_w, bw, seg_base[seg.seq])
        self._dev = (p_pos, p_w, self._place_repl(meta))
        self._dev_state = {
            "ncap": ncap, "pcap": pcap, "used": used, "garbage": 0,
            "seg_base": seg_base, "n_synced": n, "avg_len": self._avg_len,
            "dead_scattered": 0,
            "planes": None, "plane_rows": {}, "plane_free": [],
        }
        self._dev_pending_dead = []
        self.fts_full_uploads += 1
        return self._dev

    def _ensure_device(self):
        """Sync the resident device state, then prewarm score planes for
        the highest-df terms (so a fresh session pays plane scatter builds
        at sync, not inside its first queries). See _ensure_device_sync
        for the sync semantics."""
        dev = self._ensure_device_sync()
        self._prewarm_planes()
        return dev

    def _ensure_device_sync(self):
        """Incremental sync of the resident state: new segments append their
        posting blocks, new docs their meta entries, deletes scatter
        DEAD_SLOT; a full rebuild on capacity overflow, garbage past half,
        avg_len drift past 10% or too many post-sync deletes."""
        self._ensure_dense()
        st = self._dev_state
        if self._dev is None or st is None:
            return self._device_rebuild()
        n = self._dnums_sorted.size
        live_segs = {seg.seq for seg in self._segments}
        new_segs = [seg for seg in self._segments if seg.seq not in st["seg_base"]]
        removed = [sq for sq in st["seg_base"] if sq not in live_segs]
        drift = abs(self._avg_len - st["avg_len"]) / max(st["avg_len"], 1e-9)
        if (
            n > st["ncap"]
            or (n > st["n_synced"]
                and st["n_synced"] + _pow2(n - st["n_synced"]) > st["ncap"])
            or st["used"] + sum(_pow2(max(len(sg), 1)) for sg in new_segs)
            + CHUNK > st["pcap"]
            or drift > 0.10
            or st["garbage"] > 0.5 * max(st["used"], 1)
            or st.get("dead_scattered", 0) + len(self._dev_pending_dead) > DEAD_RESYNC_MAX
        ):
            return self._device_rebuild()
        if not new_segs and not removed and not self._dev_pending_dead \
                and n == st["n_synced"]:
            return self._dev
        p_pos, p_w, meta = self._dev
        if n > st["n_synced"]:
            b = st["n_synced"]
            packed = np.where(self._live_arr[b:n], self._kind_arr[b:n], DEAD_SLOT).astype(np.int32)
            meta = device_ops.update_1d(meta, packed, b)
            st["n_synced"] = n
            self.fts_incremental_updates += 1
        if self._dev_pending_dead:
            meta = device_ops.scatter_fill(meta, self._dev_pending_dead, st["ncap"], DEAD_SLOT)
            st["dead_scattered"] = st.get("dead_scattered", 0) + len(self._dev_pending_dead)
            self._dev_pending_dead = []
            self.fts_incremental_updates += 1
        for sq in removed:
            del st["seg_base"][sq]
        if removed:
            st["garbage"] = st["used"] - sum(
                len(seg) for seg in self._segments if seg.seq in st["seg_base"])
        for seg in new_segs:
            bp, bw = self._segment_posting_block(seg)
            p_pos = device_ops.update_1d(p_pos, bp, st["used"])
            p_w = device_ops.update_1d(p_w, bw, st["used"])
            st["seg_base"][seg.seq] = st["used"]
            st["used"] += len(seg)
            self.fts_incremental_updates += 1
        if new_segs and st.get("plane_rows"):
            for key in list(st["plane_rows"]):
                if any(sg.term_range(key) != (0, 0) for sg in new_segs):
                    st["plane_free"].append(st["plane_rows"].pop(key))
        self._dev = (p_pos, p_w, meta)
        return self._dev

    # ---- score planes ----------------------------------------------------------

    def _term_infos(self, keys, n: int, max_df: float, seg_base: dict):
        """Per-term (key, df, absolute CSR ranges, idf, chunk count) for the
        terms with 0 < df <= max_df; idf counts tombstoned docs too."""
        infos = []
        for key in keys:
            ranges, df = [], 0
            for seg in self._segments:
                slo, shi = seg.term_range(int(key))
                if slo != shi:
                    ranges.append((seg_base[seg.seq] + slo, shi - slo))
                    df += shi - slo
            if df == 0 or df > max_df:
                continue
            t_idf = float(np.log(1.0 + (n - df + 0.5) / (df + 0.5)))
            n_chunks = sum((rln + CHUNK - 1) // CHUNK for _, rln in ranges)
            infos.append((key, df, ranges, t_idf, n_chunks))
        return infos

    def _prewarm_planes(self) -> None:
        """Build score planes for the highest-df terms right after a device
        sync, into free rows only, leaving headroom for query-time terms and
        inserting lowest df first (the LRU evicts those first)."""
        st = self._dev_state
        if not self.planes_enabled or not self.plane_prewarm or st is None:
            return
        sig = (tuple(sorted(sg.seq for sg in self._segments)), self.plane_df_floor)
        if st.get("prewarm_sig") == sig:
            return
        st["prewarm_sig"] = sig
        n = self._dnums_sorted.size
        max_df = max(MAX_DF_RATIO * max(self._n_live, 1), 64.0)
        cand: set[int] = set()
        per_seg_floor = max(1, self.plane_df_floor // max(len(self._segments), 1))
        for seg in self._segments:
            df = np.diff(seg.offsets)
            for i in np.nonzero(df >= per_seg_floor)[0]:
                cand.add(int(seg.terms[i]))
        infos = [it for it in self._term_infos(list(cand), n, max_df, st["seg_base"])
                 if it[1] > self.plane_df_floor]
        if not infos:
            return
        infos.sort(key=lambda it: -it[1])
        rows = st.get("plane_rows") or {}
        cap = self._plane_rows_cap()
        free = len(st["plane_free"]) if st.get("planes") is not None else cap
        budget = max(free - max(2, cap // 8), 0)
        fresh = [it for it in infos if it[0] not in rows][:budget]
        if not fresh:
            return
        try:
            self._ensure_planes(fresh[::-1])
        except torch.OutOfMemoryError as e:
            log.warning("score-plane prewarm failed (%s) — planes stay lazy", e)
            return
        self.plane_prewarms += len(fresh)
        log.info("prewarmed %d score plane(s) at device sync (top df %d)",
                 len(fresh), fresh[0][1])

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return self._n_live

    def _gather_query(self, keys: np.ndarray):
        """Gather CSR ranges for the query terms across all segments.

        Returns (pos [P] i32 into the dense view, contrib [P] f32 — the
        complete BM25 per-posting contribution) with dead postings zeroed.
        All O(P) and fully vectorized."""
        # idf N counts tombstoned docs too (tantivy parity: deleted docs
        # affect term stats until merges purge them) — df ≤ N always, so
        # idf stays positive; the stopword CAP tracks the live corpus
        n_docs = max(self._dnums_sorted.size, 1)
        # floor keeps tiny corpora exhaustive; the cap only bites at scale
        max_df = max(MAX_DF_RATIO * max(self._n_live, 1), 64.0)
        parts_d, parts_c, parts_s, term_lens = [], [], [], []
        for key in keys:
            ranges = []
            tl = 0
            for seg in self._segments:
                lo, hi = seg.term_range(int(key))
                if lo == hi:
                    continue
                ranges.append((seg, lo, hi))
                tl += hi - lo
            # df-cap: near-zero-idf stopword terms dominate gather cost
            if tl == 0 or tl > max_df:
                continue
            for seg, lo, hi in ranges:
                parts_d.append(seg.dnums[lo:hi])
                parts_c.append(seg.tfc[lo:hi])
                parts_s.append(seg.tfs[lo:hi])
            term_lens.append(tl)
        if not parts_d:
            return None
        dnums = np.concatenate(parts_d)
        tfb = (
            np.concatenate(parts_c).astype(np.float32)
            + _SIG_BOOST * np.concatenate(parts_s).astype(np.float32)
        )
        pos, found = self._slot_positions(dnums)
        live = found & self._live_arr[pos]
        # per-term df over RAW segment postings (tombstones included, like
        # tantivy's term stats — deleted docs affect idf until a merge
        # purges them, fts/tantivy_store.rs query path) — keeps host scores
        # byte-consistent with the device path, whose df comes from the
        # same CSR ranges (device_query_args)
        lens = np.asarray(term_lens, np.int64)
        idf = np.log(1.0 + (n_docs - lens + 0.5) / (lens + 0.5))
        idf_rep = np.repeat(idf, lens).astype(np.float32)
        len_norm = _K1 * (1.0 - _B + _B * self._len_arr[pos] / self._avg_len)
        contrib = np.where(
            live, idf_rep * tfb * (_K1 + 1.0) / (tfb + len_norm), 0.0
        ).astype(np.float32)
        return pos.astype(np.int32), contrib

    def search(
        self,
        query: str,
        limit: int = 20,
        boost_kind: str | None = None,
    ) -> list[FtsResult]:
        with self._lock:
            self._flush_mem()
            self._ensure_dense()
            n = self._dnums_sorted.size
            if n == 0:
                return []
            args = None
            if n >= self.device_min_docs:
                # device path: no host-side posting materialization at all
                # (None → host fallback: nothing selected OR too many
                # intervals for the kernel's bounded run reduction)
                args = self.device_query_args(query, boost_kind, limit)
            elif self._n_live:
                log.debug(
                    "BM25 corpus %d docs below device floor %d — host path",
                    self._n_live, self.device_min_docs,
                )
            if args is not None:
                top_scores, top_pos = self._score_device(args, limit)
            else:
                keys = query_term_keys(query)
                if keys.size == 0:
                    return []
                gathered = self._gather_query(keys)
                if gathered is None:
                    return []
                pos, contrib = gathered
                top_scores, top_pos = self._score_host(pos, contrib, boost_kind, limit)
            return self._results_from_slots(top_scores, top_pos)

    def _score_host(self, pos, contrib, boost_kind, limit):
        n = self._dnums_sorted.size
        scores = np.bincount(pos, weights=contrib, minlength=n)
        if boost_kind is not None and boost_kind in self._kind_vocab:
            scores = np.where(
                self._kind_arr == self._kind_vocab[boost_kind],
                scores * _KIND_BOOST, scores,
            )
        k = min(limit, n)
        top = np.argpartition(-scores, k - 1)[:k]
        top = top[np.argsort(-scores[top])]
        return scores[top], top

    # ---- queries -----------------------------------------------------------------

    def device_query_args(self, query: str, boost_kind: str | None, limit: int):
        """Device-scoring inputs for a query against the resident postings:
        CHUNK-aligned (start, live length, idf) slices of the sparse terms,
        the resident tensors, the boost kind id, (k, kpre, imax), and the
        plane weights + buffer for the dense terms. None means "score on the
        host" (small corpus, nothing selected, or over the sparse budget)."""
        with self._lock:
            self._flush_mem()
            self._ensure_dense()
            if self._dnums_sorted.size < self.device_min_docs:
                log.debug("BM25 corpus %d docs below device floor %d — host path",
                          self._dnums_sorted.size, self.device_min_docs)
                return None
            if _pow2(self._dnums_sorted.size) > (1 << SLOT_BITS) \
                    or len(self._kind_names) >= (1 << (31 - SLOT_BITS)) - 1:
                log.debug("BM25 store exceeds packed-posting limits — scoring on host")
                return None
            dev = self._ensure_device()
            n = self._dnums_sorted.size
            if n == 0:
                return None
            keys = query_term_keys(query)
            if keys.size == 0:
                return None
            max_df = max(MAX_DF_RATIO * self._n_live, 64.0)
            infos = self._term_infos(keys, n, max_df, self._dev_state["seg_base"])
            if not infos:
                return None
            dense, sparse = [], []
            if self.planes_enabled:
                for it in infos:
                    (dense if it[1] > self.plane_df_floor else sparse).append(it)
                sparse.sort(key=lambda it: it[4])
                while sparse and sum(it[4] for it in sparse) > self.sparse_chunk_budget:
                    dense.append(sparse.pop())
                rows_cap = self._plane_rows_cap()
                if len(dense) > rows_cap:
                    dense.sort(key=lambda it: it[1])
                    while len(dense) > rows_cap:
                        sparse.append(dense.pop(0))
            else:
                sparse = infos
            pw = planes = None
            if dense:
                try:
                    pw, planes = self._ensure_planes(dense)
                except torch.OutOfMemoryError as e:
                    log.warning("score-plane allocation failed (%s) — disabling planes "
                                "for this session; high-df terms fall back to chunk "
                                "gathers", e)
                    self.planes_enabled = False
                    sparse = sparse + dense
                    dense = []
            if sum(it[4] for it in sparse) > self.sparse_chunk_budget:
                log.warning(
                    "BM25 query %r needs %d posting chunks on the sparse leg "
                    "(budget %d, planes_enabled=%s) — scoring on host",
                    query[:60], sum(it[4] for it in sparse),
                    self.sparse_chunk_budget, self.planes_enabled)
                return None
            cstart, clen, cidf = [], [], []
            n_intervals = 0
            for _key, _df, ranges, t_idf, _nc in sparse:
                n_intervals += len(ranges)
                cs_t, cl_t = _chunk_table(ranges)
                cstart += cs_t
                clen += cl_t
                cidf += [t_idf] * len(cs_t)
            if not cstart and planes is None:
                return None
            if n_intervals > MAX_DEVICE_INTERVALS:
                log.debug("BM25 query %r selects %d intervals (cap %d) — scoring on host",
                          query[:60], n_intervals, MAX_DEVICE_INTERVALS)
                return None
            cpad = max(_pow2(len(cstart)), 8)
            cs_a = np.zeros(cpad, np.int32)
            cl_a = np.zeros(cpad, np.int32)
            ci_a = np.zeros(cpad, np.float32)
            cs_a[: len(cstart)] = cstart
            cl_a[: len(clen)] = clen
            ci_a[: len(cidf)] = cidf
            kid = self._kind_vocab.get(boost_kind, -1) if boost_kind else -1
            k = min(_pow2(max(limit, 1)), dev[2].shape[0])
            dead = self._dev_state.get("dead_scattered", 0)
            kpre = min(_pow2(k + dead), dev[2].shape[0]) if dead else k
            imax = max(_pow2(max(len(sparse), 1)), 4)
            return dev, cs_a, cl_a, ci_a, kid, k, kpre, imax, pw, planes

    def _plane_rows_cap(self) -> int:
        """Plane-buffer rows affordable under the HBM budget at this
        corpus's slot capacity (allocated lazily on first dense routing)."""
        ncap = max(self._dev_state["ncap"], 1)
        return max(4, min(PLANE_ROWS_MAX, (PLANE_HBM_MB << 20) // (4 * ncap)))

    def release_planes(self) -> None:
        """Free the resident score-plane buffer and stop routing high-df
        terms through it for the rest of this process — the HBM-pressure
        escape hatch. SearchSession catches a device out-of-memory error,
        calls this, and retries: high-df terms then fall back to the
        chunk-gather sparse leg (slower per query, but allocation-light —
        no [rows, ncap] buffer, no transient build copy). Bumps
        mutation_count so response caches keyed on device state drop
        entries whose plan held the released buffer."""
        with self._lock:
            st = self._dev_state
            if st is not None:
                st["planes"] = None
                st["plane_rows"] = {}
                st["plane_free"] = []
            self.planes_enabled = False
            self.mutation_count += 1
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _ensure_planes(self, infos) -> tuple[np.ndarray, "object"]:
        """Resolve (building on miss) the resident score planes for this
        query's dense terms; returns (pw [H] f32 — idf at each term's row,
        zeros elsewhere — and the plane buffer). LRU over buffer rows; a
        build replaces the buffer object (functional update, no donation)
        so in-flight queries keep their consistent snapshot — which is also
        what a batched wave's identity check will key on. Caller holds the
        store lock."""
        st = self._dev_state
        if st.get("planes") is None:
            rows_cap = self._plane_rows_cap()
            st["planes"] = self._full_repl(
                (rows_cap, st["ncap"]), 0.0, np.float32
            )
            st["plane_rows"] = {}
            st["plane_free"] = list(range(rows_cap - 1, -1, -1))
        rows: dict = st["plane_rows"]
        pw = np.zeros(st["planes"].shape[0], np.float32)
        missing: list[tuple[int, object]] = []
        for key, _df, ranges, idf, _nc in infos:
            row = rows.pop(key, None)
            if row is None:
                if st["plane_free"]:
                    row = st["plane_free"].pop()
                else:
                    row = rows.pop(next(iter(rows)))  # LRU-oldest row
                    self.plane_evictions += 1
                missing.append((row, ranges))
                self.plane_builds += 1
            rows[key] = row                       # LRU refresh / insert
            pw[row] = idf
        if missing:
            self._build_planes(missing)
        return pw, st["planes"]

    def _build_planes(self, missing: list) -> None:
        """Scatter the missing terms' contributions into their plane rows,
        at most PLANE_BUILD_ROWS rows per call (padding rows target the
        buffer's row count and are dropped)."""
        st = self._dev_state
        p_pos, p_w, _meta = self._dev
        rows_cap = st["planes"].shape[0]
        for g in range(0, len(missing), PLANE_BUILD_ROWS):
            group = missing[g: g + PLANE_BUILD_ROWS]
            tables = [_chunk_table(ranges) for _row, ranges in group]
            cpad = max(_pow2(max(len(t[0]) for t in tables)), 8)
            rpad = _pow2(len(group))
            cs = np.zeros((rpad, cpad), np.int32)
            cl = np.zeros((rpad, cpad), np.int32)
            rw = np.full(rpad, rows_cap, np.int32)
            for i, ((row, _), (cstart, clen)) in enumerate(zip(group, tables)):
                cs[i, : len(cstart)] = cstart
                cl[i, : len(clen)] = clen
                rw[i] = row
            st["planes"] = plane_write_rows(
                st["planes"], p_pos, p_w, self._place_repl(cs),
                self._place_repl(cl), self._place_repl(rw))

    def results_from_device(self, vals, idx, limit: int) -> list[FtsResult]:
        """Map device top-k (scores, dense positions) back to FtsResults."""
        with self._lock:
            return self._results_from_slots(
                np.asarray(vals)[:limit], np.asarray(idx)[:limit]
            )

    def _results_from_slots(self, vals: np.ndarray, slots) -> list[FtsResult]:
        """Vectorized (score, doc-slot) → FtsResult mapping shared by the
        device and host read tails (the per-row loop cost ~1.6 ms/query at
        fetch≈400 on one host core). Filters score>0, slot-in-range, live;
        callers hold the lock."""
        n = self._dnums_sorted.size
        slots = np.asarray(slots).astype(np.int64)
        vals = np.asarray(vals, np.float64)
        keep = (vals > 0) & (slots < n)
        if not keep.all():
            vals, slots = vals[keep], slots[keep]
        if n and len(slots):
            live = self._live_arr[slots]
            if not live.all():
                vals, slots = vals[live], slots[live]
        if not len(slots):
            return []
        kn, pn = self._kind_names, self._path_names
        pids = self._doc_pid.a[slots].tolist()
        return [
            FtsResult(c, s, pn[p], kn[k])
            for c, s, p, k in zip(
                self._cid_arr[slots].tolist(), vals.tolist(),
                pids, self._kind_arr[slots].tolist(),
            )
        ]

    def _score_device(self, args, limit):
        """One BM25 call against the resident postings."""
        dev, cs, cl, ci, kid, k, kpre, imax, pw, planes = args
        vals, idx = bm25_resident_topk(
            dev[0], dev[1], dev[2], self._place_repl(cs), self._place_repl(cl),
            self._place_repl(ci), int(kid), k, kpre, imax,
            pw=self._place_repl(pw) if planes is not None else None, planes=planes)
        vals, idx = to_host(vals, idx)
        return vals[:limit], idx[:limit]

    def search_exact(
        self,
        identifier: str,
        kind: str | None = None,
        limit: int = 20,
    ) -> list[FtsResult]:
        """Exact identifier lookup: signature hits boosted ×3 over content
        hits; AND-ed with kind when provided.

        Scoring matches tantivy's TermQuery semantics
        (tantivy_store.rs:460-524): each field contributes a real BM25 term
        score (tf saturation + length normalization), signature boosted ×3 —
        NOT raw term counts. Raw counts let a long chunk that merely *calls*
        an identifier many times outrank the short chunk that *defines* it;
        saturation caps the caller's tf while the definition keeps the ×3
        signature-field boost.

        High-df terms ("config"/"util" class: df in the millions at 10M
        docs) are served from per-segment impact tiers with an exactness
        bound (see _exact_tier) — the full scan's ~110 ms of random
        len/liveness gathers happens once per (segment, term), not per
        query. The bound-failed fallback is logged, never silent."""
        with self._lock:
            self._flush_mem()
            self._ensure_dense()
            toks = code_tokens(identifier)
            target = None
            for t in toks:
                if t.replace("_", "").isalnum() and ("_" in t or len(t) >= 3):
                    if target is None or len(t) > len(target):
                        target = t
            if target is None:
                return []
            key = _to_i64(stable_u64(target))
            ranges = []
            total = 0
            for seg in self._segments:
                lo, hi = seg.term_range(key)
                if lo != hi:
                    ranges.append((seg, lo, hi))
                    total += hi - lo
            if not ranges:
                return []
            if total > self.exact_tier_df:
                out = self._exact_tiered(key, ranges, kind, limit)
                if out is not None:
                    self.exact_tier_hits += 1
                    return out
                self.exact_tier_fallbacks += 1
                log.debug("exact tier bound failed for %r (df=%d) — "
                          "full posting scan", target, total)
            # vectorized posting gather (same shape as _gather_query): a
            # high-df identifier ("config") at 1M docs selects 10^5+ postings
            # — per-posting Python iteration is index-speed, numpy is µs
            dnums = np.concatenate([s.dnums[lo:hi] for s, lo, hi in ranges])
            tfc = np.concatenate(
                [s.tfc[lo:hi] for s, lo, hi in ranges]).astype(np.float32)
            tfs = np.concatenate(
                [s.tfs[lo:hi] for s, lo, hi in ranges]).astype(np.float32)
            return self._exact_score(dnums, tfc, tfs, kind, limit)

    def _exact_tier(self, seg: Segment, key: int, lo: int, hi: int) -> tuple:
        """Impact tier for one (segment, term): the top ``exact_tier_cap``
        postings by score AT BUILD TIME, stored score-descending with the
        raw fields (dnum, tfc, tfs, len) needed to rescore them exactly
        under the CURRENT corpus stats — build-time stats only pick WHICH
        postings are candidates, never what they score.

        A capped tier also records ``tail`` — an upper bound on the
        build-time score of every excluded posting — and ``avg_built``.
        len_norm scales uniformly with 1/avg_len, so a posting's current
        score is ≤ its build score × max(1, avg_now/avg_built); the caller
        uses that to verify no excluded posting could reach the top-k and
        falls back to the full scan otherwise. Build-time-dead docs are
        dropped outright (dnums never revive). Host analog of tantivy's
        block-max pruning (tantivy_store.rs:460-524)."""
        ck = (seg.seq, key)
        t = self._xtier_cache.pop(ck, None)
        if t is not None:
            self._xtier_cache[ck] = t            # LRU refresh
            return t
        t = self._tier_from_disk(seg, key)
        if t is None:
            t = self._build_tier(seg, lo, hi)
        self._xtier_cache[ck] = t
        while len(self._xtier_cache) > EXACT_TIER_CACHE:
            self._xtier_cache.pop(next(iter(self._xtier_cache)))
        return t

    def _build_tier(self, seg: Segment, lo: int, hi: int) -> tuple:
        """Compute one (segment, term) tier from the raw postings — the
        ~O(df) scan _exact_tier's caching layers exist to avoid."""
        dn = np.asarray(seg.dnums[lo:hi])
        tfc = np.asarray(seg.tfc[lo:hi]).astype(np.float32)
        tfs = np.asarray(seg.tfs[lo:hi]).astype(np.float32)
        pos, found = self._slot_positions(dn)
        live = (found & self._live_arr[pos]) if self._dnums_sorted.size \
            else np.zeros(len(dn), bool)
        dn, tfc, tfs, pos = dn[live], tfc[live], tfs[live], pos[live]
        lens = self._len_arr[pos].astype(np.float32)
        len_norm = _K1 * (1.0 - _B + _B * lens / self._avg_len)
        sat_s = np.where(tfs > 0, tfs * (_K1 + 1.0) / (tfs + len_norm), 0.0)
        sat_c = np.where(tfc > 0, tfc * (_K1 + 1.0) / (tfc + len_norm), 0.0)
        score = _EXACT_SIG_BOOST * sat_s + sat_c
        cap = self.exact_tier_cap
        if len(dn) > cap:
            sel = np.argpartition(-score, cap - 1)[:cap]
            tail = float(score[sel].min())
        else:
            sel = np.arange(len(dn))
            tail = 0.0
        order = sel[np.argsort(-score[sel], kind="stable")]
        return (dn[order], tfc[order], tfs[order], lens[order], tail,
                float(self._avg_len))

    def _tier_sidecar(self, seg: Segment) -> dict | None:
        """Lazy-open the segment's persisted tier sidecar (mmap'd .npy
        columns + a tiny json for the build-time avg_len); None when the
        segment predates sidecars or has no prewarmed terms."""
        sc = self._xtier_disk.get(seg.seq, False)
        if sc is not False:
            return sc
        sc = None
        if seg.name and not seg.name.endswith(".npz"):
            jp = self.dir / f"{seg.name}.xtier.json"
            if jp.exists():
                try:
                    sc = {a: np.load(self.dir / f"{seg.name}.xtier.{a}.npy",
                                     mmap_mode="r")
                          for a in _XTIER_ARRAYS}
                    sc["avg_built"] = float(
                        json.loads(jp.read_text())["avg_built"])
                except (OSError, ValueError, KeyError) as e:
                    log.warning("unreadable tier sidecar for %s (%s) — "
                                "rebuilding tiers on demand", seg.name, e)
                    sc = None
        self._xtier_disk[seg.seq] = sc
        return sc

    def _tier_from_disk(self, seg: Segment, key: int) -> tuple | None:
        sc = self._tier_sidecar(seg)
        if sc is None:
            return None
        keys = sc["keys"]
        i = int(np.searchsorted(keys, key))
        if i >= len(keys) or int(keys[i]) != key:
            return None
        a, b = int(sc["off"][i]), int(sc["off"][i + 1])
        self.exact_tier_disk_hits += 1
        return (np.asarray(sc["dn"][a:b]),
                np.asarray(sc["tfc"][a:b]),
                np.asarray(sc["tfs"][a:b]),
                np.asarray(sc["lens"][a:b]),
                float(sc["tail"][i]), sc["avg_built"])

    def _write_tier_sidecar(self, seg: Segment) -> None:
        """Persist impact tiers for every term in this just-written
        (immutable) segment whose per-segment df reaches the prewarm
        threshold, so a FRESH process serves high-df exact lookups from
        mmap'd candidates instead of paying the first-query posting scan
        (~110-300 ms at df 2.6M, measured r3). Tiers store candidate sets
        + build-time stats only; query-time rescoring, liveness filtering
        and the exactness bound stay exact (see _exact_tier docstring) —
        the same invariants that make the in-process LRU safe across
        later adds/deletes make the on-disk copy safe across processes."""
        df = np.diff(seg.offsets)
        idx = np.nonzero(df >= max(1, self.exact_tier_prewarm_df))[0]
        if idx.size == 0:
            return
        self._ensure_dense()
        parts, tails = [], np.empty(len(idx), np.float32)
        for j, i in enumerate(idx):
            lo, hi = int(seg.offsets[i]), int(seg.offsets[i + 1])
            dn, tfc, tfs, lens, tail, _ = self._build_tier(seg, lo, hi)
            parts.append((dn, tfc, tfs, lens))
            tails[j] = tail
        off = np.zeros(len(idx) + 1, np.int64)
        off[1:] = np.cumsum([len(p[0]) for p in parts])
        arrays = {
            "keys": seg.terms[idx].astype(np.int64),
            "off": off,
            "tail": tails,
            "dn": np.concatenate([p[0] for p in parts]).astype(np.int64),
            "tfc": np.concatenate([p[1] for p in parts]).astype(np.float32),
            "tfs": np.concatenate([p[2] for p in parts]).astype(np.float32),
            "lens": np.concatenate([p[3] for p in parts]).astype(np.float32),
        }
        for a in _XTIER_ARRAYS:
            tmp = self.dir / f"{seg.name}.xtier.{a}.tmp.npy"
            np.save(tmp, np.ascontiguousarray(arrays[a]))
            os.replace(tmp, self.dir / f"{seg.name}.xtier.{a}.npy")
        # json written LAST: its presence gates sidecar use, so a crash
        # mid-write leaves no readable-but-partial sidecar
        tmpj = self.dir / f"{seg.name}.xtier.json.tmp"
        tmpj.write_text(json.dumps({"avg_built": float(self._avg_len)}))
        os.replace(tmpj, self.dir / f"{seg.name}.xtier.json")

    def _exact_tiered(
        self, key: int, ranges: list, kind: str | None, limit: int
    ) -> list[FtsResult] | None:
        """Top-limit over the per-segment impact tiers. Returns None when
        the exactness bound cannot rule out an excluded posting (caller
        runs the full scan)."""
        kid = None
        if kind is not None:
            kid = self._kind_vocab.get(kind)
            if kid is None:
                return []
        parts = []
        bound = 0.0
        for seg, lo, hi in ranges:
            dn, tfc, tfs, lens, tail, avg_built = \
                self._exact_tier(seg, key, lo, hi)
            if tail > 0.0:
                bound = max(bound, tail * max(1.0, self._avg_len / avg_built))
            parts.append((dn, tfc, tfs, lens))
        dn = np.concatenate([p[0] for p in parts])
        tfc = np.concatenate([p[1] for p in parts])
        tfs = np.concatenate([p[2] for p in parts])
        lens = np.concatenate([p[3] for p in parts])
        # byte-identical scoring to _exact_score — lens ARE _len_arr values
        len_norm = _K1 * (1.0 - _B + _B * lens / self._avg_len)
        sat_s = np.where(tfs > 0, tfs * (_K1 + 1.0) / (tfs + len_norm), 0.0)
        sat_c = np.where(tfc > 0, tfc * (_K1 + 1.0) / (tfc + len_norm), 0.0)
        scores = _EXACT_SIG_BOOST * sat_s + sat_c
        pos, found = self._slot_positions(dn)
        n = self._dnums_sorted.size
        keep = (found & self._live_arr[pos]) if n else np.zeros(len(dn), bool)
        if kid is not None:
            keep &= self._kind_arr[pos] == kid
        keep &= scores > 0
        pos, scores = pos[keep], scores[keep]
        if bound > 0.0:
            # some tier was capped: the selection is provably exact only
            # if every excluded posting (score ≤ bound) ties or loses
            # against the limit-th result
            if len(pos) < limit:
                return None
            kth = float(np.partition(scores, len(scores) - limit)
                        [len(scores) - limit])
            if kth < bound:
                return None
        return self._exact_results(pos, scores, limit)

    def _exact_score(
        self, dnums, tfc, tfs, kind: str | None, limit: int
    ) -> list[FtsResult]:
        """TermQuery-style saturation scoring over a posting subset
        (signature field boosted ×3); top-limit results sorted desc."""
        n = self._dnums_sorted.size
        pos, found = self._slot_positions(dnums)
        keep = (found & self._live_arr[pos]) if n else np.zeros(len(dnums), bool)
        if kind is not None:
            kid = self._kind_vocab.get(kind)
            if kid is None:
                return []
            keep &= self._kind_arr[pos] == kid
        len_norm = _K1 * (1.0 - _B + _B * self._len_arr[pos] / self._avg_len)
        sat_s = np.where(tfs > 0, tfs * (_K1 + 1.0) / (tfs + len_norm), 0.0)
        sat_c = np.where(tfc > 0, tfc * (_K1 + 1.0) / (tfc + len_norm), 0.0)
        scores = np.where(keep, _EXACT_SIG_BOOST * sat_s + sat_c, 0.0)
        keep &= scores > 0
        return self._exact_results(pos[keep], scores[keep], limit)

    def _exact_results(
        self, pos: np.ndarray, scores: np.ndarray, limit: int
    ) -> list[FtsResult]:
        """Materialize the top-limit (slot, score) pairs, score-desc."""
        if not len(pos):
            return []
        k = min(limit, len(pos))
        top = np.argpartition(-scores, k - 1)[:k]
        top = top[np.argsort(-scores[top], kind="stable")]
        return [
            FtsResult(
                chunk_id=int(self._cid_arr[p]),
                score=float(s),
                path=self._path_of_slot(int(p)),
                kind=self._kind_names[int(self._kind_arr[p])],
            )
            for s, p in zip(scores[top], pos[top])
        ]

    def stats(self) -> dict:
        """Counts, disk bytes and the serving state: the plane buffer's
        occupancy and build/eviction/prewarm counters, the exact-tier
        sidecars on disk and the tier's hit counters (``stats``, ``doctor``
        and the HTTP ``/status``; the JAX store's keys)."""
        with self._lock:
            extra = [self.dir / self.DOCIDX_FILE, self.dir / self.PATHS_FILE,
                     self._doclog_path] + list(self.dir.glob("docvalid*.bin"))
            disk = sum(f.stat().st_size
                       for f in (list(self.dir.glob("seg-*.npz"))
                                 + list(self.dir.glob("seg-*.npy")) + extra)
                       if f.exists())
            st = self._dev_state or {}
            planes = st.get("planes")
            return {
                "docs": self._n_live,
                "terms": int(sum(len(s.terms) for s in self._segments)),
                "postings": int(sum(len(s) for s in self._segments)) + self._new_terms.n,
                "segments": len(self._segments),
                "disk_bytes": disk,
                "planes_enabled": self.planes_enabled,
                "plane_rows_used": len(st.get("plane_rows") or {}),
                "plane_rows_cap": int(planes.shape[0]) if planes is not None else 0,
                "plane_builds": self.plane_builds,
                "plane_evictions": self.plane_evictions,
                "plane_prewarms": self.plane_prewarms,
                "exact_tier_sidecars": len(list(self.dir.glob("seg-*.xtier.json"))),
                "exact_tier_hits": self.exact_tier_hits,
                "exact_tier_fallbacks": self.exact_tier_fallbacks,
                "exact_tier_disk_hits": self.exact_tier_disk_hits,
            }
