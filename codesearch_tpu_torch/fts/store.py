"""BM25 full-text store with device scoring on torch (device half of
``codesearch_tpu/fts/store.py``).

Segments, the doc store, persistence, host BM25 and exact-identifier
lookups are the JAX store's, reused by subclassing. Overridden here is
everything that touched a JAX array: the resident postings (``p_pos``,
``p_w``) and the packed kind|liveness table (``slot_meta``) live as torch
tensors on ``device``, grow by in-place writes, and are scored by
``ops/bm25.py`` of this package; the resident score planes are a torch
buffer built by its ``plane_write_rows``. The routing rules, capacity
triggers and plane memory knobs keep the JAX store's values.
"""

from __future__ import annotations

import numpy as np
import torch

from codesearch_tpu.fts.store import (
    DEAD_RESYNC_MAX,
    MAX_DEVICE_INTERVALS,
    MAX_DF_RATIO,
    PLANE_BUILD_ROWS,
    FtsResult,
    _B,
    _K1,
    _SIG_BOOST,
    _pow2,
    log,
    query_term_keys,
)
from codesearch_tpu.fts.store import FtsStore as _HostFtsStore

from ..ops.bm25 import (
    CHUNK,
    DEAD_SLOT,
    PACK_PAD,
    SLOT_BITS,
    bm25_resident_topk,
    plane_write_rows,
)
from ..utils.device import resolve_device, to_host
from ..vectordb import device_ops

__all__ = ["FtsResult", "FtsStore"]

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


class FtsStore(_HostFtsStore):
    """BM25 store whose resident device state lives on ``device``."""

    def __init__(self, directory, readonly: bool = False, device=None):
        self.device = resolve_device(device)
        super().__init__(directory, readonly=readonly)

    # ---- placement -----------------------------------------------------------

    def _place_repl(self, host_arr: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(host_arr)).to(self.device)

    def _full_repl(self, shape, fill, dtype):
        return torch.full(shape, fill, dtype=_TORCH_DTYPES[np.dtype(dtype)],
                          device=self.device)

    # ---- resident postings -----------------------------------------------------

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

    def _compile_warm_builds(self, infos) -> None:
        """Nothing to warm: torch runs eagerly, there is no executable to
        compile ahead of a query."""

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

    def release_planes(self) -> None:
        """Drop the plane buffer (the device-memory escape hatch) and hand
        its memory back to the device."""
        super().release_planes()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

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

    def _score_device(self, args, limit):
        """One BM25 call against the resident postings."""
        dev, cs, cl, ci, kid, k, kpre, imax, pw, planes = args
        vals, idx = bm25_resident_topk(
            dev[0], dev[1], dev[2], self._place_repl(cs), self._place_repl(cl),
            self._place_repl(ci), int(kid), k, kpre, imax,
            pw=self._place_repl(pw) if planes is not None else None, planes=planes)
        vals, idx = to_host(vals, idx)
        return vals[:limit], idx[:limit]
