"""Shared server-side read plane on torch (the port of
``codesearch_tpu/server/readplane.py``): the device call + 3-way RRF fusion +
boosts used by both the MCP service and the HTTP server (and their warmups).
The device call is the store's one entry, ``VectorStore.dispatch``, as in
the CLI session (``search/pipeline.py``); planning, featurization and
unpacking around it are assembled here and in the session each on its own
(the session expands query variants, the read plane sends one).

Also home of the serving-side dynamic micro-batcher: concurrent requests
coalesce into ONE batched call (one launch of kernel a or b for the wave's
rows, one batched BM25 call), the analog of inference-server dynamic
batching — a wave of B queries costs one readback wait and one well-fed
kernel instead of B serialized calls. (The reference serves each HTTP
request on its own rayon thread with per-query retrieval,
src/server/mod.rs:484-596.) The variant rows are not padded: the port
compiles nothing per shape.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..fts.store import stack_wave
from ..rerank.fusion import rrf_fusion_with_exact
from ..search.analysis import (
    DOC_PATH_PENALTY,
    TEST_PATH_PENALTY,
    adapt_rrf_k,
    compile_operators,
    detect_identifiers,
    detect_structural_intent,
    is_doc_path,
    is_test_path,
    parse_operators,
    passes_operators,
    query_wants_docs,
    query_wants_tests,
)
from ..search.degrade import dispatch_with_degrade
from ..utils.device import to_host
from ..utils.tracing import span


def _featurize(service, texts: list[str]):
    """Host featurization of query texts (the model's query prefix applied)
    by the embedding backend. The span counts the real token positions and
    the padding beside them."""
    with span("cs.readplane.featurize") as sp:
        feats = service.backend.featurize_queries(
            [service.spec.query_prefix + t for t in texts])
        if sp:
            real = int(np.count_nonzero(feats[1]))
            sp.add(tokens=real, padded=int(feats[1].size) - real)
        return feats


def device_candidates(stores, service, query: str, kind: str | None, fetch: int):
    """One query's device call: embed + vector top-k + BM25 top-k
    (``VectorStore.dispatch``). Returns (vector results, fts results or
    None). Callers hold stores.lock."""
    ids, aux = _featurize(service, [parse_operators(query)[0] or query])
    with span("cs.fts.plan"):
        bm = stores.fts.device_query_args(query, kind, fetch)
    out = stores.store.dispatch(service.backend, ids, aux, fetch, bm)
    if out is None:            # no live row: BM25 is scored on the host
        return [], None
    if bm is None:
        return stores.store._materialize(*out)[0], None
    vv, vi, bv, bi = to_host(*out)
    vres = stores.store._materialize(vv, vi)[0]
    with span("cs.readplane.unpack"):
        fres = stores.fts.results_from_device(bv, bi, fetch)
    return vres, fres


def device_candidates_many(stores, service, items):
    """Batched read plane: B concurrent single-variant queries ride ONE
    device call (batched embed, batched vector top-k, batched BM25).
    ``items`` is [(query, kind, fetch)]; returns a list of (vpairs, fres)
    where vpairs is [(chunk_id, score)] sorted descending and fres is
    [FtsResult] or None (None ⟹ caller falls back to host FTS scoring).
    Semantics per item are identical to device_candidates. Callers hold
    stores.lock."""

    def _single(query, kind, fetch):
        vres, fres = device_candidates(stores, service, query, kind, fetch)
        return [(r.chunk_id, r.score) for r in vres], fres

    if len(items) == 1:
        return [_single(*it) for it in items]
    ids, aux = _featurize(service, [parse_operators(q)[0] or q for q, _, _ in items])
    kvmax = max(fetch for _, _, fetch in items)

    bm_list, hyb_idx = [], []
    for i, (q, kind, fetch) in enumerate(items):
        bm = stores.fts.device_query_args(q, kind, fetch)
        if bm is not None:
            hyb_idx.append(i)
            bm_list.append(bm)

    bm_batch = None
    if bm_list:
        stacked = stack_wave(stores.fts, [items[i] for i in hyb_idx], bm_list)
        if stacked is None:
            return [_single(*it) for it in items]
        bm_batch = stacked[1]
    dev_out = stores.store.dispatch(service.backend, ids, aux, kvmax, bm_batch)
    if dev_out is None:  # store empty
        return [_single(*it) for it in items]
    bv = bi = None
    if bm_batch is None:
        cids, scores = stores.store.rows_to_ids(*dev_out)
    else:
        vv, vi, bv, bi = to_host(*dev_out)
        cids, scores = stores.store.rows_to_ids(vv, vi)

    hi_of = {i: h for h, i in enumerate(hyb_idx)}
    out = []
    for i, (q, kind, fetch) in enumerate(items):
        row_c, row_s = cids[i, :fetch], scores[i, :fetch]
        vpairs = [(int(c), float(s)) for c, s in zip(row_c, row_s) if c >= 0]
        fres = None
        if bv is not None and i in hi_of:
            fres = stores.fts.results_from_device(bv[hi_of[i]], bi[hi_of[i]], fetch)
        out.append((vpairs, fres))
    return out


class DynamicBatcher:
    """Dynamic micro-batching for serving surfaces: the first request to
    arrive becomes the wave leader, waits a short window for followers
    (only when traffic is concurrent — a lone request pays no window),
    then runs the whole wave through device_candidates_many in ONE
    dispatch. Followers that outlive a wave (overflow, or a crashed
    leader) self-promote by polling their position in the queue, so no
    request can strand. Thread-safe; takes stores.lock only around the
    device dispatch."""

    def __init__(self, stores, service, window_s: float = 0.003,
                 max_wave: int = 64):
        self.stores = stores
        self.service = service
        self.window_s = window_s
        self.max_wave = max_wave
        self._mu = threading.Lock()
        self._pending: list[DynamicBatcher._Slot] = []
        self._last_arrival = 0.0
        # observability (reported by /status): waves, the queries they
        # carried, and the seconds those queries waited between get() and
        # their wave's dispatch, summed
        self.waves = 0
        self.batched_queries = 0
        self.queue_wait_s = 0.0

    class _Slot:
        __slots__ = ("query", "kind", "fetch", "arrived", "done", "result", "error")

        def __init__(self, query, kind, fetch):
            self.query, self.kind, self.fetch = query, kind, fetch
            self.arrived = time.monotonic()
            self.done = threading.Event()
            self.result = None
            self.error: BaseException | None = None

    def get(self, query: str, kind: str | None, fetch: int):
        slot = self._Slot(query, kind, fetch)
        with self._mu:
            now = time.monotonic()
            recent = (now - self._last_arrival) < 0.2
            self._last_arrival = now
            self._pending.append(slot)
            leader = self._pending[0] is slot
        if leader:
            return self._lead(slot, wait_window=recent)
        # follower: wait, but self-promote if we reach the queue head
        # (wave overflow or a leader that died before draining us)
        while not slot.done.wait(timeout=0.02):
            with self._mu:
                promote = bool(self._pending) and self._pending[0] is slot
            if promote:
                return self._lead(slot, wait_window=False)
        if slot.error is not None:
            raise slot.error
        return slot.result

    def _lead(self, slot, wait_window: bool):
        if wait_window and self.window_s > 0:
            time.sleep(self.window_s)
        with self._mu:
            wave = self._pending[: self.max_wave]
            del self._pending[: len(wave)]
        try:
            with self.stores.lock:
                dispatched = time.monotonic()
                waited = sum(dispatched - s.arrived for s in wave)
                with self._mu:
                    self.queue_wait_s += waited
                # serving gets the same device-memory degrade as the CLI
                # session: release score planes on device OOM, retry once
                results = dispatch_with_degrade(
                    self.stores.fts,
                    lambda: device_candidates_many(
                        self.stores, self.service,
                        [(s.query, s.kind, s.fetch) for s in wave],
                    ),
                    "serving wave",
                )
        except BaseException as e:
            for s in wave:
                s.error = e
                s.done.set()
            raise
        for s, r in zip(wave, results):
            s.result = r
            s.done.set()
        with self._mu:
            self.waves += 1
            self.batched_queries += len(wave)
        if slot.error is not None:  # pragma: no cover — set only on raise
            raise slot.error
        return slot.result


def rank_candidates(
    stores,
    metadata: dict,
    query: str,
    limit: int,
    kind: str | None,
    vector_k: float,
    fts_k: float,
    vpairs,
    fres,
    filter_path: str | None = None,
):
    """Post-dispatch ranking shared by every serving surface: exact
    identifier matches → adaptive 3-way RRF → language/kind boosts →
    path filter. ``vpairs`` is [(chunk_id, score)]; ``fres`` is
    [FtsResult] or None (None ⟹ host FTS fallback). Returns
    [(score, chunk_id, ChunkMetadata)] sorted desc, truncated to
    ``limit``. Callers hold stores.lock."""
    if fres is None:
        fres = stores.fts.search(query, limit * 3, boost_kind=kind)
    eres = []
    for ident in detect_identifiers(query):
        eres.extend(stores.fts.search_exact(ident, kind=kind, limit=limit * 3))
    fused = rrf_fusion_with_exact(
        vpairs,
        [(r.chunk_id, r.score) for r in fres],
        [(r.chunk_id, r.score) for r in eres],
        vector_k=vector_k, fts_k=fts_k,
    )
    primary = metadata.get("primary_language")
    # quoted spans are hard phrase constraints; -term/-"phrase" are MustNot
    # exclusions (tantivy QueryParser parity) — ONE shared implementation
    # with the session pipeline (analysis.passes_operators)
    _retr, op_requirements, op_exclusions = parse_operators(query)
    req_matchers, excl_matchers = compile_operators(op_requirements, op_exclusions)
    has_ops = bool(req_matchers or excl_matchers)
    wants_tests = query_wants_tests(query)
    wants_docs = query_wants_docs(query)
    scored = []
    with span("cs.rank.materialize"):
        for f in fused:
            meta = stores.store.get_chunk(f.chunk_id)
            if meta is None:
                continue
            if filter_path and filter_path not in meta.path:
                continue
            if has_ops and not passes_operators(
                meta.content, req_matchers, excl_matchers
            ):
                continue
            score = f.rrf_score
            if primary and meta.language == primary:
                score *= 1.2
            if kind and meta.kind == kind:
                score *= 1.15
            if not wants_tests and is_test_path(meta.path):
                score *= TEST_PATH_PENALTY
            if not wants_docs and is_doc_path(meta.path):
                score *= DOC_PATH_PENALTY
            scored.append((score, f.chunk_id, meta))
    scored.sort(key=lambda x: -x[0])
    return scored[:limit]


def ranked_chunks(
    stores,
    service,
    metadata: dict,
    query: str,
    limit: int,
    filter_path: str | None = None,
    batcher: DynamicBatcher | None = None,
):
    """Full hybrid ranking for serving surfaces: fused candidates → exact
    identifier matches → adaptive 3-way RRF → language/kind boosts →
    path filter. Returns [(score, chunk_id, ChunkMetadata)] sorted desc,
    truncated to ``limit``.

    Without ``batcher`` the caller holds stores.lock (MCP's serial stdio
    plane). With ``batcher`` the caller must NOT hold the lock: the device
    dispatch rides the micro-batching wave (which locks internally) and
    only the ranking phase takes the lock here. Spans: ``cs.readplane.query``
    around it all, ``cs.readplane.candidates`` and ``cs.readplane.rank``
    around its two stages."""
    with span("cs.readplane.query"):
        intent = detect_structural_intent(query)
        kind = intent.value if intent else None
        vector_k, fts_k = adapt_rrf_k(query)
        fetch = _serving_fetch(query, limit)
        if batcher is not None:
            with span("cs.readplane.candidates"):
                vpairs, fres = batcher.get(query, kind, fetch)
            with stores.lock, span("cs.readplane.rank"):
                return rank_candidates(
                    stores, metadata, query, limit, kind, vector_k, fts_k,
                    vpairs, fres, filter_path,
                )
        with span("cs.readplane.candidates"):
            vres, fres = dispatch_with_degrade(
                stores.fts,
                lambda: device_candidates(stores, service, query, kind, fetch),
                "serving search",
            )
        with span("cs.readplane.rank"):
            return rank_candidates(
                stores, metadata, query, limit, kind, vector_k, fts_k,
                [(r.chunk_id, r.score) for r in vres], fres, filter_path,
            )


def _serving_fetch(query: str, limit: int) -> int:
    """Serving retrieval depth: limit*3 normally; deepened when operator
    constraints prune after retrieval (a rare exact phrase whose terms
    are common must still be reachable in the pool)."""
    _r, phrases, exclusions = parse_operators(query)
    if phrases or exclusions:
        return max(limit * 3, 200)
    return limit * 3


def ranked_chunks_wave(
    stores,
    service,
    metadata: dict,
    requests: list[tuple],
):
    """Batch ranking for an assembled wave: ``requests`` is
    [(query, limit, filter_path)] — every query rides ONE batched fused
    dispatch (device_candidates_many) with its OWN retrieval depth, then
    each is ranked independently. Serving surfaces that receive pipelined
    request groups (MCP parallel tool calls, HTTP ``queries`` bodies) call
    this; concurrent single-query requests get the same batching
    implicitly via DynamicBatcher. Takes stores.lock internally."""
    plans = []
    for q, limit, filter_path in requests:
        intent = detect_structural_intent(q)
        kind = intent.value if intent else None
        vector_k, fts_k = adapt_rrf_k(q)
        plans.append((q, limit, filter_path, kind, vector_k, fts_k))
    with stores.lock:
        cands = dispatch_with_degrade(
            stores.fts,
            lambda: device_candidates_many(
                stores, service,
                [(q, kind, _serving_fetch(q, limit))
                 for q, limit, _, kind, _, _ in plans],
            ),
            "serving wave",
        )
        return [
            rank_candidates(
                stores, metadata, q, limit, kind, vector_k, fts_k,
                vpairs, fres, filter_path,
            )
            for (q, limit, filter_path, kind, vector_k, fts_k),
                (vpairs, fres) in zip(plans, cands)
        ]


def ranked_chunks_many(
    stores,
    service,
    metadata: dict,
    queries: list[str],
    limit: int,
    filter_path: str | None = None,
):
    """Uniform-limit convenience wrapper over ranked_chunks_wave."""
    return ranked_chunks_wave(
        stores, service, metadata, [(q, limit, filter_path) for q in queries]
    )
