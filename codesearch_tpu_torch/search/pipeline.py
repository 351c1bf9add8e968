"""Search pipeline on torch — the read plane (the port of
``codesearch_tpu/search/pipeline.py``; parity with src/search/mod.rs:409-1053).

query → host planning (operators, depth, variant expansion, featurization:
hash features, or token ids and mask for a BERT-family model) → ONE device
call: variant embedding + exact vector top-k (+ resident BM25 top-k in
hybrid mode), whose result arrays are read back together → best-score-per-
chunk dedup → early termination to vector-only on a confident top-5 →
hybrid: BM25 + per-identifier exact match + adaptive 3-way RRF → path
filter → primary-language boost ×1.2 → kind boost ×1.15 → with
``rerank``, the neural rerank blend of the top candidates (the cross-encoder
on the session's device, or its weights-free proxy) and the path filter
again. ``search_many`` answers a wave of queries from one device call
(rerank waves query by query, as the JAX session does).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..embed import EmbeddingService
from ..fts import FtsStore
from ..fts.store import stack_wave
from ..index.db_discovery import resolve_database_with_message
from ..index.pipeline import read_metadata
from ..rerank.fusion import rrf_fusion_with_exact, vector_only
from ..rerank.neural import NeuralReranker
from ..utils.constants import EMBEDDER_VERSION, FTS_DIR_NAME
from ..utils.device import resolve_device, to_host
from ..utils.errors import SearchError
from ..utils.tracing import stage
from ..vectordb import VectorStore
from .analysis import (
    DOC_PATH_PENALTY,
    TEST_PATH_PENALTY,
    adapt_rrf_k,
    compile_operators,
    detect_identifiers,
    detect_structural_intent,
    expand_query,
    is_doc_path,
    is_test_path,
    parse_operators,
    passes_operators,
    query_wants_docs,
    query_wants_tests,
)
from .degrade import dispatch_with_degrade

__all__ = ["SearchHit", "SearchOptions", "SearchResponse", "SearchSession", "search",
           "search_all"]

EARLY_TERMINATION_SCORE = 0.85   # top-5 similarity (ref: distance < 0.15)
LANGUAGE_BOOST = 1.2
KIND_BOOST = 1.15
RESPONSE_CACHE_MAX = 128         # fused responses kept per session


class ResponseCache:
    """Small LRU for fused search responses, keyed on query/options plus
    store mutation counters. Values are stored and returned as copies deep
    enough that caller mutation (rescoring hits, annotating timings,
    appending to context lists) cannot poison the cache. Shared by
    SearchSession and the MCP service (whose values are result dicts)."""

    def __init__(self, max_entries: int = RESPONSE_CACHE_MAX):
        self._d: OrderedDict = OrderedDict()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _copy(value):
        if isinstance(value, dict):   # MCP result dicts
            return {**value, "results": [{**r} for r in value.get("results", [])]}
        return dataclasses.replace(
            value,
            hits=[dataclasses.replace(h, context=list(h.context)) for h in value.hits],
            timings_ms=dict(value.timings_ms),
        )

    def get(self, key):
        v = self._d.get(key)
        if v is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return self._copy(v)

    def clear(self) -> None:
        self._d.clear()

    def put(self, key, value) -> None:
        self._d[key] = self._copy(value)
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)


@dataclass
class SearchOptions:
    limit: int = 10
    mode: str = "hybrid"          # "hybrid" | "vector"
    rerank: bool = False
    path_filter: str | None = None
    min_score: float | None = None
    model: str | None = None
    sync: bool = False
    # parity: the reference auto-creates a missing index (search/mod.rs:413-435)
    create_index: bool = True
    no_expand: bool = False
    rrf_k: float | None = None      # fixed RRF k override (search/mod.rs:640)
    rerank_top: int | None = None   # candidates to rerank (search/mod.rs:712)
    per_file: int | None = None     # max hits per file (search/mod.rs:1007)
    # explicit db location (the global --store flag; skips discovery —
    # the reference declares the flag but never consumes it, cli/mod.rs:71)
    store_path: Path | None = None


@dataclass
class SearchHit:
    chunk_id: int
    score: float
    path: str
    start_line: int
    end_line: int
    kind: str
    signature: str | None
    content: str
    context: list[str] = field(default_factory=list)
    docstring: str | None = None
    language: str | None = None
    vector_score: float | None = None
    fts_score: float | None = None


@dataclass
class SearchResponse:
    hits: list[SearchHit]
    query: str
    mode: str
    total_chunks: int
    timings_ms: dict[str, float] = field(default_factory=dict)
    db_path: str = ""
    # "cross-encoder" | "proxy-bi-encoder" when --rerank ran, else None —
    # degraded (weights-free) reranking must be visible (VERDICT r1 item 6)
    rerank_mode: str | None = None


class SearchSession:
    """Open stores + embedding service on ``device`` for repeated queries
    (the reference reopens per CLI call; servers keep this warm)."""

    def __init__(self, db_path: Path, model: str | None = None,
                 readonly: bool = True, device=None):
        db_path = Path(db_path)
        meta = read_metadata(db_path)
        if meta and meta.get("embedder_version", 1) != EMBEDDER_VERSION:
            raise SearchError(
                f"index at {db_path} was built with embedder "
                f"v{meta.get('embedder_version', 1)} (current v{EMBEDDER_VERSION}) "
                "— run `codesearch index --force` to rebuild")
        model_name = model or meta.get("model") or "code-hash-384"
        dims = int(meta.get("dimensions", 384))
        self.device = resolve_device(device)
        self.db_path = db_path
        self.metadata = meta
        self.service = EmbeddingService(model_name, db_path=db_path, device=self.device)
        if self.service.dims != dims:
            raise SearchError(f"model {model_name} has {self.service.dims} dims "
                              f"but index was built with {dims}")
        self.store = VectorStore(db_path, dims=dims, readonly=readonly,
                                 int8=bool(meta.get("int8", False)), device=self.device)
        self.fts = FtsStore(db_path / FTS_DIR_NAME, readonly=readonly, device=self.device)
        # the cross-encoder, built on the first rerank query
        self.reranker: NeuralReranker | None = None
        # response LRU keyed on the options + store mutation counters (any
        # index change invalidates); agents (the MCP consumer) repeat queries
        self._resp_cache = ResponseCache()

    def search(self, query: str, options: SearchOptions | None = None) -> SearchResponse:
        return self._search_impl(query, options)

    def _cache_key(self, query: str, o: SearchOptions) -> tuple:
        return (
            query, o.limit, o.mode, o.rerank, o.path_filter, o.min_score,
            o.no_expand, o.rrf_k, o.rerank_top, o.per_file,
            self.store.mutation_count, self.fts.mutation_count,
        )

    def _search_impl(self, query: str, options: SearchOptions | None = None) -> SearchResponse:
        return dispatch_with_degrade(
            self.fts, lambda: self._search_attempt(query, options), "search"
        )

    def _search_attempt(self, query: str, options: SearchOptions | None = None) -> SearchResponse:
        options = options or SearchOptions()
        if not query or not query.strip():
            raise SearchError("empty query")
        key = self._cache_key(query, options)
        cached = self._resp_cache.get(key)
        if cached is not None:
            cached.timings_ms["cached"] = True
            return cached
        with stage("cs.search.query") as whole:
            resp = self._search_fresh(query, options, whole)
        self._resp_cache.put(key, resp)
        return resp

    def _search_fresh(self, query: str, options: SearchOptions, whole) -> SearchResponse:
        """One query past the response cache. Its ``timings_ms`` are the
        stages' spans on the monotonic clock: ``embed`` (featurization and
        BM25 planning, host only), ``vector`` (the device call to the
        readback of its results and their unpacking), ``fusion`` (host),
        ``rerank`` (the cross-encoder, to its scores on the host), ``total``
        (``whole``)."""
        timings: dict[str, float] = {}
        with stage("cs.search.featurize") as t:
            st = self._prep_query(query, options)
        timings["embed"] = t.ms
        identifiers, intent, fetch = st["identifiers"], st["intent"], st["fetch"]
        feats, bm_args = st["feats"], st["bm"]
        fused_fts = None
        exact_prefetched = None
        with stage("cs.search.dispatch") as t:
            out = self.store.dispatch(self.service.backend, *feats, fetch, bm_args)
            if bm_args is not None and identifiers and options.mode == "hybrid":
                # the device call is queued: run the host-side exact-identifier
                # scans while it computes
                exact_prefetched = []
                for ident in identifiers:
                    exact_prefetched.extend(self.fts.search_exact(
                        ident, kind=intent.value if intent else None, limit=fetch))
            if out is None:    # no live row: no hits from either device leg
                vector_ranked = []
                fused_fts = [] if bm_args is not None else None
            elif bm_args is None:
                vector_ranked = self._dedup_raw(self.store.rows_to_ids(*out), fetch)
            else:
                vv, vi, bv, bi = to_host(*out)
                raw = self.store.rows_to_ids(vv, vi)
                fused_fts = self.fts.results_from_device(bv, bi, fetch)
                vector_ranked = self._dedup_raw(raw, fetch)
        timings["vector"] = t.ms
        return self._finish(
            query, options, identifiers, intent, st["vk"], st["fk"], fetch,
            vector_ranked, fused_fts, exact_prefetched, timings, whole)

    @staticmethod
    def _dedup_raw(raw, fetch: int) -> list[tuple[int, float]]:
        """Vectorized best-score-per-chunk across variants
        (search/mod.rs:513-590): at the reference's fusion depth (≤9
        variants × 256 candidates) per-result Python objects cost
        milliseconds on one host core — keep it all in numpy."""
        cids, scores = raw
        flat_i = cids.ravel()
        flat_s = scores.ravel().astype(np.float64)
        keep = flat_i >= 0
        flat_i, flat_s = flat_i[keep], flat_s[keep]
        if not flat_i.size:
            return []
        order = np.lexsort((-flat_s, flat_i))
        fi, fs = flat_i[order], flat_s[order]
        first = np.ones(len(fi), bool)
        first[1:] = fi[1:] != fi[:-1]
        bi_, bs_ = fi[first], fs[first]
        top = np.argsort(-bs_, kind="stable")[:fetch]
        return list(zip(bi_[top].tolist(), bs_[top].tolist()))

    def _finish(
        self, query, options, identifiers, intent, vector_k, fts_k, fetch,
        vector_ranked, fused_fts, exact_prefetched, timings, whole,
    ) -> SearchResponse:
        """Post-retrieval stages: early termination → fusion →
        boost-bounded lazy materialization → filters → optional rerank →
        response. ``whole`` is the open stage whose time so far is the
        response's ``total``."""
        # ---- early termination (search/mod.rs:595-621) -------------------
        top5 = [s for _, s in vector_ranked[:5]]
        confident = len(top5) >= 5 and min(top5) > EARLY_TERMINATION_SCORE
        use_hybrid = options.mode == "hybrid" and not confident

        with stage("cs.search.fusion") as t:
            if use_hybrid:
                fts_results = fused_fts if fused_fts is not None else self.fts.search(
                    query, limit=fetch,
                    boost_kind=intent.value if intent else None,
                )
                if exact_prefetched is not None:
                    exact_results = exact_prefetched
                else:
                    exact_results = []
                    for ident in identifiers:
                        exact_results.extend(
                            self.fts.search_exact(
                                ident, kind=intent.value if intent else None,
                                limit=fetch,
                            )
                        )
                fused = rrf_fusion_with_exact(
                    vector_ranked,
                    [(r.chunk_id, r.score) for r in fts_results],
                    [(r.chunk_id, r.score) for r in exact_results],
                    vector_k=vector_k, fts_k=fts_k,
                )
            else:
                fused = vector_only(vector_ranked)
        timings["fusion"] = t.ms

        # ---- materialize hits (incl. FTS-only chunks), boosts inline -----
        # Metadata reads are lazy preads at corpus scale (vectordb/store.py)
        # — materializing EVERY fused candidate (200-400) costs real ms on
        # one host core. Candidates arrive sorted by rrf_score, and the
        # language ×1.2 / kind ×1.15 boosts (search/mod.rs:789-806, 238-252)
        # can inflate a score at most ×1.38 — so once the `need`-th best
        # boosted score exceeds remaining_rrf × 1.38, no later candidate can
        # enter the result and materialization stops, EXACTLY. Post-filters
        # (path/min-score/per-file) prune after retrieval, so their presence
        # disables the early exit (they need the full pool to refill from).
        primary = self.metadata.get("primary_language")
        boost_cap = LANGUAGE_BOOST * KIND_BOOST
        # quoted spans are hard phrase constraints and -term/-"phrase" are
        # MustNot exclusions (tantivy QueryParser parity): checked at
        # materialization since the index is position-free
        _retr, op_requirements, op_exclusions = parse_operators(query)
        req_matchers, excl_matchers = compile_operators(
            op_requirements, op_exclusions
        )
        wants_tests = query_wants_tests(query)
        wants_docs = query_wants_docs(query)
        has_ops = bool(req_matchers or excl_matchers)
        unbounded = bool(
            options.path_filter or options.min_score is not None
            or (options.per_file or 0) > 0 or has_ops
        )
        if options.rerank:
            need = max(options.rerank_top if options.rerank_top is not None
                       else 0, 100, options.limit)
        else:
            need = options.limit
        top_scores: list[float] = []   # min-heap of the best `need` scores
        hits: list[SearchHit] = []
        for f in fused:
            if (
                not unbounded
                and len(top_scores) >= need
                and f.rrf_score * boost_cap < top_scores[0]
            ):
                break
            meta = self.store.get_chunk(f.chunk_id)
            if meta is None:
                continue
            if has_ops and not passes_operators(
                meta.content, req_matchers, excl_matchers
            ):
                continue
            score = f.rrf_score
            if primary and meta.language == primary:
                score *= LANGUAGE_BOOST
            if intent is not None and meta.kind == intent.value:
                score *= KIND_BOOST
            if not wants_tests and is_test_path(meta.path):
                score *= TEST_PATH_PENALTY
            if not wants_docs and is_doc_path(meta.path):
                score *= DOC_PATH_PENALTY
            hits.append(
                SearchHit(
                    chunk_id=f.chunk_id,
                    score=score,
                    path=meta.path,
                    start_line=meta.start_line,
                    end_line=meta.end_line,
                    kind=meta.kind,
                    signature=meta.signature,
                    content=meta.content,
                    context=meta.context,
                    docstring=meta.docstring,
                    language=meta.language,
                    vector_score=f.vector_score,
                    fts_score=f.fts_score,
                )
            )
            if len(top_scores) < need:
                heapq.heappush(top_scores, score)
            elif score > top_scores[0]:
                heapq.heapreplace(top_scores, score)

        # ---- path filter (pre-rerank, search/mod.rs:698-745) -------------
        if options.path_filter:
            needle = options.path_filter
            hits = [h for h in hits if needle in h.path]

        hits.sort(key=lambda h: -h.score)

        # ---- neural rerank blend (search/mod.rs:829-866) -----------------
        rerank_mode: str | None = None
        if options.rerank and hits:
            with stage("cs.search.rerank") as t:
                if self.reranker is None:
                    self.reranker = NeuralReranker(device=self.device)
                rerank_mode = self.reranker.model.mode
                n_rerank = (max(options.rerank_top, 0)
                            if options.rerank_top is not None
                            else max(100, options.limit))
                cands = hits[:n_rerank]
                reranked = self.reranker.rerank_and_blend(
                    query,
                    [(h.chunk_id, h.signature or h.content[:512]) for h in cands],
                    {h.chunk_id: h.score for h in cands},
                )
                order = {r.chunk_id: (i, r.final_score) for i, r in enumerate(reranked)}
                cands.sort(key=lambda h: order.get(h.chunk_id, (len(order), 0.0))[0])
                for h in cands:
                    if h.chunk_id in order:
                        h.score = order[h.chunk_id][1]
                hits = cands + hits[len(cands):]
            timings["rerank"] = t.ms
            # path filter re-applied post-rerank (search/mod.rs:869-882)
            if options.path_filter:
                needle = options.path_filter
                hits = [h for h in hits if needle in h.path]

        if options.min_score is not None:
            hits = [h for h in hits if h.score >= options.min_score]
        if options.per_file is not None and options.per_file > 0:
            seen_per_file: dict[str, int] = {}
            capped = []
            for h in hits:
                c = seen_per_file.get(h.path, 0)
                if c < options.per_file:
                    capped.append(h)
                    seen_per_file[h.path] = c + 1
            hits = capped
        hits = hits[: options.limit]
        timings["total"] = whole.elapsed_ms()
        return SearchResponse(
            hits=hits,
            query=query,
            mode="vector" if not use_hybrid else "hybrid",
            total_chunks=len(self.store),
            timings_ms=timings,
            db_path=str(self.db_path),
            rerank_mode=rerank_mode,
        )

    def _prep_query(self, query: str, options: SearchOptions) -> dict:
        """Host-side planning, as the JAX session's: operator parsing,
        adaptive retrieval depth, variant expansion, featurization (hash
        features, or token ids and mask for a BERT-family model) and the BM25
        interval table."""
        if not query or not query.strip():
            raise SearchError("empty query")
        retrieval, phrases, exclusions = parse_operators(query)
        retrieval = retrieval or query
        identifiers = detect_identifiers(retrieval)
        intent = detect_structural_intent(retrieval)
        if options.rrf_k is not None:
            vector_k = fts_k = float(options.rrf_k)
        else:
            vector_k, fts_k = adapt_rrf_k(retrieval)
        variants = [retrieval] if options.no_expand else expand_query(retrieval)
        if options.mode == "vector":
            fetch = options.limit * 3
        elif identifiers:
            fetch = max(options.limit * 3, 100)
        else:
            fetch = max(options.limit * 5, 200)
        if phrases or exclusions:
            fetch = max(fetch, 500)
        feats = self.service.backend.featurize_queries(
            [self.service.spec.query_prefix + v for v in variants])
        bm_args = None
        if options.mode == "hybrid":
            bm_args = self.fts.device_query_args(
                query, intent.value if intent else None, fetch)
        return {
            "query": query, "identifiers": identifiers, "intent": intent,
            "vk": vector_k, "fk": fts_k, "fetch": fetch, "feats": feats,
            "bm": bm_args, "variants": variants,
        }

    def search_many(self, queries: list[str],
                    options: SearchOptions | None = None) -> list[SearchResponse]:
        """Batched serving path: the whole WAVE of queries rides ONE device
        call — every query's variants concatenated into one [Qtot, T] embed
        + top-k batch (one launch of kernel a or b), every query's BM25
        interval table stacked into one [B, C] batched call — then one
        readback for the wave. Host exact-identifier scans run while the
        device works. Each query's results are trimmed to its own retrieval
        depth, so the answers equal per-query ``search``. The rows are not
        padded: the port compiles nothing per shape."""
        return dispatch_with_degrade(
            self.fts, lambda: self._search_many_attempt(queries, options),
            "batched search")

    def _cached_or_prep(self, queries, options):
        """(responses with the cached ones filled in, per-query plans or None
        where cached)."""
        out: list[SearchResponse | None] = [None] * len(queries)
        pending: list[dict | None] = []
        for qi, query in enumerate(queries):
            if not query or not query.strip():
                raise SearchError("empty query")
            key = self._cache_key(query, options)
            cached = self._resp_cache.get(key)
            if cached is not None:
                cached.timings_ms["cached"] = True
                out[qi] = cached
                pending.append(None)
                continue
            st = self._prep_query(query, options)
            st["key"] = key
            pending.append(st)
        return out, pending

    def _exact_scans(self, plans) -> None:
        """The host exact-identifier scans of the hybrid plans, run while
        the device computes."""
        for st in plans:
            if st["bm"] is None or not st["identifiers"]:
                continue
            kind = st["intent"].value if st["intent"] else None
            exact = []
            for ident in st["identifiers"]:
                exact.extend(self.fts.search_exact(ident, kind=kind, limit=st["fetch"]))
            st["exact"] = exact

    def _respond(self, st, options, vector_ranked, fused_fts, wave) -> SearchResponse:
        resp = self._finish(
            st["query"], options, st["identifiers"], st["intent"], st["vk"], st["fk"],
            st["fetch"], vector_ranked, fused_fts, st.get("exact"), {}, wave)
        self._resp_cache.put(st["key"], resp)
        return resp

    def _search_many_attempt(self, queries, options=None) -> list[SearchResponse]:
        options = options or SearchOptions()
        if options.rerank:
            return [self.search(q, options) for q in queries]
        with stage("cs.search.wave") as wave:
            return self._search_wave(queries, options, wave)

    def _search_wave(self, queries, options, wave) -> list[SearchResponse]:
        """The wave's one device call; each response's ``total`` is the
        wave's time up to it (``wave``, an open stage)."""
        out, pending = self._cached_or_prep(queries, options)
        live = [st for st in pending if st is not None]
        if not live:
            return out  # type: ignore[return-value]

        # ---- assemble ONE device call for the whole wave -------------------
        tmax = max(st["feats"][0].shape[1] for st in live)
        qtot = sum(st["feats"][0].shape[0] for st in live)
        ids_all = np.zeros((qtot, tmax), np.int32)
        aux_all = np.zeros((qtot, tmax), live[0]["feats"][1].dtype)
        row = 0
        for st in live:
            f_ids, f_aux = st["feats"]
            v, t = f_ids.shape
            ids_all[row:row + v, :t] = f_ids
            aux_all[row:row + v, :t] = f_aux
            st["rows"] = (row, row + v)
            row += v
        kvmax = max(st["fetch"] for st in live)
        hyb = [st for st in live if st["bm"] is not None]
        for hi, st in enumerate(hyb):
            st["hi"] = hi
        bm_batch = None
        if hyb:
            stacked = stack_wave(
                self.fts, [(st["query"], st["intent"].value if st["intent"] else None,
                            st["fetch"]) for st in hyb], [st["bm"] for st in hyb])
            if stacked is None:
                return self._search_many_waves(queries, options)
            for st, bm in zip(hyb, stacked[0]):
                st["bm"] = bm
            bm_batch = stacked[1]
        dev_out = self.store.dispatch(self.service.backend, ids_all, aux_all, kvmax, bm_batch)
        if dev_out is None:   # the store emptied under us
            return self._search_many_waves(queries, options)
        self._exact_scans(hyb)
        bv = bi = None
        if bm_batch is None:
            raw_all = self.store.rows_to_ids(*dev_out)
        else:
            vv, vi, bv, bi = to_host(*dev_out)
            raw_all = self.store.rows_to_ids(vv, vi)
        cids_all, scores_all = raw_all
        for qi, st in enumerate(pending):
            if st is None:
                continue
            rs, re_ = st["rows"]
            fq = st["fetch"]
            # each query's own depth: candidates are sorted descending, so the
            # [:fq] prefix IS that query's top-fq
            vector_ranked = self._dedup_raw((cids_all[rs:re_, :fq], scores_all[rs:re_, :fq]), fq)
            fused_fts = None
            if st["bm"] is not None:
                fused_fts = self.fts.results_from_device(bv[st["hi"]], bi[st["hi"]], fq)
            out[qi] = self._respond(st, options, vector_ranked, fused_fts, wave)
        return out  # type: ignore[return-value]

    def _search_many_waves(self, queries, options=None) -> list[SearchResponse]:
        """Query by query: the fallback when the one-call wave cannot run
        (the epoch moved twice, the store emptied)."""
        return [self.search(q, options) for q in queries]


def search(query: str, path: str | Path = ".", options: SearchOptions | None = None,
           device=None) -> SearchResponse:
    """One-shot search: resolve the database (building it when missing and
    ``create_index`` is set, refreshing it with ``sync``), then query."""
    from ..index.pipeline import IndexOptions, index

    options = options or SearchOptions()
    if options.store_path is not None:
        db = Path(options.store_path)
        if not (db / "metadata.json").exists():
            raise SearchError(f"--store {db} is not a codesearch database")
        return SearchSession(db, model=options.model, device=device).search(query, options)
    db, message = resolve_database_with_message(Path(path))
    if db is None:
        if not options.create_index:
            raise SearchError(message)
        db = index(path, IndexOptions(model=options.model or "code-hash-384"),
                   device=device).db_path
    elif options.sync:
        index(path, IndexOptions(quiet=True), device=device)
    return SearchSession(db, model=options.model, device=device).search(query, options)


def search_all(query: str, path: str | Path = ".", options: SearchOptions | None = None,
               device=None) -> list[tuple[str, "SearchResponse | Exception"]]:
    """Federated search: the same query against every index discoverable
    from ``path`` (cwd, children, parents and the global registry: the set
    ``list`` reports), each through its own session on ``device``. Results
    stay grouped per database, since RRF scores compare only within one
    corpus. A database that fails to open or to answer (a stale embedder
    version, corruption) contributes its exception instead of ending the
    rest."""
    from ..index.db_discovery import find_databases

    device = resolve_device(device)
    options = options or SearchOptions()
    out: list[tuple[str, SearchResponse | Exception]] = []
    for db in find_databases(Path(path)):
        try:
            out.append((str(db), SearchSession(db, device=device).search(query, options)))
        except Exception as e:  # per-database isolation
            out.append((str(db), e))
    return out
