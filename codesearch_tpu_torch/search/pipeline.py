"""Search pipeline on torch — the read plane (the port of
``codesearch_tpu/search/pipeline.py``; parity with src/search/mod.rs:409-1053).

query → host planning (operators, depth, variant expansion, featurization:
hash features, or token ids and mask for a BERT-family model) → ONE device
call: variant embedding + exact vector top-k (+ resident BM25 top-k in
hybrid mode), whose result arrays are read back together → best-score-per-
chunk dedup → early termination to vector-only on a confident top-5 →
hybrid: BM25 + per-identifier exact match + adaptive 3-way RRF → path
filter → primary-language boost ×1.2 → kind boost ×1.15. Batched waves
(``search_many``) and neural reranking are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..embed import EmbeddingService
from ..fts import FtsStore
from ..fts.store import DEAD_RESYNC_MAX
from ..index.db_discovery import resolve_database_with_message
from ..index.pipeline import read_metadata
from ..models.hash_embedder import batch_features
from ..ops.fused_topk import MAX_K
from ..rerank.fusion import rrf_fusion_with_exact, vector_only
from ..utils.constants import EMBEDDER_VERSION, FTS_DIR_NAME
from ..utils.device import resolve_device, to_host
from ..utils.errors import SearchError
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

__all__ = ["SearchHit", "SearchOptions", "SearchResponse", "SearchSession", "search"]

_NOT_PORTED = "not ported yet (ROADMAP.md Queue 1)"
# Largest candidate depth a GPU query may ask for: its BM25 leg selects
# kpre <= pow2(pow2(fetch) + DEAD_RESYNC_MAX) rows, which must stay within the
# top-k kernels' MAX_K. The CPU path (plain versions) has no such bound.
MAX_FETCH = MAX_K - DEAD_RESYNC_MAX

EARLY_TERMINATION_SCORE = 0.85   # top-5 similarity (ref: distance < 0.15)
LANGUAGE_BOOST = 1.2
KIND_BOOST = 1.15
RESPONSE_CACHE_MAX = 128         # fused responses kept per session


class ResponseCache:
    """Small LRU for fused search responses, keyed on query/options plus
    store mutation counters. Values are stored and returned as copies deep
    enough that caller mutation (rescoring hits, annotating timings,
    appending to context lists) cannot poison the cache."""

    def __init__(self, max_entries: int = RESPONSE_CACHE_MAX):
        self._d: OrderedDict = OrderedDict()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _copy(value: SearchResponse) -> SearchResponse:
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
        if options.rerank:
            raise NotImplementedError(f"neural rerank is {_NOT_PORTED}")
        key = self._cache_key(query, options)
        cached = self._resp_cache.get(key)
        if cached is not None:
            cached.timings_ms["cached"] = True
            return cached

        t_all = time.time()
        timings: dict[str, float] = {}
        t = time.time()
        st = self._prep_query(query, options)
        timings["embed"] = (time.time() - t) * 1000
        identifiers, intent, fetch = st["identifiers"], st["intent"], st["fetch"]
        fused, feats, bm_args = st["fused"], st["feats"], st["bm"]
        backend = self.service.backend
        fused_fts = None
        exact_prefetched = None
        t = time.time()
        if bm_args is not None:
            if fused == "hash":
                dev_out = self.store.hybrid_search_featurized(
                    backend.model.table, feats[0], feats[1], fetch, bm_args,
                    raw=True, defer=True)
            else:
                dev_out = self.store.hybrid_search_encoded(
                    backend.encoder, feats[0], feats[1], fetch, bm_args,
                    raw=True, defer=True)
            # the device call is queued: run the host-side exact-identifier
            # scans while it computes
            if identifiers and options.mode == "hybrid":
                exact_prefetched = []
                for ident in identifiers:
                    exact_prefetched.extend(self.fts.search_exact(
                        ident, kind=intent.value if intent else None, limit=fetch))
            vv, vi, bv, bi = to_host(*dev_out)
            raw = self.store.rows_to_ids(vv, vi)
            fused_fts = self.fts.results_from_device(bv, bi, fetch)
        elif fused == "hash":
            raw = self.store.search_featurized_auto(
                backend.model, feats[0], feats[1], fetch, raw=True)
        else:
            raw = self.store.search_encoded(
                backend.encoder, feats[0], feats[1], fetch, raw=True)
        vector_ranked = self._dedup_raw(raw, fetch)
        timings["vector"] = (time.time() - t) * 1000
        resp = self._finish(
            query, options, identifiers, intent, st["vk"], st["fk"], fetch,
            vector_ranked, fused_fts, exact_prefetched, timings, t_all)
        self._resp_cache.put(key, resp)
        return resp

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
        vector_ranked, fused_fts, exact_prefetched, timings, t_all,
    ) -> SearchResponse:
        """Post-retrieval stages: early termination → fusion →
        boost-bounded lazy materialization → filters → response."""
        # ---- early termination (search/mod.rs:595-621) -------------------
        top5 = [s for _, s in vector_ranked[:5]]
        confident = len(top5) >= 5 and min(top5) > EARLY_TERMINATION_SCORE
        use_hybrid = options.mode == "hybrid" and not confident

        t = time.time()
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
        timings["fusion"] = (time.time() - t) * 1000

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

        # ---- path filter (search/mod.rs:698-745) ------------------------
        if options.path_filter:
            needle = options.path_filter
            hits = [h for h in hits if needle in h.path]

        hits.sort(key=lambda h: -h.score)

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
        timings["total"] = (time.time() - t_all) * 1000
        return SearchResponse(
            hits=hits,
            query=query,
            mode="vector" if not use_hybrid else "hybrid",
            total_chunks=len(self.store),
            timings_ms=timings,
            db_path=str(self.db_path),
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
        if self.device.type == "cuda" and fetch > MAX_FETCH:
            raise SearchError(
                f"limit {options.limit} needs {fetch} candidates per leg; the GPU "
                f"top-k kernels allow at most {MAX_FETCH} (ROADMAP.md Queue 1)")
        fused = self.service.fused_kind()
        prefixed = [self.service.spec.query_prefix + v for v in variants]
        if fused == "hash":
            feats = batch_features(prefixed)
        else:
            feats = self.service.backend.featurize_queries(prefixed)
        bm_args = None
        if options.mode == "hybrid":
            bm_args = self.fts.device_query_args(
                query, intent.value if intent else None, fetch)
        return {
            "query": query, "identifiers": identifiers, "intent": intent,
            "vk": vector_k, "fk": fts_k, "fetch": fetch, "feats": feats,
            "bm": bm_args, "fused": fused, "variants": variants,
        }

    def search_many(self, queries, options=None):
        raise NotImplementedError(f"batched search (search_many) is {_NOT_PORTED}")

    def _search_many_waves(self, queries, options=None):
        raise NotImplementedError(f"batched search (search_many) is {_NOT_PORTED}")


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
