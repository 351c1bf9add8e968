"""Search pipeline on torch (port of ``codesearch_tpu/search/pipeline.py``).

The query plan, fusion, boosts and hit materialization are the JAX
package's (``SearchSession._finish``, ``_dedup_raw``, the response cache),
reused by subclassing. The port opens its own stores and embedding service
on ``device`` and runs the hash-model query as one call whose four result
arrays are read back together. Batched waves (``search_many``) and neural
reranking are not ported yet.
"""

from __future__ import annotations

import time
from pathlib import Path

from codesearch_tpu.fts.store import DEAD_RESYNC_MAX
from codesearch_tpu.index.db_discovery import resolve_database_with_message
from codesearch_tpu.index.pipeline import read_metadata
from codesearch_tpu.search.analysis import (
    adapt_rrf_k,
    detect_identifiers,
    detect_structural_intent,
    expand_query,
    parse_operators,
)
from codesearch_tpu.search.pipeline import (
    ResponseCache,
    SearchHit,
    SearchOptions,
    SearchResponse,
)
from codesearch_tpu.search.pipeline import SearchSession as _HostSearchSession
from codesearch_tpu.utils.constants import EMBEDDER_VERSION, FTS_DIR_NAME
from codesearch_tpu.utils.errors import SearchError

from ..embed import EmbeddingService
from ..fts import FtsStore
from ..models.hash_embedder import batch_features
from ..ops.fused_topk import MAX_K
from ..utils.device import resolve_device, to_host
from ..vectordb import VectorStore
from .degrade import dispatch_with_degrade

__all__ = ["SearchHit", "SearchOptions", "SearchResponse", "SearchSession", "search"]

_NOT_PORTED = "not ported yet (ROADMAP.md Queue 1)"
# Largest candidate depth a GPU query may ask for: its BM25 leg selects
# kpre <= pow2(pow2(fetch) + DEAD_RESYNC_MAX) rows, which must stay within the
# top-k kernels' MAX_K. The CPU path (plain versions) has no such bound.
MAX_FETCH = MAX_K - DEAD_RESYNC_MAX


class SearchSession(_HostSearchSession):
    """Open stores + embedding service on ``device`` for repeated queries."""

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
        self.reranker = None
        self._resp_cache = ResponseCache()

    def search(self, query: str, options: SearchOptions | None = None) -> SearchResponse:
        return self._search_impl(query, options)

    def _search_impl(self, query: str, options: SearchOptions | None = None) -> SearchResponse:
        return dispatch_with_degrade(
            self.fts, lambda: self._search_attempt(query, options), "search")

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
        feats, bm_args = st["feats"], st["bm"]
        hash_model = self.service.backend.model
        fused_fts = None
        exact_prefetched = None
        t = time.time()
        if bm_args is not None:
            dev_out = self.store.hybrid_search_featurized(
                hash_model.table, feats[0], feats[1], fetch, bm_args,
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
        else:
            raw = self.store.search_featurized_auto(
                hash_model, feats[0], feats[1], fetch, raw=True)
        vector_ranked = self._dedup_raw(raw, fetch)
        timings["vector"] = (time.time() - t) * 1000
        resp = self._finish(
            query, options, identifiers, intent, st["vk"], st["fk"], fetch,
            vector_ranked, {}, fused_fts, exact_prefetched, timings, t_all)
        self._resp_cache.put(key, resp)
        return resp

    def _prep_query(self, query: str, options: SearchOptions) -> dict:
        """Host-side planning, as the JAX session's: operator parsing,
        adaptive retrieval depth, variant expansion, featurization and the
        BM25 interval table."""
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
        feats = batch_features([self.service.spec.query_prefix + v for v in variants])
        bm_args = None
        if options.mode == "hybrid":
            bm_args = self.fts.device_query_args(
                query, intent.value if intent else None, fetch)
        return {
            "query": query, "identifiers": identifiers, "intent": intent,
            "vk": vector_k, "fk": fts_k, "fetch": fetch, "feats": feats,
            "bm": bm_args, "fused": "hash", "variants": variants,
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
