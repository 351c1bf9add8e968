"""HTTP server on torch (the port of ``codesearch_tpu/server/http.py``;
parity with src/server/mod.rs): GET /health, GET /status, POST /search.
Search over HTTP defaults to vector-only with 200-char truncated snippets
(server/mod.rs:484-596 — the reference's HTTP surface never grew the
hybrid pipeline); passing ``"mode": "hybrid"`` runs the
full fused read plane + RRF + boosts via the same shared implementation
as the MCP server (server/readplane.py). Hybrid requests are dynamically
micro-batched: concurrent requests coalesce into ONE batched fused device
call (readplane.DynamicBatcher), and an explicit ``"queries": [...]``
body batches a whole list in one call. Runs its own watcher loop via
IndexManager. The device path runs on CUDA unless the CPU is named
(``serve(..., device="cpu")``)."""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from ..embed import EmbeddingService
from ..index.db_discovery import find_best_database
from ..index.file_meta import FileMetaStore
from ..index.manager import IndexManager, SharedStores
from ..index.pipeline import (
    IndexOptions,
    index,
    invalidate_for_embedder_version,
    read_metadata,
)
from ..ops import _build
from ..utils.constants import EMBEDDER_VERSION
from ..utils.logger import get_logger, init_logger
from ..utils.output import info_print
from .readplane import DynamicBatcher, ranked_chunks, ranked_chunks_many
from .warmup import start_search_warmup

log = get_logger("http")

SNIPPET_CHARS = 200


class ServerState:
    def __init__(self, root: Path, db: Path, stores: SharedStores,
                 service: EmbeddingService, manager: IndexManager | None):
        self.root = root
        self.db = db
        self.stores = stores
        self.service = service
        self.manager = manager
        self.started_at = time.time()
        # dynamic micro-batching: concurrent hybrid requests coalesce into
        # one batched fused device call (server/readplane.py)
        self.batcher = DynamicBatcher(stores, service)


def _make_handler(state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route access logs to our logger
            log.info("%s %s", self.address_string(), fmt % args)

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, {"status": "ok"})
                return
            if self.path == "/status":
                meta = read_metadata(state.db)
                fm = FileMetaStore.load_or_create(state.db)
                with state.stores.lock:
                    chunks = len(state.stores.store)
                    fts = state.stores.fts
                    serving = {
                        "planes_enabled": fts.planes_enabled,
                        "plane_builds": fts.plane_builds,
                        "plane_evictions": fts.plane_evictions,
                        "plane_prewarms": fts.plane_prewarms,
                        "exact_tier_hits": fts.exact_tier_hits,
                        "exact_tier_fallbacks": fts.exact_tier_fallbacks,
                    }
                self._reply(
                    200,
                    {
                        "status": state.manager.status if state.manager else "ready",
                        "db_path": str(state.db),
                        "model": meta.get("model"),
                        "dimensions": meta.get("dimensions"),
                        "total_chunks": chunks,
                        "total_files": len(fm.files),
                        "uptime_s": round(time.time() - state.started_at, 1),
                        "batch_waves": state.batcher.waves,
                        "batched_queries": state.batcher.batched_queries,
                        "batch_queue_wait_s": state.batcher.queue_wait_s,
                        # live serving state: THIS process's plane routing
                        # (a latched OOM degrade shows up here first)
                        "serving": serving,
                    },
                )
                return
            self._reply(404, {"error": "not found"})

        @staticmethod
        def _hit(meta, score: float) -> dict:
            return {
                "path": meta.path,
                "start_line": meta.start_line + 1,
                "end_line": meta.end_line,
                "kind": meta.kind,
                "score": round(score, 4),
                "snippet": meta.content[:SNIPPET_CHARS],
            }

        def do_POST(self):
            if self.path != "/search":
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                body = json.loads(raw or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._reply(400, {"error": "invalid JSON body"})
                return
            query = str(body.get("query", "")).strip()
            queries = body.get("queries")
            if not query and not (isinstance(queries, list) and queries):
                self._reply(400, {"error": "missing query"})
                return
            limit = int(body.get("limit") or 10)
            path_filter = body.get("path")
            # "vector" (reference parity, server/mod.rs:525) is the default;
            # "hybrid" runs the full fused read plane + 3-way RRF + boosts —
            # the same shared implementation the MCP server uses
            mode = str(body.get("mode") or "vector")
            if mode not in ("vector", "hybrid"):
                self._reply(400, {"error": f"unknown mode {mode!r}"})
                return
            t0 = time.time()
            if isinstance(queries, list) and queries:
                # explicit batch API: all queries ride ONE batched fused
                # device call (readplane.ranked_chunks_many)
                if mode != "hybrid":
                    self._reply(400, {"error": "queries[] requires mode=hybrid"})
                    return
                # same wave cap as the internal batcher: an uncapped list
                # would force an arbitrarily large single device call (score
                # rows of every variant against the corpus) under stores.lock
                if len(queries) > 64:
                    self._reply(400, {"error": "too many queries (max 64)"})
                    return
                qlist = [str(q).strip() for q in queries]
                if not all(qlist):
                    self._reply(400, {"error": "empty query in queries[]"})
                    return
                meta_json = read_metadata(state.db)
                waves = ranked_chunks_many(
                    state.stores, state.service, meta_json, qlist, limit,
                    filter_path=path_filter,
                )
                self._reply(
                    200,
                    {
                        "mode": mode,
                        "batch": [
                            {"query": q,
                             "results": [self._hit(m, s) for s, _c, m in scored]}
                            for q, scored in zip(qlist, waves)
                        ],
                        "took_ms": round((time.time() - t0) * 1000, 1),
                    },
                )
                return
            out = []
            if mode == "hybrid":
                meta_json = read_metadata(state.db)
                # no lock held here: the device call rides the dynamic
                # micro-batching wave (concurrent requests coalesce into one
                # batched kernel); only the ranking phase locks, inside
                scored = ranked_chunks(
                    state.stores, state.service, meta_json, query, limit,
                    filter_path=path_filter, batcher=state.batcher,
                )
                for score, _cid, meta in scored:
                    out.append(self._hit(meta, score))
            else:
                qvec = state.service.embed_query(query)
                with state.stores.lock:
                    results = state.stores.store.search(np.asarray(qvec), limit * 3)
                for r in results:
                    if path_filter and path_filter not in r.metadata.path:
                        continue
                    out.append(self._hit(r.metadata, r.score))
                    if len(out) >= limit:
                        break
            self._reply(
                200,
                {"query": query, "mode": mode, "results": out,
                 "took_ms": round((time.time() - t0) * 1000, 1)},
            )

    return Handler


class _Server(ThreadingHTTPServer):
    # listen backlog: a burst of concurrent requests (the batcher's waves
    # take up to 64) must wait in the accept queue; at http.server's default
    # of 5 the kernel drops or resets the rest, and their clients retry a
    # second or more later
    request_queue_size = 128


def make_server(project_path: Path, host: str = "127.0.0.1", port: int = 7878,
                initial_index: bool = True, device=None):
    """Build (httpd, state) without blocking — used by serve() and tests."""
    project_path = Path(project_path).resolve()
    db = find_best_database(project_path)
    if db is None:
        if not initial_index:
            raise RuntimeError(f"no index under {project_path}")
        stats = index(project_path, IndexOptions(quiet=True), device=device)
        db = stats.db_path
    root = db.parent
    meta = read_metadata(db)
    service = EmbeddingService(meta.get("model", "code-hash-384"), db_path=db, device=device)
    stores, writer_lock = SharedStores.new_or_readonly(db, service.dims, device=device)
    # featurizer-version guard (same rule as MCP: rebuild or refuse — never
    # serve an index whose vectors are incomparable with current queries)
    if meta and meta.get("embedder_version", 1) != EMBEDDER_VERSION:
        if stores.readonly:
            if writer_lock is not None:
                writer_lock.release()
            raise RuntimeError(
                f"index at {db} was built with embedder "
                f"v{meta.get('embedder_version', 1)} (current v{EMBEDDER_VERSION}); "
                "run `codesearch-torch index --force` to rebuild"
            )
        invalidate_for_embedder_version(db, service, (stores.store, stores.fts))
    manager: IndexManager | None = None
    if not stores.readonly:
        manager = IndexManager(root, db, stores, service)
        manager.start_background(initial_refresh=True)
    state = ServerState(root, db, stores, service, manager)
    _start_http_warmup(state)
    httpd = _Server((host, port), _make_handler(state))
    state._writer_lock = writer_lock  # keep alive
    return httpd, state


def _start_http_warmup(state: ServerState) -> None:
    """Background first-call warmup (server/warmup.py): the kernels' build
    and load (CUDA), the corpus upload and one vector-mode call with the real
    handler's shapes (limit 10 × 3), then one batched wave, after the
    initial refresh, with no coarse lock held (a race with the writer is
    retried)."""
    def ready() -> bool:
        with state.stores.lock:
            n = len(state.stores.store)
        refreshed = state.manager is None or state.manager.status == "ready"
        return n > 0 and refreshed

    def fire():
        if state.stores.store.device.type == "cuda":
            _build.load()   # the kernels' nvcc build and load
        for attempt in range(3):
            try:
                qvec = state.service.embed_query("warmup parse config entry")
                state.stores.store.search(np.asarray(qvec), 30)
                break
            except Exception:
                if attempt == 2:
                    raise
                time.sleep(0.5)
        # one batched wave too: the first concurrent burst should find the
        # wave path's launches warm
        try:
            ranked_chunks_many(
                state.stores, state.service, read_metadata(state.db),
                ["warmup parse config entry", "warmup walk the tree"], 10,
            )
        except Exception:
            log.info("batched-wave warmup skipped", exc_info=True)

    start_search_warmup(ready, fire)


def serve(project_path: Path, host: str = "127.0.0.1", port: int = 7878,
          initial_index: bool = True, device=None) -> int:
    init_logger(quiet=False)
    httpd, state = make_server(project_path, host, port,
                               initial_index=initial_index, device=device)
    info_print(f"codesearch http server on http://{host}:{port} (db: {state.db})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if state.manager is not None:
            state.manager.stop()
        httpd.server_close()
    return 0
