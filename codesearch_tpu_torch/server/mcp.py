"""MCP server over stdio (JSON-RPC 2.0, newline-delimited) on torch (the
port of ``codesearch_tpu/server/mcp.py``: the same frames, the
instructions text naming the GPU).

Parity with src/mcp/mod.rs: four tools (semantic_search, find_references,
index_status, find_databases), compact-by-default responses (~40 tokens per
result vs ~600, mcp/types.rs:15-19), <5s startup via a placeholder database
plus background refresh (mcp/mod.rs:945-1182), readonly multi-instance
mode, the device path on CUDA unless the CPU is named
(``run_mcp_server(..., device="cpu")``), and strict stdout discipline —
stdout carries only JSON-RPC frames (a source-scanning test enforces no
stray prints in this module).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from ..index.db_discovery import find_best_database, find_databases
from ..index.file_meta import FileMetaStore
from ..index.manager import IndexManager, SharedStores
from ..index.pipeline import (
    get_db_path_smart,
    invalidate_for_embedder_version,
    read_metadata,
    write_metadata,
)
from ..utils.constants import EMBEDDER_VERSION, FTS_DIR_NAME, METADATA_FILE_NAME
from ..utils.logger import get_logger, init_logger, start_cleanup_task
from ..embed import EmbeddingService
from ..fts import FtsStore
from ..ops import _build
from ..search.pipeline import ResponseCache
from ..vectordb import VectorStore
from .readplane import device_candidates, ranked_chunks, ranked_chunks_wave
from .warmup import start_search_warmup as _start_warmup

log = get_logger("mcp")

PROTOCOL_VERSION = "2024-11-05"

def build_instructions(project, db, model: str, dims: int, readonly: bool) -> str:
    """Agent-facing playbook (parity in depth with the reference's get_info
    workflow prompt, mcp/mod.rs:766-929): tool guide, token-efficient and
    refactoring workflows, anti-grep guidance, troubleshooting."""
    import os

    db_exists = Path(db).exists()
    return f"""\
codesearch: local semantic code search over this repository. Search by
MEANING, not just keywords — the index is built from AST-aware chunks with
signatures, docstrings and context breadcrumbs, and stays fresh
automatically (file watcher + git branch detection).

TOOLS

1. find_databases()
   Discover every index reachable from here (cwd, children, parents,
   global registry) with per-database stats. Call this FIRST when unsure
   which project is indexed.
2. index_status()
   Readiness check: status (ready/building/error), chunk/file counts,
   model info. Call it before the first search and when results look
   stale or empty.
3. semantic_search(query, limit=10, compact=true, filter_path=null)
   Natural-language or identifier search. Compact results carry only
   path, line range, kind, signature and score — fetch code with your
   read tool at those exact lines. filter_path narrows to a directory
   (e.g. "src/api/"). Good queries describe intent:
     - "where do we validate upload size limits"
     - "retry logic for failed network calls"
     - "handle_file_modified"  (identifiers work too)
4. find_references(symbol, limit=50)
   Every usage/call site of a function, class, method or type. USE THIS
   INSTEAD OF grep for symbol usage — it is indexed, ranked and compact.
   Essential before any refactor: it lists every location that must change.

TOKEN-EFFICIENT WORKFLOW

  1. find_databases() → index_status()        (discover, verify)
  2. semantic_search("concept you need")      (compact metadata only)
  3. find_references("SymbolName")            (locations only)
  4. read the specific files/lines returned   (only what you need)

Keep compact=true; set compact=false only when you truly need inline
content for many results at once (high token cost).

REFACTORING WORKFLOW

  1. semantic_search("the thing to change") → find the definition
  2. find_references("name") → enumerate ALL call sites
  3. read each site, understand usage variants
  4. change the definition plus every call site; re-run find_references
     afterwards to confirm nothing was missed (the watcher reindexes your
     edits within ~2s).

DO / DON'T

  ✓ start broad, then narrow with filter_path or more specific phrasing
  ✓ use full phrases ("parse the gitignore stack"), not fragments ("git")
  ✓ operators: "double quotes" require the exact phrase verbatim;
    -term or -"a phrase" exclude matches (e.g. `error handling -test`)
  ✓ trust scores: results ≥0.8 are near-certain matches; <0.3 are noise
  ✗ never grep for symbol usages — find_references is ranked and complete
  ✗ don't search subdirectories expecting separate indexes (one per repo)
  ✗ don't re-issue identical queries — results are deterministic and cached

TROUBLESHOOTING

  "no index": run find_databases(); if empty, ask the user to run
  `codesearch index` in the project root (30-60s). This server refreshes
  an existing index but a first full build is a CLI action.
  Poor results: check index_status() for "building"/errors; try different
  phrasing; a stale index rebuilds with `codesearch index --force`.

PROJECT STATE

  project: {project}
  database: {db} ({"exists" if db_exists else "MISSING"}{", read-only" if readonly else ""})
  model: {model} ({dims}d, GPU-accelerated exact search)
  cwd: {os.getcwd()}
"""

TOOLS = [
    {
        "name": "semantic_search",
        "description": (
            "Meaning-based code retrieval: describe what the code does in "
            "plain English and get ranked matching chunks. Each hit carries "
            "location metadata only (path, line span, kind, signature, "
            "score) — open the file at those lines to see the code itself; "
            "pass compact=false if you truly need chunk text embedded in "
            "the response. filter_path restricts hits to one subtree."
        ),
        "inputSchema": {
            "type": "object",
            "properties": {
                "query": {"type": "string", "description": "What to look for — a plain-English description, an identifier, or a pasted fragment of code"},
                "limit": {"type": "integer", "description": "Cap on returned hits; 10 if omitted"},
                "compact": {"type": "boolean", "description": "true (the default) keeps each hit to location metadata, which is far cheaper in tokens"},
                "filter_path": {"type": "string", "description": "Keep only hits whose file path begins with this prefix, e.g. src/api/"},
            },
            "required": ["query"],
        },
    },
    {
        "name": "find_references",
        "description": (
            "Locate every chunk that mentions a named symbol (function, "
            "type, method, variable) — the indexed, ranked replacement for "
            "a repo-wide grep. Reach for it before text search whenever the "
            "question is \"who calls/uses this?\": rename planning, blast-"
            "radius checks, tracing callers."
        ),
        "inputSchema": {
            "type": "object",
            "properties": {
                "symbol": {"type": "string", "description": "Bare identifier to look up — a function, class, method or constant name"},
                "limit": {"type": "integer", "description": "Cap on returned reference sites; 50 if omitted"},
            },
            "required": ["symbol"],
        },
    },
    {
        "name": "index_status",
        "description": (
            "Readiness probe for the active index: reports whether it is "
            "ready, still building, or errored, along with chunk/file "
            "counts and the embedding model in use. Worth one call up "
            "front — an empty or mid-build index explains poor results "
            "better than rephrasing the query does."
        ),
        "inputSchema": {"type": "object", "properties": {}},
    },
    {
        "name": "find_databases",
        "description": (
            "Enumerate every index reachable from here — the working "
            "directory, its immediate children, up to five parent levels, "
            "and the machine-wide repo registry — with per-database stats, "
            "so you can tell which project is actually indexed."
        ),
        "inputSchema": {"type": "object", "properties": {}},
    },
]


class CodesearchService:
    def __init__(
        self,
        project_root: Path,
        db_path: Path,
        stores: SharedStores,
        service: EmbeddingService,
        manager: IndexManager | None,
    ):
        self.project_root = project_root
        self.db_path = db_path
        self.stores = stores
        self.service = service
        self.manager = manager
        self._metadata = read_metadata(db_path)
        # fused-response LRU keyed on store mutation counters: agents repeat
        # queries (same cache class as SearchSession)
        self._resp_cache = ResponseCache()

    # ------------------------------------------------------------------
    # tools
    # ------------------------------------------------------------------

    def _device_candidates(self, query: str, kind: str | None, fetch: int):
        """The fused read plane for one query: embed + vector top-k + BM25
        top-k in ONE device call (same path as the CLI/session pipeline).
        Returns (vector results, fts results or None). Used by the startup
        warmup, so it runs the same device path as real tool calls."""
        return device_candidates(self.stores, self.service, query, kind, fetch)

    def semantic_search(self, args: dict) -> dict:
        query = str(args.get("query", "")).strip()
        if not query:
            return {"error": "empty query"}
        limit = int(args.get("limit") or 10)
        compact = args.get("compact", True)
        filter_path = args.get("filter_path")

        cache_key = (
            query, limit, bool(compact), filter_path,
            self.stores.store.mutation_count, self.stores.fts.mutation_count,
        )
        cached = self._resp_cache.get(cache_key)
        if cached is not None:
            return cached

        # fused candidates + adaptive 3-way RRF + language ×1.2 /
        # structural-kind ×1.15 boosts (mcp/mod.rs:369-390) — one shared
        # implementation with the HTTP server (server/readplane.py)
        with self.stores.lock:
            scored = ranked_chunks(
                self.stores, self.service, self._metadata, query, limit,
                filter_path=filter_path,
            )
            resp = self._format_scored(scored, query, compact)
        self._resp_cache.put(cache_key, resp)
        return resp

    @staticmethod
    def _format_scored(scored, query: str, compact: bool) -> dict:
        items = []
        for score, _cid, meta in scored:
            item = {
                "path": meta.path,
                "start_line": meta.start_line + 1,
                "end_line": meta.end_line,
                "kind": meta.kind,
                "score": round(score, 4),
            }
            if meta.signature:
                item["signature"] = meta.signature
            if not compact:
                item["content"] = meta.content
            items.append(item)
        return {"query": query, "results": items, "total": len(items)}

    def semantic_search_many(self, args_list: list[dict]) -> list[dict]:
        """Pipelined semantic_search calls answered from ONE batched fused
        dispatch (readplane.ranked_chunks_wave): agents issue parallel
        tool calls, and the stdio loop groups consecutive ones so the
        whole group costs one device round trip. Per-call semantics are
        identical to semantic_search (same cache, same ranking)."""
        out: list[dict | BaseException | None] = [None] * len(args_list)
        live = []
        for i, args in enumerate(args_list):
            # per-item isolation: a malformed sibling (bad limit type, args
            # not a dict) must not fail the rest of the group — single-call
            # semantics give each request its own error frame
            try:
                query = str(args.get("query", "")).strip()
                if not query:
                    out[i] = {"error": "empty query"}
                    continue
                limit = int(args.get("limit") or 10)
                compact = args.get("compact", True)
                filter_path = args.get("filter_path")
            except Exception as e:  # caller maps to a protocol error frame
                out[i] = e
                continue
            key = (
                query, limit, bool(compact), filter_path,
                self.stores.store.mutation_count,
                self.stores.fts.mutation_count,
            )
            cached = self._resp_cache.get(key)
            if cached is not None:
                out[i] = cached
                continue
            live.append((i, query, limit, compact, filter_path, key))
        if live:
            waves = ranked_chunks_wave(
                self.stores, self.service, self._metadata,
                [(q, limit, fp) for _, q, limit, _, fp, _ in live],
            )
            for (i, query, _limit, compact, _fp, key), scored in zip(live, waves):
                resp = self._format_scored(scored, query, compact)
                self._resp_cache.put(key, resp)
                out[i] = resp
        return out  # type: ignore[return-value]

    def find_references(self, args: dict) -> dict:
        symbol = str(args.get("symbol", "")).strip()
        if not symbol:
            return {"error": "empty symbol"}
        # default 50 — parity with the reference (mcp/mod.rs:811)
        limit = int(args.get("limit") or 50)
        with self.stores.lock:
            hits = self.stores.fts.search(symbol, limit)
            refs = []
            for h in hits:
                meta = self.stores.store.get_chunk(h.chunk_id)
                if meta is None:
                    continue
                refs.append(
                    {
                        "path": meta.path,
                        "line": meta.start_line + 1,
                        "kind": meta.kind,
                        "signature": meta.signature,
                        "score": round(h.score, 3),
                    }
                )
        return {"symbol": symbol, "references": refs}

    def index_status(self, args: dict) -> dict:
        meta = read_metadata(self.db_path)
        fm = FileMetaStore.load_or_create(self.db_path)
        with self.stores.lock:
            total_chunks = len(self.stores.store)
            max_id = self.stores.store.next_id()
        status = self.manager.status if self.manager else "ready"
        return {
            "indexed": total_chunks > 0,
            "status": status,
            "status_message": (self.manager.status_message if self.manager else "")
            or f"{total_chunks} chunks across {len(fm.files)} files",
            "total_chunks": total_chunks,
            "total_files": len(fm.files),
            "model": meta.get("model", self.service.model_name),
            "dimensions": meta.get("dimensions", self.service.dims),
            "max_chunk_id": max_id,
            "db_path": str(self.db_path),
            "project_path": str(self.project_root),
        }

    def find_databases_tool(self, args: dict) -> dict:
        cwd = Path.cwd()
        dbs = []
        for db in find_databases(cwd):
            meta = read_metadata(db)
            fm = FileMetaStore.load_or_create(db)
            project = db.parent
            try:
                depth = len(cwd.resolve().relative_to(project.resolve()).parts)
                is_current = depth == 0
            except ValueError:
                depth = -1
                is_current = False
            dbs.append(
                {
                    "database_path": str(db),
                    "project_path": str(project),
                    "is_current_directory": is_current,
                    "depth_from_current": depth,
                    "total_files": len(fm.files),
                    "model": meta.get("model"),
                }
            )
        return {
            "databases": dbs,
            "message": f"found {len(dbs)} database(s)",
            "current_directory": str(cwd),
        }

    def call_tool(self, name: str, args: dict) -> dict:
        if name == "semantic_search":
            return self.semantic_search(args)
        if name == "find_references":
            return self.find_references(args)
        if name == "index_status":
            return self.index_status(args)
        if name == "find_databases":
            return self.find_databases_tool(args)
        raise ValueError(f"unknown tool: {name}")


# ---------------------------------------------------------------------------
# stdio transport
# ---------------------------------------------------------------------------

def _write_frame(obj: dict, out) -> None:
    out.write(json.dumps(obj, separators=(",", ":")) + "\n")
    out.flush()


def serve_stdio(service: CodesearchService, stdin=None, stdout=None) -> int:
    """Line-delimited JSON-RPC loop with request pipelining: a background
    reader feeds a queue, the loop blocks for the first request then
    drains whatever else is already buffered (agents issue parallel tool
    calls over stdio), and consecutive semantic_search calls in the
    drained group are answered from ONE batched fused device call
    (semantic_search_many). Responses are emitted in request order."""
    import queue as queue_mod
    import threading

    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    q: queue_mod.Queue = queue_mod.Queue()

    def reader():
        try:
            for line in stdin:
                q.put(line)
        finally:
            q.put(None)

    threading.Thread(target=reader, daemon=True, name="mcp-stdin").start()
    eof = False
    while not eof:
        line = q.get()
        if line is None:
            break
        batch = [line]
        # drain pipelined requests already buffered; a 2 ms grace catches
        # near-simultaneous arrivals from a parallel tool-call burst
        while True:
            try:
                nxt = q.get(timeout=0.002)
            except queue_mod.Empty:
                break
            if nxt is None:
                eof = True
                break
            batch.append(nxt)
        if _process_frames(service, batch, stdout):
            return 0
    return 0


# sentinel object for blank input lines — an in-band string would collide
# with a valid JSON string frame of the same content
_BLANK = object()


def _parse_frame(line: str):
    """line → req dict | _BLANK (empty line) | None (unparseable — error
    frame emitted by the caller)."""
    line = line.strip()
    if not line:
        return _BLANK
    try:
        return json.loads(line)
    except json.JSONDecodeError:
        return None


def _is_search_call(req) -> bool:
    return (
        isinstance(req, dict)
        and req.get("method") == "tools/call"
        and (req.get("params") or {}).get("name") == "semantic_search"
        and req.get("id") is not None
    )


def _process_frames(service: CodesearchService, lines: list[str], stdout) -> bool:
    """Handle a drained group of request lines in order, batching maximal
    runs of consecutive semantic_search tool calls through ONE device
    call. Returns True when a shutdown request ends the session."""
    reqs = [_parse_frame(line) for line in lines]
    i = 0
    while i < len(reqs):
        req = reqs[i]
        if req is _BLANK:
            i += 1
            continue
        if req is None:
            _write_frame(
                {"jsonrpc": "2.0", "id": None,
                 "error": {"code": -32700, "message": "parse error"}},
                stdout,
            )
            i += 1
            continue
        # maximal run of consecutive semantic_search calls → one wave
        if _is_search_call(req):
            j = i
            while j < len(reqs) and _is_search_call(reqs[j]):
                j += 1
            group = reqs[i:j]
            if len(group) > 1:
                try:
                    payloads = service.semantic_search_many(
                        [(g.get("params") or {}).get("arguments") or {}
                         for g in group]
                    )
                except Exception as e:
                    log.exception("mcp batched semantic_search failed")
                    for g in group:
                        _write_frame(
                            {"jsonrpc": "2.0", "id": g.get("id"),
                             "error": {"code": -32603, "message": str(e)}},
                            stdout,
                        )
                    i = j
                    continue
                for g, payload in zip(group, payloads):
                    if isinstance(payload, BaseException):
                        # per-item failure (malformed arguments): the same
                        # -32603 frame the single-call path would produce
                        _write_frame(
                            {"jsonrpc": "2.0", "id": g.get("id"),
                             "error": {"code": -32603,
                                       "message": str(payload)}},
                            stdout,
                        )
                        continue
                    _write_frame(
                        {"jsonrpc": "2.0", "id": g.get("id"), "result": {
                            "content": [{"type": "text",
                                         "text": json.dumps(payload)}],
                            "isError": "error" in payload,
                        }},
                        stdout,
                    )
                i = j
                continue
        method = req.get("method", "") if isinstance(req, dict) else ""
        req_id = req.get("id") if isinstance(req, dict) else None
        if method.startswith("notifications/"):
            i += 1
            continue  # notifications get no response
        try:
            result = _handle(service, method, req.get("params") or {})
        except Exception as e:
            log.exception("mcp method %s failed", method)
            _write_frame(
                {"jsonrpc": "2.0", "id": req_id,
                 "error": {"code": -32603, "message": str(e)}},
                stdout,
            )
            i += 1
            continue
        if req_id is not None:
            _write_frame({"jsonrpc": "2.0", "id": req_id, "result": result}, stdout)
        if method == "shutdown":
            return True
        i += 1
    return False


def _handle(service: CodesearchService, method: str, params: dict) -> dict:
    if method == "initialize":
        return {
            "protocolVersion": params.get("protocolVersion", PROTOCOL_VERSION),
            "capabilities": {"tools": {}},
            "serverInfo": {"name": "codesearch-tpu", "version": "0.1.0"},
            "instructions": build_instructions(
                service.project_root, service.db_path,
                service.service.model_name, service.service.dims,
                service.stores.readonly,
            ),
        }
    if method == "ping":
        return {}
    if method == "tools/list":
        return {"tools": TOOLS}
    if method == "prompts/list":
        return {"prompts": []}
    if method == "resources/list":
        return {"resources": []}
    if method == "tools/call":
        name = params.get("name", "")
        args = params.get("arguments") or {}
        payload = service.call_tool(name, args)
        return {
            "content": [{"type": "text", "text": json.dumps(payload)}],
            "isError": "error" in payload,
        }
    if method == "shutdown":
        return {}
    raise ValueError(f"unknown method: {method}")


# ---------------------------------------------------------------------------
# startup
# ---------------------------------------------------------------------------

def make_placeholder_db(db_path: Path, service: EmbeddingService) -> None:
    """Minimal valid db for <5s MCP startup (mcp/mod.rs:982-1029); the
    background refresh fills it."""
    db_path.mkdir(parents=True, exist_ok=True)
    (db_path / FTS_DIR_NAME).mkdir(exist_ok=True)
    VectorStore(db_path, dims=service.dims, device=service.device).save()
    FtsStore(db_path / FTS_DIR_NAME, device=service.device).commit()
    fm = FileMetaStore(db_path, service.model_name)
    fm.save()

    class _S:
        primary_language = None

    write_metadata(db_path, service, _S())


def start_search_warmup(svc: CodesearchService) -> None:
    """Pre-pay the first device calls (the kernels' build and load, the
    corpus upload, the first launches of a single query and of a wave;
    server/warmup.py) with the shapes of a default real query (limit=10 →
    fetch=30), through the SAME device path real tool calls use. Waits for the initial refresh to finish;
    runs WITHOUT the coarse stores lock, and retries with backoff when it
    races the writer."""
    def ready() -> bool:
        with svc.stores.lock:
            n = len(svc.stores.store)
        refreshed = svc.manager is None or svc.manager.status == "ready"
        return n > 0 and refreshed

    def fire():
        import time as _t

        if svc.stores.store.device.type == "cuda":
            _build.load()   # the kernels' nvcc build and load
        delay = 0.5
        for attempt in range(7):
            try:
                svc._device_candidates("warmup parse config entry", None, 30)
                break
            except Exception:
                if attempt == 6:
                    raise
                _t.sleep(delay)
                delay = min(delay * 2, 16.0)
                deadline = _t.time() + delay
                while not ready() and _t.time() < deadline:
                    _t.sleep(0.2)
        # and one wave, as a pipelined group of tool calls makes
        ranked_chunks_wave(svc.stores, svc.service, svc._metadata,
                           [("warmup parse config entry", 10, None),
                            ("warmup walk the tree", 10, None)])

    _start_warmup(ready, fire)


def run_mcp_server(project_path: Path, create_index: bool = True, device=None) -> int:
    """Serve MCP over stdio for the project's index on ``device`` (CUDA
    unless the CPU is named)."""
    project_path = Path(project_path).resolve()
    db = find_best_database(project_path)
    if db is None:
        db, root = get_db_path_smart(project_path)
    else:
        root = db.parent
    meta = read_metadata(db)
    model = meta.get("model", "code-hash-384")
    service = EmbeddingService(model, db_path=db, device=device)
    if not (db / METADATA_FILE_NAME).exists():
        if not create_index:
            sys.stderr.write(f"no index at {db}; run `codesearch-torch index`\n")
            return 1
        make_placeholder_db(db, service)
    init_logger(db_path=db, quiet=True)  # file-only: stdout is JSON-RPC
    start_cleanup_task(db)
    stores, writer_lock = SharedStores.new_or_readonly(db, service.dims, device=device)
    # featurizer-version guard: an index built by an older featurizer is
    # incomparable with new query vectors — rebuild when writable, refuse
    # when readonly (never serve silently mis-ranked results)
    if meta and meta.get("embedder_version", 1) != EMBEDDER_VERSION:
        if stores.readonly:
            sys.stderr.write(
                f"index at {db} was built with embedder "
                f"v{meta.get('embedder_version', 1)} (current v{EMBEDDER_VERSION}) "
                "and another writer holds the lock — run `codesearch-torch index "
                "--force` to rebuild\n"
            )
            if writer_lock is not None:
                writer_lock.release()
            return 1
        invalidate_for_embedder_version(db, service, (stores.store, stores.fts))
    manager: IndexManager | None = None
    if not stores.readonly:
        manager = IndexManager(root, db, stores, service)
        manager.start_background(initial_refresh=True)
    svc = CodesearchService(root, db, stores, service, manager)
    start_search_warmup(svc)
    try:
        return serve_stdio(svc)
    finally:
        if manager is not None:
            manager.stop()
        if writer_lock is not None:
            writer_lock.release()
