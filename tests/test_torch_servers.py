"""The port's MCP and HTTP servers, held to the JAX package's on the CPU.

Both packages serve one index (a small demo repository plus 400 synthetic
chunks, indexed by the port, device routes forced). The MCP servers answer
the same JSON-RPC frames, apart from the instructions text, which names the
GPU in the port; the HTTP servers answer ``/health``, ``/status`` and
``POST /search`` (hybrid, vector and ``queries[]``) with the same results
and the same 400 answers. The CLI's ``mcp`` and ``serve`` run with
``--platform cpu``; without it, and with no CUDA device, the servers raise.
Servers bind port 0, and every thread a test starts is joined with a
timeout.
"""

import contextlib
import io
import json
import re
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from codesearch_tpu.embed import EmbeddingService as JaxService
from codesearch_tpu.index.manager import SharedStores as JaxStores
from codesearch_tpu.server import http as jhttp
from codesearch_tpu.server.mcp import CodesearchService as JaxMcp
from codesearch_tpu.server.mcp import serve_stdio as jax_serve_stdio
from codesearch_tpu_torch.embed import EmbeddingService
from codesearch_tpu_torch.index import IndexOptions, index
from codesearch_tpu_torch.index.manager import SharedStores
from codesearch_tpu_torch.server import http as thttp
from codesearch_tpu_torch.server.mcp import CodesearchService, serve_stdio
from test_torch_slice import SCORE_TOL, _add_synthetic

ROOT = Path(__file__).resolve().parents[1]
PLANE_FLOOR = 100
QUERIES = ["parse the configuration file", "shared_registry sync", "validate the schema",
           "compute a content hash", '"render the config" -walk']


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    """A repository indexed by the port at its default place (``.codesearch.db``)."""
    repo = tmp_path_factory.mktemp("servers") / "repo"
    (repo / "src").mkdir(parents=True)
    (repo / "src" / "main.py").write_text(
        'def parse_config(path):\n    """Parse the configuration file."""\n'
        "    with open(path) as f:\n        return f.read()\n")
    (repo / "src" / "lib.rs").write_text(
        "/// Compute a content hash.\npub fn content_hash(data: &[u8]) -> u64 {\n"
        "    data.iter().fold(0u64, |h, b| h.wrapping_mul(31) + *b as u64)\n}\n")
    _add_synthetic(repo, n_files=4)
    from test_torch_slice import jax_make_table, th

    path = th._table_bits_path(384, th.VOCAB_BUCKETS)
    if not path.exists():
        np.asarray(jax_make_table(384)).view(np.uint16).ravel().tofile(path)
    stats = index(repo, IndexOptions(quiet=True), device="cpu")
    assert stats.db_path == repo / ".codesearch.db" and stats.chunks_added > 400
    return repo


def _force(stores) -> None:
    stores.store.host_path_rows = 0
    stores.fts.device_min_docs = 1
    stores.fts.plane_df_floor = PLANE_FLOOR


# ---------------------------------------------------------------------------
# MCP
# ---------------------------------------------------------------------------

REQUESTS = [
    {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
    {"jsonrpc": "2.0", "method": "notifications/initialized"},
    {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
    {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
     "params": {"name": "semantic_search", "arguments": {"query": QUERIES[0], "limit": 5}}},
    {"jsonrpc": "2.0", "id": 4, "method": "ping"},
    # a pipelined group: one wave
    *({"jsonrpc": "2.0", "id": 10 + i, "method": "tools/call",
       "params": {"name": "semantic_search",
                  "arguments": {"query": q, "limit": 3 + i, "compact": i % 2 == 0,
                                **({"filter_path": "src/"} if i == 2 else {})}}}
      for i, q in enumerate(QUERIES)),
    {"jsonrpc": "2.0", "id": 20, "method": "tools/call",
     "params": {"name": "semantic_search", "arguments": {"query": ""}}},
    {"jsonrpc": "2.0", "id": 21, "method": "tools/call",
     "params": {"name": "find_references", "arguments": {"symbol": "shared_registry",
                                                          "limit": 7}}},
    {"jsonrpc": "2.0", "id": 22, "method": "tools/call",
     "params": {"name": "index_status", "arguments": {}}},
    {"jsonrpc": "2.0", "id": 23, "method": "tools/call",
     "params": {"name": "find_databases", "arguments": {}}},
    {"jsonrpc": "2.0", "id": 24, "method": "tools/call",
     "params": {"name": "nope", "arguments": {}}},
    # a repeat, answered from the response cache
    {"jsonrpc": "2.0", "id": 25, "method": "tools/call",
     "params": {"name": "semantic_search", "arguments": {"query": QUERIES[0], "limit": 5}}},
    {"jsonrpc": "2.0", "id": 26, "method": "shutdown"},
]


def _frames(serve, svc, requests) -> list[dict]:
    stdin = io.StringIO("not json\n" + "\n".join(json.dumps(r) for r in requests) + "\n")
    stdout = io.StringIO()
    serve(svc, stdin=stdin, stdout=stdout)
    return [json.loads(line) for line in stdout.getvalue().splitlines()]


def _mcp_frames(repo, port: bool) -> list[dict]:
    db = repo / ".codesearch.db"
    if port:
        svc = EmbeddingService("code-hash-384", device="cpu")
        stores, lock = SharedStores.new_or_readonly(db, 384, device="cpu")
        make, serve = CodesearchService, serve_stdio
    else:
        svc = JaxService("code-hash-384")
        stores, lock = JaxStores.new_or_readonly(db, 384)
        make, serve = JaxMcp, jax_serve_stdio
    _force(stores)
    try:
        return _frames(serve, make(repo, db, stores, svc, None), REQUESTS)
    finally:
        if lock is not None:
            lock.release()


def test_mcp_frames_equal_jax(repo):
    got, ref = _mcp_frames(repo, port=True), _mcp_frames(repo, port=False)
    assert [f.get("id") for f in got] == [f.get("id") for f in ref]
    assert got[0] == {"jsonrpc": "2.0", "id": None,
                      "error": {"code": -32700, "message": "parse error"}}
    got, ref = got[1:], ref[1:]
    assert [f["id"] for f in got] == [1, 2, 3, 4, 10, 11, 12, 13, 14, 20, 21, 22, 23, 24,
                                      25, 26]
    instructions = got[0]["result"].pop("instructions")
    assert "GPU-accelerated" in instructions and "TPU" not in instructions
    assert instructions == ref[0]["result"].pop("instructions").replace(
        "TPU-accelerated", "GPU-accelerated")
    assert got == ref
    payload = {f["id"]: json.loads(f["result"]["content"][0]["text"])
               for f in got if "result" in f and "content" in f["result"]}
    assert payload[3]["results"][0]["path"].endswith("main.py")
    assert all(len(payload[10 + i]["results"]) == 3 + i for i in (0, 1, 3))
    assert all(r["path"].startswith("src/") for r in payload[12]["results"])
    assert payload[21]["references"] and payload[22]["total_chunks"] > 400
    assert payload[25] == payload[3] and payload[20] == {"error": "empty query"}
    assert got[-3]["error"]["code"] == -32603      # the unknown tool


def test_mcp_pipelined_group_is_one_wave_matching_single_calls(repo, monkeypatch):
    db = repo / ".codesearch.db"
    svc = EmbeddingService("code-hash-384", device="cpu")
    stores = SharedStores(db, 384, readonly=True, device="cpu")
    _force(stores)
    mcp = CodesearchService(repo, db, stores, svc, None)
    from codesearch_tpu_torch.server import readplane

    waves = []
    orig = readplane.device_candidates_many
    monkeypatch.setattr(readplane, "device_candidates_many",
                        lambda *a: waves.append(len(a[2])) or orig(*a))
    group = mcp.semantic_search_many([{"query": q, "limit": 4} for q in QUERIES]
                                     + [{"query": "x", "limit": "many"}])
    assert waves == [len(QUERIES)]
    assert isinstance(group[-1], ValueError)
    single = CodesearchService(repo, db, stores, svc, None)
    for q, got in zip(QUERIES, group):
        assert got == single.semantic_search({"query": q, "limit": 4})


def test_no_print_in_port_server_modules():
    # stdout carries only JSON-RPC frames (the JAX package's rule)
    pattern = re.compile(r"(?<!\w)print\(")
    for rel in ("server/mcp.py", "server/warmup.py", "server/readplane.py",
                "search/pipeline.py", "index/manager.py"):
        for i, line in enumerate((ROOT / "codesearch_tpu_torch" / rel).read_text().splitlines()):
            if not line.strip().startswith(("#", '"')):
                assert not pattern.search(line), f"print in {rel}:{i + 1}"


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _serving(make_server, repo, **kw):
    httpd, state = make_server(repo, host="127.0.0.1", port=0, initial_index=False, **kw)
    _force(state.stores)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        deadline = time.time() + 60
        while state.manager is not None and state.manager.status != "ready" \
                and time.time() < deadline:
            time.sleep(0.05)
        yield f"http://127.0.0.1:{httpd.server_address[1]}", state
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()
        if state.manager is not None:
            state.manager.stop()
        if state._writer_lock is not None:
            state._writer_lock.release()


def _post(base, payload, raw: bytes | None = None):
    req = urllib.request.Request(base + "/search",
                                 data=raw if raw is not None else json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


BAD = [({"query": ""}, None), ({"query": "x", "mode": "quantum"}, None), (None, b"{not json"),
       ({"queries": QUERIES, "mode": "vector"}, None),
       ({"queries": ["q"] * 65, "mode": "hybrid"}, None),
       ({"queries": ["ok", " "], "mode": "hybrid"}, None)]


def _http_answers(repo, make_server, **kw) -> dict:
    with _serving(make_server, repo, **kw) as (base, state):
        out = {"health": json.loads(urllib.request.urlopen(base + "/health").read())}
        status = json.loads(urllib.request.urlopen(base + "/status").read())
        out["status"] = {k: status[k] for k in ("db_path", "model", "dimensions",
                                                "total_chunks", "total_files")}
        out["hybrid"] = [_post(base, {"query": q, "limit": 4, "mode": "hybrid"})[1]["results"]
                         for q in QUERIES]
        out["filtered"] = _post(base, {"query": QUERIES[1], "limit": 4, "mode": "hybrid",
                                       "path": "gen_1"})[1]["results"]
        out["vector"] = [_post(base, {"query": q, "limit": 6})[1]["results"] for q in QUERIES]
        code, batch = _post(base, {"queries": QUERIES, "limit": 4, "mode": "hybrid"})
        assert code == 200 and batch["mode"] == "hybrid"
        out["batch"] = batch["batch"]
        out["bad"] = [_post(base, p, raw) for p, raw in BAD]
        try:
            urllib.request.urlopen(base + "/nope")
        except urllib.error.HTTPError as e:
            out["404"] = e.code
    return out


def test_http_answers_equal_jax(repo):
    got = _http_answers(repo, thttp.make_server, device="cpu")
    ref = _http_answers(repo, jhttp.make_server)
    assert got["health"] == {"status": "ok"} and got["404"] == 404 == ref["404"]
    assert got["status"] == ref["status"] and got["status"]["total_chunks"] > 400
    # hybrid answers carry rank-fused scores: equal to the digit
    assert got["hybrid"] == ref["hybrid"] and all(got["hybrid"])
    assert got["filtered"] == ref["filtered"] and all("gen_1" in r["path"]
                                                      for r in got["filtered"])
    assert got["batch"] == ref["batch"]
    assert [b["results"] for b in got["batch"]] == got["hybrid"]
    # vector answers carry cosines rounded to 4 digits: the same hits, and
    # scores within one rounding step
    for g, r in zip(got["vector"], ref["vector"]):
        assert [(h["path"], h["start_line"]) for h in g] == [(h["path"], h["start_line"])
                                                             for h in r] and g
        np.testing.assert_allclose([h["score"] for h in g], [h["score"] for h in r],
                                   rtol=0, atol=1e-4 + SCORE_TOL)
        assert all(len(h["snippet"]) <= 200 for h in g)
    assert got["bad"] == ref["bad"] and all(code == 400 for code, _ in got["bad"])


def test_http_concurrent_hybrid_posts_coalesce(repo):
    with _serving(thttp.make_server, repo, device="cpu") as (base, state):
        singles = [_post(base, {"query": q, "limit": 3, "mode": "hybrid"})[1]["results"]
                   for q in QUERIES]
        waves_before = state.batcher.waves
        state.batcher.window_s = 0.5
        state.batcher._last_arrival = time.monotonic()   # traffic is flowing
        n = 8
        out, errors = [None] * n, []
        barrier = threading.Barrier(n)

        def worker(i):
            try:
                barrier.wait(timeout=10)
                out[i] = _post(base, {"query": QUERIES[i % len(QUERIES)], "limit": 3,
                                      "mode": "hybrid"})[1]["results"]
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        status = json.loads(urllib.request.urlopen(base + "/status").read())
        assert status["batch_waves"] - waves_before < n
        assert status["serving"]["planes_enabled"] is True
        for i in range(n):
            assert out[i] == singles[i % len(QUERIES)]


# ---------------------------------------------------------------------------
# the CLI and the device
# ---------------------------------------------------------------------------

def test_cli_mcp_runs_on_the_cpu(repo, monkeypatch):
    from codesearch_tpu_torch.cli import main

    requests = [{"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
                {"jsonrpc": "2.0", "id": 2, "method": "tools/call",
                 "params": {"name": "semantic_search",
                            "arguments": {"query": QUERIES[0], "limit": 2}}}]
    stdout = io.StringIO()
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(json.dumps(r) for r in requests)
                                                 + "\n"))
    monkeypatch.setattr("sys.stdout", stdout)
    assert main(["--platform", "cpu", "mcp", str(repo)]) == 0
    frames = [json.loads(line) for line in stdout.getvalue().splitlines()]
    assert [f["id"] for f in frames] == [1, 2]
    hits = json.loads(frames[1]["result"]["content"][0]["text"])["results"]
    assert len(hits) == 2 and hits[0]["path"].endswith("main.py")


def test_cli_serve_runs_on_the_cpu(repo, monkeypatch):
    from codesearch_tpu_torch.cli import main

    made = {}
    orig = thttp.make_server

    def capture(*a, **kw):
        made["server"] = orig(*a, **kw)
        made["ready"].set()
        return made["server"]

    made["ready"] = threading.Event()
    monkeypatch.setattr(thttp, "make_server", capture)
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault("rc", main(
        ["--platform", "cpu", "serve", str(repo), "--port", "0"])), daemon=True)
    t.start()
    assert made["ready"].wait(timeout=60)
    httpd, state = made["server"]
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                health = json.loads(urllib.request.urlopen(base + "/health").read())
                break
            except urllib.error.URLError:
                time.sleep(0.05)
        assert health == {"status": "ok"}
        code, res = _post(base, {"query": QUERIES[0], "limit": 2, "mode": "hybrid"})
        assert code == 200 and res["results"][0]["path"].endswith("main.py")
        assert state.stores.store.device.type == "cpu"
    finally:
        httpd.shutdown()
        t.join(timeout=30)
        if state._writer_lock is not None:
            state._writer_lock.release()
    assert not t.is_alive() and rc["rc"] == 0


def test_servers_need_cuda_unless_the_cpu_is_named(repo, monkeypatch):
    from codesearch_tpu_torch.cli import main
    from codesearch_tpu_torch.server.mcp import run_mcp_server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thttp.make_server(repo, port=0, initial_index=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_mcp_server(repo)
    assert main(["serve", str(repo), "--port", "0", "--no-create-index"]) == 1
    assert main(["mcp", str(repo)]) == 1
    assert main(["stats", str(repo)]) == 1      # ported: it opens the stores on CUDA


def test_http_takes_a_burst_of_connections(repo):
    # more simultaneous connections than http.server's default listen backlog
    # (5): every one is answered, none reset or left to a retry
    import http.client

    with _serving(thttp.make_server, repo, device="cpu") as (base, state):
        port = int(base.rsplit(":", 1)[1])
        n = 32
        codes, errors = [None] * n, []
        barrier = threading.Barrier(n)

        def client(i):
            try:
                barrier.wait(timeout=10)
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                conn.request("POST", "/search", json.dumps(
                    {"query": QUERIES[i % len(QUERIES)], "limit": 3, "mode": "hybrid"}).encode())
                codes[i] = conn.getresponse().status
                conn.close()
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors, errors[:3]
        assert codes == [200] * n
        assert state.batcher.batched_queries == n
