"""The port's spans (``codesearch_tpu_torch/utils/tracing.py``) on the CPU.

- Off (no profiler, no ``recording()``), a span records nothing and costs a
  flag check; no span ever enters ``record_function``.
- Nesting: self time is a span's time less its children's; children inherit
  their root's request id; two threads keep apart parent stacks.
- A span decides at entry whether it records.
- Under ``torch.profiler.profile`` the spans record by themselves, and the
  profiler's own events lie inside the spans that enclose them: one clock.
- A small ``index()`` and ``ranked_chunks`` calls under the profiler record
  every span of the query and index paths, one root a call; calls before the
  profiler starts leave nothing. ``SearchSession``'s stage timings and
  ``IndexStats.elapsed_s`` are the spans' durations on the monotonic clock.
- ``DynamicBatcher`` sums its requests' queue wait; ``/status`` reports it.
- The benchmark's readers of these spans, on made-up aggregates.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.request
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from codesearch_tpu_torch.utils import tracing

QUERY_SPANS = ("cs.readplane.query", "cs.readplane.candidates", "cs.readplane.featurize",
               "cs.fts.plan", "cs.store.dispatch", "cs.device.readback",
               "cs.readplane.unpack", "cs.readplane.rank", "cs.rank.materialize")
INDEX_SPANS = ("cs.index.call", "cs.index.open", "cs.index.walk", "cs.index.diff",
               "cs.index.chunk", "cs.embed.batch", "cs.embed.tokenize", "cs.embed.launch",
               "cs.embed.finish", "cs.device.readback", "cs.store.insert", "cs.fts.add",
               "cs.fts.commit", "cs.index.finalize")
QUERIES = ["parse the config file", "flush_buffer", "where is merge_token called"]


@pytest.fixture(autouse=True)
def _clean():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture()
def no_record_function(monkeypatch):
    """Any ``record_function`` range raises."""
    def refuse(*a, **kw):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__", refuse)


def _busy(seconds: float) -> None:
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


def test_off_records_nothing(no_record_function):
    assert tracing.span("cs.x") is tracing.span("cs.y", n=3)      # one shared object
    with tracing.span("cs.x", n=1) as sp:
        assert not sp
        sp.add(n=2)
        with tracing.span("cs.y"):
            pass
    tracing.count("cs.counter", 5)
    with tracing.stage("cs.z") as st:
        _busy(0.002)
    assert st.seconds >= 0.002 and st.ms == st.seconds * 1e3
    from codesearch_tpu_torch.utils.device import to_host

    assert to_host(torch.ones(3))[0].tolist() == [1.0, 1.0, 1.0]
    assert tracing.snapshot() == {"spans": {}, "counters": {}}
    assert tracing.spans() == []


def test_on_records_without_record_function(no_record_function):
    with tracing.recording():
        with tracing.span("cs.x", n=1) as sp:
            assert sp
            sp.add(n=2, m=1)
        tracing.count("cs.counter", 5)
        tracing.count("cs.counter")
    snap = tracing.snapshot()
    assert snap["spans"]["cs.x"]["count"] == 1
    assert snap["spans"]["cs.x"]["counts"] == {"n": 3, "m": 1}
    assert snap["counters"] == {"cs.counter": 6}


def test_nesting_self_time_and_requests():
    with tracing.recording():
        for _ in range(2):
            with tracing.span("cs.root"):
                _busy(0.003)
                with tracing.span("cs.child"):
                    _busy(0.004)
                    with tracing.span("cs.leaf"):
                        _busy(0.002)
                with tracing.span("cs.child"):
                    _busy(0.001)
    agg = tracing.snapshot()["spans"]
    assert agg["cs.root"]["count"] == 2 and agg["cs.child"]["count"] == 4
    for name, child in (("cs.root", "cs.child"), ("cs.child", "cs.leaf")):
        assert agg[name]["self_s"] == pytest.approx(agg[name]["total_s"]
                                                    - agg[child]["total_s"], abs=1e-9)
    assert agg["cs.leaf"]["self_s"] == agg["cs.leaf"]["total_s"]
    assert agg["cs.root"]["self_s"] >= 0.006 and agg["cs.child"]["self_s"] >= 0.01
    raw = tracing.spans()
    by_id = {s.id: s for s in raw}
    roots = [s for s in raw if s.parent is None]
    assert len(roots) == 2 and len({r.request for r in roots}) == 2
    for s in raw:
        if s.parent is not None:
            parent = by_id[s.parent]
            assert s.request == parent.request
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert [s.name for s in raw[:4]] == ["cs.leaf", "cs.child", "cs.child", "cs.root"]


def test_threads_keep_their_own_parents():
    started, go = threading.Barrier(2), threading.Event()

    def worker(name):
        with tracing.span(f"cs.{name}"):
            started.wait(timeout=10)
            go.wait(timeout=10)
            with tracing.span(f"cs.{name}.child"):
                pass

    with tracing.recording():
        threads = [threading.Thread(target=worker, args=(n,)) for n in ("a", "b")]
        for t in threads:
            t.start()
        go.set()
        for t in threads:
            t.join(timeout=30)
    raw = {s.name: s for s in tracing.spans()}
    assert set(raw) == {"cs.a", "cs.b", "cs.a.child", "cs.b.child"}
    for n in ("a", "b"):
        assert raw[f"cs.{n}"].parent is None
        assert raw[f"cs.{n}.child"].parent == raw[f"cs.{n}"].id
        assert raw[f"cs.{n}.child"].request == raw[f"cs.{n}"].request
    assert raw["cs.a"].request != raw["cs.b"].request


def test_threads_lose_no_span():
    """More threads than cores, switching often: every span and count is
    kept, and each thread's self times still add up."""
    import sys

    n_threads, n_spans = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(n_spans):
                with tracing.span("cs.outer", n=1):
                    with tracing.span("cs.inner"):
                        tracing.count("cs.counted")

        with tracing.recording():
            threads = [threading.Thread(target=worker) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = tracing.snapshot()
    assert snap["spans"]["cs.outer"]["count"] == n_threads * n_spans
    assert snap["spans"]["cs.outer"]["counts"] == {"n": n_threads * n_spans}
    assert snap["counters"] == {"cs.counted": n_threads * n_spans}
    outer, inner = snap["spans"]["cs.outer"], snap["spans"]["cs.inner"]
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"], abs=1e-9)
    raw = tracing.spans()
    by_id = {s.id: s for s in raw}
    assert len(by_id) == len(raw) == 2 * n_threads * n_spans
    assert all(by_id[s.parent].name == "cs.outer" for s in raw if s.name == "cs.inner")
    assert len({s.request for s in raw}) == n_threads * n_spans


def test_a_span_decides_at_entry():
    with tracing.span("cs.before"):
        with tracing.recording():
            with tracing.span("cs.inner"):
                pass
    with tracing.recording():
        outer = tracing.span("cs.after")
        outer.__enter__()
    outer.__exit__(None, None, None)
    raw = tracing.spans()
    assert [s.name for s in raw] == ["cs.inner", "cs.after"]
    assert raw[0].parent is None       # its enclosing span never recorded
    assert "cs.before" not in tracing.snapshot()["spans"]


def test_profiler_turns_recording_on_and_shares_its_clock(no_record_function):
    x = torch.randn(64, 64)
    with tracing.span("cs.before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(8):
            with tracing.span("cs.mm"):
                x @ x
    with tracing.span("cs.after"):
        pass
    spans = [s for s in tracing.spans() if s.name == "cs.mm"]
    assert len(spans) == 8 and set(tracing.snapshot()["spans"]) == {"cs.mm"}
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(events) == 8
    for e in events:
        assert any(s.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= s.end_ns
                   for s in spans), e.start_ns()


# ---------------------------------------------------------------------------
# the program's paths
# ---------------------------------------------------------------------------

def _write_repo(repo, salt: int = 0) -> None:
    """A git repository of seven small files; ``salt`` makes every chunk's
    content its own, so no other repository's chunks are in the embedding
    cache."""
    (repo / ".git").mkdir(parents=True)
    (repo / "src").mkdir()
    for f, noun in enumerate(("config", "buffer", "token", "socket", "record", "cache")):
        body = "\n\n".join(
            f"def {verb}_{noun}(arg):\n    \"\"\"{verb.capitalize()} the {noun}.\"\"\"\n"
            f"    return arg.{noun}_{i} + {f + 100 * salt}\n"
            for i, verb in enumerate(("parse", "merge", "flush", "validate", "scan")))
        (repo / "src" / f"{noun}.py").write_text(body)
    (repo / "src" / "lib.rs").write_text(
        "/// Parse the config.\npub fn parse_config(data: &[u8]) -> u64 {\n"
        f"    {salt}\n}}\n")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """bge-small cut to hidden 64 and 2 layers (the registry entry swapped
    for the module) and a small repository indexed with it: (repo, db)."""
    from codesearch_tpu_torch.index import IndexOptions, index
    from codesearch_tpu_torch.models import registry as treg

    repo = tmp_path_factory.mktemp("tracing") / "repo"
    _write_repo(repo)
    with pytest.MonkeyPatch.context() as mp:
        spec = treg.MODELS["bge-small"]
        arch = dataclasses.replace(spec.arch, hidden=64, heads=4, intermediate=96, layers=2)
        mp.setitem(treg.MODELS, "bge-small", dataclasses.replace(spec, arch=arch, dims=64))
        tracing.reset()
        stats = index(repo, IndexOptions(model="bge-small", quiet=True), device="cpu")
        assert stats.chunks_added >= 30
        yield repo, stats.db_path


def _stores(db):
    from codesearch_tpu_torch.embed import EmbeddingService
    from codesearch_tpu_torch.index.manager import SharedStores

    stores = SharedStores(db, 64, readonly=True, device="cpu")
    stores.store.host_path_rows = 0
    stores.fts.device_min_docs = 1
    return stores, EmbeddingService("bge-small", use_persistent_cache=False, device="cpu")


def test_index_and_queries_record_every_span(small, tmp_path, monkeypatch):
    from codesearch_tpu_torch.embed import EmbeddingService
    from codesearch_tpu_torch.index import IndexOptions, index
    from codesearch_tpu_torch.server import readplane

    repo, db = small
    stores, service = _stores(db)
    # the calls the benchmark wraps stay where it looks for them
    seen = {"candidates": 0, "rank": 0, "embed": 0, "encode": 0}
    for name, owner, attr in (("candidates", readplane, "device_candidates"),
                              ("rank", readplane, "rank_candidates"),
                              ("embed", EmbeddingService, "embed_chunks_matrix_async"),
                              ("encode", service.backend.encoder, "encode")):
        fn = getattr(owner, attr)

        def counted(*a, _fn=fn, _name=name, **kw):
            seen[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(owner, attr, counted)
    meta = {"primary_language": "Python"}
    with stores.lock:                                   # warm-up, unrecorded
        readplane.ranked_chunks(stores, service, meta, QUERIES[0], limit=5)
    warm, fresh = tmp_path / "warm", tmp_path / "fresh"
    _write_repo(warm, salt=1)
    _write_repo(fresh, salt=2)
    index(warm, IndexOptions(model="bge-small", quiet=True), device="cpu")
    assert tracing.snapshot() == {"spans": {}, "counters": {}}

    with profile(activities=[ProfilerActivity.CPU]):
        st = index(fresh, IndexOptions(model="bge-small", quiet=True), device="cpu")
        hits = []
        for q in QUERIES:
            with stores.lock:
                hits.append(readplane.ranked_chunks(stores, service, meta, q, limit=5))
    assert all(hits)
    assert seen["candidates"] == seen["rank"] == 4 and seen["embed"] >= 2
    assert seen["encode"] == 4
    agg = tracing.snapshot()["spans"]
    missing = [n for n in QUERY_SPANS + INDEX_SPANS if n not in agg]
    assert not missing, missing
    assert agg["cs.readplane.query"]["count"] == len(QUERIES)
    assert agg["cs.readplane.candidates"]["count"] == len(QUERIES)
    assert agg["cs.index.call"]["count"] == 1
    assert st.elapsed_s == pytest.approx(agg["cs.index.call"]["total_s"], rel=0.05, abs=5e-3)
    walk, chunk = agg["cs.index.walk"]["counts"], agg["cs.index.chunk"]["counts"]
    assert walk["files"] == st.files_walked
    assert chunk["files"] == st.files_indexed and chunk["chunks"] == st.chunks_added
    tok = agg["cs.embed.tokenize"]["counts"]
    assert tok["texts"] == st.chunks_added and tok["tokens"] > tok["texts"]
    sent = agg["cs.embed.launch"]["counts"]
    assert 0 < sent["tokens"] <= tok["tokens"] and sent["padded"] >= 0
    feat = agg["cs.readplane.featurize"]["counts"]
    assert feat["tokens"] > 0 and feat["padded"] >= 0
    # every recorded moment of a root is its own or one child's: self times
    # add up to the roots' time, request by request
    raw = tracing.spans()
    roots = {s.request: s for s in raw if s.parent is None}
    assert sorted(s.name for s in roots.values()) == ["cs.index.call"] + \
        ["cs.readplane.query"] * len(QUERIES)
    by_id = {s.id: s for s in raw}
    own = {s.id: s.end_ns - s.start_ns for s in raw}
    for s in raw:
        if s.parent is not None:
            own[s.parent] -= s.end_ns - s.start_ns
            assert by_id[s.parent].request == s.request
    for req, root in roots.items():
        assert sum(own[s.id] for s in raw if s.request == req) == root.end_ns - root.start_ns
    # the store's entry returns its results unread: the read plane reads a
    # query's back, so ``cs.store.dispatch`` is the enqueue alone
    names_under = {by_id[s.parent].name for s in raw if s.name == "cs.device.readback"}
    assert names_under == {"cs.readplane.candidates", "cs.embed.finish"}
    assert not any(by_id[s.parent].name == "cs.store.dispatch" for s in raw if s.parent)


def test_search_session_timings_are_the_stage_spans(small, monkeypatch):
    from codesearch_tpu_torch.index import IndexOptions, index
    from codesearch_tpu_torch.search import SearchOptions, SearchSession

    repo, db = small
    session = SearchSession(db, device="cpu")
    session.store.host_path_rows = 0
    session.fts.device_min_docs = 1
    monkeypatch.setattr(time, "time", lambda: 1000.0)   # a wall clock that stands still
    resp = session.search(QUERIES[0], SearchOptions(limit=5))
    t = resp.timings_ms
    assert set(t) == {"embed", "vector", "fusion", "total"}
    assert all(v > 0 for v in t.values())
    assert t["total"] >= t["embed"] + t["vector"] + t["fusion"]
    assert session.search(QUERIES[0], SearchOptions(limit=5)).timings_ms["cached"] is True
    with profile(activities=[ProfilerActivity.CPU]):
        resp = session.search(QUERIES[2], SearchOptions(limit=5))
        waves = session.search_many(QUERIES[:2] + ["scan_socket"], SearchOptions(limit=5))
    assert all(w.timings_ms["total"] > 0 for w in waves[2:])
    agg = tracing.snapshot()["spans"]
    for name in ("cs.search.query", "cs.search.featurize", "cs.search.dispatch",
                 "cs.search.wave"):
        assert agg[name]["count"] == 1, name
    assert agg["cs.search.fusion"]["count"] == 3         # the query's and the wave's two
    raw = tracing.spans()
    first = next(s for s in raw if s.name == "cs.search.fusion")
    assert (first.end_ns - first.start_ns) / 1e6 == pytest.approx(
        resp.timings_ms["fusion"], rel=0.05, abs=0.5)
    by_id = {s.id: s for s in raw}
    readback = [s for s in raw if s.name == "cs.device.readback"]
    assert any(by_id[s.parent].name == "cs.search.dispatch" for s in readback)
    st = index(repo, IndexOptions(model="bge-small", quiet=True), device="cpu")
    assert st.elapsed_s > 0


def test_batcher_sums_queue_wait(monkeypatch):
    from codesearch_tpu_torch.server import readplane

    monkeypatch.setattr(readplane, "device_candidates_many",
                        lambda stores, service, items: [(q, None) for q, _k, _f in items])
    stores = SimpleNamespace(lock=threading.RLock(), fts=None)
    batcher = readplane.DynamicBatcher(stores, None, window_s=0.2)
    assert batcher.get("alone", None, 10) == ("alone", None)
    assert 0.0 <= batcher.queue_wait_s < 0.2             # a lone request waits no window
    lone = batcher.queue_wait_s
    batcher._last_arrival = time.monotonic()             # traffic is flowing
    n, out = 4, [None] * 4
    barrier = threading.Barrier(n)

    def worker(i):
        barrier.wait(timeout=10)
        out[i] = batcher.get(f"q{i}", None, 10)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert out == [(f"q{i}", None) for i in range(n)]
    assert batcher.batched_queries == n + 1 and batcher.waves < n + 1
    assert batcher.queue_wait_s - lone >= 0.2            # the leader waited its window


def test_status_reports_queue_wait(small):
    from codesearch_tpu_torch.server import http

    repo, _db = small
    httpd, state = http.make_server(repo, host="127.0.0.1", port=0, initial_index=False,
                                    device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        state.batcher.queue_wait_s = 0.25
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        status = json.loads(urllib.request.urlopen(base + "/status", timeout=60).read())
        assert status["batch_queue_wait_s"] == 0.25
        assert {"batch_waves", "batched_queries"} <= set(status)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        if state.manager is not None:
            state.manager.stop()
        if state._writer_lock is not None:
            state._writer_lock.release()


# ---------------------------------------------------------------------------
# the benchmark's readers of the spans
# ---------------------------------------------------------------------------

def _agg(total, self_s=None, count=1, **counts):
    return {"count": count, "total_s": total, "self_s": total if self_s is None else self_s,
            "counts": counts}


SNAPSHOT = {"spans": {
    "cs.readplane.query": _agg(0.080, count=4),
    "cs.readplane.featurize": _agg(0.012, count=4, tokens=60, padded=20),
    "cs.fts.plan": _agg(0.008, count=4),
    "cs.store.dispatch": _agg(0.030, 0.020, count=4),
    "cs.device.readback": _agg(0.004, count=4),
    "cs.readplane.unpack": _agg(0.006, count=8),
    "cs.rank.materialize": _agg(0.010, count=4),
    "cs.index.open": _agg(0.5),
    "cs.index.walk": _agg(0.2),
    "cs.index.diff": _agg(0.1, count=2),
    "cs.index.chunk": _agg(0.4),
    "cs.embed.tokenize": _agg(1.0),
    "cs.model.load": _agg(0.3, bytes=1 << 20, tensors=8),
}, "counters": {}}
READS = {
    "readplane.featurize_ms.query": 3.0, "readplane.padded_share.query": 25.0,
    "readplane.plan_ms.query": 2.0, "readplane.launch_ms.query": 5.0,
    "readplane.readback_ms.query": 1.0, "readplane.unpack_ms.query": 1.5,
    "ranking.materialize_ms.query": 2.5,
    "index.open_share": 12.5, "index.walk_share": 7.5, "index.chunk_share": 10.0,
    "embed.tokenize_share.index": 25.0, "embed.readback_share.index": 0.1,
    "model.load_share.index": 7.5,
}


@pytest.mark.parametrize("name", sorted(READS))
def test_span_readers(name, monkeypatch):
    from bench_cells.harness import metric_reader

    read = metric_reader(name)
    trace = {"queries": 4} if name.endswith(".query") else {"index_wall_s": 4.0}
    assert read(trace) is None                           # nothing recorded
    monkeypatch.setattr(tracing, "snapshot", lambda: SNAPSHOT)
    assert read(trace) == pytest.approx(READS[name])
    assert read({}) is None                              # not its cell's trace
    assert read({"queries": 4, "index_wall_s": 4.0}) == pytest.approx(READS[name])


def test_span_readers_without_the_module(monkeypatch):
    """On a program that has no tracing module the readers read None."""
    import sys

    from bench_cells.harness import metric_reader

    import codesearch_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "codesearch_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(utils, "tracing")
    for name in READS:
        trace = {"queries": 4, "index_wall_s": 4.0}
        assert metric_reader(name)(trace) is None, name
