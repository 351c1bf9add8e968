"""The per-layer arithmetic against hand-worked shapes: the work the
yardstick counts for each model and kernel, and every reader on a small
made-up trace."""

import json

import pytest

from bench_cells.harness import HERE, ROOT, Cell, load_benchmark, metric_reader, model_dims
from bench_cells.roofline import (HBM_BYTES_PER_S, PEAK_OPS_PER_S, attention_work, bound_s,
                                  encoder_flops, matmul_params, score_pass_work, weight_bytes)

BGE = model_dims(json.loads((HERE / "configs" / "bge-small.json").read_text()))
NOMIC = model_dims(json.loads((HERE / "configs" / "nomic-v1.5.json").read_text()))


def test_model_work_by_hand():
    # bge-small: 4 x 384^2 + 2 x 384 x 1536 a layer, 12 layers
    assert matmul_params(BGE) == 12 * (4 * 384 * 384 + 2 * 384 * 1536) == 21_233_664
    # nomic: fused QKV 3 x 768^2, output 768^2, fc11 + fc12 2 x 768 x 3072, fc2 3072 x 768
    assert matmul_params(NOMIC) == 12 * (4 * 768 * 768 + 3 * 768 * 3072) == 113_246_208
    assert weight_bytes(BGE) == 2 * 21_233_664
    # two texts of 10 and 20 tokens: 2 x params x 30 + 4 x 12 x 384 x (100 + 400)
    assert encoder_flops(BGE, [10, 20]) == 2 * 21_233_664 * 30 + 4 * 12 * 384 * 500


def test_kernel_work_by_hand():
    nbytes, ops = attention_work(NOMIC, [3])
    assert nbytes == 12 * (8 * 768 * 3 + 4 * 3)
    assert ops == 12 * 4 * 768 * 9
    nbytes, ops = score_pass_work(262_144, 384, 1, 30)
    assert nbytes == 262_144 * 384 * 2 + 262_144 + 384 * 4 + 30 * 8
    assert ops == 2 * 262_144 * 384
    assert bound_s(nbytes, ops) == pytest.approx(nbytes / HBM_BYTES_PER_S)
    assert bound_s(0, 989e12) == pytest.approx(1.0)
    assert PEAK_OPS_PER_S["bf16"] == 989e12


def _query_trace(**kw):
    t = {"window_s": 2.0, "busy_s": 0.5, "queries": 2,
         "spans": {"bench.readplane.candidates": (0.030, 2), "bench.readplane.rank": (0.010, 2)},
         "query_tokens": [16, 20], "posting_bytes": [8000, 0], "corpus_rows": 262_144,
         "dims": BGE, "weight_bytes": weight_bytes(BGE), "top_k": 30,
         "kernels": [("void cosine_scores<false>(float const*)", 1e-4),
                     ("void select_hist<(anonymous namespace)::RowKeys, 0>(RowKeys)", 1e-5),
                     ("void select_collect<(anonymous namespace)::RowKeys>(RowKeys)", 1e-5),
                     ("void select_sort(Select)", 1e-5),
                     ("void select_hist<(anonymous namespace)::ScoreKeys, 0>(ScoreKeys)", 5e-5),
                     ("void select_collect<(anonymous namespace)::ScoreKeys>(ScoreKeys)", 5e-5),
                     ("void select_sort(Select)", 5e-5)]}
    t.update(kw)
    return t


def test_query_readers():
    t = _query_trace()
    assert metric_reader("readplane.candidates_ms.query")(t) == pytest.approx(15.0)
    assert metric_reader("readplane.rank_ms.query")(t) == pytest.approx(5.0)
    assert metric_reader("device_idle.query")(t) == pytest.approx(75.0)
    sb, so = score_pass_work(262_144, 384, 1, 30)
    want = 100 * bound_s(sb, so) / 1.3e-4          # a's kernels, not c's select
    assert metric_reader("kernel_a.roofline.query")(t) == pytest.approx(want)
    least = sum(bound_s(weight_bytes(BGE), encoder_flops(BGE, [n])) + bound_s(sb, so)
                + p / HBM_BYTES_PER_S for n, p in ((16, 8000), (20, 0)))
    assert metric_reader("mfu.query")(t) == pytest.approx(100 * least / 2.0)


def _index_trace(**kw):
    t = {"window_s": 4.0, "busy_s": 1.0, "index_calls": 2, "index_wall_s": 4.0,
         "spans": {"bench.index.embed": (1.0, 4), "bench.index.embed_wait": (1.0, 4),
                   "bench.index.store": (0.5, 9)},
         "tokens": 750, "padded_tokens": 1000, "dims": NOMIC, "text_tokens": [100, 200],
         "kernels": [("void attention_two_sweep<1, 4>(bf16 const*)", 2e-3),
                     ("ampere_bf16_s16816gemm", 5e-3)]}
    t.update(kw)
    return t


def test_index_readers():
    t = _index_trace()
    assert metric_reader("index.embed_share")(t) == pytest.approx(50.0)
    assert metric_reader("index.store_share")(t) == pytest.approx(12.5)
    assert metric_reader("embed.padded_share.index")(t) == pytest.approx(25.0)
    assert metric_reader("device_idle.index")(t) == pytest.approx(75.0)
    flops = 2 * matmul_params(NOMIC) * 300 + 4 * 12 * 768 * (100 ** 2 + 200 ** 2)
    assert metric_reader("mfu.index")(t) == pytest.approx(100 * flops / 4.0 / 989e12)
    nb, ops = attention_work(NOMIC, [100, 200])
    assert metric_reader("kernel_d.roofline.index")(t) == pytest.approx(
        100 * bound_s(nb, ops) / 2e-3)


def _agg(total, self_s=None, count=1, **counts):
    return {"count": count, "total_s": total, "self_s": total if self_s is None else self_s,
            "counts": counts}


# what the program's tracing module holds after a traced run of each cell
PROGRAM_SPANS = {"spans": {
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
}, "counters": {"encoder.graph_replays": 9, "encoder.graph_captures": 1}}


def test_readers_find_nothing_in_the_other_kind_of_trace(monkeypatch):
    """A reader with nothing to read returns None, never 0: the program's
    spans and counters are there for every reader, and the cell's trace
    decides."""
    from codesearch_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "snapshot", lambda: PROGRAM_SPANS)
    bench = load_benchmark(ROOT)
    q, i = _query_trace(), _index_trace()
    for m in bench["per_layer"]:
        read = metric_reader(m["name"])
        mine = q if m["moves"] in ("query_p95_ms", "queries_per_s") else i
        other = i if mine is q else q
        assert read(mine) is not None, m["name"]
        assert read(other) is None, m["name"]
        assert read({}) is None, m["name"]
    assert metric_reader("kernel_a.roofline.query")(_query_trace(kernels=[])) is None
    assert metric_reader("kernel_d.roofline.index")(_index_trace(kernels=[])) is None


def test_every_cell_reports_what_its_readers_move():
    bench = load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = Cell(w["name"], ROOT, bench)
        e2e = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = cell.per_layer()
        assert layers and all(m["moves"] in e2e for m in layers)
        assert {m["name"] for m in layers} == {
            m["name"] for m in bench["per_layer"] if w["name"] in m["workloads"]}


class _Event:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._c else DeviceType.CPU


def test_reduce_counts_only_the_calls_intervals():
    """An index run's trace: the device's work and idle gaps inside the
    calls count, the time between calls (writing the next repository)
    does not."""
    from types import SimpleNamespace

    from bench_cells.trace import reduce

    events = [_Event("k", 100, 50, True), _Event("k", 400, 100, True),
              _Event("late", 900, 10, True), _Event("bench.index.embed", 0, 300, False)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    t = reduce(prof, intervals=[(0, 300), (350, 600)])
    assert t["window_s"] == pytest.approx(550e-9)
    assert t["busy_s"] == pytest.approx(150e-9)
    assert dict(t["idle_gaps"]) == pytest.approx({"bench.index.embed": 250e-9,
                                                  "outside any span": 150e-9})


def test_traced_window_drops_the_spans_before_it():
    from bench_cells.trace import Tracer

    tr = Tracer(True)
    with tr.span("bench.x"):
        pass
    with tr.window():
        with tr.span("bench.y"):
            pass
        tr.stop()
        with tr.span("bench.y"):
            pass
    assert dict(tr.counts) == {"bench.y": 1}
