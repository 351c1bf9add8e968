"""The encoder's inference forward replayed as CUDA graphs (``BertEncoder.encode``).

On the CPU: which forwards ``graph_key`` admits (rows rounded up to a power
of two, at most ``GRAPH_MAX_ROWS``; never trainable, on a mesh or off
CUDA), and that ``encode`` on CPU tensors runs eagerly with no
``encoder.*`` counter and no graph.

On the card (``cuda`` marker), at bge-small's and nomic-v1.5's widths, 12
layers (one layer's random init repeated, a vocabulary of 512): a replay
equals the eager forward bit for bit at 1 and 4 rows and within one bf16
step at 3 rows (padded to 4); results of two calls are independent
tensors; a shape runs eagerly, then is captured, then replayed, with the
counters to match; kernel d counts 12 launches a replay; 65 rows, a
trainable encoder and CPU tensors never capture; a capture while the
profiler records; and a hybrid query through ``ranked_chunks`` ranks the
same list with graphs as with the eager forward.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from codesearch_tpu_torch.models import encoder as te
from codesearch_tpu_torch.models.registry import MODELS
from codesearch_tpu_torch.ops import attention as ta
from codesearch_tpu_torch.utils import tracing

SMALL = dataclasses.replace(MODELS["bge-small"].arch, vocab_size=97, hidden=64, layers=2,
                            heads=2, intermediate=128)
COUNTERS = ("encoder.graph_replays", "encoder.graph_captures", "encoder.eager_forwards")


def _counters() -> dict:
    c = tracing.snapshot()["counters"]
    return {name: c.get(name, 0) for name in COUNTERS}


def _inputs(rows: int, seq: int, vocab: int, seed: int, device="cpu"):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(1, vocab, (rows, seq)).astype(np.int32))
    mask = torch.zeros(rows, seq, dtype=torch.int32)
    for r, n in enumerate(rng.integers(1, seq + 1, rows)):
        mask[r, :n] = 1
    return ids.to(device), mask.to(device)


# ---------------------------------------------------------------------------
# the rule, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows, seq, want", [
    (1, 16, (1, 16)), (2, 32, (2, 32)), (3, 64, (4, 64)), (4, 16, (4, 16)),
    (5, 128, (8, 128)), (33, 512, (64, 512)), (64, 16, (64, 16)), (65, 16, None),
    (128, 64, None), (256, 512, None), (0, 16, None),
])
def test_graph_key_rounds_rows_and_caps_them(rows, seq, want):
    assert te.graph_key(rows, seq, "cuda", False, None) == want


@pytest.mark.parametrize("device_type, trainable, mesh", [
    ("cpu", False, None), ("cuda", True, None), ("cuda", True, object()),
    ("cuda", False, object()), ("meta", False, None),
])
def test_graph_key_refuses_what_runs_eagerly(device_type, trainable, mesh):
    assert te.graph_key(1, 16, device_type, trainable, mesh) is None


@pytest.mark.parametrize("trainable", [False, True], ids=["inference", "trainable"])
def test_encode_on_cpu_is_eager_and_counts_nothing(trainable):
    enc = te.BertEncoder(SMALL, te.init_params(SMALL), device="cpu", trainable=trainable)
    ids, mask = _inputs(3, 16, SMALL.vocab_size, seed=0)
    with torch.inference_mode():
        want = enc._pooled(ids, mask)
    tracing.reset()
    with tracing.recording():
        outs = [enc.encode(ids, mask) for _ in range(3)]
    assert _counters() == dict.fromkeys(COUNTERS, 0)
    assert not enc._graphs.graphs and not enc._graphs.seen
    for out in outs:
        assert torch.equal(out.detach(), want)
    assert outs[0] is not outs[1]


def test_an_encoder_is_freed_without_the_garbage_collector():
    # graphs hold the device's memory: they go with their encoder as soon as
    # its last reference does, as the weights do
    import gc
    import weakref

    gc.disable()
    try:
        enc = te.BertEncoder(SMALL, te.init_params(SMALL), device="cpu")
        ids, mask = _inputs(1, 16, SMALL.vocab_size, seed=1)
        enc.encode(ids, mask)
        gone = weakref.ref(enc)
        del enc
        assert gone() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("counters, want", [
    ({}, None),
    ({"encoder.eager_forwards": 2}, 0.0),
    ({"encoder.graph_replays": 98, "encoder.graph_captures": 1,
      "encoder.eager_forwards": 1}, 98.0),
    ({"encoder.graph_replays": 5}, 100.0),
])
def test_graph_share_reader(counters, want, monkeypatch):
    from bench_cells.harness import metric_reader

    read = metric_reader("model.graph_share.query")
    monkeypatch.setattr(tracing, "snapshot", lambda: {"spans": {}, "counters": counters})
    assert read({"queries": 4}) == (None if want is None else pytest.approx(want))
    assert read({"index_wall_s": 4.0}) is None          # not its cell's trace


def test_graph_share_reader_without_the_module(monkeypatch):
    import sys

    from bench_cells.harness import metric_reader

    import codesearch_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "codesearch_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(utils, "tracing")
    assert metric_reader("model.graph_share.query")({"queries": 4}) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@functools.cache
def _one_layer(cfg):
    return te.init_params(dataclasses.replace(cfg, layers=1))


def _encoder(name: str, trainable: bool = False, layers: int = 12) -> te.BertEncoder:
    """``name``'s widths, ``layers`` copies of one randomly initialised layer,
    a vocabulary of 512 (the full random init takes tens of seconds)."""
    cfg = dataclasses.replace(MODELS[name].arch, vocab_size=512)
    one = _one_layer(cfg)
    params = {**one, "layers": [dict(one["layers"][0]) for _ in range(layers)]}
    return te.BertEncoder(dataclasses.replace(cfg, layers=layers), params, device="cuda",
                          trainable=trainable)


@pytest.fixture(scope="module", params=["bge-small", "nomic-v1.5"])
def model(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return request.param


def _eager(enc, ids, mask):
    with torch.inference_mode():
        return enc._pooled(ids, mask)


def _three_calls(enc, ids, mask):
    """The shape's eager call, its capture and its first replay."""
    return [enc.encode(ids, mask) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4])
def test_replay_equals_the_eager_forward_bit_for_bit(cuda, model, rows):
    enc = _encoder(model)
    ids, mask = _inputs(rows, 32, 512, seed=rows, device=cuda)
    want = _eager(enc, ids, mask)
    for out in _three_calls(enc, ids, mask):
        assert out.shape == want.shape and torch.equal(out, want)
    assert (rows, 32) in enc._graphs.graphs


@pytest.mark.cuda
def test_replay_of_padded_rows_within_one_bf16_step(cuda, model):
    enc = _encoder(model)
    ids, mask = _inputs(3, 64, 512, seed=3, device=cuda)
    want = _eager(enc, ids, mask)
    outs = _three_calls(enc, ids, mask)
    assert torch.equal(outs[0], want)
    step = 2.0 ** -8 * want.abs().max()
    for out in outs[1:]:
        assert out.shape == (3, want.shape[1])
        assert (out - want).abs().max() <= step
    assert set(enc._graphs.graphs) == {(4, 64)}
    # a later call of 4 rows under the same key leaves no row of the 3-row call
    ids4, mask4 = _inputs(4, 64, 512, seed=4, device=cuda)
    assert torch.equal(enc.encode(ids4, mask4), _eager(enc, ids4, mask4))
    assert (enc.encode(ids, mask) - want).abs().max() <= step


@pytest.mark.cuda
def test_results_of_two_calls_are_independent(cuda, model):
    enc = _encoder(model)
    a_ids, a_mask = _inputs(2, 16, 512, seed=10, device=cuda)
    b_ids, b_mask = _inputs(2, 16, 512, seed=11, device=cuda)
    _three_calls(enc, a_ids, a_mask)
    a = enc.encode(a_ids, a_mask)
    kept = a.clone()
    b = enc.encode(b_ids, b_mask)
    torch.cuda.synchronize()
    assert torch.equal(a, kept)
    assert torch.equal(b, _eager(enc, b_ids, b_mask)) and not torch.equal(a, b)
    assert a.data_ptr() != b.data_ptr()


@pytest.mark.cuda
def test_a_shape_runs_eagerly_then_captures_then_replays(cuda, model):
    enc = _encoder(model)
    ids, mask = _inputs(1, 16, 512, seed=20, device=cuda)
    tracing.reset()
    want = [{"encoder.graph_replays": 0, "encoder.graph_captures": 0,
             "encoder.eager_forwards": 1},
            {"encoder.graph_replays": 0, "encoder.graph_captures": 1,
             "encoder.eager_forwards": 1},
            {"encoder.graph_replays": 1, "encoder.graph_captures": 1,
             "encoder.eager_forwards": 1},
            {"encoder.graph_replays": 2, "encoder.graph_captures": 1,
             "encoder.eager_forwards": 1}]
    with tracing.recording():
        for i, counts in enumerate(want):
            enc.encode(ids, mask)
            assert _counters() == counts, i
            assert (len(enc._graphs.graphs) == 1) == (i >= 1)


@pytest.mark.cuda
def test_kernel_d_counts_twelve_launches_a_replay(cuda, model):
    enc = _encoder(model)
    ids, mask = _inputs(1, 32, 512, seed=30, device=cuda)
    ta.reset_launch_counts()
    for i in range(1, 5):           # eager, capture (its warm-up runs), replays
        enc.encode(ids, mask)
        assert ta.launch_counts["attention_full"] == 12 * i
        assert ta.launches_by_seq["attention_full", 32] == 12 * i
    assert ta.launch_counts["attention_flash"] == 0
    assert ta.composed_counts == dict.fromkeys(ta.composed_counts, 0)


@pytest.mark.cuda
def test_what_runs_eagerly_never_captures(cuda):
    tracing.reset()
    with tracing.recording():
        enc = _encoder("bge-small", layers=2)
        ids, mask = _inputs(65, 16, 512, seed=40, device=cuda)
        for _ in range(3):
            enc.encode(ids, mask)
        assert not enc._graphs.graphs and not enc._graphs.seen
        assert _counters()["encoder.eager_forwards"] == 3
        cpu_ids, cpu_mask = ids[:1].cpu(), mask[:1].cpu()
        cpu_enc = te.BertEncoder(enc.cfg, enc.to_params(), device="cpu")
        for _ in range(3):
            cpu_enc.encode(cpu_ids, cpu_mask)
        assert not cpu_enc._graphs.graphs
        trainable = _encoder("bge-small", trainable=True, layers=2)
        for _ in range(3):
            out = trainable.encode(ids[:1], mask[:1])
        assert out.requires_grad and not trainable._graphs.graphs
    assert _counters() == {"encoder.graph_replays": 0, "encoder.graph_captures": 0,
                           "encoder.eager_forwards": 3}


@pytest.mark.cuda
def test_capture_while_the_profiler_records(cuda):
    enc = _encoder("bge-small", layers=2)
    ids, mask = _inputs(1, 16, 512, seed=50, device=cuda)
    want = _eager(enc, ids, mask)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        outs = _three_calls(enc, ids, mask)
        torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs) and enc._graphs.graphs
    assert tracing.snapshot()["counters"].get("encoder.graph_replays", 0) >= 1


@pytest.mark.cuda
def test_ranked_chunks_equal_with_graphs_and_eager(cuda, tmp_path, monkeypatch):
    from codesearch_tpu_torch.embed import EmbeddingService
    from codesearch_tpu_torch.index.manager import SharedStores
    from codesearch_tpu_torch.server.readplane import ranked_chunks
    from codesearch_tpu_torch.vectordb import ChunkMetadata

    spec = MODELS["bge-small"]
    spec = dataclasses.replace(spec, arch=dataclasses.replace(spec.arch, layers=2))
    service = EmbeddingService(spec, use_persistent_cache=False, device=cuda)
    words = ["parse", "config", "render", "schema", "hash", "matrix", "walk", "token",
             "index", "store", "query", "batch"]
    rng = np.random.default_rng(60)
    n = 600
    metas = []
    for i in range(n):
        body = " ".join(rng.choice(words, 12))
        name = f"fn_{i}_{words[i % len(words)]}"
        metas.append(ChunkMetadata(path=f"src/m{i % 40}.py", content=f"def {name}():\n    {body}\n",
                                   start_line=1, end_line=2, kind="function",
                                   signature=f"def {name}()", language="python"))
    vecs = rng.standard_normal((n, spec.dims)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    stores = SharedStores(tmp_path / "db", spec.dims, readonly=False, device=cuda)
    ids = stores.store.insert_chunks_with_ids(vecs, metas)
    stores.fts.add_chunks([(i, m.content, m.path, m.signature, m.kind)
                           for i, m in zip(ids, metas)])
    stores.fts.commit()
    stores.store.build_index()
    stores.store.host_path_rows = 0
    stores.fts.device_min_docs = 1
    metadata = {"primary_language": "python"}
    queries = ["parse the config schema", "fn_7_walk", "where is fn_30_render called",
               "hash a token batch", "render", "store the matrix index for a query"]

    def run():
        with stores.lock:
            return [[(s, cid) for s, cid, _m in
                     ranked_chunks(stores, service, metadata, q, limit=10)] for q in queries]

    enc = service.backend.encoder
    with monkeypatch.context() as m:
        m.setattr(enc, "encode", lambda i, k: _eager(enc, i, k))
        want = run()
    assert all(want)
    for _ in range(3):
        assert run() == want
    assert enc._graphs.graphs
