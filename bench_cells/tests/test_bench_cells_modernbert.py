"""ModernBERT-large as a family module and a configuration of the benchmark,
and the two readers of the windowed kernel: its roofline share and the
share of windowed layers that ran it."""

import json
import math
from types import SimpleNamespace

import pytest

from bench_cells.drivers.common import check_served_model
from bench_cells.families import family
from bench_cells.gen.weights import tensor_specs
from bench_cells.harness import HERE, ROOT, Cell, load_benchmark, metric_reader, model_dims
from bench_cells.roofline import attention_work, bound_s, encoder_flops, matmul_params

CONFIG = json.loads((HERE / "configs" / "modernbert-large.json").read_text())
MB = model_dims(CONFIG)


def test_dims_are_the_published_ones():
    assert MB == {"family": "modernbert", "hidden": 1024, "layers": 28, "heads": 16,
                  "intermediate": 2624, "vocab": 50368, "positions": 8192, "eps": 1e-5,
                  "rope_base": 160000.0, "rope_base_local": 10000.0, "local_window": 128,
                  "global_every": 3, "type_vocab": 0, "pooling": "mean"}
    assert CONFIG["reduced"] == [] and CONFIG["served_dtype"] == "bfloat16"


def test_matrix_product_weights_and_checkpoint_size():
    # fused QKV 3 x 1024^2, Wo 1024^2, Wi 1024 x 5248, mlp Wo 2624 x 1024, 28 layers
    assert matmul_params(MB) == 28 * (4 * 1024 * 1024 + 3 * 1024 * 2624) == 343_146_496
    specs = tensor_specs(MB)
    total = sum(math.prod(shape) for _, shape, _ in specs)
    assert total - matmul_params(MB) == 50368 * 1024 + (2 + 2 * 28 - 1) * 1024
    assert total == 394_781_696


def test_layer_windows():
    windows = family("modernbert").layer_windows(MB)
    assert windows == [0 if i % 3 == 0 else 128 for i in range(28)]
    assert windows.count(0) == 10 and windows.count(128) == 18


def test_tensor_names_are_those_the_program_loads():
    specs = {name: (shape, kind) for name, shape, kind in tensor_specs(MB)}
    assert "layers.0.attn_norm.weight" not in specs
    assert specs["layers.1.attn_norm.weight"] == ((1024,), "norm")
    assert specs["layers.27.mlp.Wi.weight"] == ((5248, 1024), "dense")
    assert specs["layers.27.mlp.Wo.weight"] == ((1024, 2624), "dense")
    assert specs["layers.5.attn.Wqkv.weight"] == ((3072, 1024), "dense")
    assert specs["embeddings.tok_embeddings.weight"] == ((50368, 1024), "dense")
    assert {k for k, (_, kind) in specs.items() if kind == "bias"} == set()
    assert specs["final_norm.weight"] == ((1024,), "norm")
    assert len(specs) == 2 + 28 * 5 + 27 + 1


def test_the_programs_registry_entry_serves_the_configuration(tmp_path):
    from codesearch_tpu_torch.models.registry import MODELS

    spec = MODELS[CONFIG["registry_model"]]
    check_served_model(spec, tmp_path, CONFIG, MB)
    fake = SimpleNamespace(arch=SimpleNamespace(**{**vars(spec.arch), "local_window": 64}),
                           query_prefix=spec.query_prefix, short_name=spec.short_name)
    with pytest.raises(RuntimeError, match="the configuration states"):
        check_served_model(fake, tmp_path, CONFIG, MB)


def test_the_cell_is_declared():
    bench = load_benchmark(ROOT)
    cell = Cell("modernbert-large.index", ROOT, bench)
    assert cell.workload["config"] == "modernbert-large" and cell.workload["chips"] == 1
    assert cell.traffic["driver"] == "index_repos"
    assert set(cell.limits) == {"chunk_set", "stored_vectors"}
    assert [m["name"] for m in cell.end_to_end()] == ["setup_s", "index_chunks_per_s"]
    layers = {m["name"] for m in cell.per_layer()}
    assert {"kernel_dw.roofline.index", "model.window_kernel_share.index",
            "kernel_d.roofline.index", "mfu.index"} <= layers
    assert "kernel_dw.roofline.index" not in {
        m["name"] for m in Cell("nomic-v1.5.index", ROOT, bench).per_layer()}


D_LAUNCH = ("void (anonymous namespace)::attention_two_sweep<64, 1, 4, false>(bf16 const*)", 2e-3)
DW_LAUNCH = ("void (anonymous namespace)::attention_window_band<64, 4>(bf16 const*)", 1e-3)


def _trace(kernels, **kw):
    t = {"window_s": 4.0, "busy_s": 1.0, "index_calls": 2, "index_wall_s": 4.0,
         "dims": MB, "text_tokens": [100, 300], "kernels": kernels}
    t.update(kw)
    return t


def test_kernel_d_reads_alike_with_and_without_the_windowed_launches():
    read = metric_reader("kernel_d.roofline.index")
    alone = read(_trace([D_LAUNCH]))
    assert alone == read(_trace([D_LAUNCH, DW_LAUNCH, DW_LAUNCH]))
    nbytes, ops = attention_work(MB, [100, 300], windowed=False)
    assert alone == pytest.approx(100 * bound_s(nbytes, ops) / 2e-3)


def test_windowed_roofline_reads_its_own_launches():
    read = metric_reader("kernel_dw.roofline.index")
    nbytes, ops = attention_work(MB, [100, 300], windowed=True)
    # 18 layers: q and o, K and V of the valid keys, the mask; the band's pairs
    assert nbytes == 18 * (8 * 1024 * 400 + 4 * 400)
    assert ops == 18 * 4 * 1024 * ((100 * 129 - 64 * 65) + (300 * 129 - 64 * 65))
    assert read(_trace([D_LAUNCH, DW_LAUNCH, DW_LAUNCH])) == pytest.approx(
        100 * bound_s(nbytes, ops) / 2e-3)
    assert read(_trace([D_LAUNCH])) is None           # the parent: no such kernel
    assert read({"kernels": [DW_LAUNCH]}) is None
    assert encoder_flops(MB, [100]) > 2 * matmul_params(MB) * 100


@pytest.mark.parametrize("counters,want", [
    ({"attention.window_kernel": 36}, 100.0),
    ({"attention.window_kernel": 27, "attention.window_composed": 9}, 75.0),
    ({"attention.window_composed": 18}, 0.0),
    ({}, None),                                         # the parent, or no windowed layer
    ({"encoder.graph_replays": 4}, None),
])
def test_window_kernel_share_reads_the_counters(monkeypatch, counters, want):
    from codesearch_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "snapshot", lambda: {"spans": {}, "counters": counters})
    read = metric_reader("model.window_kernel_share.index")
    assert read(_trace([])) == want
    assert read({"queries": 3}) is None                # a query cell's trace
