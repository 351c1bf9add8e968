"""Encoder families as modules of their own (``bench_cells/families/``).

The bert and nomic families are held to values that the harness gave before
its family code moved into these modules (``data/families_parity.json``:
each configuration's sizes, checkpoint layout, work counts and served-model
comparison; seeded weights and reference forwards at a tiny size on the
CPU), bit for bit. A third, windowed family is added to a copy of the
benchmark as new files alone, and the windowed counts are held to a brute
force."""

import hashlib
import json
import re
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from bench_cells.drivers.common import check_served_model
from bench_cells.gen.weights import make_weights, tensor_specs
from bench_cells.harness import HERE, model_dims
from bench_cells.reference.encoder import Encoder
from bench_cells.roofline import (attention_work, encoder_flops, matmul_params, weight_bytes,
                                  window_pairs)

FROZEN = json.loads((HERE / "tests" / "data" / "families_parity.json").read_text())
CONFIGS = sorted(FROZEN["dims"])


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _tiny_dims(family):
    return {"family": family, "hidden": 64, "layers": 2, "heads": 4, "intermediate": 128,
            "vocab": 1200, "positions": 64, "eps": 1e-12, "rope_base": 1000.0,
            "type_vocab": 2, "pooling": "cls" if family == "bert" else "mean"}


def _tiny_inputs():
    g = torch.Generator().manual_seed(2024)
    ids = torch.randint(999, 1200, (3, 20), generator=g)
    mask = torch.zeros(3, 20)
    for i, n in enumerate((20, 13, 5)):
        mask[i, :n] = 1
    return ids, mask


@pytest.fixture
def one_thread():
    """One CPU thread, as the frozen forwards were computed with."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CONFIGS)
def test_sizes_and_checkpoint_layout_are_frozen(name):
    dims = model_dims(_config(name))
    assert dims == FROZEN["dims"][name]
    assert [[n, list(s), k] for n, s, k in tensor_specs(dims)] == FROZEN["tensor_specs"][name]


@pytest.mark.parametrize("family", ["bert", "nomic"])
def test_seeded_weights_are_frozen(family):
    h = hashlib.sha256()
    for k, v in make_weights(_tiny_dims(family), 7, "cpu").items():
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(str(v.dtype).encode())
        h.update(v.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == FROZEN["weights_sha256"][family]


@pytest.mark.parametrize("quant", [None, "fp8"])
@pytest.mark.parametrize("family", ["bert", "nomic"])
def test_reference_forward_is_frozen(family, quant, one_thread):
    dims = _tiny_dims(family)
    enc = Encoder(dims, make_weights(dims, 7, "cpu"), "cpu", quant=quant)
    got = enc.encode(*_tiny_inputs())
    assert got.tolist() == FROZEN["encode"][family][quant or "f32"]


@pytest.mark.parametrize("name", CONFIGS)
def test_work_counts_are_frozen(name):
    dims, want, lengths = model_dims(_config(name)), FROZEN["counts"][name], FROZEN["lengths"]
    assert matmul_params(dims) == want["matmul_params"]
    assert weight_bytes(dims) == want["weight_bytes"]
    assert encoder_flops(dims, lengths) == want["encoder_flops"]
    assert encoder_flops(dims, [17]) == want["encoder_flops_one"]
    assert list(attention_work(dims, lengths)) == want["attention_work"]
    # every layer of these families is full: the full layers are all of them
    assert list(attention_work(dims, lengths, windowed=False)) == want["attention_work"]
    assert attention_work(dims, lengths, windowed=True) == (0.0, 0.0)


def _changed(value):
    if isinstance(value, str):
        return value + "x"
    return value * 2 if isinstance(value, float) else value + 1


@pytest.mark.parametrize("name", CONFIGS)
def test_served_model_comparison_is_frozen(name, tmp_path):
    """The program's attributes compared are exactly the frozen ones: a spec
    holding only those passes, and a change to any one of them fails."""
    cfg, frozen = _config(name), FROZEN["served"][name]
    dims = model_dims(cfg)

    def spec(arch=frozen["arch"], prefix=frozen["query_prefix"]):
        return SimpleNamespace(arch=SimpleNamespace(**arch), query_prefix=prefix,
                               short_name=name)

    check_served_model(spec(), tmp_path, cfg, dims)
    for attr, value in frozen["arch"].items():
        with pytest.raises(RuntimeError, match="the configuration states"):
            check_served_model(spec(arch={**frozen["arch"], attr: _changed(value)}),
                               tmp_path, cfg, dims)
    with pytest.raises(RuntimeError, match="the configuration states"):
        check_served_model(spec(prefix=frozen["query_prefix"] + "x"), tmp_path, cfg, dims)


@pytest.mark.parametrize("window", [0, 1, 2, 3, 8, 9, 128])
def test_window_pairs_against_brute_force(window):
    lengths = [0, 1, 2, 3, 4, 5, 8, 9, 17, 64, 65, 100, 130]
    want = [sum(1 for i in range(n) for j in range(n)
                if not window or abs(i - j) <= window // 2) for n in lengths]
    assert window_pairs(lengths, window).tolist() == want


def test_a_window_of_128_at_512_tokens():
    assert window_pairs([512], 128).tolist() == [61_888]
    assert window_pairs([512], 0).tolist() == [262_144]


def test_windowed_attention_against_a_loop():
    """Each valid query row attends to the valid keys with |i - j| <= w // 2;
    a padding row with no such key reads zeros, never NaN."""
    torch.manual_seed(3)
    enc = Encoder(_tiny_dims("bert"), {}, "cpu")
    b, h, s, dh, window = 2, 3, 24, 8, 8
    q, k, v = (torch.randn(b, h, s, dh) for _ in range(3))
    mask = torch.ones(b, s)
    mask[1, 6:] = 0
    got = enc._attend(q, k, v, mask, window)
    assert torch.isfinite(got).all()
    for bi in range(b):
        n = int(mask[bi].sum())
        for i in range(n):
            keys = [j for j in range(n) if abs(i - j) <= window // 2]
            scores = torch.einsum("hd,hkd->hk", q[bi, :, i], k[bi, :, keys]) / dh ** 0.5
            want = torch.einsum("hk,hkd->hd", torch.softmax(scores, -1), v[bi, :, keys])
            torch.testing.assert_close(got[bi, :, i], want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1, :, 6 + window // 2:], torch.zeros(h, s - 6 - window // 2, dh))
    full = enc._attend(q, k, v, mask)
    assert torch.equal(enc._attend(q, k, v, mask, 0), full)
    assert not torch.allclose(got[0], full[0])


TOY_FAMILY = '''"""A toy windowed family: rotary, post-norm, bias-free, a ReLU MLP, mean
pooling; its layers' windows come from its configuration."""

import torch


def dims(cfg):
    c = cfg["config"]
    return {"family": "toy", "hidden": c["width"], "layers": len(c["windows"]),
            "heads": c["heads"], "intermediate": c["ffn"], "vocab": c["vocab"],
            "positions": c["positions"], "eps": 1e-5, "type_vocab": 0,
            "pooling": cfg["pooling"], "windows": c["windows"]}


def tensor_specs(d):
    h, i = d["hidden"], d["intermediate"]
    out = [("tok.weight", (d["vocab"], h), "dense"), ("norm.weight", (h,), "norm"),
           ("norm.bias", (h,), "bias")]
    for n in range(d["layers"]):
        p = f"layers.{n}."
        out += [(p + "qkv.weight", (3 * h, h), "dense"), (p + "out.weight", (h, h), "dense"),
                (p + "ln.weight", (h,), "norm"), (p + "ln.bias", (h,), "bias"),
                (p + "up.weight", (i, h), "dense"), (p + "down.weight", (h, i), "dense")]
    return out


def matmul_params(d):
    h, i = d["hidden"], d["intermediate"]
    return (4 * h * h + 2 * h * i) * d["layers"]


def layer_windows(d):
    return list(d["windows"])


def forward(enc, ids, mask):
    h = enc.dims["hidden"]
    x = enc._ln(enc.w["tok.weight"][ids], "norm")
    for n, window in enumerate(layer_windows(enc.dims)):
        p = f"layers.{n}."
        q, k, v = (enc._heads(t) for t in enc._lin(x, p + "qkv", bias=False).split(h, dim=-1))
        q, k = enc._rope(q, 10000.0), enc._rope(k, 10000.0)
        a = enc._lin(enc._merge(enc._attend(q, k, v, mask, window)), p + "out", bias=False)
        x = enc._ln(x + a, p + "ln")
        x = x + enc._lin(torch.relu(enc._lin(x, p + "up", bias=False)), p + "down", bias=False)
    return (x * mask[:, :, None]).sum(1) / mask.sum(1, keepdim=True)


def served(d):
    return {"arch_style": "toy", "local_window": max(d["windows"])}
'''

TOY_CONFIG = {"name": "toy-windowed", "source": "https://example.org/toy", "registry_model": "toy",
              "family": "toy", "pooling": "mean", "query_prefix": "q: ",
              "config": {"width": 32, "heads": 2, "ffn": 64, "vocab": 1100, "positions": 64,
                         "windows": [0, 8]},
              "assumed": {}, "reduced": []}

TOY_RUN = '''
import json, sys
from pathlib import Path
from types import SimpleNamespace

import torch

import bench_cells
from bench_cells.drivers.common import check_served_model
from bench_cells.families import family
from bench_cells.gen.weights import make_weights
from bench_cells.harness import Cell
from bench_cells.reference.encoder import Encoder
from bench_cells.roofline import attention_work, encoder_flops, matmul_params, weight_bytes

root = Path.cwd()
assert Path(bench_cells.__file__).resolve().is_relative_to(root.resolve()), bench_cells.__file__
cell = Cell("toy-windowed.index", root)
w = make_weights(cell.dims, 3, "cpu")
g = torch.Generator().manual_seed(5)
ids = torch.randint(999, 1100, (3, 20), generator=g)
mask = torch.ones(3, 20)
mask[1, 11:] = 0
mask[2, 3:] = 0
out = Encoder(cell.dims, w, "cpu").encode(ids, mask)
toy = family("toy")
windows = toy.layer_windows
toy.layer_windows = lambda d: [0] * d["layers"]
unwindowed = Encoder(cell.dims, w, "cpu").encode(ids, mask)
toy.layer_windows = windows
arch = dict(hidden=32, layers=2, heads=2, intermediate=64, vocab_size=1100, layer_norm_eps=1e-5,
            pooling="mean", arch_style="toy", local_window=8)
spec = SimpleNamespace(arch=SimpleNamespace(**arch), query_prefix="q: ", short_name="toy")
check_served_model(spec, root, cell.config, cell.dims)
spec.arch.local_window = 0
try:
    check_served_model(spec, root, cell.config, cell.dims)
    refused = False
except RuntimeError:
    refused = True
lengths = [1, 3, 11, 20]
print(json.dumps({
    "dims": cell.dims, "tensors": sorted(w), "finite": bool(torch.isfinite(out).all()),
    "norms": out.norm(dim=-1).tolist(), "window_moves": not torch.allclose(out, unwindowed),
    "refused": refused, "matmul_params": matmul_params(cell.dims),
    "weight_bytes": weight_bytes(cell.dims), "flops": encoder_flops(cell.dims, lengths),
    "attention": {str(k): attention_work(cell.dims, lengths, windowed=k)
                  for k in (None, False, True)}}))
'''


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_family_is_added_by_new_files_alone(tmp_path):
    """A windowed family and a configuration that names it, added to a copy
    of the benchmark as two new files and a new entry: the copy's unchanged
    harness loads the cell, draws the weights, runs the reference forward on
    the CPU, counts the work by window and holds the served model to it."""
    shutil.copytree(HERE, tmp_path / "bench_cells", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "bench_cells")
    (tmp_path / "bench_cells" / "families" / "toy.py").write_text(TOY_FAMILY)
    (tmp_path / "bench_cells" / "configs" / "toy-windowed.json").write_text(json.dumps(TOY_CONFIG))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-windowed", "source": "https://example.org/toy",
                             "file": "bench_cells/configs/toy-windowed.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "toy-windowed.index", "config": "toy-windowed",
                               "traffic": "index", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", TOY_RUN], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "PYTHONPATH": str(tmp_path), "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["dims"]["windows"] == [0, 8] and got["dims"]["layers"] == 2
    assert len(got["tensors"]) == 3 + 2 * 6
    assert got["finite"] and got["norms"] == pytest.approx([1.0] * 3)
    assert got["window_moves"] and got["refused"]
    h, lengths = 32, [1, 3, 11, 20]
    assert got["matmul_params"] == 2 * (4 * h * h + 2 * h * 64)
    assert got["weight_bytes"] == 2 * got["matmul_params"]
    full = sum(n * n for n in lengths)
    banded = sum(1 for n in lengths for i in range(n) for j in range(n) if abs(i - j) <= 4)
    per_layer_bytes = 8 * h * sum(lengths) + 4 * sum(lengths)
    assert got["attention"] == {"None": [2 * per_layer_bytes, 4 * h * (full + banded)],
                                "False": [per_layer_bytes, 4 * h * full],
                                "True": [per_layer_bytes, 4 * h * banded]}
    assert got["flops"] == 2 * got["matmul_params"] * sum(lengths) + 4 * h * (full + banded)
    after = _digest(tmp_path / "bench_cells")
    assert {k: v for k, v in after.items() if k in before} == before


def test_no_family_branch_outside_the_family_modules():
    """What differs between families lives in their modules alone."""
    branch = re.compile(r"""family"?'?\]\s*==|\.family\s*==""")
    for path in HERE.rglob("*.py"):
        rel = path.relative_to(HERE)
        if rel.parts[0] in ("families", "tests"):
            continue
        assert not branch.search(path.read_text()), rel
