"""The windowed attention of ModernBERT's local layers (``ops/attention.py``
``attention_window``, the windowed kernel of ``csrc/attention_kernels.cu``)
and the ModernBERT encoder held to the benchmark's plain reference.

- The plain twin against ``reference_attention(window=w)`` in f32 on every
  valid query row, at the f32 tolerance ``tests/test_torch_attention.py``
  holds d's twin to: Dh 32 and 64, S in {16, 64, 127, 128, 200, 512}, w in
  {8, 16, 128}, on a full row, ragged rows, a row of three valid keys, a
  row with holes and a fully masked row. A query row whose band holds no
  valid key (a padding row) reads 0 in the twin, as it does in the kernel.
- The route: on the CPU ``fused_encoder_attention(window=w)`` is
  ``reference_attention`` and counts nothing; on the CUDA branch (the
  wrappers' CUDA branch on CPU tensors, the twin standing in for the
  launch) a call outside autograd launches the windowed kernel, counted in
  ``launch_counts``, ``launches_by_seq`` and the program counter
  ``attention.window_kernel``; under autograd it takes the composed route,
  counted in ``composed_counts["window"]`` and ``attention.window_composed``.
  A CUDA graph's replay re-adds both program counters.
- A small ModernBERT (hidden 64, 6 layers: 0 and 3 global, 4 heads, window
  8, S up to 40) with seeded weights written as a checkpoint under the
  family's tensor names, loaded by ``load_safetensors`` into a CPU
  ``BertEncoder``, against ``bench_cells/families/modernbert.py``'s float32
  reference forward through ``bench_cells.reference.encoder.Encoder``; the
  same reference with its window removed fails that comparison.
- On the card (``cuda``): the kernel against ``reference_attention(window=w)``
  on valid rows within d's bf16 tolerance and against its twin on every row,
  at the same shapes; every output finite; the encoder's strided views.
"""

import dataclasses

import numpy as np
import pytest
import torch

from codesearch_tpu_torch.models import encoder as te
from codesearch_tpu_torch.models.registry import MODELS
from codesearch_tpu_torch.ops import _build
from codesearch_tpu_torch.ops import attention as ta
from codesearch_tpu_torch.utils import tracing

F32_TOL = {"atol": 2e-5, "rtol": 2e-3}
BF16_TOL = {"atol": 1e-2, "rtol": 1e-2}
HEADS = 2
SEQS = [16, 64, 127, 128, 200, 512]
WINDOWS = [8, 16, 128]


def _mask(s: int, seed: int) -> np.ndarray:
    """[5, S]: a full row, a ragged one, three valid keys (every query row
    past 3 + w // 2 has no valid key in its band), holes, fully masked."""
    rng = np.random.default_rng(seed)
    m = np.zeros((5, s), np.float32)
    m[0] = 1.0
    m[1, :max(1, int(s * 0.6))] = 1.0
    m[2, :3] = 1.0
    m[3] = (rng.random(s) > 0.4).astype(np.float32)
    m[3, 0] = 1.0
    return m


def _inputs(s: int, dh: int, seed: int):
    rng = np.random.default_rng(seed)
    mask = _mask(s, seed)
    q, k, v = (rng.standard_normal((mask.shape[0], HEADS, s, dh)).astype(np.float32)
               for _ in range(3))
    return q, k, v, mask


def _no_key_rows(mask: np.ndarray, window: int) -> np.ndarray:
    """[B, S] True where a query row's band holds no valid key."""
    s = mask.shape[1]
    i = np.arange(s)
    band = np.abs(i[:, None] - i[None, :]) <= window // 2
    return ~(band[None] & (mask[:, None, :] != 0)).any(-1)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("dh", [32, 64])
def test_twin_matches_the_reference_on_valid_rows(dh, s, window):
    q, k, v, mask = _inputs(s, dh, seed=s + dh + window)
    t = [torch.from_numpy(a) for a in (q, k, v, mask)]
    got = ta.attention_window_plain(*t, window).numpy()
    ref = ta.reference_attention(*t, window=window).numpy()
    valid = mask.astype(bool)
    for b in range(mask.shape[0]):
        np.testing.assert_allclose(got[b][:, valid[b]], ref[b][:, valid[b]], **F32_TOL)
    assert np.isfinite(got).all()
    empty = _no_key_rows(mask, window)
    assert empty[2].any() == (s > 3 + window // 2) and empty[4].all() and not empty[0].any()
    assert (got.transpose(0, 2, 1, 3)[empty] == 0).all()


def test_twin_equals_the_reference_where_the_window_covers_every_key():
    q, k, v, mask = _inputs(64, 32, seed=9)
    t = [torch.from_numpy(a) for a in (q, k, v, mask)]
    got = ta.attention_window_plain(*t, 128)
    valid = mask.astype(bool)
    ref = ta.attention_full_plain(*t).numpy()
    for b in range(4):        # the fully masked row reads 0, not d's average
        np.testing.assert_allclose(got[b].numpy()[:, valid[b]], ref[b][:, valid[b]], **F32_TOL)


def test_cpu_route_is_the_reference_and_counts_nothing():
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(64, 32, seed=3))
    ta.reset_launch_counts()
    tracing.reset()
    with tracing.recording():
        got = ta.fused_encoder_attention(q, k, v, mask, window=16)
    assert torch.equal(got, ta.reference_attention(q, k, v, mask, window=16))
    assert ta.launch_counts == dict.fromkeys(ta.launch_counts, 0)
    assert ta.composed_counts == dict.fromkeys(ta.composed_counts, 0)
    assert tracing.snapshot()["counters"] == {}


@pytest.fixture
def as_if_cuda(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors, the twin standing in for
    the windowed kernel's launch; the library is never loaded."""
    monkeypatch.setattr(ta, "_on_cpu", lambda *t: False)

    def no_load(*a, **k):
        raise AssertionError("the kernel library was loaded")

    def launch(entry, q, k, v, mask, *ints):
        assert entry == "cs_attention_window"
        return ta.attention_window_plain(q, k, v, mask, *ints)

    monkeypatch.setattr(_build, "load", no_load)
    monkeypatch.setattr(ta, "_launch", launch)
    ta.reset_launch_counts()
    tracing.reset()
    yield
    ta.reset_launch_counts()
    tracing.reset()


def _bf16(s=64, dh=32):
    q, k, v, mask = _inputs(s, dh, seed=11)
    return [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)] + [torch.from_numpy(mask)]


def test_cuda_route_launches_the_windowed_kernel_outside_autograd(as_if_cuda):
    q, k, v, mask = _bf16()
    with tracing.recording():
        got = ta.fused_encoder_attention(q, k, v, mask, window=16)
    assert torch.equal(got, ta.attention_window_plain(q, k, v, mask, 16))
    assert ta.launch_counts == {"attention_full": 0, "attention_flash": 0, "attention_window": 1}
    assert ta.launches_by_seq == {("attention_window", 64): 1}
    assert ta.composed_counts == {"window": 0, "bias2d": 0, "backward": 0}
    assert tracing.snapshot()["counters"] == {"attention.window_kernel": 1}


def test_cuda_route_composes_the_window_under_autograd(as_if_cuda):
    q, k, v, mask = _bf16()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with tracing.recording():
        out = ta.fused_encoder_attention(*leaves, mask, window=16)
    out.float().sum().backward()
    assert torch.equal(out, ta.reference_attention(q, k, v, mask, window=16))
    assert all(t.grad is not None for t in leaves)
    assert ta.launch_counts == dict.fromkeys(ta.launch_counts, 0)
    assert ta.composed_counts == {"window": 1, "bias2d": 0, "backward": 0}
    assert tracing.snapshot()["counters"] == {"attention.window_composed": 1}


@pytest.mark.parametrize("case", ["window_0", "f32"])
def test_windowed_kernel_refuses_what_it_does_not_take(as_if_cuda, case):
    # a window below 1, and (as d and e) what _check_cuda_inputs refuses
    q, k, v, mask = _bf16()
    if case == "window_0":
        with pytest.raises(ValueError, match="window"):
            ta.attention_window(q, k, v, mask, 0)
    else:
        with pytest.raises(TypeError, match="bf16"):
            ta.attention_window(q.float(), k.float(), v.float(), mask, 16)
    assert ta.launch_counts == dict.fromkeys(ta.launch_counts, 0)


def test_a_graph_replay_re_adds_the_window_counters():
    ta.reset_launch_counts()
    tracing.reset()
    captured = [{"attention_full": 1, "attention_window": 2},
                {("attention_full", 64): 1, ("attention_window", 64): 2}, {"window": 3}]
    with tracing.recording():
        te._add_counts(captured)
        te._add_counts(captured)
    assert ta.launch_counts == {"attention_full": 2, "attention_flash": 0, "attention_window": 4}
    assert ta.launches_by_seq == {("attention_full", 64): 2, ("attention_window", 64): 4}
    assert ta.composed_counts["window"] == 6
    assert tracing.snapshot()["counters"] == {"attention.window_kernel": 4,
                                              "attention.window_composed": 6}
    with tracing.recording():
        te._add_counts(captured, -1)
    assert tracing.snapshot()["counters"] == {"attention.window_kernel": 2,
                                              "attention.window_composed": 3}
    ta.reset_launch_counts()
    tracing.reset()


# ---------------------------------------------------------------------------
# a small ModernBERT against the benchmark's plain reference
# ---------------------------------------------------------------------------

SMALL = {"family": "modernbert", "hidden": 64, "layers": 6, "heads": 4, "intermediate": 96,
         "vocab": 1200, "positions": 8192, "eps": 1e-5, "rope_base": 160000.0,
         "rope_base_local": 10000.0, "local_window": 8, "global_every": 3, "type_vocab": 0,
         "pooling": "mean"}
# the fused QKV weights drawn at 8 times the benchmark's 0.02: at 0.02 the
# scores of a 16-wide head are near 0, every key weighs alike, and a window
# barely moves the mean of the states (no window read 4e-5 to 8e-5 there)
QKV_GAIN = 8.0
# 1 - cos of the port's pooled vector (bf16 activations) against the float32
# reference's, the largest of four texts: the port read at most 2.6e-5 over
# seeds 0-9; the reference without its window 1.6e-2 or more
SMALL_LIMIT = 2e-4


def _small_case(tmp_path, seed: int):
    from bench_cells.gen.weights import make_weights, write_checkpoint

    cfg = dataclasses.replace(MODELS["modernbert-large"].arch, vocab_size=SMALL["vocab"],
                              hidden=SMALL["hidden"], layers=SMALL["layers"],
                              heads=SMALL["heads"], intermediate=SMALL["intermediate"],
                              local_window=SMALL["local_window"])
    weights = {name: (t.float() * QKV_GAIN).half() if "Wqkv" in name else t
               for name, t in make_weights(SMALL, seed, "cpu").items()}
    path = tmp_path / f"modernbert-{seed}" / "model.safetensors"
    write_checkpoint(weights, path)
    enc = te.BertEncoder(cfg, te.load_safetensors(path, cfg, "cpu"), device="cpu")
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(999, SMALL["vocab"], (4, 40), generator=g)
    mask = torch.zeros(4, 40)
    for i, n in enumerate((40, 29, 11, 3)):
        mask[i, :n] = 1
    return enc, weights, ids, mask


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((1.0 - (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_small_modernbert_matches_the_benchmark_reference(tmp_path, seed):
    from bench_cells.reference.encoder import Encoder

    enc, weights, ids, mask = _small_case(tmp_path, seed)
    assert [layer.window for layer in enc.layers] == [0, 8, 8, 0, 8, 8]
    got = enc.encode(ids, mask)
    want = Encoder(SMALL, weights, "cpu").encode(ids, mask)
    assert _gap(got, want) <= SMALL_LIMIT


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_reference_without_its_window_fails_the_comparison(tmp_path, monkeypatch, seed):
    from bench_cells.families import family
    from bench_cells.reference.encoder import Encoder

    enc, weights, ids, mask = _small_case(tmp_path, seed)
    got = enc.encode(ids, mask)
    monkeypatch.setattr(family("modernbert"), "layer_windows", lambda d: [0] * d["layers"])
    want = Encoder(SMALL, weights, "cpu").encode(ids, mask)
    assert _gap(got, want) > SMALL_LIMIT


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("s", SEQS)
@pytest.mark.parametrize("dh", [32, 64])
def test_windowed_kernel_matches_the_reference_on_cuda(cuda, dh, s, window):
    q, k, v, mask = _inputs(s, dh, seed=s + dh + window)
    q, k, v = (torch.from_numpy(a).to(cuda).to(torch.bfloat16) for a in (q, k, v))
    m = torch.from_numpy(mask).to(cuda)
    before = ta.launch_counts["attention_window"]
    got = ta.attention_window(q, k, v, m, window)
    assert ta.launch_counts["attention_window"] == before + 1
    got = got.float().cpu().numpy()
    ref = ta.reference_attention(q, k, v, m, window=window).float().cpu().numpy()
    twin = ta.attention_window_plain(q, k, v, m, window).float().cpu().numpy()
    assert np.isfinite(got).all()
    valid = mask.astype(bool)
    for b in range(mask.shape[0]):
        np.testing.assert_allclose(got[b][:, valid[b]], ref[b][:, valid[b]], **BF16_TOL)
    np.testing.assert_allclose(got, twin, **BF16_TOL)
    assert (got.transpose(0, 2, 1, 3)[_no_key_rows(mask, window)] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 512])
def test_windowed_kernel_takes_the_encoders_strided_views_on_cuda(cuda, s):
    # ModernBERT's q, k, v: [B, H, S, Dh] views of one [B, S, 3 * H * Dh] tensor
    b, h, dh = 3, 16, 64
    qkv = torch.randn(b, s, 3 * h * dh, device=cuda).to(torch.bfloat16)
    q, k, v = (t.view(b, s, h, dh).transpose(1, 2) for t in qkv.split(h * dh, dim=-1))
    mask = torch.ones(b, s, device=cuda)
    mask[1, 40:] = 0
    got = ta.fused_encoder_attention(q, k, v, mask, window=128)
    assert got.stride(1) == dh and got.stride(2) == h * dh     # [B, S, H, Dh] underneath
    ref = ta.attention_window_plain(q.contiguous(), k.contiguous(), v.contiguous(), mask, 128)
    np.testing.assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(), **BF16_TOL)
