"""Port of the boosted score-row top-k (kernel c) held against the JAX package.

The port's plain version runs against ``fused_scores_topk`` in interpret
mode and against the XLA route of ``ops/bm25.py`` ``_dense_scores_topk``
on the same numpy inputs. Selection only multiplies by 1 or 3, so values
and indices are exact on every filled position; dead slots differ only in
their sentinel (-3e38 in Pallas and the port, -inf on the XLA route), so
positions a reference fills with a dead slot are compared by count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codesearch_tpu.ops.bm25 import _dense_scores_topk as jax_dense_topk
from codesearch_tpu.ops.pallas_topk import fused_scores_topk as pallas_scores
from codesearch_tpu_torch.ops import bm25, fused_topk

N = 4096
DEAD = bm25.DEAD_SLOT


def _inputs(seed: int, b: int, n_live: int | None = None):
    rng = np.random.default_rng(seed)
    scores = rng.random((b, N)).astype(np.float32)
    scores[:, ::3] = 0.0                                   # no dense term
    scores[:, 1::5] = scores[:, 0::5][:, : scores[:, 1::5].shape[1]]  # exact ties
    meta = rng.integers(0, 6, N).astype(np.int32)
    meta[rng.random(N) < 0.05] = DEAD
    if n_live is not None:
        meta[:] = DEAD
        meta[rng.choice(N, n_live, replace=False)] = 2
    kid = (np.arange(b) % 7 - 1).astype(np.int32)         # -1: no boost
    return scores, meta, kid


def _port(scores, meta, kid, k):
    return fused_topk.fused_scores_topk(torch.from_numpy(scores), torch.from_numpy(meta),
                                        torch.from_numpy(kid), k, DEAD)


def _assert_exact_filled(vals, idx, rv, ri):
    vals, idx, rv, ri = map(np.asarray, (vals, idx, rv, ri))
    filled = rv > -1e29
    np.testing.assert_array_equal((vals > -1e29).sum(1), filled.sum(1))
    np.testing.assert_array_equal(vals[filled], rv[filled])
    np.testing.assert_array_equal(idx[filled], ri[filled])


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("k", [1, 8, 256])
def test_matches_pallas_interpret(b, k):
    scores, meta, kid = _inputs(b * 100 + k, b)
    rv, ri = pallas_scores(jnp.asarray(scores), jnp.asarray(meta), jnp.asarray(kid), k,
                           DEAD, tile=1024, interpret=True)
    _assert_exact_filled(*_port(scores, meta, kid, k), rv, ri)


@pytest.mark.parametrize("k", [8, 500])
def test_matches_xla_route(k):
    scores, meta, kid = _inputs(7, 4)
    rv, ri = jax_dense_topk(jnp.asarray(scores), jnp.asarray(meta), jnp.asarray(kid), k)
    _assert_exact_filled(*_port(scores, meta, kid, k), rv, ri)


def test_more_k_than_live_slots():
    scores, meta, kid = _inputs(8, 2, n_live=5)
    rv, ri = pallas_scores(jnp.asarray(scores), jnp.asarray(meta), jnp.asarray(kid), 8,
                           DEAD, tile=1024, interpret=True)
    vals, idx = _port(scores, meta, kid, 8)
    _assert_exact_filled(vals, idx, rv, ri)
    assert (vals[:, 5:] == np.float32(fused_topk.NEG_INF)).all()


def test_boost_and_tie_order():
    scores = np.zeros((1, N), np.float32)
    scores[0, [10, 20, 30]] = 1.0
    meta = np.zeros(N, np.int32)
    meta[20] = 4
    meta[30] = DEAD
    vals, idx = _port(scores, meta, np.array([4], np.int32), 3)
    assert idx.tolist() == [[20, 10, 0]]          # boosted x3, then ties by index
    assert vals.tolist() == [[3.0, 1.0, 0.0]]


def test_dense_route_on_cpu_launches_nothing():
    scores, meta, kid = _inputs(9, 2)
    fused_topk.reset_launch_counts()
    got = bm25._dense_scores_topk(torch.from_numpy(scores), torch.from_numpy(meta),
                                  torch.from_numpy(kid), 64)
    ref = fused_topk.fused_scores_topk_plain(torch.from_numpy(scores), torch.from_numpy(meta),
                                             torch.from_numpy(kid), 64, DEAD)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert fused_topk.launch_counts["fused_scores_topk"] == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("k", [1, 10, 256, 1024])
def test_kernel_matches_plain_on_cuda(cuda, b, k):
    scores, meta, kid = _inputs(11, b)
    args = [torch.from_numpy(a).to(cuda) for a in (scores, meta, kid)]
    got = fused_topk.fused_scores_topk(*args, k, DEAD)
    ref = fused_topk.fused_scores_topk_plain(*args, k, DEAD)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1024, 4096, 8192, 20000])
def test_deep_k_matches_plain_on_cuda(cuda, k):
    # 65,536 columns (64 CTAs a row of the radix select), deep k included
    rng = np.random.default_rng(12)
    n = 65536
    scores = rng.random((2, n)).astype(np.float32)
    scores[:, ::3] = 0.0
    scores[:, 1::5] = scores[:, 0::5][:, : scores[:, 1::5].shape[1]]
    meta = rng.integers(0, 6, n).astype(np.int32)
    meta[rng.random(n) < 0.05] = DEAD
    args = [torch.from_numpy(a).to(cuda) for a in (scores, meta, np.array([2, -1], np.int32))]
    got = fused_topk.fused_scores_topk(*args, k, DEAD)
    ref = fused_topk.fused_scores_topk_plain(*args, k, DEAD)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [8192, 20000])
def test_dense_leg_at_deep_k_on_cuda(cuda, k):
    # the dense leg at deep k runs the kernel (no bound but the columns)
    scores, meta, kid = _inputs(13, 1)
    scores = np.tile(scores, (1, 8))
    meta = np.tile(meta, 8)
    args = [torch.from_numpy(a).to(cuda) for a in (scores, meta, kid)]
    before = fused_topk.launch_counts["fused_scores_topk"]
    got = bm25._dense_scores_topk(*args, k)
    assert fused_topk.launch_counts["fused_scores_topk"] == before + 1
    ref = fused_topk.fused_scores_topk_plain(*args, k, DEAD)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(ValueError, match="selectable columns"):
        fused_topk.fused_scores_topk(*args, scores.shape[1] + 1, DEAD)
    assert fused_topk.launch_counts["fused_scores_topk"] == before + 1
