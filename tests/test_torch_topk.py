"""Port of the cosine top-k (kernels a and b) held against the JAX package.

The port's plain versions (which serve CPU tensors) run against the Pallas
kernels in interpret mode and against their XLA twins, on the same numpy
inputs. Tolerances: int8 scores are exact against Pallas (same
``(s * q_scale) * row_scale`` order) and within 1e-6 relative against the
XLA twin (``s * (q_scale * row_scale)``); bf16 scores agree within 1e-5
(f32 sums over d in another order), and indices are compared wherever the
reference's neighbouring scores are more than 1e-5 apart. Positions a
reference leaves unfilled (score -3e38: fewer valid rows than k) are
compared only by their count.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codesearch_tpu.ops.pallas_topk import fused_cosine_topk as pallas_cosine
from codesearch_tpu.ops.pallas_topk import fused_cosine_topk_int8 as pallas_cosine_int8
from codesearch_tpu.ops.topk import _cosine_topk_int8_xla, _cosine_topk_xla
from codesearch_tpu.ops.topk import quantize_rows_int8 as jax_quantize
from codesearch_tpu_torch.ops import fused_topk, topk

TOL = 1e-5
N, D, Q = 4096, 64, 4


def _inputs(seed: int, n_valid: int | None = None, nq: int = Q, n: int = N, d: int = D):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c[1::9] = c[0::9][: len(c[1::9])]                    # exact ties
    queries = (c[np.arange(nq) % n] + 0.05 * rng.standard_normal((nq, d))).astype(np.float32)
    valid = rng.random(n) > 0.1
    if n_valid is not None:
        valid[:] = False
        valid[rng.choice(n, n_valid, replace=False)] = True
    return queries, c, valid


def _filled(vals: np.ndarray) -> np.ndarray:
    return vals > -1e29


def _assert_close_topk(vals, idx, ref_vals, ref_idx, tol):
    vals, idx = np.asarray(vals), np.asarray(idx)
    ref_vals, ref_idx = np.asarray(ref_vals), np.asarray(ref_idx)
    filled = _filled(ref_vals)
    np.testing.assert_array_equal(_filled(vals).sum(1), filled.sum(1))
    assert np.abs(vals - ref_vals)[filled].max(initial=0.0) <= tol
    gap = np.abs(np.diff(ref_vals, axis=1)) > tol
    clear = np.ones_like(filled)
    clear[:, :-1] &= gap
    clear[:, 1:] &= gap
    np.testing.assert_array_equal(idx[filled & clear], ref_idx[filled & clear])


def _port_bf16(queries, c, valid, k):
    return fused_topk.fused_cosine_topk(
        torch.from_numpy(queries), torch.from_numpy(c).to(torch.bfloat16),
        torch.from_numpy(valid), k)


@pytest.mark.parametrize("k", [1, 8, 256])
def test_bf16_matches_pallas_interpret(k):
    queries, c, valid = _inputs(0)
    rv, ri = pallas_cosine(jnp.asarray(queries), jnp.asarray(c, jnp.bfloat16),
                           jnp.asarray(valid), k, tile=1024, interpret=True)
    vals, idx = _port_bf16(queries, c, valid, k)
    _assert_close_topk(vals, idx, rv, ri, TOL)


@pytest.mark.parametrize("k", [1, 8, 256, 500])
def test_bf16_matches_xla(k):
    queries, c, valid = _inputs(1)
    rv, ri = _cosine_topk_xla(jnp.asarray(queries), jnp.asarray(c, jnp.bfloat16),
                              jnp.asarray(valid), k)
    vals, idx = _port_bf16(queries, c, valid, k)
    _assert_close_topk(vals, idx, rv, ri, TOL)


def test_k_above_valid_rows():
    queries, c, valid = _inputs(2, n_valid=5)
    k = 8
    rv, ri = pallas_cosine(jnp.asarray(queries), jnp.asarray(c, jnp.bfloat16),
                           jnp.asarray(valid), k, tile=1024, interpret=True)
    vals, idx = _port_bf16(queries, c, valid, k)
    _assert_close_topk(vals, idx, rv, ri, TOL)
    vals = vals.numpy()
    assert (vals[:, 5:] == np.float32(fused_topk.NEG_INF)).all()
    assert valid[idx.numpy()[:, :5]].all()


def test_exact_ties_keep_lowest_index():
    queries, c, valid = _inputs(3)
    valid[:] = True
    queries = c[:Q].copy()                      # row 0 and its copy row 1 tie
    vals, idx = _port_bf16(queries, c, valid, 4)
    assert idx[0, 0].item() == 0 and idx[0, 1].item() == 1
    assert vals[0, 0].item() == vals[0, 1].item()


@pytest.mark.parametrize("nq", [1, 9, 17])
def test_bf16_query_groups_match_pallas_interpret(nq):
    # one query variant, an identifier's nine, and 17: past one 16-query
    # group of the card's score pass
    queries, c, valid = _inputs(11, nq=nq)
    rv, ri = pallas_cosine(jnp.asarray(queries), jnp.asarray(c, jnp.bfloat16),
                           jnp.asarray(valid), 200, tile=1024, interpret=True)
    vals, idx = _port_bf16(queries, c, valid, 200)
    assert vals.shape == (nq, 200)
    _assert_close_topk(vals, idx, rv, ri, TOL)


def _port_int8(queries, cq, scale, valid, k):
    return fused_topk.fused_cosine_topk_int8(
        torch.from_numpy(queries), torch.from_numpy(cq), torch.from_numpy(scale),
        torch.from_numpy(valid), k)


@pytest.mark.parametrize("k", [1, 8, 256])
def test_int8_exact_vs_pallas_interpret(k):
    queries, c, valid = _inputs(4)
    cq, scale = jax_quantize(jnp.asarray(c))
    rv, ri = pallas_cosine_int8(jnp.asarray(queries), cq, scale, jnp.asarray(valid), k,
                                tile=1024, interpret=True)
    vals, idx = _port_int8(queries, np.array(cq), np.array(scale), valid, k)
    rv, ri = np.asarray(rv), np.asarray(ri)
    filled = _filled(rv)
    np.testing.assert_array_equal(vals.numpy()[filled], rv[filled])
    np.testing.assert_array_equal(idx.numpy()[filled], ri[filled])


@pytest.mark.parametrize("nq", [1, 9, 17])
def test_int8_query_groups_exact_vs_pallas_interpret(nq):
    # Bit-exact in every row whose query scale the jitted Pallas wrapper
    # computes as the port does. Jitted on the CPU, XLA computes some rows'
    # absmax / 127 one ulp off the true division (seen at Q >= 8); the port
    # divides exactly, as the eager JAX function does
    # (test_quantize_rows_int8_matches_jax) and kernel b does on the card.
    # Those rows' scores may then differ by one ulp: within 1e-6.
    queries, c, valid = _inputs(12, nq=nq)
    cq, scale = jax_quantize(jnp.asarray(c))
    rv, ri = pallas_cosine_int8(jnp.asarray(queries), cq, scale, jnp.asarray(valid), 200,
                                tile=1024, interpret=True)
    vals, idx = _port_int8(queries, np.array(cq), np.array(scale), valid, 200)
    assert vals.shape == (nq, 200)
    jit_scale = np.asarray(jax.jit(lambda q: jnp.maximum(
        jnp.max(jnp.abs(q), axis=1), 1e-12) / 127.0)(jnp.asarray(queries)))
    same = jit_scale == topk.quantize_rows_int8(torch.from_numpy(queries))[1].numpy()
    assert same.sum() >= nq - 2
    rv, ri, vals, idx = np.asarray(rv), np.asarray(ri), vals.numpy(), idx.numpy()
    np.testing.assert_array_equal(vals[same], rv[same])
    np.testing.assert_array_equal(idx[same], ri[same])
    _assert_close_topk(vals[~same], idx[~same], rv[~same], ri[~same], 1e-6)


@pytest.mark.parametrize("k", [8, 500])
def test_int8_vs_xla(k):
    queries, c, valid = _inputs(5)
    cq, scale = jax_quantize(jnp.asarray(c))
    rv, ri = _cosine_topk_int8_xla(jnp.asarray(queries), cq, scale, jnp.asarray(valid), k)
    vals, idx = _port_int8(queries, np.array(cq), np.array(scale), valid, k)
    # the XLA twin multiplies the scales in the other order: one ulp apart
    _assert_close_topk(vals, idx, rv, ri, 1e-6)


def test_quantize_rows_int8_matches_jax():
    _, c, _ = _inputs(6)
    jq, js = jax_quantize(jnp.asarray(c))
    tq, ts = topk.quantize_rows_int8(torch.from_numpy(c))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_cpu_dispatch_runs_plain_without_launching():
    queries, c, valid = _inputs(7)
    fused_topk.reset_launch_counts()
    q, cb, v = (torch.from_numpy(queries), torch.from_numpy(c).to(torch.bfloat16),
                torch.from_numpy(valid))
    got = topk.cosine_topk(q, cb, v, 16)
    ref = fused_topk.fused_cosine_topk_plain(q, cb, v, 16)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    cq, s = topk.quantize_rows_int8(torch.from_numpy(c))
    topk.cosine_topk_int8(q, cq, s, v, 16)
    assert all(n == 0 for n in fused_topk.launch_counts.values())


def test_wrapper_rejects_only_k_outside_the_columns():
    # no bound but the columns: a k past any shared-memory buffer is taken
    # (on the card by the radix select, as every k is), k above the
    # selectable columns or below 1 raises
    queries, c, valid = _inputs(8)
    c2, valid2 = np.concatenate([c, c]), np.concatenate([valid, valid])
    k = 4097
    vals, _ = topk.cosine_topk(torch.from_numpy(queries), torch.from_numpy(c2).to(torch.bfloat16),
                               torch.from_numpy(valid2), k)
    assert vals.shape == (Q, k)
    for ok in (1, k, 2 * N):
        fused_topk._check_k(ok, 2 * N)
    for bad in (0, 2 * N + 1):
        with pytest.raises(ValueError, match="selectable columns"):
            fused_topk._check_k(bad, 2 * N)


@pytest.mark.parametrize("fn", [fused_topk.fused_cosine_topk, fused_topk.fused_cosine_topk_int8])
def test_wrappers_take_no_second_pass_choice(fn):
    # one second pass for every k: the radix select
    params = inspect.signature(fn).parameters
    assert "pass2" not in params and list(params)[-1] == "k"
    for gone in ("MERGE_MAX_K", "PASS2", "_select", "_ROWS_COSINE"):
        assert not hasattr(fused_topk, gone)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 200, 500, 1024])
def test_kernels_match_plain_on_cuda(cuda, k):
    queries, c, valid = _inputs(9)
    q, v = torch.from_numpy(queries).to(cuda), torch.from_numpy(valid).to(cuda)
    cb = torch.from_numpy(c).to(torch.bfloat16).to(cuda)
    before = fused_topk.launch_counts["fused_cosine_topk"]
    got = fused_topk.fused_cosine_topk(q, cb, v, k)
    assert fused_topk.launch_counts["fused_cosine_topk"] == before + 1
    ref = fused_topk.fused_cosine_topk_plain(q, cb, v, k)
    _assert_close_topk(got[0].cpu(), got[1].cpu(), ref[0].cpu(), ref[1].cpu(), TOL)
    cq, s = topk.quantize_rows_int8(torch.from_numpy(c))
    got = fused_topk.fused_cosine_topk_int8(q, cq.to(cuda), s.to(cuda), v, k)
    ref = fused_topk.fused_cosine_topk_int8_plain(q, cq.to(cuda), s.to(cuda), v, k)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _large_inputs(cuda, n: int):
    # n rows: at 65,536 the score pass has 1,024 tiles of 64 rows, more than
    # its persistent grid, so each CTA walks several
    rng = np.random.default_rng(10)
    c = rng.standard_normal((n, D)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c[1::9] = c[0::9][: len(c[1::9])]
    queries = (c[:Q] + 0.05 * rng.standard_normal((Q, D))).astype(np.float32)
    valid = rng.random(n) > 0.1
    cb = torch.from_numpy(c).to(torch.bfloat16).to(cuda)
    return torch.from_numpy(queries).to(cuda), c, cb, torch.from_numpy(valid).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1024, 4096, 8192, 20000])
def test_deep_k_matches_plain_on_cuda(cuda, k):
    # deep k: the radix select sorts up to 16,384 winners, ranks them above
    q, c, cb, v = _large_inputs(cuda, 65536)
    got = fused_topk.fused_cosine_topk(q, cb, v, k)
    ref = fused_topk.fused_cosine_topk_plain(q, cb, v, k)
    _assert_close_topk(got[0].cpu(), got[1].cpu(), ref[0].cpu(), ref[1].cpu(), TOL)
    cq, s = topk.quantize_rows_int8(torch.from_numpy(c))
    got = fused_topk.fused_cosine_topk_int8(q, cq.to(cuda), s.to(cuda), v, k)
    ref = fused_topk.fused_cosine_topk_int8_plain(q, cq.to(cuda), s.to(cuda), v, k)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


CARD_N = 32768


@pytest.mark.cuda
@pytest.mark.parametrize("d", [384, 768, 40])
@pytest.mark.parametrize("k", [1, 200, 4096, 4097, 20000, CARD_N])
@pytest.mark.parametrize("nq", [1, 9, 16, 17])
def test_score_pass_and_select_match_plain_on_cuda(cuda, nq, k, d):
    # a and b through the tensor-core score pass and the radix select, on
    # rows with exact ties and invalid rows: one query group, a full one and
    # one past it; k up to every row; d = 40 leaves a k tail (80 bytes: two
    # and a half 32-byte k-steps), where b, which takes d % 16 == 0, runs
    # d = 48 (one and a half)
    queries, c, valid = _inputs(13, nq=nq, n=CARD_N, d=d)
    q, v = torch.from_numpy(queries).to(cuda), torch.from_numpy(valid).to(cuda)
    cb = torch.from_numpy(c).to(torch.bfloat16).to(cuda)
    got = fused_topk.fused_cosine_topk(q, cb, v, k)
    ref = fused_topk.fused_cosine_topk_plain(q, cb, v, k)
    assert got[0].shape == (nq, k)
    _assert_close_topk(got[0].cpu(), got[1].cpu(), ref[0].cpu(), ref[1].cpu(), TOL)
    if d % 16:
        queries, c, valid = _inputs(14, nq=nq, n=CARD_N, d=48)
        q, v = torch.from_numpy(queries).to(cuda), torch.from_numpy(valid).to(cuda)
    cq, s = topk.quantize_rows_int8(torch.from_numpy(c))
    got = fused_topk.fused_cosine_topk_int8(q, cq.to(cuda), s.to(cuda), v, k)
    ref = fused_topk.fused_cosine_topk_int8_plain(q, cq.to(cuda), s.to(cuda), v, k)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
def test_quantize_rows_int8_same_on_cuda(cuda):
    # the query quantization that kernel b repeats, bit for bit on both
    # devices (the scale divides by a tensor, never by a Python scalar)
    rows = torch.from_numpy(np.random.default_rng(15).standard_normal((8192, D), np.float32))
    tq, ts = topk.quantize_rows_int8(rows)
    cq, cs = topk.quantize_rows_int8(rows.to(cuda))
    assert torch.equal(cq.cpu(), tq) and torch.equal(cs.cpu(), ts)


@pytest.mark.cuda
def test_k_above_rows_raises_on_cuda(cuda):
    # only k above the rows raises, before any launch
    q, c, cb, v = _large_inputs(cuda, 8192)
    cq, s = topk.quantize_rows_int8(torch.from_numpy(c))
    before = dict(fused_topk.launch_counts)
    with pytest.raises(ValueError, match="selectable columns"):
        topk.cosine_topk(q, cb, v, 8193)
    with pytest.raises(ValueError, match="selectable columns"):
        topk.cosine_topk_int8(q, cq.to(cuda), s.to(cuda), v, 8193)
    assert fused_topk.launch_counts == before
    vals, idx = topk.cosine_topk(q, cb, v, 8192)
    assert vals.shape == (Q, 8192) and torch.equal(idx.sort(dim=1).values[0].cpu(),
                                                   torch.arange(8192, dtype=torch.int32))
