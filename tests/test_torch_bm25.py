"""Port of the resident-postings BM25 (``ops/bm25.py``) held against JAX.

Same numpy postings, chunk tables and planes through both packages. The
port keeps JAX's semantics (clamped chunk starts, dropped out-of-range
scatters, stable sorts, lowest-index ties), so indices are exact; values
agree within 1e-6 (in practice bit for bit). Positions both leave at -inf
(fewer candidates than k) are compared by count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codesearch_tpu.ops import bm25 as jb
from codesearch_tpu_torch.ops import bm25 as tb
from codesearch_tpu_torch.ops import fused_topk

N_DOCS, N_POST = 5000, 40000


def _postings(seed: int):
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 5, N_DOCS)
    slots = rng.integers(0, N_DOCS, N_POST)
    p_pos = (slots | (kinds[slots] << tb.SLOT_BITS)).astype(np.int32)
    p_pos[rng.random(N_POST) < 0.05] = tb.PACK_PAD
    p_w = rng.random(N_POST).astype(np.float32)
    meta = kinds.astype(np.int32)
    meta[rng.random(N_DOCS) < 0.05] = tb.DEAD_SLOT
    return rng, p_pos, p_w, meta


def _tables(rng, b: int, c: int):
    cs = rng.integers(0, N_POST - 10, (b, c)).astype(np.int32)
    cs[0, 0] = N_POST - 10                 # start clamps like lax.dynamic_slice
    cl = rng.integers(0, tb.CHUNK + 1, (b, c)).astype(np.int32)
    ci = rng.random((b, c)).astype(np.float32)
    kid = (np.arange(b) % 4 * 2 - 1).astype(np.int32)
    return cs, cl, ci, kid


def _assert_same(jv, ji, tv, ti):
    jv, ji, tv, ti = np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(fin, np.isfinite(tv))
    np.testing.assert_array_equal(ji[fin], ti[fin])
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=1e-6)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("planes_on", [False, True])
@pytest.mark.parametrize("k,kpre", [(10, 10), (16, 64)])
@pytest.mark.parametrize("b", [1, 3, 16])
def test_batch_core_matches_jax(planes_on, k, kpre, b):
    rng, p_pos, p_w, meta = _postings(b * 10 + k)
    cs, cl, ci, kid = _tables(rng, b, 8)
    kw_j, kw_t = {}, {}
    if planes_on:
        h = 4
        planes = (rng.random((h, N_DOCS)) * (rng.random((h, N_DOCS)) < 0.3)).astype(np.float32)
        pw = rng.random((b, h)).astype(np.float32)
        kw_j = {"pw": jnp.asarray(pw), "planes": jnp.asarray(planes)}
        pw_t, planes_t = _t(pw, planes)
        kw_t = {"pw": pw_t, "planes": planes_t}
    jv, ji = jb.bm25_resident_topk_batch(
        *map(jnp.asarray, (p_pos, p_w, meta, cs, cl, ci, kid)), k, kpre, 8, **kw_j)
    tv, ti = tb.bm25_resident_topk_batch(*_t(p_pos, p_w, meta, cs, cl, ci, kid), k, kpre, 8,
                                         **kw_t)
    _assert_same(jv, ji, tv, ti)


@pytest.mark.parametrize("planes_on", [False, True])
def test_single_query_matches_jax(planes_on):
    rng, p_pos, p_w, meta = _postings(3)
    cs, cl, ci, _ = _tables(rng, 1, 16)
    kw_j, kw_t = {}, {}
    if planes_on:
        planes = rng.random((4, N_DOCS)).astype(np.float32)
        pw = rng.random(4).astype(np.float32)
        kw_j = {"pw": jnp.asarray(pw), "planes": jnp.asarray(planes)}
        kw_t = dict(zip(("pw", "planes"), _t(pw, planes)))
    jv, ji = jb.bm25_resident_topk(*map(jnp.asarray, (p_pos, p_w, meta, cs[0], cl[0], ci[0])),
                                   2, 32, 64, 16, **kw_j)
    tv, ti = tb.bm25_resident_topk(*_t(p_pos, p_w, meta, cs[0], cl[0], ci[0]), 2, 32, 64, 16,
                                   **kw_t)
    _assert_same(jv, ji, tv, ti)


@pytest.mark.parametrize("rows", [[2, 4], [0, 3]])
def test_plane_write_rows_matches_jax(rows):
    rng, p_pos, p_w, _ = _postings(5)
    planes0 = rng.random((4, N_DOCS)).astype(np.float32)
    cs, cl, _, _ = _tables(rng, 2, 8)
    rows = np.asarray(rows, np.int32)         # 4 is padding: dropped
    ref = jb.plane_write_rows(*map(jnp.asarray, (planes0, p_pos, p_w, cs, cl, rows)))
    got = tb.plane_write_rows(*_t(planes0, p_pos, p_w, cs, cl, rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_plane_write_rows_leaves_input_buffer():
    rng, p_pos, p_w, _ = _postings(6)
    planes0 = torch.zeros((2, N_DOCS))
    cs, cl, _, _ = _tables(rng, 1, 8)
    out = tb.plane_write_rows(planes0, *_t(p_pos, p_w, cs, cl, np.array([1], np.int32)))
    assert float(planes0.abs().sum()) == 0.0 and float(out[1].sum()) > 0.0


def test_chunk_gather_clamps_start():
    arr = torch.arange(3000, dtype=torch.int32)
    got = tb._chunk_gather(arr, torch.tensor([2500, -5]))
    assert got[0, 0].item() == 3000 - tb.CHUNK and got[1, 0].item() == 0


def test_dense_merge_uses_selection_plain_on_cpu():
    rng, p_pos, p_w, meta = _postings(7)
    cs, cl, ci, kid = _tables(rng, 2, 8)
    planes, pw = rng.random((4, N_DOCS)).astype(np.float32), rng.random((2, 4)).astype(np.float32)
    fused_topk.reset_launch_counts()
    tb.bm25_resident_topk_batch(*_t(p_pos, p_w, meta, cs, cl, ci, kid), 8, 8, 8,
                                *_t(pw, planes))
    assert fused_topk.launch_counts["fused_scores_topk"] == 0
