"""Kernel f (head-packed attention) of the port held against the JAX package.

``attention_packed_plain`` (which serves CPU tensors) runs against the JAX
``packed_attention`` of ``examples/ablate_head_packing.py`` in interpret
mode, on the same numpy inputs rounded to bf16: B=2, H in {4, 8}, S in
{64, 128}, D=32, P in {2, 4}, ragged masks and one fully masked row.
Tolerance: one bf16 step (atol 1e-2, rtol 1e-2 on outputs of size up to ~1),
since both sides round the probabilities and the output to bf16 after f32
sums in another order; compared on valid query rows, as the JAX study
compares, and the fully masked row must stay finite. On the card the kernel
is held to the plain version at the same tolerance and, since one bf16 step
also passes kernel d's order (bf16(p) @ V, then the divide), to a share of
differing outputs that d's order exceeds on the same inputs.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codesearch_tpu_torch.examples import ablate_head_packing as port_ablation
from codesearch_tpu_torch.ops import packed_attention as tp
from codesearch_tpu_torch.ops.attention import attention_full_plain

ROOT = Path(__file__).resolve().parents[1]
BF16_TOL = {"atol": 1e-2, "rtol": 1e-2}
# the share of outputs in which kernel f may differ from its plain twin: sums
# in another order flip a bf16 rounding now and then, while d's order rounds
# every unnormalised p and so moves a far larger share (chip_smoke.py holds
# the kernel to the same limit)
ORDER_SHARE_MAX = 0.02
B, D = 2, 32


def _jax_study():
    spec = importlib.util.spec_from_file_location(
        "_jax_ablate_head_packing", ROOT / "examples" / "ablate_head_packing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_JAX = _jax_study()


def _inputs(h: int, s: int, seed: int):
    """bf16-representable q, k, v [B, H, S, D] and a mask: row 0 ragged with
    its first key valid, row 1 fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (np.array(jnp.asarray(rng.standard_normal((B, h, s, D)), jnp.bfloat16)
                        .astype(jnp.float32)) for _ in range(3))
    mask = (rng.random((B, s)) > 0.3).astype(np.float32)
    mask[0, 0] = 1.0
    mask[1] = 0.0
    return q, k, v, mask


def _port(fn, q, k, v, mask, pack):
    out = fn(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
             torch.from_numpy(mask), pack)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("pack", [2, 4])
@pytest.mark.parametrize("s", [64, 128])
@pytest.mark.parametrize("h", [4, 8])
def test_plain_matches_jax_packed_attention(h, s, pack):
    q, k, v, mask = _inputs(h, s, seed=h * 1000 + s + pack)
    got = _port(tp.attention_packed_plain, q, k, v, mask, pack)
    ref = np.asarray(_JAX.packed_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(mask),
        pack=pack, interpret=True), np.float32)
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    valid = mask[:, None, :, None] > 0
    np.testing.assert_allclose(np.where(valid, got, 0), np.where(valid, ref, 0), **BF16_TOL)


@pytest.mark.parametrize("pack", [2, 4])
def test_fully_masked_row_averages_v(pack):
    # every score of a fully masked row is exactly -1e30: uniform weights
    q, k, v, mask = _inputs(4, 64, seed=7)
    got = _port(tp.attention_packed_plain, q, k, v, mask, pack)
    mean_v = v[1].mean(axis=1, keepdims=True)
    np.testing.assert_allclose(got[1], np.broadcast_to(mean_v, got[1].shape), **BF16_TOL)


def _share_differing(a, b) -> float:
    return float((a.float() != b.float()).float().mean())


@pytest.mark.parametrize("h,s", [(4, 64), (8, 128), (4, 512)])
def test_share_limit_rejects_kernel_d_rounding(h, s):
    # d's order (attention_full_plain) passes one bf16 step; the share limit
    # that holds kernel f on the card must not let it pass
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(h, s, seed=11 + s))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    f = tp.attention_packed_plain(q, k, v, mask, 4)
    d = attention_full_plain(q, k, v, mask)
    np.testing.assert_allclose(d.float().numpy(), f.float().numpy(), **BF16_TOL)
    assert _share_differing(d, f) > ORDER_SHARE_MAX


def test_wrapper_takes_the_plain_version_on_cpu():
    q, k, v, mask = _inputs(4, 64, seed=3)
    before = dict(tp.launch_counts)
    got = _port(tp.attention_packed, q, k, v, mask, 4)
    ref = _port(tp.attention_packed_plain, q, k, v, mask, 4)
    np.testing.assert_array_equal(got, ref)
    assert tp.launch_counts == before


@pytest.mark.parametrize("h,pack", [(6, 4), (4, 3)])
def test_pack_must_divide_heads(h, pack):
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(h, 64, seed=1))
    with pytest.raises(ValueError):
        tp.attention_packed(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask, pack)


def test_ablation_entry_point_on_cpu(tmp_path, capsys):
    out = tmp_path / "ablation.md"
    assert port_ablation.main(["--batch", "3", "--seq", "64", "--heads", "4",
                               "--device", "cpu", "--out", str(out)]) == 0
    table = capsys.readouterr().out
    assert table == out.read_text()
    rows = [line for line in table.splitlines() if line.startswith("| kernel f")]
    assert len(rows) == 2 and all("not measured" in r for r in rows)
    # f's arithmetic is the reference's: normalise in f32, then round p
    assert all(float(r.split("|")[2]) <= BF16_TOL["atol"] for r in rows)


def test_ablation_rows_on_cpu():
    rows = port_ablation.ablate(2, 4, 64, 32, torch.device("cpu"), seed=0)
    assert [r["name"].split(",")[0].split(" (")[0] for r in rows] == [
        "plain reference", "kernel d", "kernel f", "kernel f"]
    assert rows[0]["max_abs_err"] == 0.0
    assert all(r["ms"] is None and r["max_abs_err"] <= 2e-2 for r in rows)


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pack", [2, 4])
@pytest.mark.parametrize("h,s", [(4, 64), (8, 100), (12, 512), (4, 1000)])
def test_kernel_matches_plain_on_cuda(cuda, h, s, pack):
    q, k, v, mask = (torch.from_numpy(a).to(cuda) for a in _inputs(h, s, seed=s + pack))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    before = tp.launch_counts["attention_packed"]
    got = tp.attention_packed(q, k, v, mask, pack)
    torch.cuda.synchronize()
    assert tp.launch_counts["attention_packed"] == before + 1
    assert got.stride(1) == D and got.stride(2) == h * D   # a view of [B, S, H, D]
    ref = tp.attention_packed_plain(q, k, v, mask, pack)
    np.testing.assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(), **BF16_TOL)
    assert _share_differing(got, ref) <= ORDER_SHARE_MAX
    assert _share_differing(attention_full_plain(q, k, v, mask), ref) > ORDER_SHARE_MAX
    assert torch.isfinite(got).all()


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take_on_cuda(cuda):
    q, k, v, mask = (torch.from_numpy(a).to(cuda) for a in _inputs(4, 64, seed=5))
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    before = dict(tp.launch_counts)
    for call, exc in (
            (lambda: tp.attention_packed(q, k, v, mask, 4), TypeError),          # f32
            (lambda: tp.attention_packed(qb, kb, vb, mask, 3), ValueError),      # pack
            (lambda: tp.attention_packed(qb[:, :3], kb[:, :3], vb[:, :3], mask, 2),
             ValueError),                                                        # H % pack
            (lambda: tp.attention_packed(qb.requires_grad_(True), kb, vb, mask, 4),
             NotImplementedError)):
        with pytest.raises(exc):
            call()
    z64 = torch.zeros(2, 4, 64, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head size"):
        tp.attention_packed(z64, z64, z64, mask, 4)
    long = torch.zeros(1, 4, tp.PACKED_MAX_SEQ + 1, D, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="bound"):
        tp.attention_packed(long, long, long, torch.ones(1, tp.PACKED_MAX_SEQ + 1, device=cuda))
    assert tp.launch_counts == before
