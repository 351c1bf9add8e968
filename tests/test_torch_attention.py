"""Port of the encoder attention (kernels d and e) held against the JAX package.

The port's plain versions (which serve CPU tensors) run against JAX's
``reference_attention`` and the Pallas kernels in interpret mode
(``pallas_attention_full``; ``pallas_attention`` with 64-row and 64-key
blocks), on the same numpy inputs: S in {16, 128}, padding masks and a fully
masked row. Tolerances: float32 at atol 2e-5 / rtol 2e-3 under
``jax.default_matmul_precision("float32")``, as ``tests/test_ops.py`` holds
the Pallas kernels to the reference; bf16 inputs at atol 1e-2 / rtol 1e-2,
one bf16 rounding step (2**-7 relative) of outputs of size up to ~1, since
both sides round the output to bf16 after f32 sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codesearch_tpu.ops import attention as ja
from codesearch_tpu_torch.ops import _build
from codesearch_tpu_torch.ops import attention as ta
from codesearch_tpu_torch.ops import packed_attention as tp

B, H, DH = 2, 4, 32
F32_TOL = {"atol": 2e-5, "rtol": 2e-3}
BF16_TOL = {"atol": 1e-2, "rtol": 1e-2}


def _inputs(s: int, seed: int, dh: int = DH):
    """q, k, v [B, H, S, Dh] and a mask: row 0 padded, row 1 fully masked."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, s, dh)).astype(np.float32) for _ in range(3))
    mask = (rng.random((B, s)) > 0.3).astype(np.float32)
    mask[0, 0] = 1.0
    mask[1] = 0.0
    return q, k, v, mask


def _as_dtype(arrays, dtype: str):
    """The same values for both frameworks: rounded to bf16 or kept f32."""
    if dtype == "f32":
        return [np.asarray(a, np.float32) for a in arrays]
    return [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]


def _jax(fn, q, k, v, mask, dtype):
    dt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    with jax.default_matmul_precision("float32"):
        out = fn(jnp.asarray(q, dt), jnp.asarray(k, dt), jnp.asarray(v, dt), jnp.asarray(mask))
    return np.asarray(out, np.float32)


def _port(fn, q, k, v, mask, dtype):
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    t = [torch.from_numpy(a).to(dt) for a in (q, k, v)]
    out = fn(*t, torch.from_numpy(mask))
    assert out.dtype == dt
    return out.float().numpy()


_PAIRS = {
    # port plain version, its JAX counterpart
    "reference": (ta.reference_attention, ja.reference_attention),
    "full": (ta.attention_full_plain,
             lambda q, k, v, m: ja.pallas_attention_full(q, k, v, m, interpret=True)),
    "flash": (ta.attention_flash_plain,
              lambda q, k, v, m: ja.pallas_attention(q, k, v, m, block_q=64, block_k=64,
                                                     interpret=True)),
    "dispatch": (ta.fused_encoder_attention, ja.fused_encoder_attention),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s", [16, 128])
@pytest.mark.parametrize("impl", sorted(_PAIRS))
def test_plain_versions_match_jax(impl, s, dtype):
    port_fn, jax_fn = _PAIRS[impl]
    q, k, v, mask = _as_dtype(_inputs(s, seed=s), dtype)
    got = _port(port_fn, q, k, v, mask, dtype)
    ref = _jax(jax_fn, q, k, v, mask, dtype)
    np.testing.assert_allclose(got, ref, **(F32_TOL if dtype == "f32" else BF16_TOL))
    assert np.isfinite(got).all()          # the fully masked row included


@pytest.mark.parametrize("s", [16, 128])
def test_kernel_twins_match_the_xla_reference(s):
    # d's and e's arithmetic differ from the reference only in rounding
    q, k, v, mask = _inputs(s, seed=s + 1)
    ref = _port(ta.reference_attention, q, k, v, mask, "f32")
    for fn in (ta.attention_full_plain, ta.attention_flash_plain):
        np.testing.assert_allclose(_port(fn, q, k, v, mask, "f32"), ref, **F32_TOL)


def test_fully_masked_row_averages_v():
    q, k, v, mask = _inputs(64, seed=3)
    want = v[1].mean(axis=1)                               # [H, Dh]
    for fn in (ta.attention_full_plain, ta.attention_flash_plain, ta.reference_attention):
        got = _port(fn, q, k, v, mask, "f32")
        np.testing.assert_allclose(got[1], np.broadcast_to(want[:, None], got[1].shape),
                                   atol=1e-5)


def test_flash_twin_takes_a_ragged_last_block():
    q, k, v, mask = _inputs(100, seed=4)
    ref = _port(ta.reference_attention, q, k, v, mask, "f32")
    np.testing.assert_allclose(_port(ta.attention_flash_plain, q, k, v, mask, "f32"), ref,
                               **F32_TOL)


@pytest.mark.parametrize("option", ["window", "bias2d"])
def test_window_and_bias2d_match_jax_on_cpu(option):
    q, k, v, mask = _inputs(64, seed=5)
    mask[1, :8] = 1.0
    if option == "window":
        kw_j, kw_t = {"window": 16}, {"window": 16}
    else:
        bias = np.array(ja.alibi_bias(H, 64))
        kw_j, kw_t = {"bias2d": jnp.asarray(bias)}, {"bias2d": torch.from_numpy(bias)}
    with jax.default_matmul_precision("float32"):
        ref = np.asarray(ja.fused_encoder_attention(*map(jnp.asarray, (q, k, v, mask)), **kw_j))
    got = ta.fused_encoder_attention(*map(torch.from_numpy, (q, k, v, mask)), **kw_t)
    np.testing.assert_allclose(got.numpy(), ref, **F32_TOL)


def test_cpu_dispatch_takes_the_twin_of_the_kernel_cuda_would_launch(monkeypatch):
    calls = []
    for name in ("attention_full_plain", "attention_flash_plain"):
        fn = getattr(ta, name)
        monkeypatch.setattr(ta, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    ta.reset_launch_counts()
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(32, seed=6))
    ta.fused_encoder_attention(q, k, v, mask)
    monkeypatch.setattr(ta, "full_max_seq", lambda dh: 16)
    ta.fused_encoder_attention(q, k, v, mask)
    assert calls == ["attention_full_plain", "attention_flash_plain"]
    assert ta.launch_counts == {"attention_full": 0, "attention_flash": 0, "attention_window": 0}


def test_kernel_d_sequence_bound(monkeypatch):
    # the d/e route's threshold: S up to full_max_seq(Dh) goes to kernel d,
    # longer sequences to e
    assert ta.FULL_MAX_SEQ == {32: 1552, 64: 832}
    for dh, bound in ta.FULL_MAX_SEQ.items():
        assert ta.full_max_seq(dh) == bound
    assert ta.full_max_seq(48) == ta.FULL_MAX_SEQ[64]
    routed = []
    for name in ("attention_full_plain", "attention_flash_plain"):
        monkeypatch.setattr(ta, name, lambda q, *a, _n=name: routed.append((_n, q.shape[2])))
    for dh, bound in ta.FULL_MAX_SEQ.items():
        for s in (bound, bound + 1):
            q = torch.zeros(1, 1, s, dh)
            ta.fused_encoder_attention(q, q, q, torch.ones(1, s))
    assert routed == [("attention_full_plain", 1552), ("attention_flash_plain", 1553),
                      ("attention_full_plain", 832), ("attention_flash_plain", 833)]


def _keys_needed(mask_row: np.ndarray) -> int:
    """Kernels d's, e's and f's key count for one mask row: 1 + its last nonzero
    key, or all S when it has none."""
    nz = np.flatnonzero(mask_row)
    return int(nz[-1]) + 1 if nz.size else mask_row.shape[0]


def _skip_masks(s: int = 128) -> dict:
    """[2, S] 0/1 masks for the skip rule: holes before the last valid key,
    a trailing valid key, a fully masked row, and lengths 1 and S."""
    rng = np.random.default_rng(17)
    holes = (rng.random((2, s)) > 0.4).astype(np.float32)
    holes[0, 71:] = 0.0
    holes[0, 70] = 1.0
    holes[1, 21:] = 0.0
    holes[1, 20] = 1.0
    trailing = holes.copy()
    trailing[0, -1] = 1.0
    trailing[1] = 0.0
    trailing[1, -1] = 1.0
    masked = np.zeros((2, s), np.float32)
    masked[0, :40] = 1.0
    ones = np.zeros((2, s), np.float32)
    ones[0, 0] = ones[1, 0] = 1.0
    full = holes.copy()
    full[0] = 1.0
    return {"holes": holes, "trailing_valid_key": trailing, "fully_masked_row": masked,
            "length_1": ones, "length_s": full}


@pytest.mark.parametrize("case", sorted(_skip_masks()))
@pytest.mark.parametrize("twin", ["full", "packed", "flash"])
def test_keys_past_the_last_valid_one_add_exactly_nothing(twin, case):
    # kernels d, e and f run only over the keys below _keys_needed: the twins
    # over those keys equal the twins over all S, in f32 (no bf16 cast); for
    # e's online softmax a masked key beside a valid one gives p = 0, alpha = 1
    mask = _skip_masks()[case]
    q, k, v, _ = _inputs(mask.shape[1], seed=21)
    fn = {"full": ta.attention_full_plain, "flash": ta.attention_flash_plain,
          "packed": lambda *a: tp.attention_packed_plain(*a, pack=2)}[twin]
    q, k, v, m = (torch.from_numpy(a) for a in (q, k, v, mask))
    whole = fn(q, k, v, m)
    assert whole.dtype == torch.float32 and torch.isfinite(whole).all()
    for b in range(mask.shape[0]):
        n = _keys_needed(mask[b])
        cut = fn(q[b:b + 1], k[b:b + 1, :, :n], v[b:b + 1, :, :n], m[b:b + 1, :n])
        np.testing.assert_allclose(cut.numpy(), whole[b:b + 1].numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_full_twin_matches_jax_on_a_mask_with_holes(dtype):
    q, k, v, _ = _inputs(128, seed=23)
    q, k, v, mask = _as_dtype((q, k, v, _skip_masks()["holes"]), dtype)
    got = _port(ta.attention_full_plain, q, k, v, mask, dtype)
    ref = _jax(_PAIRS["full"][1], q, k, v, mask, dtype)
    np.testing.assert_allclose(got, ref, **(F32_TOL if dtype == "f32" else BF16_TOL))


@pytest.fixture
def as_if_cuda(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: every refusal must come
    before the kernel library is loaded or a launch counted."""
    monkeypatch.setattr(ta, "_on_cpu", lambda *t: False)

    def no_load(*a, **k):
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load", no_load)
    ta.reset_launch_counts()
    yield
    assert ta.launch_counts == {"attention_full": 0, "attention_flash": 0, "attention_window": 0}
    ta.reset_launch_counts()


def _bf16(s=64, dh=DH):
    q, k, v, mask = _inputs(s, seed=7, dh=dh)
    return [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)] + [torch.from_numpy(mask)]


@pytest.mark.parametrize("case", ["window", "bias2d", "requires_grad", "kernel_requires_grad",
                                  "f32", "head_size", "strides", "beyond_d_bound"])
def test_cuda_branch_refuses_what_the_kernels_do_not_take(as_if_cuda, monkeypatch, case):
    # bias2d has no kernel to refuse it, nor has window under autograd: on
    # CUDA they take the composed route (reference_attention), counted apart
    # from the launches (a window outside autograd launches the windowed
    # kernel: tests/test_torch_window_attention.py); inputs that require
    # grad take the autograd route: kernel d forward (its plain twin stands
    # in for the launch here), reference_attention recomputed backward and
    # counted, gradients equal to the reference's own; the kernel wrappers
    # alone have no backward and refuse them
    q, k, v, mask = _bf16()
    if case in ("window", "bias2d"):
        kw = {"window": 16} if case == "window" else {"bias2d": ta.alibi_bias(H, 64)}
        if case == "window":
            q = q.clone().requires_grad_(True)
        got = ta.fused_encoder_attention(q, k, v, mask, **kw)
        assert torch.equal(got, ta.reference_attention(q, k, v, mask, **kw))
        assert ta.composed_counts == {"window": 0, "bias2d": 0, "backward": 0, case: 1}
    elif case == "requires_grad":
        monkeypatch.setattr(ta, "_launch", lambda entry, *a: ta.attention_full_plain(*a))
        leaves, ref_leaves = ([t.clone().requires_grad_(True) for t in (q, k, v)]
                              for _ in range(2))
        out = ta.fused_encoder_attention(*leaves, mask)
        assert ta.launch_counts == {"attention_full": 1, "attention_flash": 0,
                                    "attention_window": 0}
        assert ta.composed_counts["backward"] == 0
        g = torch.from_numpy(np.random.default_rng(8).standard_normal(out.shape)
                             .astype(np.float32)).to(torch.bfloat16)
        out.backward(g)
        assert ta.composed_counts == {"window": 0, "bias2d": 0, "backward": 1}
        ta.reference_attention(*ref_leaves, mask).backward(g)
        for got, want in zip(leaves, ref_leaves):
            assert torch.equal(got.grad, want.grad)
        ta.reset_launch_counts()
    elif case == "kernel_requires_grad":
        with pytest.raises(NotImplementedError, match="no backward"):
            ta.attention_full(q.requires_grad_(True), k, v, mask)
    elif case == "f32":
        with pytest.raises(TypeError, match="bf16"):
            ta.attention_flash(q.float(), k.float(), v.float(), mask)
    elif case == "head_size":
        with pytest.raises(ValueError, match="head size 48"):
            ta.attention_full(*_bf16(dh=48))
    elif case == "strides":
        with pytest.raises(ValueError, match="contiguous"):
            ta.attention_full(q.transpose(2, 3), k, v, mask)
    else:
        q, k, v, mask = _bf16(s=ta.full_max_seq(DH) + 16)
        with pytest.raises(ValueError, match="bound"):
            ta.attention_full(q, k, v, mask)


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_d_bound_comes_from_the_card(cuda):
    # the route on the card: d up to full_max_seq(Dh), e beyond
    for dh in ta.HEAD_DIMS:
        for s, kernel in ((ta.full_max_seq(dh), "attention_full"),
                          (ta.full_max_seq(dh) + 1, "attention_flash")):
            q = torch.randn(1, 2, s, dh, device=cuda).to(torch.bfloat16)
            before = dict(ta.launch_counts)
            out = ta.fused_encoder_attention(q, q, q, torch.ones(1, s, device=cuda))
            assert ta.launch_counts[kernel] == before[kernel] + 1
            assert torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["attention_full", "attention_flash"])
@pytest.mark.parametrize("s,dh", [(16, 32), (100, 32), (512, 32), (512, 64), (1100, 32)])
def test_kernels_match_plain_on_cuda(cuda, kernel, s, dh):
    if kernel == "attention_full" and s > ta.full_max_seq(dh):
        pytest.skip("beyond kernel d's bound")
    q, k, v, mask = (t.to(cuda) for t in _bf16(s=s, dh=dh))
    before = ta.launch_counts[kernel]
    got = getattr(ta, kernel)(q, k, v, mask)
    assert ta.launch_counts[kernel] == before + 1
    ref = getattr(ta, kernel + "_plain")(q, k, v, mask)
    np.testing.assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(), **BF16_TOL)
    assert torch.isfinite(got).all()


@pytest.mark.cuda
@pytest.mark.parametrize("s", [128, 2048])
def test_autograd_route_matches_the_reference_on_cuda(cuda, s):
    # kernel d (S=128) or e (S=2048) forward, reference_attention recomputed
    # backward: gradients against reference_attention's own autograd on the
    # same bf16 inputs within 2e-2 + 2e-2 |ref| (the forwards round their
    # bf16 outputs in another order; the backwards run the same arithmetic)
    q, k, v, mask = (t.to(cuda) for t in _bf16(s=s))
    g = torch.randn(q.shape, device=cuda).to(torch.bfloat16)
    kernel = "attention_full" if s <= ta.full_max_seq(DH) else "attention_flash"
    launches, backward = ta.launch_counts[kernel], ta.composed_counts["backward"]
    leaves, ref_leaves = ([t.clone().requires_grad_(True) for t in (q, k, v)] for _ in range(2))
    out = ta.fused_encoder_attention(*leaves, mask)
    out.backward(g)
    assert ta.launch_counts[kernel] == launches + 1
    assert ta.composed_counts["backward"] == backward + 1
    ref = ta.reference_attention(*ref_leaves, mask)
    ref.backward(g)
    np.testing.assert_allclose(out.detach().float().cpu().numpy(),
                               ref.detach().float().cpu().numpy(), **BF16_TOL)
    for got, want in zip(leaves, ref_leaves):
        np.testing.assert_allclose(got.grad.float().cpu().numpy(),
                                   want.grad.float().cpu().numpy(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_encoder_attention_takes_strided_views_on_cuda(cuda):
    # the encoder's q, k, v: [B, H, S, Dh] views of one [B, S, 3 * H * Dh] tensor
    b, s, h, dh = 3, 64, 12, 32
    qkv = torch.randn(b, s, 3 * h * dh, device=cuda).to(torch.bfloat16)
    q, k, v = (t.view(b, s, h, dh).transpose(1, 2) for t in qkv.split(h * dh, dim=-1))
    mask = torch.ones(b, s, device=cuda)
    mask[1, 40:] = 0
    got = ta.fused_encoder_attention(q, k, v, mask)
    ref = ta.attention_full_plain(q.contiguous(), k.contiguous(), v.contiguous(), mask)
    np.testing.assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(), **BF16_TOL)


@pytest.mark.parametrize("heads,seq", [(4, 24), (12, 128), (16, 7)])
def test_alibi_bias_matches_jax(heads, seq):
    got = ta.alibi_bias(heads, seq)
    assert got.dtype == torch.float32 and got.shape == (heads, seq, seq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ja.alibi_bias(heads, seq)))


def test_composed_route_is_not_counted_on_the_cpu():
    q, k, v, mask = _bf16()
    ta.reset_launch_counts()
    ta.fused_encoder_attention(q, k, v, mask, window=16)
    ta.fused_encoder_attention(q, k, v, mask, bias2d=ta.alibi_bias(H, 64))
    ta.fused_encoder_attention(q.requires_grad_(True), k, v, mask).sum().backward()
    assert ta.composed_counts == {"window": 0, "bias2d": 0, "backward": 0}
