"""Port of the hash embedder held against the JAX package.

The table regenerates in numpy without JAX: its threefry bits and uniform
draws must equal ``jax.random``'s bit for bit over the full [65536, 384]
shape, and the bf16 table must equal ``make_table(384)`` entry for entry
(pinned: 0 differing entries). ``embed_features`` agrees within 1e-6
(f32 sums in another order); featurization is byte-identical.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codesearch_tpu.models import hash_embedder as jh
from codesearch_tpu_torch.models import hash_embedder as th

SHAPE = (th.VOCAB_BUCKETS, 384)
BLOCK = 1 << 22
TABLE_MISMATCHES_PINNED = 0


def test_constants_match():
    assert (th.VOCAB_BUCKETS, th.TABLE_SEED, th.MAX_TOKENS) == \
        (jh.VOCAB_BUCKETS, jh.TABLE_SEED, jh.MAX_TOKENS)


def test_threefry_bits_and_uniform_match_jax_full_shape():
    key = jax.random.PRNGKey(th.TABLE_SEED)
    jbits = np.asarray(jax.random.bits(key, SHAPE, jnp.uint32)).ravel()
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    juni = np.asarray(jax.random.uniform(key, SHAPE, jnp.float32, lo, 1.0)).ravel()
    n = jbits.size
    for a in range(0, n, BLOCK):
        b = min(n, a + BLOCK)
        x0, x1 = th._threefry2x32(0, th.TABLE_SEED, np.zeros(b - a, np.uint32),
                                  np.arange(a, b, dtype=np.uint32))
        bits = x0 ^ x1
        np.testing.assert_array_equal(bits, jbits[a:b])
        np.testing.assert_array_equal(th._uniform_open(bits).view(np.uint32),
                                      juni[a:b].view(np.uint32))


def test_table_matches_jax_make_table(monkeypatch, tmp_path):
    monkeypatch.setenv("CODESEARCH_HOME", str(tmp_path))
    ref = np.asarray(jh.make_table(384)).view(np.uint16).ravel()
    bits = th.default_table_bits(384)
    assert int((bits != ref).sum()) <= TABLE_MISMATCHES_PINNED
    # cached under the port's own file name, which the JAX package never reads
    cached = list(tmp_path.glob("hash_table_*.torch.u16"))
    assert len(cached) == 1
    np.testing.assert_array_equal(np.fromfile(cached[0], np.uint16), bits)
    t = th.make_table(384, device="cpu")
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == SHAPE
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16).ravel(), ref)


def test_erf_inv_matches_jax_log1p_branches():
    # both log1p branches (|x| below and above sqrt(2) - 1) and the w >= 5 tail
    x = np.concatenate([np.linspace(-0.999999, 0.999999, 20001),
                        np.array([0.0, 0.3, -0.64, 0.65, 0.9999])]).astype(np.float32)
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    np.testing.assert_array_equal(th._erf_inv_xla(x).view(np.uint32), ref.view(np.uint32))


def _small_table(seed: int, v: int = 1000, d: int = 64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.asarray(jnp.asarray(rng.standard_normal((v, d)) / math.sqrt(d), jnp.bfloat16))


def test_table_from_jax_keeps_values():
    jt = _small_table(0)
    t = th.table_from_jax(jt)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), jt.astype(np.float32))
    f32 = th.table_from_jax(jt.astype(np.float32))
    assert torch.equal(f32, t)


@pytest.mark.parametrize("b,t", [(1, 16), (9, 64), (4, 512)])
def test_embed_features_matches_jax(b, t):
    jt = _small_table(1)
    rng = np.random.default_rng(b * t)
    ids = rng.integers(0, jt.shape[0], (b, t)).astype(np.int32)
    ws = (rng.random((b, t)) * (rng.random((b, t)) < 0.8)).astype(np.float32)
    ref = np.asarray(jh.embed_features(jnp.asarray(jt), jnp.asarray(ids), jnp.asarray(ws)))
    got = th.embed_features(th.table_from_jax(jt), torch.from_numpy(ids), torch.from_numpy(ws))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


TEXTS = [
    "def validate_schema(config):\n    return config.schema",
    "class HashEmbedder:\n    '''Deterministic weights-free code embedder.'''",
    "",
    "x",
    "fn content_hash(data: &[u8]) -> u64 { h.wrapping_mul(31) }",
    " ".join(f"token{i} another_identifier_{i % 7}" for i in range(400)),
    "ünïcödé ident_ifier 日本語",
]


def test_batch_features_byte_identical():
    ref = jh.batch_features(TEXTS)
    got = th.batch_features(TEXTS)
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and r.shape == g.shape
        assert r.tobytes() == g.tobytes()


@pytest.mark.parametrize("text", TEXTS)
def test_featurize_python_and_capped_identical(text):
    ri, rw = jh._featurize_py(text)
    gi, gw = th._featurize_py(text)
    assert ri.tobytes() == gi.tobytes() and rw.tobytes() == gw.tobytes()
    for cap in (8, th.MAX_TOKENS):
        (ri, rw), (gi, gw) = jh.featurize(text, cap), th.featurize(text, cap)
        assert ri.tobytes() == gi.tobytes() and rw.tobytes() == gw.tobytes()


def test_hash_embedder_with_given_table():
    jt = _small_table(2, v=th.VOCAB_BUCKETS, d=32)
    emb = th.HashEmbedder(32, table=th.table_from_jax(jt), device="cpu")
    np.testing.assert_array_equal(emb.table_np(), jt.astype(np.float32))
    ids, ws = jh.batch_features(TEXTS[:2])
    ref = np.asarray(jh.embed_features(jnp.asarray(jt), jnp.asarray(ids), jnp.asarray(ws)))
    np.testing.assert_allclose(emb.embed_texts(TEXTS[:2]), ref, rtol=0, atol=1e-6)
