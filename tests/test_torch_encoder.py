"""Port of the BERT encoder held against the JAX package and Hugging Face.

- The numpy ``init_params`` equals JAX's ``init_params(PRNGKey(0), cfg)``
  bit for bit: every leaf of a small config; layers 0 and 11 and the last
  2**20 entries of the word table of bge-small's own config.
- ``params_from_jax`` then the port's ``encode_hidden``/``encode`` against
  JAX's (hidden 64, 3 layers, 4 heads, S in {24, 128}, CLS and mean
  pooling, padded rows). Both run bf16 activations with f32 LayerNorm, but
  round at other places (fused QKV bias add, GELU, the attention's
  ``p``): hidden states of valid positions agree within 0.125 (four bf16
  steps at the largest post-LayerNorm values, 4 to 8) and at cosine 0.9999
  per position; pooled embeddings at cosine 0.9999.
- A tiny random ``transformers.BertModel`` saved as safetensors and loaded
  by ``load_safetensors`` matches HF (cosine > 0.999, as
  ``tests/test_hf_parity.py`` holds the JAX encoder; HF runs f32).
- nomic-v1.5's and modernbert-large's own configs: layers 0 and last of the
  init bit for bit, and a forward at their widths; an ALiBi BERT's forward
  (``tests/test_torch_encoder_family.py`` holds the families at small sizes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codesearch_tpu.models import encoder as je
from codesearch_tpu.models.registry import MODELS, ArchConfig
from codesearch_tpu_torch.models import encoder as te
from codesearch_tpu_torch.models import jax_random

SMALL = ArchConfig(vocab_size=211, hidden=64, layers=3, heads=4, intermediate=128,
                   max_len=160)
HIDDEN_ATOL = 0.125
COS_MIN = 0.9999


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


def _cos_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-30)


@pytest.fixture(scope="module")
def small_params():
    return je.init_params(jax.random.PRNGKey(0), SMALL)


def test_init_params_bit_exact_small_config(small_params):
    ours = te.flatten_params(te.init_params(SMALL))
    ref = te.flatten_params(te.params_from_jax(small_params))
    assert set(ours) == set(ref)
    bad = [name for name in ref if not _bits_equal(ours[name], ref[name])]
    assert not bad


def test_init_params_bit_exact_bge_small_layers():
    cfg = MODELS["bge-small"].arch
    ref = je.init_params(jax.random.PRNGKey(0), cfg)
    for i in (0, cfg.layers - 1):
        ours = te.init_layer_params(cfg, i)
        assert set(ours) == set(ref["layers"][i])
        assert all(_bits_equal(ours[k], ref["layers"][i][k]) for k in ours), i
    # the word table's last 2**20 entries (its key is split(PRNGKey(0))[0])
    key = jax_random.split(jax_random.prng_key(0), 6 + cfg.layers)[0]
    n = cfg.vocab_size * cfg.hidden
    tail = jax_random.normal_f32(key, 1 << 20, n - (1 << 20)) * np.float32(0.02)
    assert _bits_equal(tail, np.asarray(ref["embeddings"]["word"]).ravel()[n - (1 << 20):])


def test_init_cache_round_trip(monkeypatch, tmp_path):
    monkeypatch.setenv("CODESEARCH_HOME", str(tmp_path))
    first = te.flatten_params(te.cached_init_params(SMALL))
    assert te.init_cache_path(SMALL).exists()
    again = te.flatten_params(te.cached_init_params(SMALL))
    assert all(_bits_equal(first[k], again[k]) for k in first)
    assert te.init_cache_path(SMALL, seed=1) != te.init_cache_path(SMALL)


def _ids_mask(s: int, seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SMALL.vocab_size, (3, s)).astype(np.int32)
    mask = np.ones((3, s), np.int32)
    mask[1, s - 7:] = 0
    mask[2, s // 2:] = 0
    return ids, mask


@pytest.mark.parametrize("pooling", ["cls", "mean"])
@pytest.mark.parametrize("s", [24, 128])
def test_encode_matches_jax(small_params, s, pooling):
    cfg = dataclasses.replace(SMALL, pooling=pooling)
    ids, mask = _ids_mask(s, seed=s)
    enc = te.BertEncoder(cfg, te.params_from_jax(small_params), device="cpu")
    jh = np.asarray(je.encode_hidden(small_params, jnp.asarray(ids), jnp.asarray(mask), cfg),
                    np.float32)
    th = enc.encode_hidden(torch.from_numpy(ids), torch.from_numpy(mask))
    assert th.dtype == torch.bfloat16
    th = th.float().numpy()
    valid = mask.astype(bool)
    assert np.abs(jh - th)[valid].max() <= HIDDEN_ATOL
    assert _cos_rows(jh[valid], th[valid]).min() >= COS_MIN
    jv = np.asarray(je.encode(small_params, jnp.asarray(ids), jnp.asarray(mask), cfg))
    tv = enc.encode(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert tv.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(tv, axis=1), 1.0, atol=1e-5)
    assert _cos_rows(jv, tv).min() >= COS_MIN


def test_token_types_match_jax(small_params):
    ids, mask = _ids_mask(24, seed=3)
    tt = (np.arange(24)[None, :] >= 12).astype(np.int32).repeat(3, axis=0)
    enc = te.BertEncoder(SMALL, te.params_from_jax(small_params), device="cpu")
    jh = np.asarray(je.encode_hidden(small_params, jnp.asarray(ids), jnp.asarray(mask), SMALL,
                                     jnp.asarray(tt)), np.float32)
    th = enc.encode_hidden(torch.from_numpy(ids), torch.from_numpy(mask),
                           torch.from_numpy(tt)).float().numpy()
    valid = mask.astype(bool)
    assert _cos_rows(jh[valid], th[valid]).min() >= COS_MIN


def test_safetensors_match_hf(tmp_path):
    from safetensors.torch import save_file
    from transformers import BertConfig, BertModel

    torch.manual_seed(0)
    hf_cfg = BertConfig(vocab_size=211, hidden_size=64, num_hidden_layers=3,
                        num_attention_heads=4, intermediate_size=128,
                        max_position_embeddings=96, type_vocab_size=2, hidden_act="gelu",
                        layer_norm_eps=1e-12, attention_probs_dropout_prob=0.0,
                        hidden_dropout_prob=0.0)
    hf = BertModel(hf_cfg, add_pooling_layer=False).eval()
    st = tmp_path / "model.safetensors"
    save_file({k: v.contiguous() for k, v in hf.state_dict().items()
               if v.dtype.is_floating_point}, str(st))
    cfg = ArchConfig(vocab_size=211, hidden=64, layers=3, heads=4, intermediate=128, max_len=96)
    enc = te.BertEncoder(cfg, te.load_safetensors(st, cfg, "cpu"), device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 211, (2, 24))
    mask = np.ones((2, 24), np.int64)
    mask[1, 18:] = 0
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids),
                 attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
    ours = enc.encode_hidden(torch.from_numpy(ids), torch.from_numpy(mask)).float().numpy()
    assert _cos_rows(ours[0].ravel(), ref[0].ravel()) > 0.999
    assert _cos_rows(ours[1, :18].ravel(), ref[1, :18].ravel()) > 0.999
    pooled = enc.encode(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    ref_pool = (ref * mask[:, :, None]).sum(1) / mask.sum(1, keepdims=True)
    assert _cos_rows(pooled, ref_pool).min() > 0.999


def _jax_layer_init(monkeypatch, cfg, i: int) -> dict:
    """Layer ``i`` of JAX's eager ``init_params(PRNGKey(0), cfg)``, making
    only that layer's weights: the other dense inits are deferred as (key,
    shape) (under ``jit`` XLA fuses ``normal * 0.02`` and rounds otherwise)."""
    dense = je._dense_init
    with monkeypatch.context() as m:
        m.setattr(je, "_dense_init", lambda key, shape, scale=0.02: (key, shape, scale))
        layer = je.init_params(jax.random.PRNGKey(0), cfg)["layers"][i]
    return {k: np.asarray(dense(*v) if isinstance(v, tuple) else v) for k, v in layer.items()}


@pytest.mark.parametrize("model", ["nomic-v1.5", "modernbert-large"])
def test_rotary_models_raise(monkeypatch, model):
    # named for the refusal the rotary families met before they were ported;
    # now: layers 0 and last of the registry's own config equal JAX's init bit
    # for bit, and a forward at the published widths (depth cut to 2: for
    # ModernBERT a global and a local layer, S=160 past its 128-key window;
    # the word table cut to 512 rows) matches JAX's at the module's bounds
    cfg = MODELS[model].arch
    for i in (0, cfg.layers - 1):
        ref = _jax_layer_init(monkeypatch, cfg, i)
        ours = te.init_layer_params(cfg, i)
        assert set(ours) == set(ref), i
        assert all(_bits_equal(ours[k], ref[k]) for k in ours), i
    cut = dataclasses.replace(cfg, layers=2, vocab_size=512)
    params = je.init_params(jax.random.PRNGKey(1), cut)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cut.vocab_size, (2, 160)).astype(np.int32)
    mask = np.ones((2, 160), np.int32)
    mask[1, 100:] = 0
    enc = te.BertEncoder(cut, te.params_from_jax(params), device="cpu")
    jh = np.asarray(je.encode_hidden(params, jnp.asarray(ids), jnp.asarray(mask), cut),
                    np.float32)
    th = enc.encode_hidden(torch.from_numpy(ids), torch.from_numpy(mask)).float().numpy()
    valid = mask.astype(bool)
    assert np.abs(jh - th)[valid].max() <= HIDDEN_ATOL
    assert _cos_rows(jh[valid], th[valid]).min() >= COS_MIN


@pytest.mark.parametrize("s", [24, 128])
def test_alibi_raises(small_params, s):
    # named for the refusal ALiBi models met before they were ported; now an
    # ALiBi BERT (no position table, the [H, S, S] bias in every layer)
    # matches JAX's forward, with token types as the cross-encoder gives them
    cfg = dataclasses.replace(SMALL, position_type="alibi", pooling="cls")
    params = je.init_params(jax.random.PRNGKey(0), cfg)
    assert "position" not in params["embeddings"]
    ids, mask = _ids_mask(s, seed=s + 1)
    tt = (np.arange(s)[None, :] >= s // 3).astype(np.int32).repeat(3, axis=0)
    enc = te.BertEncoder(cfg, te.params_from_jax(params), device="cpu")
    jh = np.asarray(je.encode_hidden(params, jnp.asarray(ids), jnp.asarray(mask), cfg,
                                     jnp.asarray(tt)), np.float32)
    th = enc.encode_hidden(torch.from_numpy(ids), torch.from_numpy(mask),
                           torch.from_numpy(tt)).float().numpy()
    valid = mask.astype(bool)
    assert np.abs(jh - th)[valid].max() <= HIDDEN_ATOL
    assert _cos_rows(jh[valid], th[valid]).min() >= COS_MIN


@pytest.mark.cuda
def test_bge_small_on_cuda_matches_cpu(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = MODELS["bge-small"].arch
    params = te.init_params(dataclasses.replace(cfg, layers=2))
    gpu = te.BertEncoder(dataclasses.replace(cfg, layers=2), params, device="cuda")
    cpu = te.BertEncoder(dataclasses.replace(cfg, layers=2), params, device="cpu")
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 64)).astype(np.int32))
    mask = torch.ones(8, 64, dtype=torch.int32)
    mask[3, 20:] = 0
    a = gpu.encode(ids.cuda(), mask.cuda()).cpu().numpy()
    b = cpu.encode(ids, mask).numpy()
    assert _cos_rows(a, b).min() >= 0.999
