"""The rest of the encoder family on torch held against the JAX package:
Nomic (rotary, SwiGLU, bias-free), ModernBERT (pre-norm, GeGLU, two rotary
bases, sliding-window local layers, a final norm) and the ALiBi BERT.

- ``init_params`` equals JAX's ``init_params(PRNGKey(0), cfg)`` bit for bit,
  every leaf of a small config of each family (ModernBERT's layer 0 has no
  attention norm, its tree a top-level ``final_ln_scale``), and the init
  cache gives the same trees back.
- ``params_from_jax`` then the port's forward against JAX's: hidden 64, 3-4
  layers, 4 heads, S in {24, 128}, padded rows, ModernBERT's window 16
  cutting inside S, at the bounds of ``tests/test_torch_encoder.py`` (|d|
  <= 0.125 at valid positions, cosine >= 0.9999 per position and pooled).
- The rotary embedding against JAX's ``_apply_rope`` (bf16 in and out, at
  most one bf16 step apart: JAX multiplies in bf16, the port sums f32
  products and rounds once).
- Checkpoints written as ``tests/test_safetensors_load.py`` and
  ``tests/test_rerank.py`` write theirs load into both packages as the same
  tree and compute the same embeddings.
- On the card (``cuda``): the GPU forward against the CPU one at the
  published widths, kernel d launched on every global layer and the
  windowed kernel on the local ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_rerank import _write_synthetic_reranker
from test_safetensors_load import (
    MB_CFG,
    NOMIC_CFG,
    _synthetic_modernbert,
    _synthetic_nomic,
)

from codesearch_tpu.models import encoder as je
from codesearch_tpu.models.cross_encoder import arch_from_hf_config
from codesearch_tpu.models.registry import MODELS, ArchConfig
from codesearch_tpu_torch.models import encoder as te
from codesearch_tpu_torch.ops import attention as ta

HIDDEN_ATOL = 0.125
COS_MIN = 0.9999
CONFIGS = {
    "nomic": ArchConfig(vocab_size=211, hidden=64, layers=4, heads=4, intermediate=128,
                        max_len=2048, arch_style="nomic", rope_base=1000.0),
    # layers 0 and 3 global, 1 and 2 local with a 16-key window
    "modernbert": ArchConfig(vocab_size=211, hidden=64, layers=4, heads=4, intermediate=96,
                             max_len=8192, layer_norm_eps=1e-5, arch_style="modernbert",
                             rope_base=160000.0, rope_base_local=10000.0, local_window=16,
                             global_every=3),
    "alibi": ArchConfig(vocab_size=211, hidden=64, layers=3, heads=4, intermediate=128,
                        max_len=160, position_type="alibi"),
}


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


def _cos_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-30)


def _ids_mask(vocab: int, s: int, seed: int, rows: int = 3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (rows, s)).astype(np.int32)
    mask = np.ones((rows, s), np.int32)
    mask[1, s - 7:] = 0
    mask[-1, s // 2:] = 0
    return ids, mask


def _match(jax_params, port_params, cfg, s: int, seed: int) -> None:
    """JAX's and the port's encode_hidden and encode on one padded batch."""
    ids, mask = _ids_mask(cfg.vocab_size, s, seed)
    enc = te.BertEncoder(cfg, port_params, device="cpu")
    jh = np.asarray(je.encode_hidden(jax_params, jnp.asarray(ids), jnp.asarray(mask), cfg),
                    np.float32)
    th = enc.encode_hidden(torch.from_numpy(ids), torch.from_numpy(mask))
    assert th.dtype == torch.bfloat16
    th = th.float().numpy()
    valid = mask.astype(bool)
    assert np.abs(jh - th)[valid].max() <= HIDDEN_ATOL
    assert _cos_rows(jh[valid], th[valid]).min() >= COS_MIN
    jv = np.asarray(je.encode(jax_params, jnp.asarray(ids), jnp.asarray(mask), cfg))
    tv = enc.encode(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(np.linalg.norm(tv, axis=1), 1.0, atol=1e-5)
    assert _cos_rows(jv, tv).min() >= COS_MIN


@pytest.fixture(scope="module")
def jax_params():
    return {name: je.init_params(jax.random.PRNGKey(0), cfg) for name, cfg in CONFIGS.items()}


@pytest.mark.parametrize("family", list(CONFIGS))
def test_init_params_bit_exact_small_config(jax_params, family):
    ours = te.flatten_params(te.init_params(CONFIGS[family]))
    ref = te.flatten_params(te.params_from_jax(jax_params[family]))
    assert set(ours) == set(ref)
    assert not [name for name in ref if not _bits_equal(ours[name], ref[name])]


def test_init_trees_have_each_family_shape():
    nomic, mb, alibi = (te.init_params(CONFIGS[f]) for f in ("nomic", "modernbert", "alibi"))
    assert "position" not in nomic["embeddings"] and "qkv_w" in nomic["layers"][0]
    assert set(mb) == {"embeddings", "final_ln_scale", "layers"}
    assert set(mb["embeddings"]) == {"word", "ln_scale"}
    assert "attn_ln_scale" not in mb["layers"][0] and "attn_ln_scale" in mb["layers"][1]
    assert "position" not in alibi["embeddings"] and "token_type" in alibi["embeddings"]


@pytest.mark.parametrize("family", list(CONFIGS))
def test_init_cache_round_trip(monkeypatch, tmp_path, family):
    monkeypatch.setenv("CODESEARCH_HOME", str(tmp_path))
    cfg = CONFIGS[family]
    first = te.cached_init_params(cfg)
    assert te.init_cache_path(cfg).exists()
    again = te.cached_init_params(cfg)
    a, b = te.flatten_params(first), te.flatten_params(again)
    assert set(a) == set(b) and all(_bits_equal(a[k], b[k]) for k in a)
    assert set(again["layers"][0]) == set(first["layers"][0])


@pytest.mark.parametrize("s", [24, 128])
@pytest.mark.parametrize("family", list(CONFIGS))
def test_encode_matches_jax(jax_params, family, s):
    cfg = CONFIGS[family]
    _match(jax_params[family], te.params_from_jax(jax_params[family]), cfg, s, seed=s)


@pytest.mark.parametrize("base", [1000.0, 10000.0, 160000.0])
def test_rope_matches_jax(base):
    b, h, s, dh = 2, 4, 96, 64
    x = np.array(jnp.asarray(np.random.default_rng(0).standard_normal((b, h, s, dh)),
                               jnp.bfloat16).astype(jnp.float32))
    ref, _ = je._apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), base)
    ref = np.asarray(ref, np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16).transpose(1, 2)           # [B, S, H, Dh]
    got = te._apply_rope(xt, te._rope_tables(s, dh, base, "cpu"))
    assert got.dtype == torch.bfloat16
    got = got.transpose(1, 2).float().numpy()
    # one bf16 step (2**-8 relative, 2**-7 at the low end of a binade)
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=2 ** -7)


def _jax_and_port_checkpoint(path, cfg):
    jp = je.load_safetensors(path, cfg)
    tp = te.load_safetensors(path, cfg, "cpu")
    a, b = te.flatten_params(te.params_from_jax(jp)), te.flatten_params(tp)
    assert set(a) == set(b)
    assert all(_bits_equal(a[k], b[k]) for k in a)
    return jp, tp


@pytest.mark.parametrize("family", ["nomic", "modernbert", "alibi"])
def test_checkpoint_loads_as_jax_loads(tmp_path, family):
    if family == "nomic":
        st = tmp_path / "model.safetensors"
        _synthetic_nomic(st, NOMIC_CFG)
        cfg = NOMIC_CFG
    elif family == "modernbert":
        st = tmp_path / "model.safetensors"
        _synthetic_modernbert(st, MB_CFG)
        cfg = MB_CFG
    else:
        _write_synthetic_reranker(tmp_path, alibi=True)
        st = tmp_path / "model.safetensors"
        cfg = dataclasses.replace(arch_from_hf_config(tmp_path), pooling="mean")
        assert cfg.position_type == "alibi"
    jp, tp = _jax_and_port_checkpoint(st, cfg)
    _match(jp, tp, cfg, 24, seed=4)


def test_missing_checkpoint_tensor_raises(tmp_path):
    st = tmp_path / "model.safetensors"
    _synthetic_nomic(st, NOMIC_CFG)
    with pytest.raises(KeyError, match="missing tensor"):
        te.load_safetensors(st, dataclasses.replace(NOMIC_CFG, layers=3), "cpu")


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="arch_style"):
        te.check_supported(dataclasses.replace(CONFIGS["nomic"], arch_style="t5"))
    with pytest.raises(ValueError, match="position_type"):
        te.init_params(dataclasses.replace(CONFIGS["alibi"], position_type="relative_key"))


# ---------------------------------------------------------------------------
# the slice: index and search with nomic-v1.5 and modernbert-large
# ---------------------------------------------------------------------------

ROW_COS_MIN = 0.999
SLICE_MODELS = ("nomic-v1.5", "modernbert-large")


@pytest.fixture(scope="module")
def rotary_indexes(tmp_path_factory):
    """A small repository indexed by each package with each rotary model at
    test widths (hidden 64, 3 layers, the published vocab, rope bases and
    window: the registry entries are swapped for the module), the port's
    init cache seeded from JAX's init: {model: (repo, jax db, port db)}."""
    from codesearch_tpu.index.pipeline import IndexOptions as JaxIndexOptions
    from codesearch_tpu.index.pipeline import index as jax_index
    from codesearch_tpu.models import registry as jreg
    from codesearch_tpu_torch.index import IndexOptions, index
    from codesearch_tpu_torch.models import registry as treg

    root = tmp_path_factory.mktemp("rotary-slice")
    repo = root / "repo"
    (repo / "src").mkdir(parents=True)
    for noun in ("config", "buffer", "token", "socket"):
        (repo / "src" / f"{noun}.py").write_text("\n\n".join(
            f"def {verb}_{noun}(arg):\n    return arg.{noun}_{i}\n"
            for i, verb in enumerate(("parse", "merge", "flush", "validate", "scan"))))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for model in SLICE_MODELS:
            for reg in (jreg, treg):
                spec = reg.MODELS[model]
                arch = dataclasses.replace(spec.arch, hidden=64, heads=4, intermediate=96,
                                           layers=3)
                mp.setitem(reg.MODELS, model, dataclasses.replace(spec, arch=arch, dims=64))
            cfg = treg.MODELS[model].arch
            te.save_params_npz(te.params_from_jax(je.init_params(jax.random.PRNGKey(0), cfg)),
                               te.init_cache_path(cfg))
            jax_db, port_db = root / f"jax-{model}", root / f"port-{model}"
            assert jax_index(repo, JaxIndexOptions(store_path=jax_db, model=model,
                                                   quiet=True)).chunks_added >= 20
            assert index(repo, IndexOptions(store_path=port_db, model=model, quiet=True),
                         device="cpu").chunks_added >= 20
            out[model] = (repo, jax_db, port_db)
        yield out


def _rows_by_hash(db) -> dict:
    from codesearch_tpu.vectordb.store import VectorStore as JaxVectorStore

    store = JaxVectorStore(db, dims=64, readonly=True)
    rows = np.asarray(store._rows_range(0, store._rows), np.float32)
    row_of = {int(cid): r for r, cid in enumerate(store._cids.view())}
    return {m.hash: rows[row_of[cid]] for cid, m in store.iter_chunks()}


@pytest.mark.parametrize("model", SLICE_MODELS)
def test_both_packages_index_rotary_models_alike(rotary_indexes, model):
    _, jax_db, port_db = rotary_indexes[model]
    jrows, trows = _rows_by_hash(jax_db), _rows_by_hash(port_db)
    assert set(jrows) == set(trows)
    assert min(float(jrows[h] @ trows[h] / (np.linalg.norm(jrows[h]) * np.linalg.norm(trows[h])))
               for h in jrows) >= ROW_COS_MIN


@pytest.mark.parametrize("model", SLICE_MODELS)
def test_port_searches_the_jax_rotary_index(rotary_indexes, model):
    from codesearch_tpu.search.pipeline import SearchSession as JaxSession
    from codesearch_tpu_torch.search import SearchOptions, SearchSession

    _, jax_db, _ = rotary_indexes[model]
    ours, ref = SearchSession(jax_db, device="cpu"), JaxSession(jax_db)
    assert ours.service.backend.encoder.cfg.arch_style == MODELS[model].arch.arch_style
    st = ours._prep_query("validate the socket", SearchOptions(limit=5))
    ids, mask = st["feats"]
    got = ours.service.backend.encoder.encode(torch.from_numpy(ids), torch.from_numpy(mask))
    want = je.encode(ref.service.backend.params, jnp.asarray(ids), jnp.asarray(mask),
                     ref.service.backend.cfg)
    assert _cos_rows(got.numpy(), np.asarray(want)).min() >= COS_MIN
    for mode in ("hybrid", "vector"):
        resp = ours.search("validate the socket", SearchOptions(limit=5, mode=mode))
        assert len(resp.hits) == 5 and all(np.isfinite(h.score) for h in resp.hits)


@pytest.mark.parametrize("model", SLICE_MODELS)
def test_cli_index_and_search_rotary_model(rotary_indexes, tmp_path, capsys, model):
    import json

    from codesearch_tpu_torch.cli import main

    repo, _, _ = rotary_indexes[model]
    db = tmp_path / "db"
    assert main(["--platform", "cpu", "--quiet", "--store", str(db), "index", "--model", model,
                 str(repo)]) == 0
    assert json.loads((db / "metadata.json").read_text())["model"] == model
    capsys.readouterr()
    assert main(["--platform", "cpu", "--store", str(db), "search", "merge the token",
                 str(repo), "--json", "--limit", "3"]) == 0
    hits = json.loads(capsys.readouterr().out)["results"]
    assert len(hits) == 3 and all(h["path"].startswith("src/") for h in hits)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["nomic-v1.5", "modernbert-large"])
def test_rotary_family_on_cuda_matches_cpu(cuda, model):
    # the published widths (Dh = 64), depth cut to 3 (ModernBERT: layer 0
    # global, 1 and 2 local); S = 256 puts the 128-key window inside S
    cfg = dataclasses.replace(MODELS[model].arch, layers=3)
    params = te.init_params(cfg)
    gpu = te.BertEncoder(cfg, params, device="cuda")
    cpu = te.BertEncoder(cfg, params, device="cpu")
    ids, mask = _ids_mask(cfg.vocab_size, 256, seed=5, rows=4)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    ta.reset_launch_counts()
    a = gpu.encode(ids.to(cuda), mask.to(cuda)).cpu().numpy()
    globals_ = sum(1 for i in range(cfg.layers) if cfg.arch_style == "nomic"
                   or i % cfg.global_every == 0)
    assert ta.launch_counts["attention_full"] == globals_
    assert ta.launch_counts["attention_window"] == cfg.layers - globals_
    assert ta.composed_counts["window"] == 0
    b = cpu.encode(ids, mask).numpy()
    assert _cos_rows(a, b).min() >= 0.999
