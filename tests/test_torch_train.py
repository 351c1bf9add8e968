"""Training on torch (``codesearch_tpu_torch.train``) held against the JAX
package's ``codesearch_tpu.train`` on the CPU, on the same numpy inputs.

- The attention backward: ``fused_encoder_attention`` with inputs that
  require grad (kernel d's or e's plain twin forward, ``reference_attention``
  recomputed backward) against ``jax.vjp`` of JAX's
  ``fused_encoder_attention``: f32 within atol 2e-5 / rtol 2e-3, bf16 within
  one bf16 step (1e-2 + 1e-2 |ref|).
- ``jax_random.fold_in`` and ``init_head`` bit for bit.
- ``finetune_table`` on a 65,536 x 64 table: per-epoch losses within 1e-4
  relative (2.5e-6 measured), at least 99% of the touched rows' bf16
  entries equal (99.7% measured; the two sum the gathered rows' gradients
  in another order, and Adam's normalisation turns a last-bit difference
  into a bf16 step now and then) and none more than 1/32 apart (1/64
  measured).
- ``make_train_step``: three steps of a 2-layer, hidden-64 encoder of each
  family (bert, nomic, modernbert) against JAX's ``make_train_step`` on a
  1 x 1 mesh: losses within 5e-3 relative (1.9e-3 measured; both run bf16
  activations, the port's forward in kernel d's rounding order), the first
  step's gradients at cosine >= 0.99 per parameter, >= 0.9 for a BERT
  layer's fused QKV bias (0.958 measured: the key bias's exact gradient is
  0, a score row being shift-invariant, and the value bias's is a sum over
  every position that mostly cancels, so rounding noise is most of both),
  and every parameter within the Adam bound of JAX's (2 x steps x lr).
- ``make_train_state``'s AdamW against ``optax.adamw`` on the same
  gradients: equal within 1e-6.
- ``train_cross_encoder``: one epoch with hard negatives, losses within
  1e-3 relative (3.2e-6 measured), and both packages' trained models,
  exported, scoring the same pairs in the port's ``CrossEncoder`` within
  2e-3 (1.2e-5 measured).
- An exported checkpoint loaded by both packages' ``CrossEncoder``: pair
  scores within 2e-3, the bound of ``tests/test_torch_rerank.py`` (1.7e-3
  measured: the two bf16 forwards round apart).
- ``mine_pairs``, ``batches`` and ``mine_hard_negatives`` equal to JAX's; a
  checkpoint round trip; ``save_table`` read by both packages.
- The CLI: ``--platform cpu train`` and ``train --cross-encoder`` on a tiny
  repository; without ``--platform cpu`` training needs CUDA.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from codesearch_tpu.chunker import Chunk, ChunkKind
from codesearch_tpu.models import hash_embedder as jh
from codesearch_tpu.models.cross_encoder import CrossEncoder as JaxCrossEncoder
from codesearch_tpu.models.registry import ArchConfig
from codesearch_tpu.ops import attention as ja
from codesearch_tpu.parallel.mesh import make_mesh
from codesearch_tpu.train import contrastive as jc
from codesearch_tpu.train import cross_encoder_train as jce
from codesearch_tpu.train import data as jd
from codesearch_tpu.train import hash_finetune as jf
from codesearch_tpu_torch.cli.main import main as cli_main
from codesearch_tpu_torch.models import cross_encoder as tcross
from codesearch_tpu_torch.models import encoder as te
from codesearch_tpu_torch.models import hash_embedder as th
from codesearch_tpu_torch.models import jax_random
from codesearch_tpu_torch.models.registry import ArchConfig as TorchArchConfig
from codesearch_tpu_torch.models.tokenizer import HashingTokenizer
from codesearch_tpu_torch.ops import attention as ta
from codesearch_tpu_torch.train import checkpoint as tck
from codesearch_tpu_torch.train import contrastive as tc
from codesearch_tpu_torch.train import cross_encoder_train as tce
from codesearch_tpu_torch.train import data as td
from codesearch_tpu_torch.train import hash_finetune as tf

FAMILIES = {
    "bert": dict(vocab_size=211, hidden=64, layers=2, heads=2, intermediate=128, max_len=64),
    "nomic": dict(vocab_size=211, hidden=64, layers=2, heads=2, intermediate=128, max_len=64,
                  arch_style="nomic", rope_base=1000.0),
    # layer 0 global, layer 1 local with a 16-key window inside S
    "modernbert": dict(vocab_size=211, hidden=64, layers=2, heads=2, intermediate=96,
                       max_len=64, layer_norm_eps=1e-5, arch_style="modernbert",
                       rope_base=160000.0, rope_base_local=10000.0, local_window=16,
                       global_every=2),
}
# the hashing tokenizer puts token ids at 999 and above
CE_CFG = dict(vocab_size=2048, hidden=64, layers=2, heads=2, intermediate=128, max_len=64,
              pooling="cls")
VERBS = ["parse", "walk", "render", "compute", "merge", "flush", "encode", "resolve",
         "validate", "dispatch"]
NOUNS = ["config", "tree", "buffer", "index", "token", "matrix", "query", "chunk", "socket",
         "widget"]


def _pair_texts(n: int = 40) -> list[tuple[str, str]]:
    out = []
    for i in range(n):
        v, o = VERBS[i % 10], NOUNS[(i * 3) % 10]
        out.append((f"{v.capitalize()} the {o} and return it",
                    f"def {v}_{o}_{i}(data):\n    out = {o}_table[{i}]\n    return {v}(out, data)"))
    return out


def _both_pairs(n: int = 40):
    texts = _pair_texts(n)
    return [jd.Pair(*t) for t in texts], [td.Pair(*t) for t in texts]


@pytest.fixture(scope="module", autouse=True)
def default_table():
    """The port's default-table cache filled from JAX's ``make_table(384)``
    (the port regenerates the same bits in tens of seconds)."""
    path = th._table_bits_path(384, th.VOCAB_BUCKETS)
    if not path.exists():
        np.asarray(jh.make_table(384)).view(np.uint16).ravel().tofile(path)


def _cos(a, b) -> float:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


# ---------------------------------------------------------------------------
# the attention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("route", ["d", "e"])
def test_attention_gradients_match_jax_vjp(monkeypatch, route, dtype):
    if route == "e":      # S above the threshold takes kernel e's twin
        monkeypatch.setattr(ta, "full_max_seq", lambda dh: 16)
    rng = np.random.default_rng(11)
    b, h, s, dh = 2, 4, 64, 32
    q, k, v, g = (rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(4))
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)
    mask[0, 0], mask[1] = 1.0, 0.0
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    with jax.default_matmul_precision("float32"):
        out, vjp = jax.vjp(lambda a, c, d: ja.fused_encoder_attention(a, c, d, jnp.asarray(mask)),
                           *(jnp.asarray(x, jdt) for x in (q, k, v)))
        want = [np.asarray(x, np.float32) for x in (out, *vjp(jnp.asarray(g, jdt)))]
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(True) for x in (q, k, v)]
    got = ta.fused_encoder_attention(*leaves, torch.from_numpy(mask))
    assert isinstance(got.grad_fn, ta.KernelAttention._backward_cls)
    got.backward(torch.from_numpy(g).to(tdt))
    tol = {"atol": 2e-5, "rtol": 2e-3} if dtype == "f32" else {"atol": 1e-2, "rtol": 1e-2}
    for name, a, w in zip(("out", "dq", "dk", "dv"), [got, *(t.grad for t in leaves)], want):
        np.testing.assert_allclose(a.detach().float().numpy(), w, err_msg=name, **tol)


# ---------------------------------------------------------------------------
# randomness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,data", [(0, 0), (0, 1), (12345, 3), (7, 2**31 + 5),
                                       (2**32 - 1, 2**32 - 1)])
def test_fold_in_is_jax_bit_for_bit(seed, data):
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data)).tolist()
    assert list(jax_random.fold_in(jax_random.prng_key(seed), data)) == want


def test_fold_in_refuses_data_past_32_bits():
    with pytest.raises(ValueError):
        jax_random.fold_in((0, 0), 1 << 32)


def test_init_head_is_jax_bit_for_bit():
    cfg = ArchConfig(**CE_CFG)
    want = jce.init_head(jax.random.fold_in(jax.random.PRNGKey(3), 1), cfg)
    got = tce.init_head(jax_random.fold_in(jax_random.prng_key(3), 1), TorchArchConfig(**CE_CFG))
    assert sorted(got) == sorted(want)
    for name in want:
        w = np.asarray(want[name], np.float32)
        assert got[name].dtype == np.float32 and got[name].shape == w.shape
        assert np.array_equal(got[name].view(np.uint32), w.view(np.uint32)), name


# ---------------------------------------------------------------------------
# the hash table
# ---------------------------------------------------------------------------

def test_finetune_table_matches_jax():
    rng = np.random.default_rng(0)
    table = torch.from_numpy((rng.standard_normal((65536, 64)) / 8).astype(np.float32))
    table = table.to(torch.bfloat16)
    jpairs, tpairs = _both_pairs()
    jt, jl = jf.finetune_table(jnp.asarray(table.float().numpy(), jnp.bfloat16), jpairs,
                               epochs=3, batch_size=16)
    tt, tl = tf.finetune_table(table, tpairs, epochs=3, batch_size=16)
    assert tt.dtype == torch.bfloat16 and tt.shape == table.shape and len(tl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    want, got, start = (np.asarray(x, np.float32) for x in
                        (jt.astype(jnp.float32), tt.float(), table.float()))
    touched = (want != start).any(axis=1) | (got != start).any(axis=1)
    assert touched.sum() > 100
    assert (want[touched] == got[touched]).mean() >= 0.99
    assert np.abs(want - got).max() <= 1 / 32


def test_finetune_table_returns_bf16_and_needs_four_pairs():
    # (the dense update itself is held by test_finetune_table_matches_jax:
    # optax decays every row's moments at every step, so a sparse update
    # would leave rows behind that JAX moves)
    table = torch.zeros(65536, 64, dtype=torch.bfloat16)
    table[:, 0] = 1.0
    _, tpairs = _both_pairs(8)
    trained, losses = tf.finetune_table(table, tpairs, epochs=2, batch_size=4)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert trained.dtype == torch.bfloat16
    assert tf.finetune_table(table, tpairs[:3])[1] == []


def test_save_table_is_read_by_both_packages(tmp_path):
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32)).to(torch.bfloat16)
    th.save_table(table, tmp_path / "port.npz")
    jh.save_table(jnp.asarray(table.float().numpy(), jnp.bfloat16), tmp_path / "jax.npz")
    want = table.float().numpy()
    for name in ("port.npz", "jax.npz"):
        with np.load(tmp_path / name) as data:
            assert list(data.files) == ["table"] and data["table"].dtype == np.float32
        np.testing.assert_array_equal(th.load_table_host(tmp_path / name, 16), want)
        np.testing.assert_array_equal(jh.load_table_host(tmp_path / name, 16), want)
    assert list(tmp_path.glob("*.tmp*")) == []


# ---------------------------------------------------------------------------
# contrastive steps
# ---------------------------------------------------------------------------

def _step_batches(n: int, vocab: int, b: int = 8, s: int = 24):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        qm = np.ones((b, s), np.int32)
        qm[1, s - 7:], qm[3, 5:] = 0, 0
        dm = np.ones((b, s), np.int32)
        dm[2, 10:] = 0
        out.append({"query_ids": rng.integers(0, vocab, (b, s)).astype(np.int32),
                    "query_mask": qm,
                    "doc_ids": rng.integers(0, vocab, (b, s)).astype(np.int32),
                    "doc_mask": dm})
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_steps_match_jax(family):
    steps, lr = 3, 1e-3
    jcfg, tcfg = ArchConfig(**FAMILIES[family]), TorchArchConfig(**FAMILIES[family])
    mesh = make_mesh(n_data=1, n_model=1)
    params, opt_state, tx = jc.make_sharded_train_state(jcfg, mesh, jax.random.PRNGKey(0),
                                                        learning_rate=lr)
    init = te.flatten_params(te.params_from_jax(params))
    batches = _step_batches(steps, jcfg.vocab_size)
    grads = jax.grad(jc.info_nce_loss)(params, {k: jnp.asarray(v) for k, v in batches[0].items()},
                                       jcfg)
    jax_step = jc.make_train_step(jcfg, mesh, tx)
    model, opt = tc.make_train_state(tcfg, device="cpu", seed=0, learning_rate=lr)
    assert te.flatten_params(model.to_params()).keys() == init.keys()
    for name, arr in te.flatten_params(model.to_params()).items():
        assert np.array_equal(arr, init[name]), name
    port_step = tc.make_train_step(tcfg, opt)
    jl, tl = [], []
    for i, batch in enumerate(batches):
        params, opt_state, loss = jax_step(params, opt_state,
                                           {k: jnp.asarray(v) for k, v in batch.items()})
        jl.append(float(loss))
        tl.append(float(port_step(model, batch)))
        if i == 0:
            # JAX's gradients under the port's (fused) parameter names
            want = dict(te.BertEncoder(tcfg, te.params_from_jax(grads), device="cpu",
                                       trainable=True).named_parameters())
            for name, p in model.named_parameters():
                floor = 0.9 if name.endswith("qkv_b") else 0.99
                assert _cos(p.grad.numpy(), want[name].detach().numpy()) >= floor, name
    np.testing.assert_allclose(tl, jl, rtol=5e-3)
    want = te.flatten_params(te.params_from_jax(params))
    for name, arr in te.flatten_params(model.to_params()).items():
        assert np.abs(arr - want[name]).max() <= 2 * steps * lr, name


def test_train_state_optimizer_is_optax_adamw():
    cfg = TorchArchConfig(**FAMILIES["bert"])
    model, opt = tc.make_train_state(cfg, device="cpu", seed=0, learning_rate=1e-2)
    assert isinstance(opt, torch.optim.AdamW) and model.trainable
    tree = model.to_params()
    jparams = jax.tree.map(jnp.asarray, tree)
    tx = optax.adamw(1e-2)
    state = tx.init(jparams)
    rng = np.random.default_rng(5)
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        gmod = dict(te.BertEncoder(cfg, g, device="cpu", trainable=True).named_parameters())
        for name, p in model.named_parameters():
            p.grad = gmod[name].detach().clone()
        opt.step()
    want = te.flatten_params(jax.tree.map(np.asarray, jparams))
    for name, arr in te.flatten_params(model.to_params()).items():
        np.testing.assert_allclose(arr, want[name], atol=1e-6, rtol=0, err_msg=name)


def test_trainable_form_computes_the_inference_form():
    cfg = TorchArchConfig(**FAMILIES["bert"], pooling="mean")
    params = te.init_params(cfg, 0)
    batch = _step_batches(1, cfg.vocab_size)[0]
    ids, mask = torch.from_numpy(batch["query_ids"]), torch.from_numpy(batch["query_mask"])
    infer = te.BertEncoder(cfg, params, device="cpu")
    train = te.BertEncoder(cfg, params, device="cpu", trainable=True)
    assert not list(infer.parameters()) and all(p.dtype == torch.float32
                                               for p in train.parameters())
    want = infer.encode(ids, mask)
    got = train.encode(ids, mask)
    assert got.requires_grad and not want.requires_grad
    assert torch.equal(got.detach(), want)


# ---------------------------------------------------------------------------
# the cross-encoder
# ---------------------------------------------------------------------------

def _ce_pair_scores(model_dir, query: str, docs: list[str]) -> np.ndarray:
    ce = tcross.CrossEncoder(model_dir.parent, name=model_dir.name, device="cpu")
    assert ce.mode == tcross.MODE_MODEL
    return ce.score_pairs(query, docs)


def test_train_cross_encoder_one_epoch_matches_jax(tmp_path):
    jpairs, tpairs = _both_pairs()
    jnegs = jd.mine_hard_negatives(jpairs, k=2)
    tnegs = td.mine_hard_negatives(tpairs, k=2, device="cpu")
    assert tnegs == jnegs
    jp, jhd, _, jl = jce.train_cross_encoder(jpairs, cfg=ArchConfig(**CE_CFG), epochs=1,
                                             batch_size=16, hard_negatives=jnegs)
    tp, thd, tok, tl = tce.train_cross_encoder(tpairs, cfg=TorchArchConfig(**CE_CFG), epochs=1,
                                               batch_size=16, hard_negatives=tnegs,
                                               device="cpu")
    assert isinstance(tok, HashingTokenizer) and len(tl) == 1
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    cfg = TorchArchConfig(**CE_CFG)
    tce.export_cross_encoder(te.params_from_jax(jp), jax.tree.map(np.asarray, jhd), cfg,
                             tmp_path / "jax-trained")
    tce.export_cross_encoder(tp, thd, cfg, tmp_path / "port-trained")
    query, docs = tpairs[0].query, [p.doc for p in tpairs[:12]]
    np.testing.assert_allclose(_ce_pair_scores(tmp_path / "port-trained", query, docs),
                               _ce_pair_scores(tmp_path / "jax-trained", query, docs),
                               atol=2e-3)


def test_pair_batch_matches_jax():
    tok = HashingTokenizer(vocab_size=2048, max_len=64)
    qs = ["find the parser", "x"]
    docs = ["def parse(text):\n    return text.split()" * 4, "y z"]
    for got, want in zip(tce._pair_batch(tok, qs, docs, 64), jce._pair_batch(tok, qs, docs, 64)):
        np.testing.assert_array_equal(got, want)


def test_exported_checkpoint_loads_in_both_packages(tmp_path):
    cfg = TorchArchConfig(**CE_CFG)
    rng = np.random.default_rng(4)
    params = jax.tree.map(lambda a: a + rng.standard_normal(a.shape).astype(np.float32) * 0.05,
                          te.init_params(cfg, 1))
    head = tce.init_head(jax_random.prng_key(9), cfg)
    head["pooler_w"] = head["pooler_w"] * 5        # pair scores spread, unsaturated
    head["cls_w"] = head["cls_w"] * 10
    out = tce.export_cross_encoder(params, head, cfg, tmp_path / tce.LOCAL_CE_NAME)
    assert sorted(p.name for p in out.iterdir()) == ["config.json", "model.safetensors"]
    query = "parse the config file"
    docs = [f"def {v}_{o}(path):\n    return {o}.{v}(path)" for v in VERBS[:4] for o in NOUNS[:3]]
    port = tcross.CrossEncoder(tmp_path, name="absent-reranker", device="cpu")
    ref = JaxCrossEncoder(tmp_path, name="absent-reranker")
    assert port.name == ref.name == tce.LOCAL_CE_NAME and port.mode == tcross.MODE_MODEL
    got, want = port.score_pairs(query, docs), np.asarray(ref.score_pairs(query, docs))
    assert np.ptp(want) > 1e-2
    np.testing.assert_allclose(got, want, atol=2e-3)


# ---------------------------------------------------------------------------
# data and checkpoints
# ---------------------------------------------------------------------------

def _chunks(n: int):
    out = []
    for i in range(n):
        v, o = VERBS[i % 10], NOUNS[i % 7]
        out.append(Chunk(content=f"def {v}_{o}_{i}(x):\n    return {o}_table[x] + {i}\n" * 2,
                         start_line=0, end_line=3, kind=ChunkKind.FUNCTION, path=f"m{i}.py",
                         docstring=f"{v.capitalize()} the {o} for the caller" if i % 3 else None,
                         signature=f"def {v}_{o}_{i}(x)" if i % 2 else None,
                         context=["File: m.py", f"Function: {v}_{o}_{i}"] if i % 4 else []))
    out.append(Chunk(content="tiny", start_line=0, end_line=1, kind=ChunkKind.FUNCTION,
                     path="t.py", docstring="a docstring long enough"))
    return out


def test_mine_pairs_and_batches_match_jax():
    chunks = _chunks(23)
    want = jd.mine_pairs(chunks)
    got = td.mine_pairs(chunks)
    assert [(p.query, p.doc) for p in got] == [(p.query, p.doc) for p in want]
    assert len(got) > 30
    tok = HashingTokenizer(vocab_size=2048, max_len=32)
    jb = list(jd.batches(want, tok, batch_size=8, max_len=32, seed=3))
    tb = list(td.batches(got, tok, batch_size=8, max_len=32, seed=3))
    assert len(tb) == len(jb) == len(got) // 8
    for a, b in zip(tb, jb):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_mine_hard_negatives_matches_jax():
    texts = [("Parse the config", "def parse_config(path):\n    return read(path)"),
             ("Parse yaml config", "def parse_yaml_config(path):\n    return yaml.load(path)"),
             ("Walk the tree", "def walk_tree(root):\n    return list(root.rglob('*'))"),
             ("Draw a triangle", "def draw_triangle(canvas):\n    canvas.fill()"),
             ("Parse the config again", "def parse_config(path):\n    return read(path)")]
    want = jd.mine_hard_negatives([jd.Pair(*t) for t in texts], k=2)
    got = td.mine_hard_negatives([td.Pair(*t) for t in texts], k=2, device="cpu")
    assert got == want
    assert all(texts[i][1] not in negs for i, negs in enumerate(got))
    assert td.mine_hard_negatives([td.Pair(*t) for t in texts[:2]], k=2) == [[], []]


def test_checkpoint_round_trip(tmp_path):
    cfg = TorchArchConfig(**FAMILIES["nomic"])
    model, opt = tc.make_train_state(cfg, device="cpu", seed=0, learning_rate=1e-3)
    tc.make_train_step(cfg, opt)(model, _step_batches(1, cfg.vocab_size)[0])
    assert tck.latest_step(tmp_path / "ckpt") is None
    for step in (5, 40, 12):
        path = tck.save_checkpoint(tmp_path / "ckpt", step, model.state_dict(), opt.state_dict())
        assert path.name == f"step_{step:08d}"
    (tmp_path / "ckpt" / "step_junk").write_text("")
    assert tck.latest_step(tmp_path / "ckpt") == 40
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_00000005", "step_00000012", "step_00000040", "step_junk"]
    restored = tck.restore_checkpoint(tmp_path / "ckpt", 40)
    assert restored["step"] == 40
    model2, opt2 = tc.make_train_state(cfg, device="cpu", seed=1, learning_rate=1e-3)
    model2.load_state_dict(restored["params"])
    opt2.load_state_dict(restored["opt_state"])
    for (n, a), (_, b) in zip(model.state_dict().items(), model2.state_dict().items()):
        assert torch.equal(a, b), n
    assert opt2.state_dict()["state"][0]["step"] == opt.state_dict()["state"][0]["step"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_train_and_cross_encoder_on_a_tiny_repo(tmp_path, monkeypatch, capsys):
    home = tmp_path / "home"
    monkeypatch.setenv("CODESEARCH_HOME", str(home))
    repo = tmp_path / "repo"
    repo.mkdir()
    for f in range(3):
        (repo / f"mod{f}.py").write_text("\n\n".join(
            f'def {v}_{o}_{f}(data, limit=10):\n    """{v.capitalize()} the {o} and return '
            f'the updated {o}."""\n    out = []\n    for item in data[:limit]:\n'
            f'        out.append(item * {i + 1})\n    return out\n'
            for i, (v, o) in enumerate(zip(VERBS, NOUNS[f:] + NOUNS[:f]))))
    path = th._table_bits_path(384, th.VOCAB_BUCKETS)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.asarray(jh.make_table(384)).view(np.uint16).ravel().tofile(path)
    db = repo / ".codesearch.db"
    assert cli_main(["--platform", "cpu", "-q", "index", str(repo)]) == 0
    assert cli_main(["--platform", "cpu", "-q", "train", str(repo), "--epochs", "2"]) == 0
    trained = th.load_table_host(db / "hash_table.npz", 384)
    assert trained is not None and jh.load_table_host(db / "hash_table.npz", 384) is not None
    assert not np.array_equal(trained, th.make_table(384, device="cpu").float().numpy())
    assert cli_main(["--platform", "cpu", "-q", "train", "--cross-encoder", str(repo),
                     "--epochs", "1"]) == 0
    ce = tcross.CrossEncoder(home / "models", device="cpu")
    assert ce.name == tce.LOCAL_CE_NAME and ce.mode == tcross.MODE_MODEL
    assert ce.cfg.hidden == tce.SMALL_CE_CFG.hidden
    # the re-index after train left no stale rows: 3 files of 10 functions
    capsys.readouterr()
    assert cli_main(["--platform", "cpu", "-q", "stats", str(repo), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["vector"]["chunks"] == 30


def test_training_needs_cuda_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.make_train_state(TorchArchConfig(**FAMILIES["bert"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tce.train_cross_encoder(_both_pairs(4)[1], cfg=TorchArchConfig(**CE_CFG), epochs=1)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_train_step_on_cuda_matches_the_cpu(cuda):
    # kernel d forward once a layer and encoding, its backward recomputed as
    # often; the loss within 1e-2 relative and the gradients at cosine >=
    # 0.99 per parameter of the same step on the CPU
    cfg = TorchArchConfig(**FAMILIES["bert"])
    batch = _step_batches(1, cfg.vocab_size)[0]
    model, opt = tc.make_train_state(cfg, device=cuda, seed=0)
    ref, ref_opt = tc.make_train_state(cfg, device="cpu", seed=0)
    launches, recomputes = ta.launch_counts["attention_full"], ta.composed_counts["backward"]
    loss = float(tc.make_train_step(cfg, opt)(model, batch))
    assert ta.launch_counts["attention_full"] == launches + 2 * cfg.layers
    assert ta.composed_counts["backward"] == recomputes + 2 * cfg.layers
    ref_loss = float(tc.make_train_step(cfg, ref_opt)(ref, batch))
    assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss)
    want = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        assert _cos(p.grad.float().cpu().numpy(), want[name].grad.numpy()) >= 0.99, name
