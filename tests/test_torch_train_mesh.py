"""The training mesh (``codesearch_tpu_torch.parallel.train_mesh``, the
sharded ``BertEncoder``, ``train.contrastive``'s mesh step) held against the
JAX package's ``codesearch_tpu.train.contrastive`` on the CPU: gloo in
spawned processes (``parallel.launch.spawn_ranks``, a ``file://`` store), the
JAX step on the 8-device virtual CPU mesh, the same numpy inputs.

- Placement: ``param_shardings`` is JAX's for each family of
  ``tests/test_torch_train.py`` on a 4 x 2 mesh, and every rank's shards
  (the JAX-layout leaves, and the encoder's own, fused, parameters) have
  JAX's ``shard_shape``.
- Three steps on a 2 x 2 mesh (four ranks) of each family against JAX's
  ``make_train_step`` on ``make_mesh(2, 2)``, at ``test_train_steps_match_jax``'s
  tolerances: losses within 5e-3 relative, the first step's gathered
  gradients at cosine >= 0.99 per parameter (0.9 for a BERT layer's fused
  QKV bias) and the gathered parameters within 2 x steps x lr (measured:
  losses 1.0e-3, cosine 0.986 at BERT's ``qkv_b`` and 0.9985 elsewhere,
  parameters 5.2e-3 of the bound's 6e-3). Cosines and AdamW both ignore a
  gradient's scale, so each first-step gradient's norm is held to JAX's
  too, within GRAD_NORM_RTOL (0.024 measured, at BERT's ``qkv_b``): a
  gradient averaged where it should be summed is 0.5 off.
- The same runs against the port's one-device step, tighter: the first
  loss equal, the losses within 1e-3 relative (2.8e-4 measured), every
  first-step gradient at cosine >= 0.999 (0.99993 measured) and within
  GRAD_REL_MAX relative L2 error (0.018 measured), the parameters within
  the same Adam bound (4.6e-3 measured) and each parameter's update over
  the steps within UPDATE_REL_MAX relative L2 error of the one device's
  (0.18 measured). The row-parallel sums round apart from the one-device
  products, and Adam turns a last-bit difference of a near-zero gradient
  into a step of up to lr; ``k_b``'s gradient is zero but for rounding
  (a bias added to every key leaves the softmax as it is), so its update
  is the sign of that rounding, and only the Adam bound holds it.
- The vocabulary is 212 rows: JAX itself refuses to split 211 over 2, and
  so does the port (a separate test), as it refuses a batch that does not
  divide by the data axis.
- An ALiBi BERT on 2 x 2 (each rank's heads take their rows of the bias)
  against the port's one-device step, at the tolerances above.
- Descent: the counterpart of ``TestTraining::test_tp_dp_train_step_runs_and_descends``.
- A 1 x 1 mesh in this process (gloo, ``file://`` store, the group destroyed
  after) is the one-device step bit for bit: each collective sums one
  rank's values in f32 and casts back, which changes no bit, and the
  products are the one-device products. Both run under
  ``torch.use_deterministic_algorithms``: the CPU may otherwise sum the
  word table's gradient over threads in another order from run to run.
- The vocab-parallel lookup: ids past the table take its last row on the
  mesh as on one device (the 2 x 2 step's loss on such a batch is the
  one-device step's on the clamped ids, bit for bit).
- A checkpoint saved from 2 x 2 and restored on 2 x 2 and on one device:
  one more step equals the unbroken run (bit for bit on 2 x 2; on one
  device the loss within 1e-4 relative and the parameters within the Adam
  bound of one step, 1.2e-3 of 2e-3 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import FAMILIES as TRAIN_FAMILIES
from test_torch_train import _cos, _step_batches

from codesearch_tpu.models.encoder import init_params as jax_init_params
from codesearch_tpu.models.registry import ArchConfig
from codesearch_tpu.parallel.mesh import make_mesh
from codesearch_tpu.train import contrastive as jc
from codesearch_tpu_torch.models import encoder as te
from codesearch_tpu_torch.models.registry import ArchConfig as TorchArchConfig
from codesearch_tpu_torch.parallel import train_mesh as tm
from codesearch_tpu_torch.parallel.launch import spawn_ranks, train_runs
from codesearch_tpu_torch.train import checkpoint as tck
from codesearch_tpu_torch.train import contrastive as tc

VOCAB = 212
FAMILIES = {name: {**kw, "vocab_size": VOCAB} for name, kw in TRAIN_FAMILIES.items()}
STEPS, LR = 3, 1e-3
GRAD_NORM_RTOL = 0.05   # a first-step gradient's norm against JAX's (0.024 measured)
GRAD_REL_MAX = 0.05     # its relative L2 error against the port's one device (0.018)
UPDATE_REL_MAX = 0.5    # the steps' update against the one device's, k_b apart (0.18)
ALIBI_BERT = {**FAMILIES["bert"], "position_type": "alibi"}
DESCENT_CFG = dict(vocab_size=256, hidden=32, layers=1, heads=2, intermediate=64, max_len=32,
                   pooling="mean")


def _descent_batch():
    rng = np.random.default_rng(0)
    return {"query_ids": rng.integers(0, 256, (4, 8)).astype(np.int32),
            "query_mask": np.ones((4, 8), np.int32),
            "doc_ids": rng.integers(0, 256, (4, 8)).astype(np.int32),
            "doc_mask": np.ones((4, 8), np.int32)}


def _past_the_table(batch: dict) -> dict:
    """``batch`` with ids past the table in three queries."""
    out = {k: v.copy() for k, v in batch.items()}
    out["query_ids"][0, :4] = VOCAB + np.arange(4) * 37
    out["query_ids"][5, 3] = VOCAB
    out["query_ids"][7, -1] = 10 * VOCAB
    return out


def _fused(cfg, tree: dict) -> dict:
    """A JAX-layout tree under the port's parameter names (a BERT layer's
    q, k and v fused)."""
    model = te.BertEncoder(cfg, te.params_from_jax(tree), device="cpu", trainable=True)
    return {name: p.detach().numpy() for name, p in model.named_parameters()}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every 2 x 2 run of the file, in one set of four spawned ranks: the
    three families' steps (BERT's saving after step 2), the descent, BERT
    resumed from step 2, and one step of each family on a batch with ids
    past the table."""
    ckpt = tmp_path_factory.mktemp("mesh-ckpt")
    batches = _step_batches(STEPS, VOCAB)
    runs = {}
    for kw in (*FAMILIES.values(), ALIBI_BERT):
        te.cached_init_params(TorchArchConfig(**kw), 0)     # the ranks read the init cache
    for name, kw in FAMILIES.items():
        cfg = TorchArchConfig(**kw)
        runs[name] = dict(cfg=cfg, batches=batches, learning_rate=LR,
                          **({"ckpt_dir": ckpt, "save_step": 2} if name == "bert" else {}))
        runs[f"{name}-past-the-table"] = dict(cfg=cfg, batches=[_past_the_table(batches[0])])
    runs["bert-alibi"] = dict(cfg=TorchArchConfig(**ALIBI_BERT), batches=batches,
                              learning_rate=LR)
    runs["descent"] = dict(cfg=TorchArchConfig(**DESCENT_CFG), batches=[_descent_batch()] * 5,
                           learning_rate=1e-2)
    runs["bert-resumed"] = dict(cfg=TorchArchConfig(**FAMILIES["bert"]), batches=batches[2:],
                                learning_rate=LR, ckpt_dir=ckpt, resume_step=2)
    ranks = spawn_ranks(2, 2, train_runs, (list(runs.values()),), device="cpu",
                        init_dir=tmp_path_factory.mktemp("mesh-init"), timeout=300)
    # every rank computes the global loss: the same on all four
    for i in range(len(runs)):
        assert all(r[i]["losses"] == ranks[0][i]["losses"] for r in ranks)
        assert all(r[i]["params"] is None for r in ranks[1:])
    return {"runs": dict(zip(runs, ranks[0])), "batches": batches, "ckpt": ckpt}


def _rel(a, b) -> float:
    """||a - b|| / ||b||."""
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _one_device(cfg, batches, lr=LR):
    """The port's one-device steps: (model, losses, first-step gradients
    under the port's names)."""
    model, opt = tc.make_train_state(cfg, device="cpu", seed=0, learning_rate=lr)
    step = tc.make_train_step(cfg, opt)
    losses, grads = [], None
    for batch in batches:
        losses.append(float(step(model, batch)))
        if grads is None:
            grads = {name: p.grad.numpy().copy() for name, p in model.named_parameters()}
    return model, losses, grads


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_param_shardings_match_jax(family):
    jcfg, tcfg = ArchConfig(**FAMILIES[family]), TorchArchConfig(**FAMILIES[family])
    jmesh = make_mesh(n_data=4, n_model=2)
    jsh = jc.param_shardings(jax_init_params(jax.random.PRNGKey(0), jcfg), jmesh)
    params = te.init_params(tcfg, 0)
    specs = te.flatten_params(tc.param_shardings(params, tm.TrainMesh(4, 2, device="cpu")))
    want = te.flatten_params(jsh)
    assert specs.keys() == want.keys()
    for name, spec in specs.items():
        assert spec == tuple(want[name].spec), name
    full = te.flatten_params(params)
    for rank in range(8):
        mesh = tm.TrainMesh(4, 2, rank=rank, device="cpu")
        local = te.flatten_params(tm.shard_params(params, mesh))
        for name, arr in local.items():
            assert arr.shape == want[name].shard_shape(full[name].shape), (rank, name)
        model = te.BertEncoder(tcfg, params, trainable=True, mesh=mesh)
        held = dict(model.named_parameters())
        for name, p in _fused(tcfg, tm.shard_params(params, mesh)).items():
            assert tuple(held[name].shape) == p.shape, (rank, name)
        if family == "bert":    # the q, k and v columns of this rank's head
            h = tcfg.hidden // 2
            qkv = held["layers.0.qkv_w"].detach().numpy()
            cols = slice(mesh.model_rank * h, (mesh.model_rank + 1) * h)
            for part, block in zip(("q_w", "k_w", "v_w"), np.split(qkv, 3, axis=1)):
                assert np.array_equal(block, full[f"layers.0.{part}"][:, cols]), part
            assert model.layers[0].heads == tcfg.heads // 2


def test_both_packages_refuse_a_table_the_model_axis_does_not_divide():
    kw = {**FAMILIES["bert"], "vocab_size": 211}
    with pytest.raises(ValueError, match="divisible by 2"):
        jc.make_sharded_train_state(ArchConfig(**kw), make_mesh(n_data=2, n_model=2),
                                    jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="embeddings.word: dimension 0 of .211, 64."):
        tc.make_sharded_train_state(TorchArchConfig(**kw), tm.TrainMesh(2, 2, device="cpu"))
    batch = _step_batches(1, VOCAB, b=7)[0]
    with pytest.raises(ValueError, match="7 rows do not divide by the 'data' axis"):
        tc.data_rows(batch, tm.TrainMesh(2, 2, device="cpu"))
    with pytest.raises(ValueError, match="2 heads do not divide"):
        tc.make_sharded_train_state(TorchArchConfig(**FAMILIES["bert"]),
                                    tm.TrainMesh(1, 4, device="cpu"))


def test_the_mesh_is_on_cuda_unless_the_cpu_is_named(monkeypatch, tmp_path):
    """As everywhere in the port: no device means CUDA, and without a card
    that raises; the backend follows the device, and ranks that would share
    a card must name gloo."""
    from codesearch_tpu_torch.parallel import launch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.TrainMesh(2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn_ranks(1, 1, train_runs, ([],), init_dir=tmp_path)
    assert tm.TrainMesh(2, 2, device="cpu").device == torch.device("cpu")
    assert launch._backend_for(torch.device("cpu"), 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert launch._backend_for(torch.device("cuda"), 4) == "nccl"
    with pytest.raises(ValueError, match="pass backend='gloo' to share a card"):
        launch._backend_for(torch.device("cuda"), 8)
    with pytest.raises(ValueError, match="pass backend='gloo' to share a card"):
        launch._backend_for(torch.device("cuda", 0), 2)
    assert not list(tmp_path.iterdir())     # refused before any rank started


def test_row_parallel_partial_product_is_the_f32_product():
    """The partial product of ``row_parallel`` (TF32 allowed inside, for
    bf16 operands it holds exactly) gives the f32 product and its
    gradients in the operands' dtypes, and leaves the process's TF32
    setting as it was."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(3)
    x0 = torch.from_numpy(rng.standard_normal((2, 5, 8), np.float32)).bfloat16()
    w0 = torch.from_numpy(rng.standard_normal((8, 6), np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((2, 5, 6), np.float32))
    outs = []
    for product in (tm._PartialProduct.apply, lambda x, w: torch.matmul(x.float(), w.float())):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        y = product(x, w)
        y.backward(g)
        outs.append((y.detach(), x.grad, w.grad))
    for got, want in zip(*outs):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.backends.cuda.matmul.allow_tf32 == tf32


# ---------------------------------------------------------------------------
# steps on 2 x 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_mesh_steps_match_jax(family, mesh_runs):
    jcfg, tcfg = ArchConfig(**FAMILIES[family]), TorchArchConfig(**FAMILIES[family])
    run, batches = mesh_runs["runs"][family], mesh_runs["batches"]
    mesh = make_mesh(n_data=2, n_model=2)
    params, opt_state, tx = jc.make_sharded_train_state(jcfg, mesh, jax.random.PRNGKey(0),
                                                        learning_rate=LR)
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    jgrads = jax.grad(jc.info_nce_loss)(params, jbatches[0], jcfg)
    jstep = jc.make_train_step(jcfg, mesh, tx)
    jlosses = []
    for batch in jbatches:
        params, opt_state, loss = jstep(params, opt_state, batch)
        jlosses.append(float(loss))
    np.testing.assert_allclose(run["losses"], jlosses, rtol=5e-3)
    got, want = _fused(tcfg, run["grads"]), _fused(tcfg, te.params_from_jax(jgrads))
    for name in want:
        floor = 0.9 if name.endswith("qkv_b") else 0.99
        assert _cos(got[name], want[name]) >= floor, name
        ratio = np.linalg.norm(got[name]) / np.linalg.norm(want[name])
        assert abs(ratio - 1) <= GRAD_NORM_RTOL, (name, ratio)
    got_p, want_p = te.flatten_params(run["params"]), te.flatten_params(te.params_from_jax(params))
    for name, arr in want_p.items():
        assert np.abs(got_p[name] - arr).max() <= 2 * STEPS * LR, name

    # the same run against the port's one-device steps
    _hold_to_one_device(tcfg, run, batches)


def _hold_to_one_device(cfg, run: dict, batches: list) -> None:
    """A 2 x 2 run against the port's one-device steps on ``batches``."""
    model, losses, grads = _one_device(cfg, batches)
    assert run["losses"][0] == losses[0]
    np.testing.assert_allclose(run["losses"], losses, rtol=1e-3)
    got = _fused(cfg, run["grads"])
    for name, g in grads.items():
        assert _cos(got[name], g) >= 0.999, name
        assert _rel(got[name], g) <= GRAD_REL_MAX, name
    init = te.flatten_params(te.cached_init_params(cfg, 0))
    got_p, want_p = te.flatten_params(run["params"]), te.flatten_params(model.to_params())
    for name, arr in want_p.items():
        assert np.abs(got_p[name] - arr).max() <= 2 * STEPS * LR, name
        if not name.endswith("k_b"):
            assert _rel(got_p[name] - init[name], arr - init[name]) <= UPDATE_REL_MAX, name


def test_alibi_bert_on_the_mesh_is_the_one_device_step(mesh_runs):
    """Each rank's heads take their rows of the ALiBi bias."""
    _hold_to_one_device(TorchArchConfig(**ALIBI_BERT), mesh_runs["runs"]["bert-alibi"],
                        mesh_runs["batches"])


def test_train_mesh_descends(mesh_runs):
    losses = mesh_runs["runs"]["descent"]["losses"]
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], f"no descent: {losses}"


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_vocab_parallel_lookup_clamps_as_one_device(family, mesh_runs):
    cfg = TorchArchConfig(**FAMILIES[family])
    batch = _past_the_table(mesh_runs["batches"][0])
    clamped = np.minimum(batch["query_ids"], VOCAB - 1)
    model = te.BertEncoder(cfg, te.init_params(cfg, 0), device="cpu")
    mask = torch.from_numpy(batch["query_mask"])
    want = model.encode(torch.from_numpy(clamped), mask).numpy()
    assert np.array_equal(model.encode(torch.from_numpy(batch["query_ids"]), mask).numpy(), want)
    _, losses, _ = _one_device(cfg, [{**batch, "query_ids": clamped}])
    assert mesh_runs["runs"][f"{family}-past-the-table"]["losses"] == losses


def test_checkpoint_saved_on_the_mesh_restores_on_the_mesh_and_on_one_device(mesh_runs):
    runs, ckpt = mesh_runs["runs"], mesh_runs["ckpt"]
    cfg = TorchArchConfig(**FAMILIES["bert"])
    unbroken, resumed = runs["bert"], runs["bert-resumed"]
    assert resumed["losses"] == unbroken["losses"][2:]
    want = te.flatten_params(unbroken["params"])
    for name, arr in te.flatten_params(resumed["params"]).items():
        assert np.array_equal(arr, want[name]), name
    model, opt = tc.make_train_state(cfg, device="cpu", seed=0, learning_rate=LR)
    assert tck.restore_train_state(ckpt, 2, model, opt) == 2
    assert all(int(s["step"]) == 2 for s in opt.state.values())
    loss = float(tc.make_train_step(cfg, opt)(model, mesh_runs["batches"][2]))
    np.testing.assert_allclose(loss, unbroken["losses"][2], rtol=1e-4)
    for name, arr in te.flatten_params(model.to_params()).items():
        assert np.abs(arr - want[name]).max() <= 2 * LR, name


# ---------------------------------------------------------------------------
# 1 x 1 in this process
# ---------------------------------------------------------------------------

@pytest.fixture()
def deterministic():
    """The CPU's ``index_put_`` with accumulation (the word table's
    gradient) may sum over threads in any order; its deterministic form
    makes the one-device step reproducible bit for bit."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_one_by_one_mesh_is_the_one_device_step(family, tmp_path, monkeypatch, deterministic):
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    cfg = TorchArchConfig(**FAMILIES[family])
    batches = _step_batches(STEPS, VOCAB)
    mesh = tm.init_train_mesh(1, 1, backend="gloo", init_method=f"file://{tmp_path / 'store'}",
                              rank=0, world_size=1, device="cpu")
    try:
        model, opt = tc.make_sharded_train_state(cfg, mesh, seed=0, learning_rate=LR)
        step = tc.make_train_step(cfg, opt, mesh)
        losses = [float(step(model, b)) for b in batches]
        got = model.gather_params()
    finally:
        mesh.destroy()
    ref, ref_losses, _ = _one_device(cfg, batches)
    assert losses == ref_losses
    want = te.flatten_params(ref.to_params())
    for name, arr in te.flatten_params(got).items():
        assert np.array_equal(arr, want[name]), name
