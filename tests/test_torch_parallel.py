"""The port's device mesh (``codesearch_tpu_torch/parallel``) held to the JAX
package's on the CPU.

JAX runs on its eight virtual CPU devices (``tests/conftest.py``); the port
on eight logical CPU shards, ``make_mesh(n_data=8, devices=[cpu] * 8)``
(one block tensor, the shards its views), or on two CPU device indices
(``cpu:0`` and ``cpu:1``, four shards each: two blocks, so writes split at a
block edge and the encoder is copied once). A test installs a mesh as the
product's corpus mesh by setting ``parallel.mesh._corpus_mesh`` and restores
it afterwards. The same seeded numpy inputs go through both packages:

- the sharded top-k: indices equal to JAX's off near-ties and scores within
  ``SCORE_TOL`` (bf16: f32 sums in another order); against the port's own
  one-device top-k int8 equal bit for bit (its sums are exact) and bf16 held
  as against JAX, since the plain version's f32 matmul rounds by the call's
  shape (a shard's scores may differ from the whole corpus's in the last
  bit; the cuda-marked twins and ``chip_smoke.py`` hold the kernels bit for
  bit); ties across a shard edge keep the lowest global index;
- ``dp_embed_features`` within 1e-5; ``dp_encode`` at the port's encoder
  tolerance against JAX (pooled cosine >= 0.9999);
- sessions (hash and a small random-init BERT, bf16 and int8, ``search``
  and ``search_many``): the sharded port session ranked as the port's
  one-device session (int8 bit for bit, bf16 as above), and as the JAX
  session (the BERT vector leg within ``tests/test_torch_bert_slice.py``'s
  tolerance).

Every test has its own ``CODESEARCH_HOME`` and working directory under its
``tmp_path``.
"""

import contextlib
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from codesearch_tpu.models import hash_embedder as jh
from codesearch_tpu.models import registry as jreg
from codesearch_tpu.models.encoder import encode as jax_encode
from codesearch_tpu.models.encoder import init_params as jax_init_params
from codesearch_tpu.parallel import sharded_search as jss
from codesearch_tpu.parallel.dp_embed import dp_embed_features as jax_dp_embed
from codesearch_tpu.parallel.dp_embed import dp_encode as jax_dp_encode
from codesearch_tpu.parallel.mesh import make_mesh as jax_make_mesh
from codesearch_tpu.parallel.sharded_store import ShardedSearcher as JaxShardedSearcher
from codesearch_tpu.search.pipeline import SearchOptions as JaxOptions
from codesearch_tpu.search.pipeline import SearchSession as JaxSession
from codesearch_tpu.vectordb.store import VectorStore as JaxVectorStore
from codesearch_tpu_torch.embed import EmbeddingService
from codesearch_tpu_torch.embed import service as esvc
from codesearch_tpu_torch.index import IndexOptions, index
from codesearch_tpu_torch.models import encoder as te
from codesearch_tpu_torch.models import hash_embedder as th
from codesearch_tpu_torch.models import registry as treg
from codesearch_tpu_torch.ops import fused_topk
from codesearch_tpu_torch.ops.topk import cosine_topk, cosine_topk_int8, quantize_rows_int8
from codesearch_tpu_torch.parallel import mesh as tmesh
from codesearch_tpu_torch.parallel import sharded_search as tss
from codesearch_tpu_torch.parallel.dp_embed import dp_embed_features, dp_encode
from codesearch_tpu_torch.parallel.sharded_search import ShardedTensor
from codesearch_tpu_torch.parallel.sharded_store import ShardedSearcher
from codesearch_tpu_torch.search import SearchOptions, SearchSession
from codesearch_tpu_torch.vectordb import ChunkMetadata, VectorStore
from codesearch_tpu_torch.vectordb import store as tstore
from test_torch_bert_slice import SCORE_TOL as BERT_TOL
from test_torch_bert_slice import _assert_same_up_to_near_ties, _legs
from test_torch_slice import SCORE_TOL

CPU = torch.device("cpu")
COS_MIN = 0.9999        # the port's encoder against JAX (tests/test_torch_encoder.py)
BERT = "bge-small"      # cut to 2 layers in both registries
VERBS = ["parse", "render", "merge", "flush", "encode", "resolve", "validate", "scan"]
NOUNS = ["config", "buffer", "token", "matrix", "socket", "schema", "widget"]
QUERIES = [("validate the schema", "hybrid"), ("flush_buffer", "hybrid"),
           ("merge token matrix", "vector")]


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _mesh(kind: str):
    devices = {"one": [CPU] * 8,
               "two": [torch.device("cpu", 0)] * 4 + [torch.device("cpu", 1)] * 4}[kind]
    return tmesh.make_mesh(n_data=8, devices=devices)


@contextlib.contextmanager
def installed(mesh):
    """``mesh`` as the product's corpus mesh, the cached one restored after."""
    saved = tmesh._corpus_mesh, tmesh._corpus_mesh_tried
    tmesh._corpus_mesh, tmesh._corpus_mesh_tried = mesh, True
    try:
        yield mesh
    finally:
        tmesh._corpus_mesh, tmesh._corpus_mesh_tried = saved


@pytest.fixture(scope="module")
def jmesh8():
    return jax_make_mesh(n_data=8, n_model=1)


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """A config dir holding both packages' default hash table (the same bf16
    bits) and the port's init cache of the small BERT, seeded from JAX's
    init; the small BERT stays in both registries for the module."""
    d = tmp_path_factory.mktemp("seeded")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CODESEARCH_HOME", str(d))
        np.asarray(jh.make_table(384)).view(np.uint16).ravel().tofile(
            th._table_bits_path(384, th.VOCAB_BUCKETS))
        for reg in (jreg, treg):
            spec = reg.MODELS[BERT]
            mp.setitem(reg.MODELS, BERT, dataclasses.replace(
                spec, arch=dataclasses.replace(spec.arch, layers=2)))
        cfg = treg.MODELS[BERT].arch
        te.save_params_npz(te.params_from_jax(jax_init_params(jax.random.PRNGKey(0), cfg)),
                           te.init_cache_path(cfg))
        yield d


@pytest.fixture(autouse=True)
def home(tmp_path, monkeypatch, seeded):
    h = tmp_path / "home"
    h.mkdir()
    for f in seeded.iterdir():
        (h / f.name).symlink_to(f)
    monkeypatch.setenv("CODESEARCH_HOME", str(h))
    monkeypatch.chdir(tmp_path)
    # a capacity this small spreads a test corpus over every shard
    monkeypatch.setattr(tstore, "VEC_INITIAL_CAPACITY", 16)
    return h


# ---------------------------------------------------------------------------
# the sharded top-k (tests/test_parallel_train.py TestShardedSearch)
# ---------------------------------------------------------------------------

def _corpus(seed: int, n: int, d: int, q: int):
    rng = np.random.default_rng(seed)
    return (_norm(rng.standard_normal((n, d)).astype(np.float32)),
            _norm(rng.standard_normal((q, d)).astype(np.float32)))


def _port_topk(kind, queries, corpus, valid, k, mesh=None, device=CPU):
    """The port's top-k of ``queries`` over ``corpus`` -> (vals, idx) numpy:
    sharded over ``mesh``, or on ``device``."""
    q, v = torch.from_numpy(queries).to(device), torch.from_numpy(valid).to(device)
    if kind == "int8":
        cq, s = quantize_rows_int8(torch.from_numpy(corpus).to(device))
        if mesh is None:
            out = cosine_topk_int8(q, cq, s, v, k)
        else:
            out = tss.sharded_cosine_topk_int8(q, ShardedTensor.place(cq, mesh),
                                               ShardedTensor.place(s, mesh),
                                               ShardedTensor.place(v, mesh), k)
    else:
        cb = torch.from_numpy(corpus).to(torch.bfloat16).to(device)
        if mesh is None:
            out = cosine_topk(q, cb, v, k)
        else:
            out = tss.sharded_cosine_topk(q, *tss.shard_corpus(cb, v, mesh), k)
    return out[0].cpu().numpy(), out[1].cpu().numpy()


def _jax_topk(kind, queries, corpus, valid, k, jmesh):
    rows, vec = NamedSharding(jmesh, P("data", None)), NamedSharding(jmesh, P("data"))
    v = jax.device_put(jnp.asarray(valid), vec)
    if kind == "int8":
        cq, s = quantize_rows_int8(torch.from_numpy(corpus))
        out = jss.sharded_cosine_topk_int8(
            jnp.asarray(queries), jax.device_put(jnp.asarray(cq.numpy()), rows),
            jax.device_put(jnp.asarray(s.numpy()), vec), v, k, jmesh)
    else:
        out = jss.sharded_cosine_topk(
            jnp.asarray(queries), jax.device_put(jnp.asarray(corpus, jnp.bfloat16), rows),
            v, k, jmesh)
    return np.asarray(out[0]), np.asarray(out[1])


def _assert_like_jax(vals, idx, jvals, jidx):
    """Indices equal wherever JAX's scores around a position are more than
    SCORE_TOL apart; scores within SCORE_TOL."""
    np.testing.assert_allclose(vals, jvals, rtol=0, atol=SCORE_TOL)
    gap = np.abs(np.diff(jvals, axis=1)) > SCORE_TOL
    clear = np.ones(jvals.shape, bool)
    clear[:, :-1] &= gap
    clear[:, 1:] &= gap
    assert not ((idx != jidx) & clear).any()


def _assert_like_one_device(kind, got, one):
    """The sharded top-k against the port's one-device top-k on the CPU:
    int8 bit for bit, bf16 as against JAX (see the module docstring)."""
    if kind == "int8":
        assert np.array_equal(got[0], one[0]) and np.array_equal(got[1], one[1])
    else:
        _assert_like_jax(*got, *one)


def _assert_ranked_alike(got, want, exact: bool):
    """Ranked [(chunk id, score)] lists of several queries: equal when
    ``exact``, else as ``_assert_like_jax`` holds a top-k."""
    if exact:
        assert got == want
        return
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        if w:
            _assert_like_jax(np.array([[v for _, v in g]]), np.array([[c for c, _ in g]]),
                             np.array([[v for _, v in w]]), np.array([[c for c, _ in w]]))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("layout", ["one", "two"])
def test_sharded_topk_matches_jax_and_one_device(jmesh8, kind, layout):
    corpus, queries = _corpus(0, 1024, 64, 5)
    valid = np.ones(1024, bool)
    vals, idx = _port_topk(kind, queries, corpus, valid, 10, _mesh(layout))
    _assert_like_one_device(kind, (vals, idx), _port_topk(kind, queries, corpus, valid, 10))
    _assert_like_jax(vals, idx, *_jax_topk(kind, queries, corpus, valid, 10, jmesh8))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_tombstones_respected_across_shards(jmesh8, kind):
    corpus, _ = _corpus(1, 512, 32, 0)
    valid = np.ones(512, bool)
    valid[::2] = False   # tombstone half, spread across shards
    vals, idx = _port_topk(kind, corpus[:3], corpus, valid, 8, _mesh("one"))
    assert (idx % 2 == 1).all()
    _assert_like_jax(vals, idx, *_jax_topk(kind, corpus[:3], corpus, valid, 8, jmesh8))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_tie_across_a_shard_edge_keeps_the_lowest_index(jmesh8, kind):
    corpus, _ = _corpus(2, 1024, 64, 0)
    r = 1024 // 8
    corpus[r] = corpus[3 * r + 5] = corpus[r - 1]   # one row in shards 0, 1 and 3
    valid = np.ones(1024, bool)
    q = corpus[r - 1:r]
    vals, idx = _port_topk(kind, q, corpus, valid, 4, _mesh("two"))
    assert idx[0, :3].tolist() == [r - 1, r, 3 * r + 5]
    assert vals[0, 0] == vals[0, 1] == vals[0, 2]
    jvals, jidx = _jax_topk(kind, q, corpus, valid, 4, jmesh8)
    assert np.array_equal(idx[:, :3], jidx[:, :3])
    _assert_like_one_device(kind, (vals, idx), _port_topk(kind, q, corpus, valid, 4))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_k_equal_to_n_with_n_not_a_multiple_of_the_shards(kind):
    """N = 1003 rows padded with invalid rows to 1008 (126 a shard): k = N
    takes every shard's 126 and every real row, as the one-device call."""
    corpus, queries = _corpus(3, 1003, 48, 3)
    padded = np.concatenate([corpus, np.zeros((5, 48), np.float32)])
    valid = np.arange(1008) < 1003
    vals, idx = _port_topk(kind, queries, padded, valid, 1003, _mesh("one"))
    _assert_like_one_device(kind, (vals, idx),
                            _port_topk(kind, queries, corpus, np.ones(1003, bool), 1003))
    assert sorted(idx[0].tolist()) == list(range(1003))


def test_shards_of_one_device_are_views_and_writes_split_at_edges():
    x = torch.arange(64, dtype=torch.float32).reshape(32, 2)
    want = x.clone()
    want[14:19] = -1.0
    want[[0, 31, 15]] = 7.0
    one = ShardedTensor.place(x.clone(), _mesh("one"))
    two = ShardedTensor.zeros((32, 2), torch.float32, _mesh("two"))
    two[0:32] = x
    assert len(one.blocks) == 1 and len(one.shards) == 8 and one.shard_rows == 4
    assert len(two.blocks) == 2 and two.blocks[1][0] == 16
    assert one.shards[3].data_ptr() == one.blocks[0][1][12:].data_ptr()
    for t in (one, two):
        t[14:19] = torch.full((5, 2), -1.0)       # straddles shards 3 and 4 (and two's blocks)
        t[torch.tensor([0, 31, 15])] = 7.0
        assert torch.equal(torch.cat(t.shards), want)


# ---------------------------------------------------------------------------
# ShardedSearcher (TestShardedSearcher)
# ---------------------------------------------------------------------------

def _metas(n: int, ext: str = "rs"):
    return [ChunkMetadata(path=f"f{i}.{ext}", content=f"c{i}", start_line=0, end_line=1,
                          kind="Function") for i in range(n)]


def test_sharded_searcher_wraps_store(jmesh8, tmp_path):
    embs = _norm(np.random.default_rng(3).standard_normal((40, 16)).astype(np.float32))
    store = VectorStore(tmp_path / "db", dims=16, device="cpu")
    store.insert_chunks_with_ids(embs, _metas(40))
    store.delete_chunks([7])
    store.save()
    searcher = ShardedSearcher(store, mesh=_mesh("one"))
    res = searcher.search_batch(embs[:3], 5)
    assert res[0][0].chunk_id == 0 and res[1][0].chunk_id == 1
    assert all(r.chunk_id != 7 for batch in res for r in batch)
    res7 = searcher.search_batch(embs[7:8], 3)[0]
    assert res7 and all(r.chunk_id != 7 for r in res7)
    want = JaxShardedSearcher(JaxVectorStore(tmp_path / "db", dims=16, readonly=True),
                              mesh=jmesh8).search_batch(embs[:8], 5)
    got = searcher.search_batch(embs[:8], 5)
    for g, w in zip(got, want):
        assert [r.chunk_id for r in g] == [r.chunk_id for r in w]
        np.testing.assert_allclose([r.score for r in g], [r.score for r in w], atol=SCORE_TOL)


# ---------------------------------------------------------------------------
# data-parallel embedding (TestDpEmbed)
# ---------------------------------------------------------------------------

def test_hash_dp_matches_single_and_jax(jmesh8):
    texts = [f"def func_{i}(): return compute_{i}()" for i in range(13)]
    ids, ws = jh.batch_features(texts)
    jtable = jh.make_table(64)
    table = th.table_from_jax(np.asarray(jtable))
    single = th.embed_features(table, torch.from_numpy(ids), torch.from_numpy(ws)).numpy()
    for layout in ("one", "two"):
        dp = dp_embed_features(table, ids, ws, _mesh(layout))
        np.testing.assert_allclose(dp, single, atol=1e-5)
    np.testing.assert_allclose(dp, jax_dp_embed(jtable, ids, ws, jmesh8), atol=1e-5)


def test_bert_dp_matches_single_and_jax(jmesh8):
    from codesearch_tpu.models.registry import ArchConfig

    cfg = ArchConfig(vocab_size=128, hidden=32, layers=1, heads=2, intermediate=64, max_len=16)
    jparams = jax_init_params(jax.random.PRNGKey(0), cfg)
    encoder = te.BertEncoder(cfg, te.params_from_jax(jparams), device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (5, 16)).astype(np.int32)
    mask = np.ones((5, 16), np.int32)
    mask[1, 9:] = 0
    single = encoder.encode(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    want = jax_dp_encode(jparams, ids, mask, cfg, jmesh8)
    np.testing.assert_allclose(want, np.asarray(jax_encode(jparams, jnp.asarray(ids),
                                                           jnp.asarray(mask), cfg)), atol=5e-2)
    for layout in ("one", "two"):
        dp = dp_encode(encoder, ids, mask, _mesh(layout))
        np.testing.assert_allclose(dp, single, atol=1e-5)
        assert (np.sum(dp * want, axis=1) / np.linalg.norm(want, axis=1)).min() >= COS_MIN


# ---------------------------------------------------------------------------
# the product on a mesh (TestProductMeshWiring)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["one", "two"])
def test_store_shards_over_the_mesh_grows_and_tombstones(tmp_path, layout):
    """Slab writes across shard edges, growth past the capacity (a full
    re-shard), tombstones spread over the shards: the sharded store answers
    as the same store on one device (a bf16 store: as ``_assert_like_jax``)."""
    e = _norm(np.random.default_rng(0).standard_normal((300, 8)).astype(np.float32))
    s = VectorStore(tmp_path / "db", dims=8, device="cpu")
    s.host_path_rows = 0

    def both(q):
        with installed(_mesh(layout)):
            sharded = s.search_batch(q, 6)
            mat = s._device[1]
            assert isinstance(mat, ShardedTensor) and len(mat.shards) == 8
            held = sum(min(max(s._rows - i * mat.shard_rows, 0), mat.shard_rows)
                       for i in range(8))           # rows of the store in each shard
            assert s.stats().device_bytes == held * 8 * 2
        one = s.search_batch(q, 6)
        assert isinstance(s._device[1], torch.Tensor)
        return [[(r.chunk_id, r.score) for r in res] for res in sharded], \
               [[(r.chunk_id, r.score) for r in res] for res in one]

    s.insert_chunks_with_ids(e[:64], _metas(64))
    with installed(_mesh(layout)):
        assert s.search(e[13], 3)[0].chunk_id == 13
        cap = s._device[1].shape[0]
        assert cap == 128 and s._device[1].shard_rows == 16
        uploads = s.full_uploads
        s.insert_chunks_with_ids(e[64:100], _metas(36))       # in place, across shards
        assert s.search(e[90], 1)[0].chunk_id == 90 and s.full_uploads == uploads
        s.insert_chunks_with_ids(e[100:], _metas(200))        # past 128 rows: re-shard
        assert s.search(e[250], 1)[0].chunk_id == 250 and s._device[1].shape[0] == 512
        s.delete_chunks(list(range(0, 300, 3)))
        assert all(r.chunk_id % 3 for r in s.search(e[30], 10))
    sharded, one = both(e[::7])
    _assert_ranked_alike(sharded, one, exact=False)


def test_session_search_uses_mesh(tmp_path):
    root = tmp_path / "repo"
    root.mkdir()
    (root / "a.py").write_text(
        "def walk_files(root):\n"
        '    """Walk the tree collecting source files."""\n'
        "    return list(root.rglob('*'))\n")
    with installed(_mesh("one")):
        stats = index(root, IndexOptions(quiet=True), device="cpu")
        sess = SearchSession(stats.db_path, device="cpu")
        sess.store.host_path_rows = 0
        resp = sess.search("walk source files", SearchOptions(limit=2))
        assert resp.hits and resp.hits[0].path.endswith("a.py")
        assert len(sess.store._device[1].shards) == 8
        assert sess.service.backend.mesh is tmesh.corpus_mesh()


def test_corpus_mesh_is_none_here_and_a_cpu_store_never_takes_a_cuda_mesh(tmp_path, monkeypatch):
    with installed(None):
        tmesh.reset_corpus_mesh()
        assert tmesh.corpus_mesh() is None      # fewer than two CUDA devices here
        monkeypatch.setenv("CODESEARCH_SINGLE_DEVICE", "1")
        tmesh.reset_corpus_mesh()
        assert tmesh.corpus_mesh() is None
    cuda_mesh = tmesh.make_mesh(devices=[torch.device("cuda", 0), torch.device("cuda", 1)])
    assert cuda_mesh.shape == {"data": 2, "model": 1}
    with installed(cuda_mesh):
        assert tmesh.mesh_for("cpu") is None and tmesh.mesh_for("cuda") is cuda_mesh
        s = VectorStore(tmp_path / "db", dims=8, device="cpu")
        e = _norm(np.random.default_rng(1).standard_normal((16, 8)).astype(np.float32))
        s.insert_chunks_with_ids(e, _metas(16))
        assert s.search(e[5], 1)[0].chunk_id == 5
        assert isinstance(s._device[1], torch.Tensor) and s._device[1].device == CPU


def test_a_mesh_that_mixes_cpu_and_cuda_raises():
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        tmesh.make_mesh(devices=[CPU, torch.device("cuda", 0)])
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        tmesh.Mesh([[CPU], [torch.device("cuda", 0)]])


def test_dp_embed_through_service(monkeypatch):
    """Batches of 12 rows (the last 8) over 8 shards: every batch launched
    by ``embed_async`` itself, the waiter only reading back."""
    launched = []
    real = esvc.embed_feature_shards
    monkeypatch.setattr(esvc, "EMBED_BATCH", 12)
    monkeypatch.setattr(esvc, "embed_feature_shards",
                        lambda *a: launched.append(a[1].shape[0]) or real(*a))
    with installed(_mesh("two")):
        svc = EmbeddingService("code-hash-384", use_persistent_cache=False, device="cpu")
        assert svc.backend.mesh is tmesh.corpus_mesh() and len(svc.backend.tables) == 2
        texts = [f"fn compute_thing_{i}(x: u32) -> u32 {{ x + {i} }}" for i in range(32)]
        wait = svc.backend.embed_async(texts)
        assert launched == [12, 12, 8]
        via_mesh = wait()
        half = svc.backend.embed_async(texts, half_transfer=True)()
    direct = svc.backend.model.embed_texts(texts)
    np.testing.assert_allclose(via_mesh, direct, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(half, direct, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# sessions (tests/test_index_search.py: sharded against one-device sessions,
# hash and BERT, bf16 and int8, search_many)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def indexes(seeded, tmp_path_factory):
    """One repository (56 functions) indexed by the port on one device with
    the hash model and with the small BERT: {model: db}."""
    root = tmp_path_factory.mktemp("mesh-sessions")
    repo = root / "repo"
    (repo / "src").mkdir(parents=True)
    for noun in NOUNS:
        (repo / "src" / f"{noun}.py").write_text("\n\n".join(
            f"def {verb}_{noun}(arg):\n    \"\"\"{verb.capitalize()} the {noun}.\"\"\"\n"
            f"    return arg.{noun}_{i}\n" for i, verb in enumerate(VERBS)))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CODESEARCH_HOME", str(root / "home"))
        for f in seeded.iterdir():
            (root / "home").mkdir(exist_ok=True)
            (root / "home" / f.name).symlink_to(f)
        for model in ("code-hash-384", BERT):
            db = root / f"db-{model}"
            assert index(repo, IndexOptions(store_path=db, model=model, quiet=True),
                         device="cpu").chunks_added == 56
            out[model] = db
    return out


def _forced(session):
    session.store.host_path_rows = 0
    session.fts.device_min_docs = 1
    session.fts.plane_df_floor = 8
    return session


def _ranked(session, options_cls):
    """[(chunk id, score)] of each query by ``search``, then by one
    ``search_many`` wave of the hybrid queries."""
    _forced(session)
    out = [[(h.chunk_id, h.score) for h in
            session.search(q, options_cls(limit=8, mode=mode)).hits] for q, mode in QUERIES]
    session._resp_cache.clear()
    hyb = [q for q, mode in QUERIES if mode == "hybrid"]
    wave = session.search_many(hyb, options_cls(limit=8))
    return out, [[(h.chunk_id, h.score) for h in r.hits] for r in wave]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("model", ["code-hash-384", BERT])
def test_sharded_session_matches_one_device_and_jax(indexes, tmp_path, model, int8):
    db = tmp_path / "db"
    shutil.copytree(indexes[model], db)
    meta = json.loads((db / "metadata.json").read_text())
    (db / "metadata.json").write_text(json.dumps({**meta, "int8": int8}))
    one, one_wave = _ranked(SearchSession(db, device="cpu"), SearchOptions)
    fused_topk.reset_launch_counts()
    js = JaxSession(db)
    assert js.store._mesh() is not None and js.store.int8 == int8
    with installed(_mesh("one")):
        ts = SearchSession(db, device="cpu")
        sharded, sharded_wave = _ranked(ts, SearchOptions)
        kind, mat = ts.store._device[0], ts.store._device[1]
        assert kind == ("int8" if int8 else "bf16") and len(mat.shards) == 8
        if model == BERT:
            # random-init embeddings: the legs of the fused call, as the
            # BERT slice holds them (near-ties in the vector leg)
            for query, _ in QUERIES:
                tc, tsc, tbm = _legs(ts, query, "hybrid", port=True)
                jc, jsc, jbm = _legs(_forced(js), query, "hybrid", port=False)
                assert [c for c, _ in tbm] == [c for c, _ in jbm]
                np.testing.assert_allclose([s for _, s in tbm], [s for _, s in jbm],
                                           atol=SCORE_TOL)
                np.testing.assert_allclose(tsc, jsc, atol=BERT_TOL)
                _assert_same_up_to_near_ties(tc, jc, jsc)
    assert not any(fused_topk.launch_counts.values())   # the CPU takes the plain versions
    _assert_ranked_alike(sharded, one, exact=int8)
    _assert_ranked_alike(sharded_wave, one_wave, exact=int8)
    _assert_ranked_alike(sharded_wave, [r for r, (_, mode) in zip(sharded, QUERIES)
                                        if mode == "hybrid"], exact=int8)
    if model != BERT:
        jax_ranked, _ = _ranked(js, JaxOptions)
        for got, want in zip(sharded, jax_ranked):
            assert got and [c for c, _ in got] == [c for c, _ in want]
            np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=SCORE_TOL)


# ---------------------------------------------------------------------------
# on the card (skipped without one): four shards of one CUDA device
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_sharded_kernels_match_one_device_on_cuda(cuda, kind):
    """Kernel a or b once a shard and c once for the merge; the same
    indices and scores as the one-device launch, with a tie across the edge
    of shards 0 and 1."""
    corpus, queries = _corpus(4, 65536, 384, 9)
    r = 65536 // 4
    corpus[r] = corpus[r - 1]
    queries[0] = corpus[r - 1]
    valid = np.random.default_rng(5).random(65536) > 0.05
    valid[r - 1:r + 1] = True
    mesh = tmesh.make_mesh(n_data=4, devices=[cuda] * 4)
    fused_topk.reset_launch_counts()
    vals, idx = _port_topk(kind, queries, corpus, valid, 200, mesh, cuda)
    name = "fused_cosine_topk_int8" if kind == "int8" else "fused_cosine_topk"
    assert fused_topk.launch_counts[name] == 4 and fused_topk.launch_counts["fused_scores_topk"] == 1
    one = _port_topk(kind, queries, corpus, valid, 200, device=cuda)
    assert np.array_equal(idx, one[1]) and np.array_equal(vals, one[0])
    assert idx[0, :2].tolist() == [r - 1, r]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_sharded_session_matches_one_device_on_cuda(cuda, indexes, tmp_path, int8):
    db = tmp_path / "db"
    shutil.copytree(indexes["code-hash-384"], db)
    meta = json.loads((db / "metadata.json").read_text())
    (db / "metadata.json").write_text(json.dumps({**meta, "int8": int8}))
    one = _ranked(SearchSession(db, device=cuda), SearchOptions)
    with installed(tmesh.make_mesh(n_data=4, devices=[cuda] * 4)):
        ts = SearchSession(db, device=cuda)
        assert _ranked(ts, SearchOptions) == one
        assert len(ts.store._device[1].shards) == 4
