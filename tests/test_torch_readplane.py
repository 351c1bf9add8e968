"""The batched read plane of the port, held to the JAX package on the CPU.

One index (a small demo repository plus 1,000 synthetic chunks, an
identifier in every third chunk) is searched by both packages with the
device routes forced: no small-corpus host shortcut, device BM25 from the
first document, a score-plane floor low enough that the dense BM25 leg runs.
Each check gives the same seeded inputs to the JAX function and to its
port (``device="cpu"``: the kernels' plain versions):

- ``stack_query_args``: shapes, padding, maxima and the epoch errors;
- the store's one query entry ``VectorStore.dispatch`` on a wave and on one
  query (hash and a 2-layer random-init bge-small, bf16 and int8, with and
  without score planes) against the JAX package's ``*_hybrid_search[_many]``
  functions;
- ``SearchSession.search_many``: against JAX ``search_many`` and against the
  port's own ``search`` for each query, with the epoch and device-OOM
  fallbacks;
- the serving read plane: ``device_candidates_many``, ``DynamicBatcher`` and
  ``ranked_chunks_wave``.

Ranked chunk ids and their order must be equal; scores agree within 1e-5
(``SCORE_TOL``: the vector leg's f32 sums run in another order). The BERT
op's vector leg holds to ``tests/test_torch_bert_slice.py``'s tolerance.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codesearch_tpu.embed import EmbeddingService as JaxService
from codesearch_tpu.fts.store import FtsStore as JaxFts
from codesearch_tpu.fts.store import stack_query_args as jax_stack
from codesearch_tpu.index.manager import SharedStores as JaxStores
from codesearch_tpu.models.encoder import init_params as jax_init_params
from codesearch_tpu.models.registry import MODELS as JAX_MODELS
from codesearch_tpu.ops import query_pipeline as jqp
from codesearch_tpu.search.pipeline import SearchOptions as JaxOptions
from codesearch_tpu.search.pipeline import SearchSession as JaxSession
from codesearch_tpu.server import readplane as jrp
from codesearch_tpu.vectordb.store import VectorStore as JaxVectorStore
from codesearch_tpu_torch.embed import EmbeddingService
from codesearch_tpu_torch.embed.service import _BertBackend
from codesearch_tpu_torch.fts import FtsStore
from codesearch_tpu_torch.fts.store import stack_query_args
from codesearch_tpu_torch.index import IndexOptions, index
from codesearch_tpu_torch.index.manager import SharedStores
from codesearch_tpu_torch.models import encoder as te
from codesearch_tpu_torch.models.hash_embedder import batch_features
from codesearch_tpu_torch.models.registry import MODELS
from codesearch_tpu_torch.models.tokenizer import load_tokenizer
from codesearch_tpu_torch.ops import fused_topk
from codesearch_tpu_torch.search import SearchOptions, SearchSession
from codesearch_tpu_torch.server import readplane as trp
from codesearch_tpu_torch.utils.device import to_host
from codesearch_tpu_torch.vectordb import VectorStore
from test_torch_bert_slice import SCORE_TOL as BERT_TOL
from test_torch_slice import SCORE_TOL, _add_synthetic

# the BERT vector leg on an int8 corpus: the two packages' query embeddings
# differ by bf16 rounding (BERT_TOL), and a component that rounds to the
# other int8 step when the query is quantized moves a score by up to
# absmax(q) / 127 * |row| (about 3e-4 for these unit vectors) more
BERT_INT8_TOL = 2e-3
PLANE_FLOOR = 300      # shared_registry's df is ~333: its term takes a plane
QUERIES = [
    "validate the schema and return it",       # hybrid, fetch 200 at limit 10
    "parse the configuration file",
    "shared_registry sync",                    # identifiers: fetch 100, 9 variants
    "where is shared_registry used",
    '"render the config" -walk',               # operators: fetch 500
    "compute matrix",
    "content hash of bytes",
    "shared_registry",
]


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = tmp_path_factory.mktemp("readplane")
    repo = root / "repo"
    (repo / "src").mkdir(parents=True)
    (repo / "src" / "main.py").write_text(
        'def parse_config(path):\n    """Parse the configuration file."""\n'
        "    with open(path) as f:\n        return f.read()\n")
    (repo / "src" / "lib.rs").write_text(
        "/// Compute a content hash.\npub fn content_hash(data: &[u8]) -> u64 {\n"
        "    data.iter().fold(0u64, |h, b| h.wrapping_mul(31) + *b as u64)\n}\n")
    _add_synthetic(repo, n_files=10)
    from test_torch_slice import jax_make_table, th

    path = th._table_bits_path(384, th.VOCAB_BUCKETS)
    if not path.exists():
        np.asarray(jax_make_table(384)).view(np.uint16).ravel().tofile(path)
    stats = index(repo, IndexOptions(store_path=root / "db", quiet=True), device="cpu")
    assert stats.chunks_added > 1000
    return root / "db"


def _force(store, fts) -> None:
    store.host_path_rows = 0
    fts.device_min_docs = 1
    fts.plane_df_floor = PLANE_FLOOR


def _sessions(db):
    js, ts = JaxSession(db), SearchSession(db, device="cpu")
    for s in (js, ts):
        _force(s.store, s.fts)
    return js, ts


def _ranked(resp):
    return [h.chunk_id for h in resp.hits], np.array([h.score for h in resp.hits])


def _assert_same(got, ref, what) -> None:
    gids, gscores = _ranked(got)
    rids, rscores = _ranked(ref)
    assert gids == rids and gids, what
    assert got.mode == ref.mode, what
    np.testing.assert_allclose(gscores, rscores, rtol=0, atol=SCORE_TOL)


# ---------------------------------------------------------------------------
# stack_query_args
# ---------------------------------------------------------------------------

def _fts_pair(db):
    jf = JaxFts(db / "fts", readonly=True)
    tf = FtsStore(db / "fts", readonly=True, device="cpu")
    for f in (jf, tf):
        f.device_min_docs = 1
        f.plane_df_floor = PLANE_FLOOR
    return jf, tf


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_stack_query_args_matches_jax(db, n):
    jf, tf = _fts_pair(db)
    preps = [(q, "function" if i == 1 else None, 20 * (i + 1)) for i, q in enumerate(QUERIES[:n])]
    jargs = [jf.device_query_args(*p) for p in preps]
    targs = [tf.device_query_args(*p) for p in preps]
    # a second pass: the planes the first built are cached, one epoch
    jargs = [jf.device_query_args(*p) for p in preps]
    targs = [tf.device_query_args(*p) for p in preps]
    j, t = jax_stack(jargs), stack_query_args(targs)
    bpad = max(4, 1 << (n - 1).bit_length())
    assert t[1].shape[0] == bpad and t[4].shape == (bpad,)
    for i in (1, 2, 3, 4):     # cs, cl, ci, kid
        np.testing.assert_array_equal(t[i], np.asarray(j[i]))
    assert (t[2][n:] == 0).all() and (t[4][n:] == -1).all()
    assert t[5:8] == j[5:8]    # k, kpre, imax: the batch maxima
    assert t[5] == max(a[5] for a in targs) and t[7] == max(a[7] for a in targs)
    assert (t[8] is None) == (j[8] is None)
    if t[8] is not None:
        np.testing.assert_array_equal(t[8], np.asarray(j[8]))
        assert t[9] is next(a[9] for a in targs if a[9] is not None)
    assert t[0] is targs[0][0]


def test_stack_query_args_refuses_a_moved_epoch(db):
    _, tf = _fts_pair(db)
    a1 = tf.device_query_args("shared_registry sync", None, 10)
    a2 = tf.device_query_args("parse the configuration file", None, 10)
    assert a1[9] is not None
    moved = ((a2[0][0].clone(),) + tuple(a2[0][1:]),) + a2[1:]
    with pytest.raises(ValueError, match="device epoch"):
        stack_query_args([a1, moved])
    # a plane build between preps replaces the buffer object
    rebuilt = a1[:9] + (a1[9].clone(),)
    with pytest.raises(ValueError, match="plane epoch"):
        stack_query_args([a1, rebuilt])


# ---------------------------------------------------------------------------
# the store's query entry against the JAX package's query functions
# ---------------------------------------------------------------------------

def _bert_pair():
    """bge-small's widths with 2 layers: the JAX params and the port's
    encoder made from them."""
    jcfg = dataclasses.replace(JAX_MODELS["bge-small"].arch, layers=2)
    tcfg = dataclasses.replace(MODELS["bge-small"].arch, layers=2)
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return params, jcfg, te.BertEncoder(tcfg, te.params_from_jax(params), device="cpu")


@pytest.fixture(scope="module")
def bert():
    return _bert_pair()


def _featurize(kind, texts):
    if kind == "hash":
        return batch_features(texts)
    cfg = MODELS["bge-small"].arch
    tok = load_tokenizer(None, lowercase=cfg.lowercase, max_len=cfg.max_len,
                         vocab_size=cfg.vocab_size)
    encs = [tok.encode(t) for t in texts]
    width = 16
    while width < max(len(e.ids) for e in encs):
        width *= 2
    ids = np.zeros((len(texts), width), np.int32)
    mask = np.zeros((len(texts), width), np.int32)
    for r, e in enumerate(encs):
        ids[r, :len(e.ids)] = e.ids[:width]
        mask[r, :len(e.ids)] = 1
    return ids, mask


def _backend(kind, bert):
    """The port's embedding backend: the hash model's, or a BERT backend
    whose encoder holds the JAX params (no checkpoint read)."""
    if kind == "hash":
        return EmbeddingService("code-hash-384", use_persistent_cache=False,
                                device="cpu").backend
    backend = object.__new__(_BertBackend)
    backend.encoder = bert[2]
    return backend


# a wave against ``*_hybrid_search_many[_int8]`` (the cases' first ids), one
# query against ``*_hybrid_search[_int8]`` (``-single``)
@pytest.mark.parametrize("kind,int8,planes,wave", [
    pytest.param(kind, int8, planes, wave,
                 id=f"{kind}-{'int8' if int8 else 'bf16'}-{'planes' if planes else 'sparse'}"
                    + ("" if wave else "-single"))
    for kind in ("hash", "bert") for int8 in (False, True) for planes in (True, False)
    for wave in (True, False)])
def test_many_ops_match_jax(db, bert, kind, int8, planes, wave):
    jf, tf = _fts_pair(db)
    jf.planes_enabled = tf.planes_enabled = planes
    jstore = JaxVectorStore(db, dims=384, readonly=True, int8=int8)
    tstore = VectorStore(db, dims=384, readonly=True, int8=int8, device="cpu")
    queries = QUERIES[:4]
    preps = [(q, None, 50 + 50 * i) for i, q in enumerate(queries)]
    for _ in range(2):    # the second pass finds every plane built
        jargs = [jf.device_query_args(*p) for p in preps]
        targs = [tf.device_query_args(*p) for p in preps]
    assert all(a is not None for a in targs)
    assert (targs[2][9] is not None) == planes
    if wave:
        jbm, tbm = jax_stack(jargs), stack_query_args(targs)
        rng = np.random.default_rng(7)
        texts = [queries[i] for i in rng.integers(0, len(queries), size=11)]
    else:       # one query's BM25 tables (a scalar boost kind) beside three vector rows
        jbm, tbm = jargs[2], targs[2]
        texts = queries[1:4]
    ids, aux = _featurize(kind, texts)
    jdev = jstore._ensure_device()
    kv = 120
    corpus_j = (jdev[1], jdev[2], jdev[3]) if int8 else (jdev[1], jdev[3])
    jd = jbm[0]
    jbm_args = (jd[0], jd[1], jd[2], jnp.asarray(jbm[1]), jnp.asarray(jbm[2]),
                jnp.asarray(jbm[3]), jnp.asarray(jbm[4]), jbm[5], jbm[6], jbm[7])
    jkw = {"pw": jnp.asarray(jbm[8]), "planes": jbm[9]} if planes else {}
    name = "_embed_hybrid_search" + ("_many" if wave else "") + ("_int8" if int8 else "")
    if kind == "hash":
        from codesearch_tpu.models.hash_embedder import make_table

        jout = getattr(jqp, "hash" + name)(make_table(384), jnp.asarray(ids),
                                           jnp.asarray(aux), *corpus_j, kv, *jbm_args, **jkw)
    else:
        params, jcfg, _ = bert
        jout = getattr(jqp, "bert" + name)(params, jnp.asarray(ids), jnp.asarray(aux), jcfg,
                                           *corpus_j, kv, *jbm_args, **jkw)
    fused_topk.reset_launch_counts()
    tout = tstore.dispatch(_backend(kind, bert), ids, aux, kv, tbm)
    assert not any(fused_topk.launch_counts.values())   # plain versions on the CPU
    jv, ji, jb, jbi = (np.asarray(x) for x in jout)
    tv, ti, tb, tbi = to_host(*tout)
    assert tv.shape == jv.shape == (len(texts), kv) and tb.shape == jb.shape
    # the BM25 legs: each real query's hits, as the session maps them
    legs = ([(p, tb[row], tbi[row], jb[row], jbi[row]) for row, p in enumerate(preps)]
            if wave else [(preps[2], tb, tbi, jb, jbi)])
    for p, tbv, tbix, jbv, jbix in legs:
        got = tf.results_from_device(tbv, tbix, p[2])
        ref = jf.results_from_device(jbv, jbix, p[2])
        assert [r.chunk_id for r in got] == [r.chunk_id for r in ref] and ref, p
        np.testing.assert_allclose([r.score for r in got], [r.score for r in ref],
                                   rtol=0, atol=SCORE_TOL)
    tc, tsc = tstore.rows_to_ids(tv, ti)
    jc, jsc = jstore.rows_to_ids(jv, ji)
    if kind == "hash":
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(tsc, jsc, rtol=0, atol=SCORE_TOL)
    else:
        tol = BERT_INT8_TOL if int8 else BERT_TOL
        np.testing.assert_allclose(tsc, jsc, rtol=0, atol=tol)
        # every chunk the port ranks at position i scores, by JAX's query
        # vector, within 2 * tol of JAX's i-th score (near-ties may swap)
        for v in range(jc.shape[0]):
            jscore = dict(zip(jc[v].tolist(), jsc[v].tolist()))
            for i, cid in enumerate(tc[v].tolist()):
                assert abs(jscore.get(cid, jsc[v, -1]) - jsc[v, i]) <= 2 * tol, (v, i, cid)


def test_many_op_rows_equal_single_query_calls(db):
    # a wave's rows are each query's own call: the store's entry on a wave of
    # hash-model queries equals its single-query calls row for row
    tstore = VectorStore(db, dims=384, readonly=True, device="cpu")
    _, tf = _fts_pair(db)
    backend = _backend("hash", None)
    preps = [(q, None, 100) for q in QUERIES[:3]]
    for _ in range(2):
        args = [tf.device_query_args(*p) for p in preps]
    ids, w = backend.featurize_queries(QUERIES[:3])
    vv, vi, bv, bi = to_host(*tstore.dispatch(backend, ids, w, 100, stack_query_args(args)))
    for row, a in enumerate(args):
        one = to_host(*tstore.dispatch(backend, ids[row:row + 1], w[row:row + 1], 100, a))
        np.testing.assert_array_equal(vi[row], one[1][0])
        got = tf.results_from_device(bv[row], bi[row], 100)
        ref = tf.results_from_device(one[2], one[3], 100)
        assert [(r.chunk_id, r.score) for r in got] == [(r.chunk_id, r.score) for r in ref]


def test_dispatch_scores_small_hash_corpora_on_the_host(db, bert):
    # the entry's one routing rule: a hash-model query without BM25 on a
    # corpus of at most host_path_rows rows is scored in numpy and ranked as
    # the device ranks it; a BM25 leg or an encoder keeps the device route
    store = VectorStore(db, dims=384, readonly=True, device="cpu")
    assert 0 < store._rows <= store.host_path_rows
    _, tf = _fts_pair(db)
    hashed = _backend("hash", None)
    ids, w = hashed.featurize_queries(QUERIES[:3])
    host = store.dispatch(hashed, ids, w, 20)
    assert all(isinstance(x, np.ndarray) for x in host) and store._device is None
    bm = tf.device_query_args(QUERIES[0], None, 20)
    assert all(isinstance(x, torch.Tensor)
               for x in store.dispatch(hashed, ids[:1], w[:1], 20, bm))
    b_ids, b_mask = _featurize("bert", QUERIES[:3])
    assert all(isinstance(x, torch.Tensor)
               for x in store.dispatch(_backend("bert", bert), b_ids, b_mask, 20))
    store.host_path_rows = 0
    (hc, hs), (dc, ds) = store.rows_to_ids(*host), store.rows_to_ids(*store.dispatch(
        hashed, ids, w, 20))
    # the host sums in f32 where the device's matmul is bf16: near-ties may
    # swap, so each chunk the host ranks i-th scores, on the device, within
    # the tolerance of the device's i-th
    np.testing.assert_allclose(hs, ds, rtol=0, atol=2e-2)
    for v in range(len(dc)):
        dev_score = dict(zip(dc[v].tolist(), ds[v].tolist()))
        for i, cid in enumerate(hc[v].tolist()):
            assert abs(dev_score.get(cid, ds[v, -1]) - ds[v, i]) <= 2e-2, (v, i, cid)


def test_dispatch_of_an_emptied_store_answers_nothing(db, tmp_path):
    # no live row: the entry returns None on the device and the host routes;
    # one serving query then has no vector hits and leaves BM25 to the host
    # (fres None), and a wave falls back to its queries one by one
    import shutil

    shutil.copytree(db, tmp_path / "db")
    stores = SharedStores(tmp_path / "db", 384, readonly=False, device="cpu")
    stores.store.delete_chunks(stores.store.all_ids())
    stores.fts.device_min_docs = 1
    svc = EmbeddingService("code-hash-384", use_persistent_cache=False, device="cpu")
    ids, w = svc.backend.featurize_queries(QUERIES[:2])
    bm = stores.fts.device_query_args(QUERIES[0], None, 30)
    assert bm is not None
    for rows in (0, stores.store.host_path_rows):
        stores.store.host_path_rows = rows
        assert stores.store.dispatch(svc.backend, ids, w, 30) is None
        assert stores.store.dispatch(svc.backend, ids[:1], w[:1], 30, bm) is None
    assert trp.device_candidates(stores, svc, QUERIES[0], None, 30) == ([], None)
    assert trp.device_candidates_many(stores, svc, ITEMS[:3]) == [([], None)] * 3


# ---------------------------------------------------------------------------
# SearchSession.search_many
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["hybrid", "vector"])
def test_search_many_matches_jax_and_per_query_search(db, mode):
    js, ts = _sessions(db)
    single = SearchSession(db, device="cpu")
    _force(single.store, single.fts)
    fused_topk.reset_launch_counts()
    got = ts.search_many(QUERIES, SearchOptions(limit=10, mode=mode))
    ref = js.search_many(QUERIES, JaxOptions(limit=10, mode=mode))
    assert len(got) == len(QUERIES)
    for q, g, r in zip(QUERIES, got, ref):
        _assert_same(g, r, q)
        _assert_same(g, single.search(q, SearchOptions(limit=10, mode=mode)), q)
    if mode == "hybrid":
        assert ts.fts.plane_builds > 0    # the dense leg ran in the wave
    assert not any(fused_topk.launch_counts.values())


def test_search_many_int8_matches_jax(db):
    js = JaxSession(db)
    ts = SearchSession(db, device="cpu")
    for s in (js, ts):
        s.store = type(s.store)(db, dims=384, readonly=True, int8=True,
                                **({"device": "cpu"} if s is ts else {}))
        _force(s.store, s.fts)
    got = ts.search_many(QUERIES[:6], SearchOptions(limit=10))
    ref = js.search_many(QUERIES[:6], JaxOptions(limit=10))
    assert ts.store._device[0] == "int8"
    for q, g, r in zip(QUERIES, got, ref):
        _assert_same(g, r, q)


def test_search_many_serves_repeats_from_the_cache(db):
    _, ts = _sessions(db)
    first = ts.search(QUERIES[0], SearchOptions(limit=5))
    wave = ts.search_many([QUERIES[0], QUERIES[1]], SearchOptions(limit=5))
    assert wave[0].timings_ms.get("cached") is True
    assert "cached" not in wave[1].timings_ms
    assert [h.chunk_id for h in wave[0].hits] == [h.chunk_id for h in first.hits]


@pytest.mark.parametrize("moves", [1, 1000], ids=["re-prep", "per-query-waves"])
def test_search_many_survives_a_moved_epoch(db, monkeypatch, moves):
    # a rebuild of the resident postings between two preps: the wave re-preps
    # once; when the epoch keeps moving it falls back to per-query calls
    _, ts = _sessions(db)
    orig = ts.fts.device_query_args
    calls = {"n": 0}

    def moving(query, kind, limit):
        out = orig(query, kind, limit)
        calls["n"] += 1
        if out is not None and calls["n"] % 2 == 1 and calls["n"] <= moves:
            out = ((out[0][0].clone(),) + tuple(out[0][1:]),) + out[1:]
        return out

    monkeypatch.setattr(ts.fts, "device_query_args", moving)
    waves = {"n": 0}
    orig_waves = ts._search_many_waves

    def counted(*a, **kw):
        waves["n"] += 1
        return orig_waves(*a, **kw)

    monkeypatch.setattr(ts, "_search_many_waves", counted)
    got = ts.search_many(QUERIES[:4], SearchOptions(limit=10))
    assert waves["n"] == (0 if moves == 1 else 1)
    monkeypatch.undo()
    ref = SearchSession(db, device="cpu")
    _force(ref.store, ref.fts)
    for q, g in zip(QUERIES, got):
        _assert_same(g, ref.search(q, SearchOptions(limit=10)), q)


def test_search_many_releases_planes_on_device_oom(db, monkeypatch):
    _, ts = _sessions(db)
    orig = ts.store.dispatch
    calls = {"n": 0}

    def oom_once(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (simulated)")
        return orig(*a, **kw)

    monkeypatch.setattr(ts.store, "dispatch", oom_once)
    got = ts.search_many(QUERIES[:4], SearchOptions(limit=10))
    assert calls["n"] == 2 and not ts.fts.planes_enabled
    ref = SearchSession(db, device="cpu")
    _force(ref.store, ref.fts)
    ref.fts.release_planes()
    for q, g in zip(QUERIES, got):
        _assert_same(g, ref.search(q, SearchOptions(limit=10)), q)
    # a second OOM is not hidden
    monkeypatch.setattr(ts.store, "dispatch",
                        lambda *a, **kw: (_ for _ in ()).throw(torch.OutOfMemoryError("again")))
    with pytest.raises(torch.OutOfMemoryError):
        ts.search_many(["merge the tree buffer"], SearchOptions(limit=10))


def test_search_many_of_an_emptied_store_falls_back_per_query(db, tmp_path, monkeypatch):
    # every vector row deleted, the FTS docs alive: the wave's device call
    # finds an empty store and the session answers query by query, as JAX's
    import shutil

    copy = tmp_path / "db"
    shutil.copytree(db, copy)
    ts = SearchSession(copy, readonly=False, device="cpu")
    _force(ts.store, ts.fts)
    ts.store.delete_chunks(ts.store.all_ids())
    waves = []
    orig = ts._search_many_waves
    monkeypatch.setattr(ts, "_search_many_waves", lambda *a: waves.append(1) or orig(*a))
    got = ts.search_many(QUERIES[:2], SearchOptions(limit=5))
    assert waves == [1]
    assert all(g.mode == "hybrid" and not g.hits and g.total_chunks == 0 for g in got)


# ---------------------------------------------------------------------------
# the serving read plane
# ---------------------------------------------------------------------------

@pytest.fixture()
def stores(db):
    jsvc = JaxService("code-hash-384")
    tsvc = EmbeddingService("code-hash-384", device="cpu")
    js = JaxStores(db, 384, readonly=True)
    ts = SharedStores(db, 384, readonly=True, device="cpu")
    for s in (js, ts):
        _force(s.store, s.fts)
    return js, jsvc, ts, tsvc


ITEMS = [("parse the configuration", None, 30), ("shared_registry sync", None, 30),
         ("validate the schema", "function", 30), ("compute a content hash", None, 15),
         ('"render the config" -walk', None, 60)]


def _vkey(pairs):
    return [c for c, _ in pairs], np.array([s for _, s in pairs])


def _fkey(fres):
    return None if fres is None else [(r.chunk_id, round(r.score, 5)) for r in fres]


def _assert_candidates(got, ref) -> None:
    (gc, gs), (rc, rs) = _vkey(got[0]), _vkey(ref[0])
    assert gc == rc and gc
    np.testing.assert_allclose(gs, rs, rtol=0, atol=SCORE_TOL)
    assert _fkey(got[1]) == _fkey(ref[1])


def test_device_candidates_many_matches_single_and_jax(stores):
    js, jsvc, ts, tsvc = stores
    with ts.lock:
        many = trp.device_candidates_many(ts, tsvc, ITEMS)
        singles = []
        for q, k, f in ITEMS:
            vres, fres = trp.device_candidates(ts, tsvc, q, k, f)
            singles.append(([(r.chunk_id, r.score) for r in vres], fres))
    ref = jrp.device_candidates_many(js, jsvc, ITEMS)
    assert len(many) == len(ITEMS)
    for m, s, r in zip(many, singles, ref):
        _assert_candidates(m, s)
        _assert_candidates(m, r)
        assert m[1] is not None


def test_dynamic_batcher_coalesces_concurrent_requests(stores):
    _, _, ts, tsvc = stores
    batcher = trp.DynamicBatcher(ts, tsvc, window_s=0.5)
    batcher._last_arrival = time.monotonic()   # traffic is flowing: wait the window
    results, errors = [None] * len(ITEMS), []
    barrier = threading.Barrier(len(ITEMS))

    def worker(i):
        try:
            barrier.wait(timeout=10)
            results[i] = batcher.get(*ITEMS[i])
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(ITEMS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert batcher.batched_queries == len(ITEMS) and batcher.waves < len(ITEMS)
    for item, got in zip(ITEMS, results):
        with ts.lock:
            vres, fres = trp.device_candidates(ts, tsvc, *item)
        _assert_candidates(got, ([(r.chunk_id, r.score) for r in vres], fres))


def test_ranked_chunks_wave_matches_jax(stores, db):
    js, jsvc, ts, tsvc = stores
    meta = {"primary_language": "Python"}
    requests = [(q, 5 + i, "src/" if i % 2 else None) for i, (q, _, _) in enumerate(ITEMS)]
    got = trp.ranked_chunks_wave(ts, tsvc, meta, requests)
    ref = jrp.ranked_chunks_wave(js, jsvc, meta, requests)
    for (q, limit, _), g, r in zip(requests, got, ref):
        assert [c for _, c, _ in g] == [c for _, c, _ in r] and g, q
        assert len(g) <= limit
        np.testing.assert_allclose([s for s, _, _ in g], [s for s, _, _ in r], rtol=0,
                                   atol=SCORE_TOL)
    # one query alone through ranked_chunks takes the same ranking
    with ts.lock:
        one = trp.ranked_chunks(ts, tsvc, meta, *requests[1])
    assert [c for _, c, _ in one] == [c for _, c, _ in got[1]]


def test_store_all_ids_and_embed_query_match_jax(db):
    jstore = JaxVectorStore(db, dims=384, readonly=True)
    tstore = VectorStore(db, dims=384, readonly=True, device="cpu")
    assert tstore.all_ids() == jstore.all_ids() and len(tstore.all_ids()) == len(tstore)
    jsvc = JaxService("code-hash-384", use_persistent_cache=False)
    tsvc = EmbeddingService("code-hash-384", use_persistent_cache=False, device="cpu")
    for q in QUERIES[:3]:
        np.testing.assert_allclose(tsvc.embed_query(q), np.asarray(jsvc.embed_query(q)),
                                   rtol=0, atol=SCORE_TOL)
    assert tsvc.query_cache.hits == 0 and tsvc.embed_query(QUERIES[0]) is not None
    assert tsvc.query_cache.hits == 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_gpu_wave_matches_cpu_session(cuda, db, int8):
    # the wave on the card: one launch of kernel a (b on int8), the same
    # ranked hits as the CPU session's per-query search
    gpu = SearchSession(db, device="cuda")
    cpu = SearchSession(db, device="cpu")
    for s in (gpu, cpu):
        if int8:
            s.store = VectorStore(db, dims=384, readonly=True, int8=True, device=s.device)
        _force(s.store, s.fts)
    gpu.search_many(["warm the corpus"], SearchOptions(limit=10))
    fused_topk.reset_launch_counts()
    got = gpu.search_many(QUERIES, SearchOptions(limit=10))
    name = "fused_cosine_topk_int8" if int8 else "fused_cosine_topk"
    assert fused_topk.launch_counts[name] == 1
    assert fused_topk.launch_counts["fused_scores_topk"] >= 1
    for q, g in zip(QUERIES, got):
        _assert_same(g, cpu.search(q, SearchOptions(limit=10)), q)
