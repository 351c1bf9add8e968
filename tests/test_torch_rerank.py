"""Neural reranking on torch held against the JAX package, on the CPU.

- ``arch_from_hf_config`` and the checkpoint fallback chain (the named
  reranker, then ``local-cross-encoder``, then the proxy) as JAX's.
- ``CrossEncoder.score_pairs``: the weights-free proxy within 1e-6 of JAX's
  (both score the hash embedder's cosine); synthetic checkpoints with
  absolute positions and with ALiBi (written as ``tests/test_rerank.py``
  writes them) within 2e-3 of JAX's, in the same order off near-ties.
  Both forwards run bf16 activations; on the CPU their pair scores moved
  by at most about 1e-3 at the test checkpoint's head gain of 1/2.
- ``NeuralReranker``: ``rerank`` and ``rerank_and_blend`` equal JAX's on flat
  and on spread scores, with the same gate decisions and counters.
- ``SearchSession.search(rerank=True)``: the port and JAX over one index rank
  the same hits with the same ``rerank_mode``, in proxy and checkpoint modes
  (positions may swap only where the final scores lie within the
  tolerance: 1e-6 for the proxy, 5e-3 for a checkpoint, measured below);
  ``search_many`` with ``rerank`` equals per-query ``search``; the CLI's
  ``search --rerank --json`` prints ``rerank_mode``.
- On the card (``cuda``): the GPU session reranks as the CPU session does,
  an absolute-position checkpoint through kernel d, an ALiBi one through
  the composed biased attention.
"""

import json
from dataclasses import asdict

import numpy as np
import pytest
import torch
from test_rerank import _write_synthetic_reranker

from codesearch_tpu.index.pipeline import IndexOptions as JaxIndexOptions
from codesearch_tpu.index.pipeline import index as jax_index
from codesearch_tpu.models import cross_encoder as jce
from codesearch_tpu.models.hash_embedder import make_table as jax_make_table
from codesearch_tpu.rerank.neural import NeuralReranker as JaxReranker
from codesearch_tpu.search.pipeline import SearchOptions as JaxOptions
from codesearch_tpu.search.pipeline import SearchSession as JaxSession
from codesearch_tpu_torch.models import cross_encoder as tce
from codesearch_tpu_torch.models import encoder as te
from codesearch_tpu_torch.models import hash_embedder as th
from codesearch_tpu_torch.ops import attention as ta
from codesearch_tpu_torch.rerank import NeuralReranker
from codesearch_tpu_torch.rerank.neural import CONFIDENCE_SPREAD_FLOOR
from codesearch_tpu_torch.search import SearchOptions, SearchSession

RERANKER = "jina-reranker-v1-turbo-en"
PAIR_TOL = 2e-3
# the session tests' checkpoint has a head gain of 2 (so the confidence gate
# opens for some queries); there bf16 rounding of the CLS state moved a pair
# score by up to 4e-3 and a final score (0.575 of it) by up to 2.4e-3
# between the two packages on the CPU
SESSION_TOL = 5e-3
PROXY_TOL = 1e-6
QUERY = "parse the configuration file"
DOCS = ["def parse_config(path)", "pub fn content_hash(data: &[u8]) -> u64",
        "class Indexer:", "def run(self)", "fn walk(root: &Path)",
        "def load the index and return it " * 12, "x", "config parser for the index",
        "pub struct Walker { root: String }", "def flush_socket_buffer(sock)"]
QUERIES = ["parse the configuration file", "compute a content hash", "walk the tree",
           "validate_schema"]


@pytest.fixture
def home(monkeypatch, tmp_path):
    """A config dir of the test's own (its models cache), with the port's
    hash table cache seeded from the JAX package's table."""
    monkeypatch.setenv("CODESEARCH_HOME", str(tmp_path / "home"))
    path = th._table_bits_path(384, th.VOCAB_BUCKETS)
    np.asarray(jax_make_table(384)).view(np.uint16).ravel().tofile(path)
    return tmp_path / "home"


def _models(home):
    return home / "models"


def _write_checkpoint(model_dir, alibi: bool, hidden: int = 64, heads: int = 4,
                      gain: float = 0.5) -> None:
    """A cross-encoder of 2 layers under HF BERT names with a config.json,
    its dense weights normal at 1/sqrt(fan-in) and norms at one, so that a
    pair's CLS state depends on its doc well beyond bf16 rounding and the
    scores spread. ``gain`` scales the classifier: at 1/2 the pair scores
    spread by 0.03-0.05 while bf16 rounding of the CLS state moves them by
    about 1e-3; at 2 some queries' candidates spread past the gate's floor."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(3)
    h, m, vocab = hidden, 2 * hidden, tce.CROSS_ENCODER_ARCH.vocab_size

    def dense(n_out, n_in):
        return (rng.standard_normal((n_out, n_in)) / np.sqrt(n_in)).astype(np.float32)

    t = {"embeddings.word_embeddings.weight": rng.standard_normal((vocab, h)).astype(np.float32),
         "embeddings.token_type_embeddings.weight": rng.standard_normal((2, h)).astype(
             np.float32),
         "embeddings.LayerNorm.weight": np.ones(h, np.float32),
         "embeddings.LayerNorm.bias": np.zeros(h, np.float32),
         "bert.pooler.dense.weight": dense(h, h), "bert.pooler.dense.bias": np.zeros(h, np.float32),
         "classifier.weight": dense(1, h) * np.float32(gain),
         "classifier.bias": np.zeros(1, np.float32)}
    if not alibi:
        t["embeddings.position_embeddings.weight"] = rng.standard_normal((512, h)).astype(
            np.float32)
    shapes = {"q_w": (h, h), "k_w": (h, h), "v_w": (h, h), "o_w": (h, h),
              "mlp_in_w": (m, h), "mlp_out_w": (h, m)}
    for i in range(2):
        for ours, theirs in te.HF_LAYER_MAP.items():
            if ours in shapes:
                arr = dense(*shapes[ours])
            else:
                n = m if ours == "mlp_in_b" else h
                arr = np.ones(n, np.float32) if ours.endswith("scale") else np.zeros(n, np.float32)
            t[f"encoder.layer.{i}.{theirs}"] = arr
    model_dir.mkdir(parents=True, exist_ok=True)
    save_file(t, str(model_dir / "model.safetensors"))
    (model_dir / "config.json").write_text(json.dumps({
        "vocab_size": vocab, "hidden_size": h, "num_hidden_layers": 2,
        "num_attention_heads": heads, "intermediate_size": m, "type_vocab_size": 2,
        "position_embedding_type": "alibi" if alibi else "absolute", "hidden_act": "gelu"}))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", ["absolute", "alibi", "relative_key", None])
def test_arch_from_hf_config_matches_jax(tmp_path, pos):
    if pos is not None:
        _write_synthetic_reranker(tmp_path, alibi=pos == "alibi")
        if pos == "relative_key":
            raw = json.loads((tmp_path / "config.json").read_text())
            raw["position_embedding_type"] = pos
            (tmp_path / "config.json").write_text(json.dumps(raw))
    if pos == "relative_key":
        for fn in (jce.arch_from_hf_config, tce.arch_from_hf_config):
            with pytest.raises(ValueError, match="position_embedding_type"):
                fn(tmp_path)
        return
    ours, ref = tce.arch_from_hf_config(tmp_path), jce.arch_from_hf_config(tmp_path)
    assert (ours is None and ref is None) or asdict(ours) == asdict(ref)


def test_proxy_scores_match_jax(home):
    ours = tce.CrossEncoder(_models(home), device="cpu")
    ref = jce.CrossEncoder(_models(home))
    assert ours.mode == ref.mode == "proxy-bi-encoder"
    got, want = ours.score_pairs(QUERY, DOCS), ref.score_pairs(QUERY, DOCS)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=PROXY_TOL)
    assert ours.score_pairs(QUERY, []).shape == (0,)


@pytest.mark.parametrize("alibi", [False, True])
def test_score_pairs_match_jax(home, alibi):
    # the names as tests/test_rerank.py writes them (its tiny weights give
    # every pair nearly one score), then a checkpoint whose pairs spread
    _write_synthetic_reranker(_models(home) / RERANKER, alibi=alibi)
    ours = tce.CrossEncoder(_models(home), device="cpu")
    ref = jce.CrossEncoder(_models(home))
    assert ours.mode == ref.mode == "cross-encoder"
    assert asdict(ours.cfg) == asdict(ref.cfg)
    assert ours.cfg.position_type == ("alibi" if alibi else "absolute")
    np.testing.assert_allclose(ours.score_pairs(QUERY, DOCS), ref.score_pairs(QUERY, DOCS),
                               rtol=0, atol=PAIR_TOL)
    _write_checkpoint(_models(home) / RERANKER, alibi)
    ours = tce.CrossEncoder(_models(home), device="cpu")
    ref = jce.CrossEncoder(_models(home))
    ids, tt, mask = ours.pair_batch(QUERY, DOCS)
    assert ids.shape[1] >= 16 and ids.shape[1] & (ids.shape[1] - 1) == 0
    assert (tt[mask == 0] == 0).all() and tt.max() == 1 and (ids[:, 0] == ids[0, 0]).all()
    got, want = ours.score_pairs(QUERY, DOCS), ref.score_pairs(QUERY, DOCS)
    assert want.max() - want.min() > 10 * PAIR_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=PAIR_TOL)
    _same_ranking(sorted(enumerate(got), key=lambda x: -x[1]),
                  sorted(enumerate(want), key=lambda x: -x[1]), PAIR_TOL)


def test_local_cross_encoder_is_the_fallback(home):
    _write_synthetic_reranker(_models(home) / tce.LOCAL_CROSS_ENCODER, alibi=False)
    ours = tce.CrossEncoder(_models(home), device="cpu")
    ref = jce.CrossEncoder(_models(home))
    assert (ours.name, ours.mode) == (ref.name, ref.mode) == ("local-cross-encoder",
                                                              "cross-encoder")
    np.testing.assert_allclose(ours.score_pairs(QUERY, DOCS[:4]),
                               ref.score_pairs(QUERY, DOCS[:4]), rtol=0, atol=PAIR_TOL)


def test_unusable_checkpoint_falls_back_to_the_proxy(home):
    model_dir = _models(home) / RERANKER
    _write_synthetic_reranker(model_dir, alibi=False)
    raw = json.loads((model_dir / "config.json").read_text())
    raw["hidden_act"] = "relu"
    (model_dir / "config.json").write_text(json.dumps(raw))
    assert tce.CrossEncoder(_models(home), device="cpu").mode == "proxy-bi-encoder"
    assert jce.CrossEncoder(_models(home)).mode == "proxy-bi-encoder"


# ---------------------------------------------------------------------------
# the reranker
# ---------------------------------------------------------------------------

class _Fixed:
    """A model whose pair scores are given."""

    def __init__(self, scores):
        self.scores = np.asarray(scores, np.float32)

    def score_pairs(self, query, docs):
        return self.scores[: len(docs)]


def _blend(reranker, docs, rrf):
    return [(r.chunk_id, r.final_score, r.rerank_score, r.rrf_score)
            for r in reranker.rerank_and_blend(QUERY, docs, rrf)]


@pytest.mark.parametrize("scores", [
    [0.50, 0.52, 0.51, 0.50, 0.55, 0.53],     # flat: spread below the floor
    [0.10, 0.90, 0.45, 0.90, 0.20, 0.60],     # spread, with a tie
])
def test_rerank_and_blend_matches_jax(scores):
    docs = [(cid, f"doc {cid}") for cid in (7, 3, 9, 1, 4, 8)]
    rrf = {7: 0.05, 3: 0.04, 9: 0.04, 1: 0.02, 4: 0.01}       # 8 has none
    ours, ref = NeuralReranker(_Fixed(scores)), JaxReranker(_Fixed(scores))
    assert _blend(ours, docs, rrf) == _blend(ref, docs, rrf)
    assert ours.rerank(QUERY, docs) == ref.rerank(QUERY, docs)
    # equal RRF scores normalise to ones
    flat = {cid: 0.03 for cid, _ in docs}
    assert _blend(ours, docs, flat) == _blend(ref, docs, flat)
    opened = max(scores) - min(scores) >= CONFIDENCE_SPREAD_FLOOR
    assert (ours.gate_calls, ours.gate_open) == (ref.gate_calls, ref.gate_open) == (2, 2 * opened)
    assert ours.rerank_and_blend(QUERY, [], {}) == [] and ours.rerank(QUERY, []) == []


def test_rerank_with_the_proxy_matches_jax(home):
    docs = list(enumerate(DOCS))
    rrf = {i: 1.0 / (60 + i) for i in range(len(DOCS))}
    ours = NeuralReranker(tce.CrossEncoder(_models(home), device="cpu"))
    ref = JaxReranker(jce.CrossEncoder(_models(home)))
    got, want = _blend(ours, docs, rrf), _blend(ref, docs, rrf)
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([g[1:] for g in got], [w[1:] for w in want], atol=PROXY_TOL)


# ---------------------------------------------------------------------------
# the session and the CLI
# ---------------------------------------------------------------------------

def _add_functions(repo) -> None:
    verbs = ["parse", "render", "merge", "flush", "walk", "validate", "compute", "load"]
    nouns = ["config", "buffer", "token", "tree", "socket", "schema", "hash"]
    for f, noun in enumerate(nouns):
        body = "\n\n".join(f"def {verb}_{noun}_{i}(arg):\n    return arg.{noun} + {i}\n"
                           for i, verb in enumerate(verbs))
        (repo / "src" / f"gen_{f}.py").write_text(body)


@pytest.fixture
def repo_db(home, tmp_repo, tmp_path):
    _add_functions(tmp_repo)
    db = tmp_path / "db"
    jax_index(tmp_repo, JaxIndexOptions(store_path=db, quiet=True))
    return tmp_repo, db


def _same_ranking(got, want, tol: float) -> None:
    """Two ranked lists of (id, score) hold the same ids; two of them may
    trade places only where ``want``'s scores for them lie within ``tol``."""
    assert sorted(c for c, _ in got) == sorted(c for c, _ in want)
    pos = {cid: i for i, (cid, _) in enumerate(got)}
    score = dict(want)
    for i, (a, _) in enumerate(want):
        for b, _ in want[i + 1:]:
            if pos[a] > pos[b]:
                assert abs(score[a] - score[b]) <= tol, (a, b)


@pytest.mark.parametrize("mode", ["proxy", "absolute", "alibi"])
def test_session_rerank_matches_jax(repo_db, home, mode):
    _, db = repo_db
    if mode != "proxy":
        _write_checkpoint(_models(home) / RERANKER, alibi=mode == "alibi", gain=2.0)
    ours, ref = SearchSession(db, device="cpu"), JaxSession(db)
    for query in QUERIES:
        got = ours.search(query, SearchOptions(limit=10, rerank=True))
        want = ref.search(query, JaxOptions(limit=10, rerank=True))
        assert got.rerank_mode == want.rerank_mode == (
            "proxy-bi-encoder" if mode == "proxy" else "cross-encoder")
        assert "rerank" in got.timings_ms
        _same_ranking([(h.chunk_id, h.score) for h in got.hits],
                      [(h.chunk_id, h.score) for h in want.hits],
                      PROXY_TOL if mode == "proxy" else SESSION_TOL)
        np.testing.assert_allclose([h.score for h in got.hits], [h.score for h in want.hits],
                                   atol=PROXY_TOL if mode == "proxy" else SESSION_TOL)
    assert ours.reranker.gate_calls == ref.reranker.gate_calls == len(QUERIES)
    assert ours.reranker.gate_open == ref.reranker.gate_open
    assert mode == "proxy" or ours.reranker.gate_open > 0


def test_session_rerank_options(repo_db):
    _, db = repo_db
    session = SearchSession(db, device="cpu")
    plain = session.search(QUERIES[0], SearchOptions(limit=5))
    assert plain.rerank_mode is None and "rerank" not in plain.timings_ms
    filtered = session.search(QUERIES[0], SearchOptions(limit=5, rerank=True,
                                                        path_filter="gen_0"))
    assert filtered.hits and all("gen_0" in h.path for h in filtered.hits)
    top2 = session.search(QUERIES[0], SearchOptions(limit=5, rerank=True, rerank_top=2))
    ref = JaxSession(db).search(QUERIES[0], JaxOptions(limit=5, rerank=True, rerank_top=2))
    assert [h.chunk_id for h in top2.hits] == [h.chunk_id for h in ref.hits]


def test_search_many_with_rerank_equals_search(repo_db):
    _, db = repo_db
    session = SearchSession(db, device="cpu")
    opts = SearchOptions(limit=8, rerank=True)
    wave = session.search_many(QUERIES, opts)
    session._resp_cache.clear()
    for query, resp in zip(QUERIES, wave):
        one = session.search(query, opts)
        assert [h.chunk_id for h in resp.hits] == [h.chunk_id for h in one.hits]
        assert resp.rerank_mode == one.rerank_mode == "proxy-bi-encoder"


def test_cli_search_rerank_json(repo_db, capsys):
    from codesearch_tpu_torch.cli import main

    repo, db = repo_db
    assert main(["--platform", "cpu", "--store", str(db), "search", QUERIES[0], str(repo),
                 "--rerank", "--rerank-top", "20", "--json", "--limit", "3"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["rerank_mode"] == "proxy-bi-encoder" and len(out["results"]) == 3
    assert main(["--platform", "cpu", "--store", str(db), "search", QUERIES[0], str(repo),
                 "--rerank", "--limit", "3"]) == 0
    assert "bi-encoder proxy" in capsys.readouterr().out
    assert main(["--platform", "cpu", "--store", str(db), "search", QUERIES[0], str(repo),
                 "--json", "--limit", "3"]) == 0
    assert "rerank_mode" not in json.loads(capsys.readouterr().out)
    # stats reads the index the rerank queries ran over
    assert main(["--platform", "cpu", "--store", str(db), "stats", str(repo), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["vector"]["chunks"] == out["total_chunks"] > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("alibi", [False, True])
def test_gpu_session_reranks_as_the_cpu_session(cuda, repo_db, home, alibi):
    _, db = repo_db
    _write_checkpoint(_models(home) / RERANKER, alibi, hidden=128, gain=2.0)
    gpu, cpu = SearchSession(db, device="cuda"), SearchSession(db, device="cpu")
    for query in QUERIES:
        ta.reset_launch_counts()
        got = gpu.search(query, SearchOptions(limit=10, rerank=True))
        assert ta.launch_counts["attention_full"] == (0 if alibi else 2)
        assert ta.composed_counts["bias2d"] == (2 if alibi else 0)
        want = cpu.search(query, SearchOptions(limit=10, rerank=True))
        _same_ranking([(h.chunk_id, h.score) for h in got.hits],
                      [(h.chunk_id, h.score) for h in want.hits], SESSION_TOL)
