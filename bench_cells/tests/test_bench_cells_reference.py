"""The plain reference against tiny cases worked another way: the array
tokenizer against the frozen loop tokenizer, BM25 against a per-chunk
loop, fusion against a hand-worked example, the BERT encoder against
``torch.nn.TransformerEncoderLayer``, the rotary embedding's relative
positions, and the list comparison on hand-made lists."""

import math
import random
from collections import Counter

import numpy as np
import pytest
import torch

from bench_cells.gen.weights import make_weights, tensor_specs
from bench_cells.reference import ranking
from bench_cells.reference.bm25 import Corpus, exact_target, signature_field
from bench_cells.reference.compare import list_gap, ranked_mismatch
from bench_cells.reference.encoder import Encoder, fp8_round
from bench_cells.reference.textstats import term_counts, token_counts
from bench_cells.reference.tokenizer import code_tokens, token_ids

TEXTS = ["XMLParser utf8Decode __init__ _foo_ a__b HTTPServerError x1Y2 ABC aB",
         "", "___", "fooBar_baz9Qux", "def parse_config(path: str) -> Config:\n    return x",
         "let mut readBuf = self.io_buf.get()?; // ÿ bytes", "A", "aBCd EFgh"]


def test_array_tokenizer_matches_the_loop_tokenizer():
    rnd = random.Random(4)
    alphabet = "abcXYZ019_ .(){}:;\n\t-"
    texts = TEXTS + ["".join(rnd.choice(alphabet) for _ in range(rnd.randint(0, 80)))
                     for _ in range(400)]
    assert token_counts(texts).tolist() == [len(code_tokens(t)) for t in texts]
    terms = sorted({t for x in texts for t in code_tokens(x)})
    _counts, (ti, ki, tf) = term_counts(texts, terms)
    got = {(int(a), terms[int(b)]): int(c) for a, b, c in zip(ti, ki, tf)}
    want = {(i, t): c for i, x in enumerate(texts) for t, c in Counter(code_tokens(x)).items()}
    assert got == want


def test_token_ids_frame_and_cut():
    ids = token_ids("alpha beta " * 400, 30522, 512)
    assert len(ids) == 512 and ids[0] == 101 and ids[-1] == 102
    ids = token_ids("alpha beta " * 400, 30528, 2048)
    assert len(ids) == 512 and ids[0] == 101 and ids[-1] != 102
    assert all(999 <= i < 30528 for i in ids[1:])


def _bm25_loop(docs, query, kind):
    """BM25 of every chunk, one chunk at a time, as the reference documents it."""
    toks = [(Counter(code_tokens(c)), Counter(code_tokens(signature_field(p, s)))) for
            c, p, s, _k in docs]
    lens = [max(sum(a.values()) + sum(b.values()), 1) for a, b in toks]
    avg = sum(lens) / len(lens)
    n = len(docs)
    scores = [0.0] * n
    for t in set(code_tokens(ranking.bm25_text(query))):
        df = sum(1 for a, b in toks if t in a or t in b)
        if df == 0 or df > max(0.4 * n, 64.0):
            continue
        idf = math.log(1 + (n - df + 0.5) / (df + 0.5))
        for i, (a, b) in enumerate(toks):
            tfb = a[t] + 2.0 * b[t]
            if tfb:
                scores[i] += idf * tfb * 2.2 / (tfb + 1.2 * (0.25 + 0.75 * lens[i] / avg))
    return [s * 3.0 if kind and docs[i][3] == kind else s for i, s in enumerate(scores)]


def test_bm25_and_exact_match_per_chunk_loops():
    rnd = random.Random(1)
    words = ["parse", "config", "tree", "Buffer", "read_all", "writeBack", "the", "flush"]
    docs = [(" ".join(rnd.choice(words) for _ in range(rnd.randint(1, 30))),
             f"src/{rnd.choice(words)}.py", f"def {rnd.choice(words)}()",
             rnd.choice(["Function", "Method"])) for _ in range(200)]
    query = "how do we parse the config Buffer"
    terms = sorted(set(code_tokens(ranking.bm25_text(query))) | {"read_all", "writeback"})
    c = Corpus(*zip(*docs), terms=terms)
    for kind in (None, "Method"):
        np.testing.assert_allclose(c.bm25(ranking.bm25_text(query), kind),
                                   _bm25_loop(docs, query, kind), rtol=1e-12)
    ex = c.exact("read_all", "Function")
    for i, (content, path, sig, kind) in enumerate(docs):
        tfc = Counter(code_tokens(content))["read_all"]
        tfs = Counter(code_tokens(signature_field(path, sig)))["read_all"]
        ln = 1.2 * (0.25 + 0.75 * c.doc_len[i] / c.avg_len)
        want = (3 * tfs * 2.2 / (tfs + ln) if tfs else 0) + (tfc * 2.2 / (tfc + ln) if tfc else 0)
        assert ex[i] == pytest.approx(want if kind == "Function" else 0.0, rel=1e-12)
    assert exact_target("parse_config") == "parse_config"
    assert exact_target("readBuf") == "readbuf"


def test_fusion_and_ranking_worked_by_hand():
    fused = ranking.fuse([(7, 0.9), (3, 0.8)], [(3, 5.0), (9, 4.0)], [(9, 2.0)], 12.0, 28.0)
    want = {7: 1 / 13, 3: 1 / 14 + 1 / 29, 9: 1 / 30 + 1 / 6}
    assert [c for c, _ in fused] == sorted(want, key=lambda c: -want[c])
    assert all(s == pytest.approx(want[c], rel=1e-15) for c, s in fused)
    meta = {7: ("src/a.py", "Function", "Python", "x"), 3: ("tests/test_a.py", "Method", "Go", "y"),
            9: ("src/b.rs", "Function", "Rust", "z")}
    got = ranking.rank("where is parse_config called", 10, [(7, 0.9), (3, 0.8)],
                       [(3, 5.0), (9, 4.0)], [(9, 2.0)], meta.get, "Python")
    assert got[0][1] == 9 and got[0][0] == pytest.approx(want[9])
    assert dict((c, s) for s, c in got)[7] == pytest.approx(want[7] * 1.2)
    assert dict((c, s) for s, c in got)[3] == pytest.approx(want[3] / 1.15)
    assert ranking.structural_kind("function parse_config") == "Function"
    assert ranking.structural_kind("function parse") is None
    assert ranking.rrf_ks("where is parse_config") == (12.0, 28.0)


def _tiny_dims(family):
    return {"family": family, "hidden": 64, "layers": 2, "heads": 4, "intermediate": 128,
            "vocab": 1200, "positions": 64, "eps": 1e-12, "rope_base": 1000.0,
            "type_vocab": 2, "pooling": "cls" if family == "bert" else "mean"}


def test_bert_reference_against_torch_encoder_layers():
    dims = _tiny_dims("bert")
    w = make_weights(dims, 3, "cpu")
    enc = Encoder(dims, w, "cpu")
    ids = torch.randint(999, 1200, (3, 20))
    mask = torch.ones(3, 20)
    mask[1, 12:] = 0
    got = enc.encode(ids, mask)
    f = {k: v.float() for k, v in w.items()}
    x = f["embeddings.word_embeddings.weight"][ids]
    x = x + f["embeddings.position_embeddings.weight"][:20]
    x = x + f["embeddings.token_type_embeddings.weight"][0]
    x = torch.nn.functional.layer_norm(x, (64,), f["embeddings.LayerNorm.weight"],
                                       f["embeddings.LayerNorm.bias"], 1e-12)
    for i in range(2):
        p = f"encoder.layer.{i}."
        layer = torch.nn.TransformerEncoderLayer(64, 4, 128, dropout=0.0, activation="gelu",
                                                 batch_first=True, layer_norm_eps=1e-12).eval()
        sd = {"self_attn.in_proj_weight": torch.cat([f[p + f"attention.self.{n}.weight"]
                                                     for n in ("query", "key", "value")]),
              "self_attn.in_proj_bias": torch.cat([f[p + f"attention.self.{n}.bias"]
                                                   for n in ("query", "key", "value")]),
              "self_attn.out_proj.weight": f[p + "attention.output.dense.weight"],
              "self_attn.out_proj.bias": f[p + "attention.output.dense.bias"],
              "linear1.weight": f[p + "intermediate.dense.weight"],
              "linear1.bias": f[p + "intermediate.dense.bias"],
              "linear2.weight": f[p + "output.dense.weight"],
              "linear2.bias": f[p + "output.dense.bias"],
              "norm1.weight": f[p + "attention.output.LayerNorm.weight"],
              "norm1.bias": f[p + "attention.output.LayerNorm.bias"],
              "norm2.weight": f[p + "output.LayerNorm.weight"],
              "norm2.bias": f[p + "output.LayerNorm.bias"]}
        layer.load_state_dict(sd)
        with torch.no_grad():
            x = layer(x, src_key_padding_mask=mask == 0)
    want = torch.nn.functional.normalize(x[:, 0], dim=-1)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-5)


def test_nomic_reference_rotary_sees_relative_positions():
    dims = _tiny_dims("nomic")
    enc = Encoder(dims, make_weights(dims, 5, "cpu"), "cpu")
    q = torch.randn(1, 1, 12, 16)
    k = torch.randn(1, 1, 12, 16)
    rq, rk = enc._rope(q, 1000.0), enc._rope(k, 1000.0)
    # shifting both by the same positions leaves every product unchanged
    q2, k2 = torch.zeros(1, 1, 20, 16), torch.zeros(1, 1, 20, 16)
    q2[:, :, 8:], k2[:, :, 8:] = q, k
    s1 = rq @ rk.transpose(-1, -2)
    s2 = (enc._rope(q2, 1000.0) @ enc._rope(k2, 1000.0).transpose(-1, -2))[:, :, 8:, 8:]
    torch.testing.assert_close(s1, s2, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(rq.norm(dim=-1), q.norm(dim=-1))
    out = enc.encode(torch.randint(999, 1200, (2, 9)), torch.ones(2, 9))
    torch.testing.assert_close(out.norm(dim=-1), torch.ones(2))


def test_weights_are_seeded_and_shaped():
    dims = _tiny_dims("nomic")
    a, b = make_weights(dims, 11, "cpu"), make_weights(dims, 11, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert {k: tuple(v.shape) for k, v in a.items()} == {n: s for n, s, _ in tensor_specs(dims)}
    assert all(v.dtype == torch.float16 for v in a.values())
    assert not torch.equal(make_weights(dims, 12, "cpu")["emb_ln.bias"], a["emb_ln.bias"])


def test_fp8_control_rounds_coarser_than_bf16():
    x = torch.randn(64, 256)
    e8 = ((fp8_round(x) - x).norm() / x.norm()).item()
    e16 = ((x.to(torch.bfloat16).float() - x).norm() / x.norm()).item()
    assert e8 > 4 * e16


def test_list_gap_hand_made_lists():
    ref = np.array([0.9, 0.8, 0.7, 0.7, 0.1])
    assert list_gap([(0, 0.9), (1, 0.8), (2, 0.7)], ref, 3, 1.0) == 0.0
    assert list_gap([(0, 0.9), (1, 0.8), (3, 0.7)], ref, 3, 1.0) == 0.0     # a tie, other pick
    assert list_gap([(0, 0.9), (1, 0.8), (4, 0.1)], ref, 3, 1.0) == pytest.approx(0.6)
    assert list_gap([(1, 0.8), (0, 0.9)], ref, 2, 1.0) == pytest.approx(0.1)   # out of order
    assert list_gap([(0, 0.95), (1, 0.8)], ref, 2, 1.0) == pytest.approx(0.05)  # score off
    assert list_gap([(0, 0.9)], ref, 3, 1.0) == 1.0                           # too short
    assert list_gap([(0, 0.9), (0, 0.9)], ref, 2, 1.0) == 1.0                 # twice
    assert list_gap([], np.zeros(5), 3, positive_only=True) == 0.0
    assert ranked_mismatch([(1.0, 3), (0.5, 4)], [(1.0, 3), (0.5, 4)]) == 0
    assert ranked_mismatch([(1.0, 3), (0.5, 4)], [(1.0, 4), (0.5, 3)]) == 2
    assert ranked_mismatch([(1.0, 3)], [(1.0, 3), (0.5, 4)]) == 1
