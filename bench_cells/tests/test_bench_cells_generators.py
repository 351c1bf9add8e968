"""The benchmark's generators: the same seed gives the same traffic, the
sizes do not depend on the run seed, chunk lengths spread as the traffic
file says, and the query mix holds its shares."""

import json

import numpy as np
import pytest

from bench_cells.gen.code import CodeWriter, corpus_shape
from bench_cells.gen.corpus import make_chunks, split_lines
from bench_cells.gen.queries import make_queries
from bench_cells.harness import HERE

QUERY_TRAFFIC = json.loads((HERE / "traffic" / "agent-query.json").read_text())
INDEX_TRAFFIC = json.loads((HERE / "traffic" / "index.json").read_text())


def small(p: dict, **kw) -> dict:
    return {**p, "statement_pool": 512, **kw}


def test_same_seed_same_corpus():
    p = small(QUERY_TRAFFIC["corpus"], functions=400)
    a, b = make_chunks(p, 2 ** 31 + 17, 300), make_chunks(p, 2 ** 31 + 17, 300)
    assert a.content == b.content and a.path == b.path and a.kind == b.kind
    assert (a.group == b.group).all()
    c = make_chunks(p, 5, 300)
    assert c.content != a.content


def test_same_seed_same_repositories():
    p = small(INDEX_TRAFFIC["repositories"], functions=200)
    shape = corpus_shape(p, 200)
    a = [f.text() for f in CodeWriter(9, p).files(shape, "x/")]
    b = [f.text() for f in CodeWriter(9, p).files(shape, "x/")]
    assert a == b


def test_sizes_do_not_depend_on_the_run_seed():
    p = small(INDEX_TRAFFIC["repositories"], functions=300)
    shape = corpus_shape(p, 300)
    sizes = []
    for seed in (1, 2 ** 33 + 1):
        files = CodeWriter(seed, p).files(shape, "x/")
        sizes.append(sorted(len(f.units) for f in files))
    assert sizes[0] == sizes[1] == sorted(shape.per_file.tolist())


@pytest.mark.parametrize("traffic", [QUERY_TRAFFIC["corpus"], INDEX_TRAFFIC["repositories"]])
def test_chunk_length_spread(traffic):
    shape = corpus_shape(traffic, 20000)
    med = float(np.median(shape.lines))
    p95 = float(np.percentile(shape.lines, 95))
    assert abs(med - traffic["lines_median"]) <= 1
    assert abs(p95 - traffic["lines_p95"]) / traffic["lines_p95"] < 0.08
    assert shape.lines.max() <= traffic["lines_cap"]
    assert shape.lines.min() >= traffic["lines_floor"]


def test_definition_names_are_unique_within_a_run():
    p = small(INDEX_TRAFFIC["repositories"], functions=400)
    w = CodeWriter(3, p)
    names = [u.name for _ in range(3) for f in w.files(corpus_shape(p, 400), "x/")
             for u in f.units]
    assert len(names) == len(set(names))


def test_split_lines_covers_with_overlap():
    assert split_lines(10, 48, 8) == [(0, 10)]
    parts = split_lines(100, 48, 8)
    assert parts[0] == (0, 48) and parts[-1][1] == 100
    assert all(b - a <= 48 for a, b in parts)
    assert all(parts[i + 1][0] == parts[i][1] - 8 for i in range(len(parts) - 1))


def test_query_mix():
    p = small(QUERY_TRAFFIC["corpus"], functions=2000)
    ch = make_chunks(p, 21, 2000)
    qp = QUERY_TRAFFIC["queries"]
    qs = make_queries(21, ch.writer.words, ch.writer.weights.tolist(), ch.names, 3000,
                      qp["mix"], tuple(qp["question_words"]))
    assert len(set(qs)) == 3000
    assert qs == make_queries(21, ch.writer.words, ch.writer.weights.tolist(), ch.names, 3000,
                              qp["mix"], tuple(qp["question_words"]))
    names = set(ch.names)
    ident = sum(q in names for q in qs) / len(qs)
    mixed = sum(q not in names and any(w in names for w in q.split()) for q in qs) / len(qs)
    assert abs(ident - qp["mix"]["identifier"]) < 0.04
    assert abs(mixed - qp["mix"]["mixed"]) < 0.03
    lo, hi = qp["question_words"]
    questions = [q for q in qs if not any(w in names for w in q.split())]
    assert all(lo <= len(q.split()) <= hi for q in questions)
