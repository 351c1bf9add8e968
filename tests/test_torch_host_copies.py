"""The port's copies of the JAX package's host modules behave as the originals.

For the same inputs each copy gives the same output as the JAX module:
the semantic chunker over every source file of ``codesearch_tpu/`` (chunk
text, kind, lines, signature, context), the file walker over the
repository, query analysis over a set of queries, RRF fusion on seeded
ranked lists, and the native featurizer and masker byte for byte. Both
packages write one on-disk index format, so their host halves must not drift.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from codesearch_tpu import native as j_native
from codesearch_tpu.chunker import SemanticChunker as JChunker
from codesearch_tpu.fileio import FileWalker as JWalker
from codesearch_tpu.fileio import detect_language as j_detect
from codesearch_tpu.rerank import fusion as j_fusion
from codesearch_tpu.search import analysis as j_analysis
from codesearch_tpu_torch import native as t_native
from codesearch_tpu_torch.chunker import SemanticChunker as TChunker
from codesearch_tpu_torch.fileio import FileWalker as TWalker
from codesearch_tpu_torch.fileio import detect_language as t_detect
from codesearch_tpu_torch.rerank import fusion as t_fusion
from codesearch_tpu_torch.search import analysis as t_analysis

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted(p.relative_to(ROOT).as_posix() for p in (ROOT / "codesearch_tpu").rglob("*")
                 if p.is_file() and p.suffix in (".py", ".cpp"))
QUERIES = [
    "how do we detect binary files", "parse the configuration file", "shared_registry",
    "where is shared_registry used", "FileWalker walk", "class Indexer", "fn main",
    'error handling "retry loop" -test', "validate the schema and return it",
    "struct Config fields", "interface Reader", "async fetch with timeout",
    "cosine_topk int8", "what does EMBEDDER_VERSION mean", "def __init__",
    "tests for the chunker", "README install docs", "-deprecated parse json",
    "enum ChunkKind", "hash table bf16 rounding", "getUserById", "snake_case_name lookup",
]


def _chunk_fields(chunks) -> list[tuple]:
    return [(c.content, c.kind.value, c.start_line, c.end_line, c.signature, c.docstring,
             tuple(c.context), c.is_complete, c.split_index) for c in chunks]


@pytest.mark.parametrize("rel", SOURCES)
def test_chunker_matches(rel):
    path = ROOT / rel
    content = path.read_text(encoding="utf-8", errors="replace")
    jl, tl = j_detect(path), t_detect(path)
    assert jl.name == tl.name
    got = TChunker().chunk_semantic(tl, rel, content)
    ref = JChunker().chunk_semantic(jl, rel, content)
    assert got and _chunk_fields(got) == _chunk_fields(ref)


def test_walker_matches():
    jfiles, jstats = JWalker(ROOT).walk()
    tfiles, tstats = TWalker(ROOT).walk()
    assert [(f.path, f.language.name, f.size) for f in tfiles] == \
        [(f.path, f.language.name, f.size) for f in jfiles]
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert len(tfiles) > 100


@pytest.mark.parametrize("query", QUERIES)
def test_analysis_matches(query):
    ti, ji = (m.detect_structural_intent(query) for m in (t_analysis, j_analysis))
    assert (ti and ti.value) == (ji and ji.value)
    for name in ("parse_operators", "expand_query", "detect_identifiers", "adapt_rrf_k",
                 "strip_question", "query_wants_tests", "query_wants_docs"):
        assert getattr(t_analysis, name)(query) == getattr(j_analysis, name)(query), name


@pytest.mark.parametrize("seed", range(4))
def test_fusion_matches(seed):
    rng = np.random.default_rng(seed)

    def ranked(n):
        ids = rng.choice(400, size=n, replace=seed % 2 == 1)   # odd seeds: duplicates
        return list(zip(ids.tolist(), np.sort(rng.random(n))[::-1].tolist()))

    vec, fts, exact = ranked(200), ranked(150), ranked(20)
    as_tuples = lambda rs: [dataclasses.astuple(r) for r in rs]  # noqa: E731
    assert as_tuples(t_fusion.rrf_fusion_with_exact(vec, fts, exact, 40.0, 60.0)) == \
        as_tuples(j_fusion.rrf_fusion_with_exact(vec, fts, exact, 40.0, 60.0))
    assert as_tuples(t_fusion.rrf_fusion(vec, fts)) == as_tuples(j_fusion.rrf_fusion(vec, fts))
    assert as_tuples(t_fusion.vector_only(vec)) == as_tuples(j_fusion.vector_only(vec))


TEXTS = ["def parse_config(path):\n    return open(path).read()\n",
         "fn main() { let x = vec![1, 2]; println!(\"{}\", x.len()); }",
         "class Indexer:\n    \"\"\"Builds the search index.\"\"\"\n", "", "ümlaut_ident naïve",
         "x" * 5000, "getUserById(userId) // TODO: cache"]


def test_native_featurizer_matches_byte_for_byte():
    assert t_native.is_available() == j_native.is_available()
    for text in TEXTS:
        a, b = t_native.featurize_native(text), j_native.featurize_native(text)
        assert (a is None) == (b is None)
        if a is not None:
            assert a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()
        a, b = t_native.token_hashes_native(text), j_native.token_hashes_native(text)
        assert (a is None and b is None) or a.tobytes() == b.tobytes()
        assert t_native.mask_native("python", text) == j_native.mask_native("python", text)
    a, b = t_native.featurize_batch_native(TEXTS), j_native.featurize_batch_native(TEXTS)
    assert (a is None) == (b is None)
    for (ai, aw), (bi, bw) in zip(a or [], b or []):
        assert ai.tobytes() == bi.tobytes() and aw.tobytes() == bw.tobytes()


def test_native_library_has_its_own_file():
    if not t_native.is_available():
        pytest.skip("no C++ compiler for the native tier")
    assert Path(t_native._lib._name).name == "cs_native_torch.so"
    assert Path(j_native._lib._name).name == "cs_native.so"
