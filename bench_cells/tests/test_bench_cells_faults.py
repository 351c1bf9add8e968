"""The correctness check catches a broken program: each cell is run on the
CPU at a small size, past the harness's look for a chip, with the timed
path broken underneath in one of the ways the cell can break, and
``correct`` has to come out false; a sound run at the same size comes out
true. The control (the reference a precision lower in the program's place)
fails the cell's limits. The program's CUDA kernels have plain versions on
the CPU; the tests marked ``cuda`` run a small cell through the kernels and
skip without a card."""

import time

import numpy as np
import pytest

def small_cell(name):
    """The cell ``<configuration>.<traffic>`` at a size the CPU runs in
    seconds; a pair that ``BENCHMARK.json`` does not list is added to a
    copy of it, with the limits file of that name."""
    from bench_cells.harness import Cell, load_benchmark

    bench = load_benchmark()
    if name not in {w["name"] for w in bench["workloads"]}:
        config, traffic = name.rsplit(".", 1)
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "a test"})
    cell = Cell(name, bench=bench)
    tr = cell.traffic
    if "corpus" in tr:
        tr["corpus"].update(chunks=2000, functions=1800, statement_pool=512)
        tr["queries"].update(min_count=300, ceiling_per_s=100, warmup=2)
        tr["check"]["sample"] = 12
    else:
        tr["repositories"].update(functions=24, warmup_functions=6,
                                  statement_pool=256, lines_median=3, lines_p95=12)
        tr["check"].update(chunks=16, longest=4)
    return cell


@pytest.fixture(scope="module")
def cache_root(tmp_path_factory):
    """One checkout-like root a module, so the native library builds once."""
    return tmp_path_factory.mktemp("checkout")


def run(cell, tmp_path, root, seconds=1.5, control=False):
    import os

    import bench_cells.run as R

    os.environ["TMPDIR"] = str(tmp_path)
    home = R.prepare_environment(root)
    line, _checks, out = R.run_cell(cell, 20261017, seconds, False, "cpu", home,
                                    time.perf_counter(), control=control)
    return line, out


def verdict(out) -> bool:
    return all(lim is not None and v <= lim for _n, v, lim in out.checks) and out.failed == 0


@pytest.fixture
def query_cell():
    return small_cell("bge-small.agent-query")


@pytest.fixture
def index_cell():
    return small_cell("bge-small.index")


def _alter_candidates(monkeypatch, alter):
    from codesearch_tpu_torch.server import readplane

    orig = readplane.device_candidates

    def broken(*a, **kw):
        vres, fres = orig(*a, **kw)
        return alter(vres, fres)

    monkeypatch.setattr(readplane, "device_candidates", broken)


def test_sound_query_run(query_cell, tmp_path, cache_root):
    _line, out = run(query_cell, tmp_path, cache_root, seconds=3.0)
    assert out.attempted >= 2 and verdict(out), out.checks


def test_query_vector_altered(query_cell, tmp_path, cache_root, monkeypatch):
    from codesearch_tpu_torch.models.encoder import BertEncoder

    orig = BertEncoder.encode

    def noisy(self, ids, mask):
        v = orig(self, ids, mask)
        return v + 0.05 * v.flip(-1) if ids.shape[0] == 1 else v

    monkeypatch.setattr(BertEncoder, "encode", noisy)
    _line, out = run(query_cell, tmp_path, cache_root)
    assert not verdict(out)
    assert dict((n, v) for n, v, _ in out.checks)["query_vector"] > 1e-3


def test_vector_hit_dropped(query_cell, tmp_path, cache_root, monkeypatch):
    _alter_candidates(monkeypatch, lambda v, f: (v[1:], f))
    _line, out = run(query_cell, tmp_path, cache_root)
    assert not verdict(out)


def test_bm25_hit_altered(query_cell, tmp_path, cache_root, monkeypatch):
    from codesearch_tpu_torch.fts.store import FtsStore

    orig = FtsStore.search

    def worse(self, *a, **kw):
        res = orig(self, *a, **kw)
        return res[::-1] if len(res) > 1 else res

    monkeypatch.setattr(FtsStore, "search", worse)
    _line, out = run(query_cell, tmp_path, cache_root)
    assert not verdict(out)


def test_ranked_list_altered(query_cell, tmp_path, cache_root, monkeypatch):
    from codesearch_tpu_torch.server import readplane

    orig = readplane.rank_candidates

    def swapped(*a, **kw):
        out = orig(*a, **kw)
        return [out[1], out[0], *out[2:]] if len(out) > 1 else out

    monkeypatch.setattr(readplane, "rank_candidates", swapped)
    _line, out = run(query_cell, tmp_path, cache_root)
    assert not verdict(out)
    assert dict((n, v) for n, v, _ in out.checks)["ranked_list"] > 0


def _alter_embeddings(monkeypatch, alter):
    from codesearch_tpu_torch.embed import EmbeddingService

    orig = EmbeddingService.embed_chunks_matrix_async

    def broken(self, chunks):
        finish = orig(self, chunks)
        return lambda: alter(np.array(finish()))

    monkeypatch.setattr(EmbeddingService, "embed_chunks_matrix_async", broken)


def test_sound_index_run(index_cell, tmp_path, cache_root):
    _line, out = run(index_cell, tmp_path, cache_root)
    assert out.attempted >= 1 and verdict(out), out.checks


def test_index_state_unchanged(index_cell, tmp_path, cache_root, monkeypatch):
    """A step that returns its state unchanged: the vector store keeps
    nothing of a call."""
    from codesearch_tpu_torch.vectordb import VectorStore

    def kept_nothing(self, embeddings, metadatas, ids=None):
        n = self.next_id()
        return list(range(n, n + len(metadatas)))

    monkeypatch.setattr(VectorStore, "insert_chunks_with_ids", kept_nothing)
    _line, out = run(index_cell, tmp_path, cache_root)
    assert not verdict(out)


def test_index_half_the_batch_left_out(index_cell, tmp_path, cache_root, monkeypatch):
    """Half of each batch embedded, the other half given the first half's rows."""
    def half(m):
        h = (len(m) + 1) // 2
        m[h:] = m[:len(m) - h]
        return m

    _alter_embeddings(monkeypatch, half)
    _line, out = run(index_cell, tmp_path, cache_root)
    assert not verdict(out)


def test_index_vector_altered(index_cell, tmp_path, cache_root, monkeypatch):
    def flipped(m):
        m[:, : m.shape[1] // 2] *= -1
        return m

    _alter_embeddings(monkeypatch, flipped)
    _line, out = run(index_cell, tmp_path, cache_root)
    assert not verdict(out)


@pytest.mark.parametrize("name", ["bge-small.agent-query", "nomic-v1.5.agent-query",
                                  "bge-small.index", "nomic-v1.5.index"])
def test_the_control_is_not_correct(name, tmp_path, cache_root):
    """The reference a precision lower (fp8 encoder and score pass, bf16
    BM25) judged in the program's place by the harness's own comparison,
    on the sample a sound run is judged on, reads not correct."""
    cell = small_cell(name)
    if "repositories" in cell.traffic:
        cell.traffic["repositories"].update(functions=120, lines_median=8, lines_p95=40)
    line, out = run(cell, tmp_path, cache_root, control=True)
    assert out.attempted >= 1 and out.failed == 0
    assert not verdict(out), out.checks
    assert '"correct": false' in line


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's kernels run only on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bge-small.agent-query", "nomic-v1.5.index"])
def test_small_cell_on_the_card(name, card, tmp_path, cache_root):
    """A sound run at a small size through the card's kernels."""
    import os

    import bench_cells.run as R

    os.environ["TMPDIR"] = str(tmp_path)
    home = R.prepare_environment(cache_root)
    _line, _checks, out = R.run_cell(small_cell(name), 20261018, 2.0, True, card, home,
                                     time.perf_counter())
    assert out.attempted >= 1 and verdict(out), out.checks
    assert out.trace["busy_s"] > 0
