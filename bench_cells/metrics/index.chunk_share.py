"""Share of the index calls' wall time reading files and chunking them
(``chunker/semantic.py`` ``chunk_semantic``), from the program's span
``cs.index.chunk``."""

from bench_cells.program_spans import index_share


def read(trace: dict):
    return index_share(trace, "cs.index.chunk")
