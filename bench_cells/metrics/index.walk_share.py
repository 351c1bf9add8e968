"""Share of the index calls' wall time in the file walker and the manifest
diff (``fileio/walker.py`` ``walk``; ``check_file`` and the deletes), from
the program's spans ``cs.index.walk`` and ``cs.index.diff``."""

from bench_cells.program_spans import index_share


def read(trace: dict):
    return index_share(trace, "cs.index.walk", "cs.index.diff")
