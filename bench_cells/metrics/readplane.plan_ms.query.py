"""Mean host ms a query spends planning its BM25 leg (``fts/store.py``
``device_query_args``: term keys, postings intervals, score planes), from
the program's span ``cs.fts.plan``."""

from bench_cells.program_spans import per_query_ms


def read(trace: dict):
    return per_query_ms(trace, "cs.fts.plan")
