"""Mean host ms a query spends turning read-back rows into candidates
(``VectorStore._materialize``: a metadata read a vector candidate;
``FtsStore.results_from_device``), from the program's span
``cs.readplane.unpack``."""

from bench_cells.program_spans import per_query_ms


def read(trace: dict):
    return per_query_ms(trace, "cs.readplane.unpack")
