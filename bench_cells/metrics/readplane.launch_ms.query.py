"""Mean host ms a query spends enqueueing its device call
(``vectordb/store.py`` ``_hybrid``: the inputs copied to the device, the
encoder's layers, kernel a, BM25 and kernel c launched), from the self time
of the program's span ``cs.store.dispatch``: its readback and unpacking,
child spans, left out."""

from bench_cells.program_spans import per_query_ms


def read(trace: dict):
    return per_query_ms(trace, "cs.store.dispatch", "self_s")
