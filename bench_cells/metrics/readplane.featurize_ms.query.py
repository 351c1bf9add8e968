"""Mean host ms a query spends featurizing its text (``server/readplane.py``
``_featurize``: the model's query prefix, the hashing tokenizer, the ids and
mask of its token bucket), from the program's span
``cs.readplane.featurize``."""

from bench_cells.program_spans import per_query_ms


def read(trace: dict):
    return per_query_ms(trace, "cs.readplane.featurize")
