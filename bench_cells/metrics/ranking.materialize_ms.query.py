"""Mean host ms a query spends in the ranking's loop over fused candidates
(``server/readplane.py`` ``rank_candidates``: ``get_chunk``, the query's
operators, the boosts), from the program's span ``cs.rank.materialize``."""

from bench_cells.program_spans import per_query_ms


def read(trace: dict):
    return per_query_ms(trace, "cs.rank.materialize")
