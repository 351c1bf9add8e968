"""Mean host ms a query spends ranking its candidates
(``server/readplane.py`` ``rank_candidates``: exact-identifier lookups,
three-way fusion, boosts and materialization), from the benchmark's span
around each call."""


def read(trace: dict):
    total, count = trace.get("spans", {}).get("bench.readplane.rank", (0.0, 0))
    return total / count * 1e3 if count else None
