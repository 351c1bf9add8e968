"""Mean host ms a query spends in the read plane's candidate stage
(``server/readplane.py`` ``device_candidates``: query tokenization and
encode, the vector top-k, BM25 and their readback), from the benchmark's
span around each call."""


def read(trace: dict):
    total, count = trace.get("spans", {}).get("bench.readplane.candidates", (0.0, 0))
    return total / count * 1e3 if count else None
