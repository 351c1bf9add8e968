"""Share of the token positions the query encoder is sent that are padding
(the bucket past each query's real tokens), from the counts of the
program's span ``cs.readplane.featurize`` (``tokens``: real, ``padded``:
padding)."""

from bench_cells.program_spans import aggregates


def read(trace: dict):
    if "queries" not in trace:
        return None
    s = aggregates().get("cs.readplane.featurize")
    if s is None:
        return None
    real, pad = s["counts"].get("tokens", 0), s["counts"].get("padded", 0)
    return 100.0 * pad / (real + pad) if real + pad else None
