"""The program's own spans (``codesearch_tpu_torch.utils.tracing``), as the
per-layer readers read them: the aggregates its ``snapshot()`` gives by
span name. The program records them only while the profiler records, so a
traced run's aggregates cover its profiled window alone. A program without
the module, or a run in which the span was not recorded, reads None."""

from __future__ import annotations


def aggregates() -> dict:
    """{span name: {"count", "total_s", "self_s", "counts"}}; empty when the
    program has no such module."""
    try:
        from codesearch_tpu_torch.utils import tracing
    except ImportError:
        return {}
    return tracing.snapshot()["spans"]


def per_query_ms(trace: dict, name: str, field: str = "total_s") -> float | None:
    """Mean ms a query of the span ``name`` (its ``field``: ``total_s`` or
    ``self_s``), over the queries the root span ``cs.readplane.query``
    counted."""
    if "queries" not in trace:
        return None
    spans = aggregates()
    root, s = spans.get("cs.readplane.query"), spans.get(name)
    if not root or not root["count"] or s is None:
        return None
    return 1e3 * s[field] / root["count"]


def index_share(trace: dict, *names: str) -> float | None:
    """The spans' summed time as a share of the index calls' wall time."""
    wall = trace.get("index_wall_s")
    spans = aggregates()
    found = [spans[n]["total_s"] for n in names if n in spans]
    if not wall or not found:
        return None
    return 100.0 * sum(found) / wall
