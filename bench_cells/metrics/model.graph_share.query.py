"""Share of the query encoder's inference forwards on the card that replayed
a CUDA graph (``models/encoder.py`` ``BertEncoder.encode``), from the
program's counters: ``encoder.graph_replays`` over replays, captures
(``encoder.graph_captures``) and eager forwards
(``encoder.eager_forwards``). A program without the counters reads None."""


def read(trace: dict):
    if "queries" not in trace:
        return None
    try:
        from codesearch_tpu_torch.utils import tracing
    except ImportError:
        return None
    c = tracing.snapshot()["counters"]
    replays = c.get("encoder.graph_replays", 0)
    total = replays + c.get("encoder.graph_captures", 0) + c.get("encoder.eager_forwards", 0)
    return 100.0 * replays / total if total else None
