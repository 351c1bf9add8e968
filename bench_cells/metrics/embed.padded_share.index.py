"""Share of the token positions sent through the encoder that are padding,
from the embedding backend's own counters (``backend.counts``: real and
padded tokens)."""


def read(trace: dict):
    padded = trace.get("padded_tokens")
    if not padded:
        return None
    return 100.0 * (padded - trace["tokens"]) / padded
