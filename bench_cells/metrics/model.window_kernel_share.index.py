"""Share of the encoder's windowed (local) layers on the card that ran the
windowed kernel, from the program's counters: ``attention.window_kernel``
over it and ``attention.window_composed`` (the composed route). A program
without the counters, or a run with no windowed layer, reads None."""


def read(trace: dict):
    if "index_calls" not in trace:
        return None
    try:
        from codesearch_tpu_torch.utils import tracing
    except ImportError:
        return None
    c = tracing.snapshot()["counters"]
    kernel = c.get("attention.window_kernel", 0)
    total = kernel + c.get("attention.window_composed", 0)
    return 100.0 * kernel / total if total else None
