"""Share of the query window in which no operation ran on the device, from
the profiler's trace (the union of kernel, copy and set intervals)."""


def read(trace: dict):
    if not trace.get("window_s") or "queries" not in trace:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
