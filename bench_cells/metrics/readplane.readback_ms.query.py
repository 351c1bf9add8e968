"""Mean host ms a query waits on the device (``utils/device.py``
``to_host``: the results copied back, one synchronise), from the program's
span ``cs.device.readback``."""

from bench_cells.program_spans import per_query_ms


def read(trace: dict):
    return per_query_ms(trace, "cs.device.readback")
