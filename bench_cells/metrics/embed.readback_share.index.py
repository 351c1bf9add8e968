"""Share of the index calls' wall time the host waits on the device
(``utils/device.py`` ``to_host``: the embedded vectors copied back), from
the program's span ``cs.device.readback``."""

from bench_cells.program_spans import index_share


def read(trace: dict):
    return index_share(trace, "cs.device.readback")
