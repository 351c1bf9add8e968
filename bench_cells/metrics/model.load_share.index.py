"""Share of the index calls' wall time spent reading the model's checkpoint
onto the device (``models/encoder.py`` ``read_safetensors``, inside each
call's open), from the program's span ``cs.model.load``."""

from bench_cells.program_spans import index_share


def read(trace: dict):
    return index_share(trace, "cs.model.load")
