"""Share of the index calls' wall time spent opening (``index/pipeline.py``:
the metadata, the ``EmbeddingService`` with its weights read and copied to
the device, the stores and the manifest), from the program's span
``cs.index.open``."""

from bench_cells.program_spans import index_share


def read(trace: dict):
    return index_share(trace, "cs.index.open")
