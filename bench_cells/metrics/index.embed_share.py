"""Share of the index calls' wall time inside the embedding service's batch
embed (``embed/service.py`` ``embed_chunks_matrix_async``: tokenization and
launch, and the wait for its result), from the benchmark's spans."""


def read(trace: dict):
    wall = trace.get("index_wall_s")
    if not wall:
        return None
    total = sum(trace["spans"].get(k, (0.0, 0))[0]
                for k in ("bench.index.embed", "bench.index.embed_wait"))
    return 100.0 * total / wall
