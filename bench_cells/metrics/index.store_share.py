"""Share of the index calls' wall time inside the stores
(``vectordb/store.py`` insert, build and save; ``fts/store.py`` add and
commit), from the benchmark's spans."""


def read(trace: dict):
    wall = trace.get("index_wall_s")
    if not wall:
        return None
    return 100.0 * trace["spans"].get("bench.index.store", (0.0, 0))[0] / wall
