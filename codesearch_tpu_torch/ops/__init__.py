"""Device ops: exact top-k kernels, BM25 scoring, attention."""
