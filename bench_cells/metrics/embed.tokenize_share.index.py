"""Share of the index calls' wall time in the host tokenizer
(``embed/service.py``: ``HashingTokenizer.encode`` of every text to embed),
from the program's span ``cs.embed.tokenize``."""

from bench_cells.program_spans import index_share


def read(trace: dict):
    return index_share(trace, "cs.embed.tokenize")
