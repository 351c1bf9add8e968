"""Geometric-growth 1D numpy buffer (shared by the FTS and vector stores).

Append-heavy columnar state at product scale (10M+ rows) cannot live in
Python dicts/lists — a 10M-entry dict costs ~1 GB of object overhead where
the equivalent numpy column costs 80 MB. The stores keep every per-row
column in one of these.
"""

from __future__ import annotations

import numpy as np


class GrowBuf:
    __slots__ = ("a", "n")

    def __init__(self, dtype, initial: int = 1024):
        self.a = np.zeros(initial, dtype)
        self.n = 0

    def extend(self, values: np.ndarray) -> None:
        need = self.n + len(values)
        if need > len(self.a):
            cap = max(need, 2 * len(self.a))
            grown = np.zeros(cap, self.a.dtype)
            grown[: self.n] = self.a[: self.n]
            self.a = grown
        self.a[self.n : need] = values
        self.n = need

    def append(self, v) -> int:
        if self.n + 1 > len(self.a):
            grown = np.zeros(2 * len(self.a), self.a.dtype)
            grown[: self.n] = self.a[: self.n]
            self.a = grown
        self.a[self.n] = v
        self.n += 1
        return self.n - 1

    def view(self) -> np.ndarray:
        return self.a[: self.n]
