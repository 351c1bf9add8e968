"""Plain BM25 over the benchmark's own chunk texts, in numpy float64: the
scoring the measured program's full-text store documents (content terms
plus the signature field at twice their weight, k1 = 1.2, b = 0.75, idf
``ln(1 + (N - df + 0.5) / (df + 0.5))``, terms in more than 40% of the
chunks skipped, a 3x boost for the kind a query asks for), and its exact
identifier lookup (signature hits 3x over content hits, each saturated,
AND-ed with the asked kind). Token statistics come from
``textstats``; nothing of the program is imported."""

from __future__ import annotations

import numpy as np

from .textstats import term_counts
from .tokenizer import code_tokens

K1 = 1.2
B = 0.75
SIG_WEIGHT = 2.0
KIND_BOOST = 3.0
EXACT_SIG_WEIGHT = 3.0
MAX_DF_SHARE = 0.4


def signature_field(path: str, signature: str | None) -> str:
    """The signature field: the declared signature and the path's parts."""
    parts = path.replace("/", " ").replace(".", " ").replace("\\", " ")
    return ((signature or "") + " " + parts).strip()


def query_terms(text: str) -> list[str]:
    return sorted(set(code_tokens(text)))


def exact_target(identifier: str) -> str | None:
    """The token of an identifier that the exact lookup matches: the
    longest that is alphanumeric (underscores allowed) and either has an
    underscore or three letters or more."""
    target = None
    for t in code_tokens(identifier):
        if t.replace("_", "").isalnum() and ("_" in t or len(t) >= 3):
            if target is None or len(t) > len(target):
                target = t
    return target


def bf16(x):
    """``x`` rounded to bfloat16 (the control's precision for float32 work)."""
    import torch

    return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16).double().numpy()


class Corpus:
    """Chunk statistics for a fixed set of terms: lengths of every chunk,
    and each term's chunks with its counts in content and signature."""

    def __init__(self, contents: list[str], paths: list[str], signatures: list,
                 kinds: list[str], terms: list[str], workers: int = 1):
        texts = []
        for c, p, s in zip(contents, paths, signatures):
            texts.append(c)
            texts.append(signature_field(p, s))
        counts, (ti, ki, tf) = term_counts(texts, terms, workers)
        self.n = len(contents)
        self.doc_len = np.maximum(counts[0::2] + counts[1::2], 1).astype(np.float64)
        self.avg_len = float(self.doc_len.mean()) if self.n else 1.0
        self.kinds = np.asarray(kinds, object)
        self.terms = {t: i for i, t in enumerate(terms)}
        doc, is_sig = ti // 2, ti % 2
        self.postings = {}
        for k in np.unique(ki):
            sel = ki == k
            d = doc[sel]
            uniq, inv = np.unique(d, return_inverse=True)
            tfc = np.zeros(len(uniq))
            tfs = np.zeros(len(uniq))
            np.add.at(tfc, inv[is_sig[sel] == 0], tf[sel][is_sig[sel] == 0])
            np.add.at(tfs, inv[is_sig[sel] == 1], tf[sel][is_sig[sel] == 1])
            self.postings[terms[int(k)]] = (uniq, tfc, tfs)

    def df(self, term: str) -> int:
        p = self.postings.get(term)
        return 0 if p is None else len(p[0])

    def _len_norm(self, docs):
        return K1 * (1.0 - B + B * self.doc_len[docs] / self.avg_len)

    def bm25(self, text: str, kind: str | None, rounding=None) -> np.ndarray:
        """Scores of every chunk for the BM25 terms of ``text``. ``rounding``
        (the control's) rounds every product and sum to a lower precision."""
        r = rounding or (lambda x: x)
        scores = np.zeros(self.n)
        max_df = max(MAX_DF_SHARE * self.n, 64.0)
        for t in query_terms(text):
            p = self.postings.get(t)
            if p is None or len(p[0]) > max_df:
                continue
            docs, tfc, tfs = p
            df = len(docs)
            idf = r(np.log(1.0 + (self.n - df + 0.5) / (df + 0.5)))
            tfb = r(tfc + SIG_WEIGHT * tfs)
            part = r(r(idf * r(tfb * (K1 + 1.0))) / r(tfb + r(self._len_norm(docs))))
            scores[docs] = r(scores[docs] + part)
        if kind is not None:
            scores = np.where(self.kinds == kind, r(scores * KIND_BOOST), scores)
        return scores

    def exact(self, identifier: str, kind: str | None, rounding=None) -> np.ndarray:
        """Scores of every chunk for the exact lookup of ``identifier``."""
        r = rounding or (lambda x: x)
        scores = np.zeros(self.n)
        target = exact_target(identifier)
        p = self.postings.get(target) if target else None
        if p is None:
            return scores
        docs, tfc, tfs = p
        ln = r(self._len_norm(docs))
        sat_s = np.where(tfs > 0, r(r(tfs * (K1 + 1.0)) / r(tfs + ln)), 0.0)
        sat_c = np.where(tfc > 0, r(r(tfc * (K1 + 1.0)) / r(tfc + ln)), 0.0)
        scores[docs] = r(r(EXACT_SIG_WEIGHT * sat_s) + sat_c)
        if kind is not None:
            scores = np.where(self.kinds == kind, scores, 0.0)
        return scores

    def scanned_postings(self, text: str) -> int:
        """Postings of the BM25 terms of ``text`` that are not skipped."""
        max_df = max(MAX_DF_SHARE * self.n, 64.0)
        return sum(d for d in (self.df(t) for t in query_terms(text)) if d <= max_df)
