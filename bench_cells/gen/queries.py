"""Seeded agent queries over a corpus's own vocabulary: natural-language
questions, bare identifiers that a chunk defines, and mixed questions about
an identifier. Every query of a set is distinct."""

from __future__ import annotations

import itertools
import random

_QUESTIONS = ("how do we {}", "where is the {}", "what does {}", "how does the {} work",
              "find the code that {}", "which function {}", "where do we {}", "{}")
_MIXED = ("where is {} called", "who calls {}", "how is {} used", "what does {} return",
          "function {} {}", "method {} that {}", "{} {} handling", "where does {} {}")


def make_queries(seed: int, words: list[str], weights, names: list[str], n: int,
                 mix: dict, words_range: tuple[int, int]) -> list[str]:
    """``n`` distinct queries: ``mix`` gives the shares of ``question``,
    ``identifier`` and ``mixed`` (the counts rounded, in seeded order);
    questions hold ``words_range`` words in all, drawn from ``words`` with
    ``weights``; identifiers are ``names``, none used twice."""
    rnd = random.Random(seed)
    cum = list(itertools.accumulate(weights))    # what ``choices`` would sum each call
    n_ident = round(n * mix["identifier"])
    n_mixed = round(n * mix["mixed"])
    kinds = ["identifier"] * n_ident + ["mixed"] * n_mixed + ["question"] * (n - n_ident - n_mixed)
    rnd.shuffle(kinds)
    distinct = sorted(set(names))
    if n_ident + n_mixed > len(distinct):
        raise ValueError(f"{n_ident + n_mixed} identifier queries, {len(distinct)} names")
    pool = rnd.sample(distinct, n_ident + n_mixed)
    out: list[str] = []
    seen: set[str] = set()
    lo, hi = words_range
    for kind in kinds:
        while True:
            if kind == "identifier":
                q = pool.pop()
            elif kind == "mixed":
                q = rnd.choice(_MIXED).format(pool.pop(), *rnd.choices(words, cum_weights=cum, k=1))
            else:
                form = rnd.choice(_QUESTIONS)
                glue = len(form.split()) - 1
                body = rnd.choices(words, cum_weights=cum, k=max(1, rnd.randint(lo, hi) - glue))
                q = form.format(" ".join(body))
            if q not in seen:
                break
        seen.add(q)
        out.append(q)
    return out
