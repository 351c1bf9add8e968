"""Frozen copies of the host ranking arithmetic of the measured program's
serving read plane: query analysis (identifiers, structural intent,
operators, question stripping, test and doc paths), the adaptive RRF
constants, three-way reciprocal rank fusion and the boosts. Plain Python,
written as loops; it imports nothing of the program."""

from __future__ import annotations

import re

_STOP_PASCAL = {"Find", "Show", "Get", "Where", "How", "What", "All"}
_INTENT_KINDS = [("class ", "Class"), ("struct ", "Struct"), ("function ", "Function"),
                 ("fn ", "Function"), ("method ", "Method"), ("enum ", "Enum"),
                 ("interface ", "Interface"), ("trait ", "Trait")]
EXACT_RRF_K = 5.0
TEST_PATH_PENALTY = 1.0 / 1.15
DOC_PATH_PENALTY = 1.0 / 1.15
LANGUAGE_BOOST = 1.2
KIND_BOOST = 1.15

_TOKEN_RE = re.compile(r'(?P<op>(?:(?<=\s)|^)[-+])?(?:"(?P<phrase>[^"]*)"|(?P<word>\S+))')
_IDENTIFIER_WORD_RE = re.compile(r"[A-Za-z_]\w*$")
_TEST_DIR_RE = re.compile(r"(?:^|/)(?:tests?|__tests__|testing|spec)(?:/|$)")
_TEST_FILE_RE = re.compile(r"(?:^|/)(?:test_[^/]*|conftest\.py"
                           r"|[^/]*(?:_test|\.test|\.spec|Test|Tests|Spec)\.[A-Za-z0-9]+)$")
_TEST_WORDS = frozenset({"test", "tests", "testing", "tested", "unittest", "pytest", "spec",
                         "specs", "fixture", "fixtures", "mock", "mocks", "mocking", "conftest",
                         "testcase", "assert", "assertion", "assertions"})
_DOC_DIR_RE = re.compile(r"(?:^|/)(?:docs?|documentation|wiki|man(?:ual)?s?)(?:/|$)")
_DOC_FILE_RE = re.compile(r"\.(?:md|markdown|rst|adoc|asciidoc|txt)$", re.I)
_NON_DOC_TXT_RE = re.compile(
    r"(?:^|/)(?:requirements[^/]*|constraints[^/]*|CMakeLists|robots)\.txt$", re.I)
_DOC_BASENAME_RE = re.compile(
    r"(?:^|/)(?:readme|changelog|changes|license|licence|copying|notice"
    r"|contributing|authors|install|news|todo|faq)"
    r"(?:-[A-Za-z0-9]+)?(?:\.(?:md|markdown|rst|adoc|asciidoc|txt|html?))?$", re.I)
_DOC_WORDS = frozenset({"readme", "documentation", "docs", "doc", "documented", "changelog",
                        "license", "licence", "guide", "tutorial", "manual", "markdown",
                        "installation", "contributing", "faq"})
_QUESTION_WORDS = {"how", "where", "what", "why", "when", "which", "who"}
_QUESTION_FILLER = {"do", "does", "did", "we", "i", "you", "is", "are", "was", "were", "can",
                    "could", "should", "would", "will", "to", "the", "a", "an", "in", "one",
                    "our", "my"}


def detect_identifiers(query: str) -> list[str]:
    out = []
    for token in query.split():
        pascal = token[:1].isupper() and any(c.islower() for c in token) \
            and token not in _STOP_PASCAL
        snake = "_" in token and all(c.isalnum() or c == "_" for c in token)
        camel = token[:1].islower() and any(c.isupper() for c in token)
        if pascal or snake or camel:
            out.append(token)
    return out


def contains_identifier(q: str) -> bool:
    n = len(q)
    if any(q[i].isupper() and (q[i + 1].islower() or q[i + 1].isdigit()) for i in range(n - 1)):
        return True
    if any(q[i] == "_" and q[i - 1].islower() and q[i + 1].islower() for i in range(1, n - 1)):
        return True
    return any(q[i].islower() and q[i + 1].isupper() for i in range(n - 1))


def structural_kind(query: str) -> str | None:
    """The chunk kind a query asks for, only with an identifier in it."""
    if not contains_identifier(query):
        return None
    low = query.lower()
    for kw, kind in _INTENT_KINDS:
        if kw in low:
            return kind
    return None


def rrf_ks(query: str) -> tuple[float, float]:
    if detect_identifiers(query):
        return 12.0, 28.0
    if structural_kind(query) is not None:
        return 15.0, 25.0
    return 20.0, 20.0


def parse_operators(query: str) -> tuple[str, list, list]:
    requirements, exclusions, keep = [], [], []
    for m in _TOKEN_RE.finditer(query):
        op, ph, w = m.group("op"), m.group("phrase"), m.group("word")
        if ph is not None:
            ph = ph.strip()
            if not ph:
                continue
            if op == "-":
                exclusions.append((ph, True))
            else:
                requirements.append((ph, True))
                keep.append(ph)
        elif op and w and _IDENTIFIER_WORD_RE.match(w):
            (exclusions if op == "-" else requirements).append((w, False))
            if op != "-":
                keep.append(w)
        else:
            keep.append(m.group(0))
    return " ".join(keep), requirements, exclusions


def serving_fetch(query: str, limit: int) -> int:
    _r, phrases, exclusions = parse_operators(query)
    return max(limit * 3, 200) if phrases or exclusions else limit * 3


def strip_question(query: str) -> str | None:
    q = query.strip().rstrip("?").strip()
    toks = q.split()
    if len(toks) < 3 or toks[0].lower() not in _QUESTION_WORDS:
        return None
    i = 1
    while i < len(toks) and toks[i].lower() in _QUESTION_FILLER:
        i += 1
    core = " ".join(toks[i:])
    return core if core and core != q else None


def bm25_text(query: str) -> str:
    """The text whose tokens select a query's BM25 terms."""
    retrieval = parse_operators(query)[0]
    core = strip_question(retrieval)
    return core if core is not None else retrieval


def _matcher(text: str, is_phrase: bool):
    t = text.casefold()
    return t if is_phrase else re.compile(rf"(?<![a-z0-9_]){re.escape(t)}(?![a-z0-9_])")


def passes_operators(content: str, query: str) -> bool:
    _r, req, excl = parse_operators(query)
    body = content.casefold()

    def hit(m):
        return (m in body) if isinstance(m, str) else bool(m.search(body))

    if req and not all(hit(_matcher(*r)) for r in req):
        return False
    return not any(hit(_matcher(*e)) for e in excl)


def is_test_path(path: str) -> bool:
    p = path.replace("\\", "/")
    return bool(_TEST_DIR_RE.search(p) or _TEST_FILE_RE.search(p))


def is_doc_path(path: str) -> bool:
    p = path.replace("\\", "/")
    if _NON_DOC_TXT_RE.search(p):
        return False
    return bool(_DOC_FILE_RE.search(p) or _DOC_DIR_RE.search(p) or _DOC_BASENAME_RE.search(p))


def wants(query: str, words: frozenset) -> bool:
    return any(t in words for t in re.findall(r"[a-z]+", query.casefold()))


def fuse(vector, fts, exact, vector_k: float, fts_k: float) -> list[tuple[int, float]]:
    """Reciprocal rank fusion of three [(chunk id, score)] lists: each
    entry adds 1 / (k + rank); ordered by fused score, then chunk id."""
    acc: dict[int, float] = {}
    for lst, k in ((vector, vector_k), (fts, fts_k), (exact, EXACT_RRF_K)):
        for rank, (cid, _s) in enumerate(lst):
            acc[int(cid)] = acc.get(int(cid), 0.0) + 1.0 / (k + float(rank + 1))
    return sorted(acc.items(), key=lambda kv: (-kv[1], kv[0]))


def rank(query: str, limit: int, vector, fts, exact, chunk_of, primary_language: str | None):
    """The ranked [(score, chunk id)] of one query from its three candidate
    lists; ``chunk_of(cid)`` gives (path, kind, language, content)."""
    kind = structural_kind(query)
    vk, fk = rrf_ks(query)
    _r, req, excl = parse_operators(query)
    tests, docs = wants(query, _TEST_WORDS), wants(query, _DOC_WORDS)
    scored = []
    for cid, rrf in fuse(vector, fts, exact, vk, fk):
        path, ckind, lang, content = chunk_of(cid)
        if (req or excl) and not passes_operators(content, query):
            continue
        score = rrf
        if primary_language and lang == primary_language:
            score *= LANGUAGE_BOOST
        if kind and ckind == kind:
            score *= KIND_BOOST
        if not tests and is_test_path(path):
            score *= TEST_PATH_PENALTY
        if not docs and is_doc_path(path):
            score *= DOC_PATH_PENALTY
        scored.append((score, cid))
    scored.sort(key=lambda x: -x[0])
    return scored[:limit]
