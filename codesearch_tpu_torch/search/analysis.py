"""Query analysis helpers (behavioral parity with src/search/mod.rs:130-406):
identifier detection, structural intent, query expansion (≤9 variants),
adaptive RRF-k selection."""

from __future__ import annotations

from ..chunker import ChunkKind

_STOP_PASCAL = {"Find", "Show", "Get", "Where", "How", "What", "All"}


def detect_identifiers(query: str) -> list[str]:
    out = []
    for token in query.split():
        is_pascal = (
            token[:1].isupper()
            and any(c.islower() for c in token)
            and token not in _STOP_PASCAL
        )
        is_snake = "_" in token and all(c.isalnum() or c == "_" for c in token)
        is_camel = token[:1].islower() and any(c.isupper() for c in token)
        if is_pascal or is_snake or is_camel:
            out.append(token)
    return out


def contains_identifier(query: str) -> bool:
    chars = query
    n = len(chars)
    for i in range(n - 1):
        if chars[i].isupper() and (chars[i + 1].islower() or chars[i + 1].isdigit()):
            return True
    for i in range(1, n - 1):
        if chars[i] == "_" and chars[i - 1].islower() and chars[i + 1].islower():
            return True
    for i in range(n - 1):
        if chars[i].islower() and chars[i + 1].isupper():
            return True
    return False


_INTENT_KINDS = [
    ("class ", ChunkKind.CLASS),
    ("struct ", ChunkKind.STRUCT),
    ("function ", ChunkKind.FUNCTION),
    ("fn ", ChunkKind.FUNCTION),
    ("method ", ChunkKind.METHOD),
    ("enum ", ChunkKind.ENUM),
    ("interface ", ChunkKind.INTERFACE),
    ("trait ", ChunkKind.TRAIT),
]


def detect_structural_intent(query: str) -> ChunkKind | None:
    """Kind boost only when BOTH a structural keyword AND an identifier
    are present (prevents boosting ALL enums for the query 'enum')."""
    if not contains_identifier(query):
        return None
    low = query.lower()
    for kw, kind in _INTENT_KINDS:
        if kw in low:
            return kind
    return None


_ABBREVIATIONS = [
    ("auth", "authentication"),
    ("config", "configuration"),
    ("db", "database"),
    ("conn", "connection"),
    ("err", "error"),
    ("msg", "message"),
]

MAX_TOTAL_VARIANTS = 9


import re as _re


_TOKEN_RE = _re.compile(
    r'(?P<op>(?:(?<=\s)|^)[-+])?(?:"(?P<phrase>[^"]*)"|(?P<word>\S+))'
)
_IDENTIFIER_WORD_RE = _re.compile(r"[A-Za-z_]\w*$")


def parse_operators(query: str) -> tuple[str, list, list]:
    """One positional, quote-aware scan of the query's operator syntax
    (the useful subset of tantivy's QueryParser, fts/tantivy_store.rs:
    403-429): quoted spans and ``+word`` are Must requirements, ``-word``
    / ``-"a phrase"`` are MustNot exclusions. A bare-word operator must
    look like an identifier — ``->``, ``--flag`` or ``+1`` are code, not
    operators, and an operator character INSIDE a quoted phrase is
    literal text. Returns (retrieval_text, requirements, exclusions):
    retrieval_text has operators stripped (exclusions removed entirely
    so they cannot attract the very candidates they reject; phrase
    quotes and ``+`` dropped), requirements are [(text, is_phrase)]
    (phrases match by containment, words on token boundaries), and
    exclusions mirror that. The index is position-free, so all
    constraints apply as content filters at hit materialization
    (passes_operators)."""
    requirements: list[tuple[str, bool]] = []
    exclusions: list[tuple[str, bool]] = []
    keep: list[str] = []
    for m in _TOKEN_RE.finditer(query):
        op = m.group("op")
        ph = m.group("phrase")
        w = m.group("word")
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
            if op == "-":
                exclusions.append((w, False))
            else:
                requirements.append((w, False))
                keep.append(w)
        else:
            keep.append(m.group(0))
    return " ".join(keep), requirements, exclusions


def detect_phrases(query: str) -> list[str]:
    """Required exact phrases of ``query`` (see parse_operators)."""
    return [t for t, is_ph in parse_operators(query)[1] if is_ph]


def detect_exclusions(query: str) -> list[tuple[str, bool]]:
    """MustNot constraints of ``query`` (see parse_operators)."""
    return parse_operators(query)[2]


def _compile_constraints(constraints: list) -> list:
    """(text, is_phrase) → matcher: phrases fold to containment strings,
    words to token-boundary patterns."""
    out = []
    for text, is_phrase in constraints:
        t = text.casefold()
        if is_phrase:
            out.append(t)
        else:
            out.append(_re.compile(
                rf"(?<![a-z0-9_]){_re.escape(t)}(?![a-z0-9_])"
            ))
    return out


def compile_operators(requirements: list, exclusions: list) -> tuple:
    """Pre-fold/pre-compile the per-query constraint set ONCE — the
    filter runs per materialized candidate (hundreds per query on one
    host core)."""
    return _compile_constraints(requirements), _compile_constraints(exclusions)


def _matches(matcher, body: str) -> bool:
    return (matcher in body) if isinstance(matcher, str) \
        else bool(matcher.search(body))


def passes_operators(content: str, req_matchers, excl_matchers) -> bool:
    """Does a candidate's content satisfy the compiled constraint set?
    ONE implementation shared by the session pipeline and the serving
    read plane, so operator semantics cannot drift between surfaces."""
    body = content.casefold()
    if req_matchers and not all(_matches(mt, body) for mt in req_matchers):
        return False
    return not any(_matches(mt, body) for mt in excl_matchers)


# -- test-code down-weight (beyond the reference) ---------------------------
# "how do we detect binary files" should land on the implementation, not the
# test that exercises it — test files restate query terms ("test detect
# binary") and routinely outrank the code they cover. Demote test-convention
# paths at the boost stage UNLESS the query itself asks about tests. The
# factor (1/1.15) mirrors the kind boost's magnitude, so an intent-matched
# implementation cleanly outranks an intent-matched test without burying
# tests entirely.
TEST_PATH_PENALTY = 1.0 / 1.15

_TEST_DIR_RE = _re.compile(r"(?:^|/)(?:tests?|__tests__|testing|spec)(?:/|$)")
_TEST_FILE_RE = _re.compile(
    r"(?:^|/)(?:test_[^/]*|conftest\.py"
    r"|[^/]*(?:_test|\.test|\.spec|Test|Tests|Spec)\.[A-Za-z0-9]+)$"
)
_TEST_INTENT_WORDS = frozenset({
    "test", "tests", "testing", "tested", "unittest", "pytest", "spec",
    "specs", "fixture", "fixtures", "mock", "mocks", "mocking", "conftest",
    "testcase", "assert", "assertion", "assertions",
})


def is_test_path(path: str) -> bool:
    """Does ``path`` follow a test-code convention? (tests/ directories,
    test_*.py / conftest.py, *_test.go, *.test.ts / *.spec.ts, FooTest.java
    — lowercase '...test.py' like 'latest.py' is NOT a test.)"""
    p = path.replace("\\", "/")
    return bool(_TEST_DIR_RE.search(p) or _TEST_FILE_RE.search(p))


def query_wants_tests(query: str) -> bool:
    """Is the query itself about tests? (then test files are the answer
    and the demotion is skipped)."""
    return any(t in _TEST_INTENT_WORDS
               for t in _re.findall(r"[a-z]+", query.casefold()))


# -- documentation down-weight (beyond the reference) -----------------------
# BM25 loves prose: a documentation-phrased query ("how does incremental
# indexing work") restates README/guide sentences verbatim, so doc files can
# outrank the code that implements the behavior — a weakness class the
# reference records against itself (benchmarks/improvement-plan.md). Demote
# doc-convention paths at the boost stage UNLESS the query asks about
# documentation. Same magnitude as the test demotion: code with matched
# language/kind boosts cleanly clears a doc hit without burying docs (they
# remain the top answer when nothing in code matches).
DOC_PATH_PENALTY = 1.0 / 1.15

_DOC_DIR_RE = _re.compile(r"(?:^|/)(?:docs?|documentation|wiki|man(?:ual)?s?)(?:/|$)")
_DOC_FILE_RE = _re.compile(r"\.(?:md|markdown|rst|adoc|asciidoc|txt)$", _re.I)
# .txt files that are build/dependency manifests, not prose — never demote.
_NON_DOC_TXT_RE = _re.compile(
    r"(?:^|/)(?:requirements[^/]*|constraints[^/]*|CMakeLists|robots)\.txt$",
    _re.I,
)
# A doc basename is the convention word alone (README, INSTALL), optionally
# a single hyphenated variant (LICENSE-MIT), optionally ONE doc-or-no
# extension (README.md, CHANGELOG.rst). Underscore joiners and code
# extensions mean a source file (readme_parser.go, install.sh.c) — the
# stem must end at the convention word, not merely start with it.
_DOC_BASENAME_RE = _re.compile(
    r"(?:^|/)(?:readme|changelog|changes|license|licence|copying|notice"
    r"|contributing|authors|install|news|todo|faq)"
    r"(?:-[A-Za-z0-9]+)?(?:\.(?:md|markdown|rst|adoc|asciidoc|txt|html?))?$",
    _re.I,
)
_DOC_INTENT_WORDS = frozenset({
    "readme", "documentation", "docs", "doc", "documented", "changelog",
    "license", "licence", "guide", "tutorial", "manual", "markdown",
    "installation", "contributing", "faq",
})


def is_doc_path(path: str) -> bool:
    """Does ``path`` follow a documentation convention? (docs/ directories,
    *.md / *.rst / *.txt, README / CHANGELOG / LICENSE basenames in any
    case and extension.)"""
    p = path.replace("\\", "/")
    if _NON_DOC_TXT_RE.search(p):
        return False
    return bool(
        _DOC_FILE_RE.search(p)
        or _DOC_DIR_RE.search(p)
        or _DOC_BASENAME_RE.search(p)
    )


def query_wants_docs(query: str) -> bool:
    """Is the query itself about documentation? (then doc files are the
    answer and the demotion is skipped)."""
    return any(t in _DOC_INTENT_WORDS
               for t in _re.findall(r"[a-z]+", query.casefold()))


_QUESTION_WORDS = {"how", "where", "what", "why", "when", "which", "who"}
_QUESTION_FILLER = {
    "do", "does", "did", "we", "i", "you", "is", "are", "was", "were",
    "can", "could", "should", "would", "will", "to", "the", "a", "an",
    "in", "one", "our", "my",
}


def strip_question(query: str) -> str | None:
    """Interrogative scaffolding dilutes both retrieval legs: "how do we
    detect binary files" scores chunks containing "how"/"do"/"we" and
    spends half the hash-embedding mass on them. When the query starts
    with a question word, return the content core ("detect binary files");
    None otherwise. The core rides as an extra vector variant AND replaces
    the BM25 term selection (beyond the reference, whose labeled set shows
    exactly this weakness — benchmarks/improvement-plan.md Cat A)."""
    q = query.strip().rstrip("?").strip()
    toks = q.split()
    if len(toks) < 3 or toks[0].lower() not in _QUESTION_WORDS:
        return None
    i = 1
    while i < len(toks) and toks[i].lower() in _QUESTION_FILLER:
        i += 1
    core = " ".join(toks[i:])
    return core if core and core != q else None


def expand_query(query: str) -> list[str]:
    variants = [query]
    core = strip_question(query)
    if core is not None:
        variants.append(core)
    if len(query) < 4 or len(query) > 50:
        return variants
    looks_like_function = "_" in query and " " not in query
    looks_like_type = query[:1].isupper() and " " not in query
    if looks_like_function:
        variants += [f"fn {query}", f"async fn {query}", f"pub fn {query}",
                     f"{query} method", f"Function: {query}"]
    if looks_like_type:
        variants += [f"struct {query}", f"impl {query}", f"enum {query}",
                     f"class {query}", f"Struct: {query}"]
    is_single_concept = (
        "_" not in query and " " not in query and query[:1].islower()
    )
    if is_single_concept:
        variants += [f"fn {query}", f"{query} function"]
    abbrev_count = 0
    for abbr, full in _ABBREVIATIONS:
        if abbrev_count >= 2:
            break
        if abbr in query:
            expanded = query.replace(abbr, full)
            if expanded != query:
                variants.append(expanded)
                abbrev_count += 1
    return variants[:MAX_TOTAL_VARIANTS]


def adapt_rrf_k(query: str) -> tuple[float, float]:
    """(vector_k, fts_k) by query type (search/mod.rs:392-406)."""
    has_identifiers = bool(detect_identifiers(query))
    has_structural = detect_structural_intent(query) is not None
    if has_identifiers:
        return (12.0, 28.0)
    if has_structural:
        return (15.0, 25.0)
    return (20.0, 20.0)
