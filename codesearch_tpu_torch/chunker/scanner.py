"""Structural scanner: recover the definition tree from masked source.

Produces ``DefNode`` trees (kind, name, line span, children) by scanning
lexically masked source (see lexer.py) with per-language header rules
(langspec.py). Brace languages use statement-start matching + brace span
tracking; Python uses indentation analysis. Nested definitions (methods in
classes/impls, inner classes) come from recursing into recognized bodies.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from . import ChunkKind
from .langspec import BRACE, BRACE_OR_SEMI, SEMI, CallableSpec, LangSpec

_WINDOW = 800          # max chars of masked text a def header may span
_MAX_HEADER_SCAN = 6000  # max chars to scan for body-open after a header


@dataclass
class DefNode:
    kind: ChunkKind
    name: str | None
    start_line: int          # 0-based inclusive
    end_line: int            # exclusive
    start_off: int           # absolute char offset of header start
    body_open_off: int       # offset of '{' / ':' opening the body (or end_off)
    end_off: int             # absolute char offset one past the span
    children: list["DefNode"] = field(default_factory=list)


def _line_of(offsets: list[int], off: int) -> int:
    """Index of the line containing char offset ``off`` (binary search)."""
    lo, hi = 0, len(offsets) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if offsets[mid] <= off:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _find_matching_brace(masked: str, open_off: int, hi: int) -> int:
    """Offset of the '}' matching the '{' at open_off, or hi-1 if unbalanced."""
    depth = 0
    for i in range(open_off, hi):
        c = masked[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return i
    return hi - 1


def _find_body_span(
    masked: str, start: int, hi: int, body_style: str
) -> tuple[int, int] | None:
    """Find (body_open_off, end_off) for a def whose header starts at start.

    end_off is one past the closing '}' or ';'. Returns None on failure.
    """
    limit = min(hi, start + _MAX_HEADER_SCAN)
    if body_style == SEMI:
        depth = 0
        for i in range(start, limit):
            c = masked[i]
            if c == "{":
                depth += 1
            elif c == "}":
                depth -= 1
            elif c == ";" and depth <= 0:
                return i, i + 1
        return None
    # BRACE / BRACE_OR_SEMI: first '{' opens the body; for BRACE_OR_SEMI a
    # ';' reached first ends the definition (unit struct, trait method decl).
    for i in range(start, limit):
        c = masked[i]
        if c == "{":
            close = _find_matching_brace(masked, i, hi)
            return i, close + 1
        if c == ";" and body_style == BRACE_OR_SEMI:
            return i, i + 1
    return None


_CALLABLE_NAME_RE = re.compile(r"([\w~$]+)[ \t]*\(")
_CALLABLE_PRE_OK = re.compile(r"^[\w\s\*&<>:,\[\].~$@]*$")
_CALLABLE_TRAILER_BAD = frozenset(";={}")


def _try_callable(
    masked: str,
    line_start: int,
    hi: int,
    spec: CallableSpec,
) -> tuple[str, int, int, int] | None:
    """Try to match a C-family function/method definition at a line start.

    Returns (name, header_start, body_open_off, end_off) or None.
    """
    window_end = min(hi, line_start + _WINDOW)
    window = masked[line_start:window_end]
    m = _CALLABLE_NAME_RE.search(window)
    if not m:
        return None
    name = m.group(1)
    if name in spec.keyword_blacklist:
        return None
    pre = window[: m.start()]
    if not _CALLABLE_PRE_OK.match(pre):
        return None
    if pre.split() and pre.split()[0] in spec.keyword_blacklist:
        return None
    # balance parens from the '('
    open_paren = line_start + m.end() - 1
    depth = 0
    close_paren = -1
    for i in range(open_paren, min(hi, open_paren + _MAX_HEADER_SCAN)):
        c = masked[i]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                close_paren = i
                break
    if close_paren < 0:
        return None
    # trailer up to '{' may not contain ; = { } (filters decls/calls/inits);
    # ctor-init lists, const/noexcept/throws/trailing-return are fine.
    for i in range(close_paren + 1, min(hi, close_paren + _MAX_HEADER_SCAN)):
        c = masked[i]
        if c == "{":
            close = _find_matching_brace(masked, i, hi)
            return name, line_start, i, close + 1
        if c in _CALLABLE_TRAILER_BAD:
            return None
    return None


_IMPL_NAME_CLEAN = re.compile(r"\s+")


def _extract_impl_name(src: str, header_start: int, body_open: int) -> str | None:
    """Rust impl: name is the (collapsed) header text after 'impl'."""
    text = src[header_start:body_open]
    idx = text.find("impl")
    if idx < 0:
        return None
    text = text[idx + 4 :]
    # drop leading generics <...>
    text = re.sub(r"^\s*<[^>]*>", "", text, count=1)
    text = text.split(" where ")[0]
    text = _IMPL_NAME_CLEAN.sub(" ", text).strip()
    return text or None


def scan_brace_language(
    src: str,
    masked: str,
    offsets: list[int],
    spec: LangSpec,
    lo_line: int = 0,
    hi_line: int | None = None,
    in_type_body: bool = False,
) -> list[DefNode]:
    n_lines = len(offsets)
    hi_line = n_lines if hi_line is None else hi_line
    hi_off = offsets[hi_line] if hi_line < n_lines else len(src)
    nodes: list[DefNode] = []
    depth = 0
    line = lo_line
    while line < hi_line:
        lstart = offsets[line]
        lend = offsets[line + 1] if line + 1 < n_lines else len(src)
        mline = masked[lstart:lend]
        stripped = mline.strip()
        if depth == 0 and stripped and not _is_attribute_line(stripped, spec):
            node = _try_rules_at(src, masked, offsets, spec, line, lstart, hi_off, in_type_body)
            if node is not None:
                nodes.append(node)
                line = node.end_line
                continue
        depth += mline.count("{") - mline.count("}")
        if depth < 0:
            depth = 0
        line += 1
    return nodes


def _is_attribute_line(stripped_masked: str, spec: LangSpec) -> bool:
    return any(stripped_masked.startswith(p) for p in spec.attribute_prefixes)


def _try_rules_at(
    src: str,
    masked: str,
    offsets: list[int],
    spec: LangSpec,
    line: int,
    lstart: int,
    hi_off: int,
    in_type_body: bool,
) -> DefNode | None:
    window = masked[lstart : min(hi_off, lstart + _WINDOW)]
    for rule in spec.rules:
        m = rule.regex.match(window)
        if not m:
            continue
        header_start = lstart + _leading_ws(window)
        span = _find_body_span(masked, lstart + m.start(), hi_off, rule.body)
        if span is None:
            continue
        body_open, end_off = span
        name = m.groupdict().get("name")
        if name is None and rule.kind is ChunkKind.IMPL:
            name = _extract_impl_name(src, header_start, body_open)
        kind = rule.kind
        if in_type_body and rule.method_kind is not None:
            kind = rule.method_kind
        end_line = _line_of(offsets, max(end_off - 1, lstart)) + 1
        node = DefNode(
            kind=kind,
            name=name,
            start_line=line,
            end_line=end_line,
            start_off=header_start,
            body_open_off=body_open,
            end_off=end_off,
        )
        if rule.recurse and masked[body_open : body_open + 1] == "{":
            body_first_line = _line_of(offsets, body_open) + 1
            body_last_line = _line_of(offsets, end_off - 1)
            if body_first_line < body_last_line:
                node.children = scan_brace_language(
                    src, masked, offsets, spec,
                    lo_line=body_first_line, hi_line=body_last_line,
                    in_type_body=True,
                )
        return node
    if spec.callable_spec is not None:
        cs = spec.callable_spec
        if not cs.only_in_type_body or in_type_body:
            hit = _try_callable(masked, lstart, hi_off, cs)
            if hit is not None:
                name, hstart, body_open, end_off = hit
                end_line = _line_of(offsets, max(end_off - 1, lstart)) + 1
                return DefNode(
                    kind=cs.method_kind if in_type_body else cs.kind,
                    name=name,
                    start_line=line,
                    end_line=end_line,
                    start_off=hstart + _leading_ws(masked[hstart:hstart + 80]),
                    body_open_off=body_open,
                    end_off=end_off,
                )
    return None


def _leading_ws(s: str) -> int:
    return len(s) - len(s.lstrip(" \t"))


# ---------------------------------------------------------------------------
# Python: indentation-based scanning
# ---------------------------------------------------------------------------

_PY_DEF_RE = re.compile(r"^([ \t]*)(async[ \t]+def|def|class)[ \t]+(\w+)")


def scan_python(
    src: str,
    masked: str,
    offsets: list[int],
) -> list[DefNode]:
    lines = masked.split("\n")
    raw_lines = src.split("\n")
    n = len(lines)

    # 1. find all def/class starts anywhere, with their indent
    starts: list[tuple[int, int, str, str]] = []  # (line, indent, kw, name)
    for i, ml in enumerate(lines):
        m = _PY_DEF_RE.match(ml)
        if m:
            indent = len(m.group(1).expandtabs(8))
            kw = "def" if "def" in m.group(2) else "class"
            starts.append((i, indent, kw, m.group(3)))

    def _indent_of(i: int) -> int | None:
        ml = lines[i]
        if not ml.strip():
            return None
        return len((ml[: len(ml) - len(ml.lstrip(" \t"))]).expandtabs(8))

    # 2. compute span of each def: until first non-blank line with indent <= def indent
    nodes_flat: list[DefNode] = []
    for (i, indent, kw, name) in starts:
        # header may span multiple lines (parens); body starts after the line
        # whose masked text ends the header with ':' at paren depth 0
        header_end_line = i
        pdepth = 0
        for j in range(i, n):
            for ch in lines[j]:
                if ch in "([{":
                    pdepth += 1
                elif ch in ")]}":
                    pdepth -= 1
            if pdepth <= 0 and lines[j].rstrip().endswith(":"):
                header_end_line = j
                break
            if j > i + 50:
                header_end_line = i
                break
        end = n
        for j in range(header_end_line + 1, n):
            ind = _indent_of(j)
            if ind is not None and ind <= indent:
                end = j
                break
        # trim trailing blank lines
        while end > i + 1 and not raw_lines[end - 1].strip():
            end -= 1
        start_off = offsets[i] + _leading_ws(raw_lines[i])
        body_open = (
            offsets[header_end_line]
            + len(raw_lines[header_end_line].rstrip())
        )
        end_off = (
            offsets[end - 1] + len(raw_lines[end - 1]) if end > 0 else len(src)
        )
        kind = ChunkKind.CLASS if kw == "class" else ChunkKind.FUNCTION
        nodes_flat.append(
            DefNode(
                kind=kind, name=name, start_line=i, end_line=end,
                start_off=start_off, body_open_off=body_open, end_off=end_off,
            )
        )

    # 3. build containment tree (deepest container wins)
    roots: list[DefNode] = []
    stack: list[DefNode] = []
    for node in nodes_flat:  # already in start order
        while stack and node.start_line >= stack[-1].end_line:
            stack.pop()
        if stack:
            parent = stack[-1]
            if parent.kind is ChunkKind.CLASS and node.kind is ChunkKind.FUNCTION:
                node.kind = ChunkKind.METHOD
            parent.children.append(node)
        else:
            roots.append(node)
        stack.append(node)
    return roots
