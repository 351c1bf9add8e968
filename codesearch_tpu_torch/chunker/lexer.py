"""Lexical masking: blank out strings and comments, preserving layout.

The structural scanner operates on a *masked* copy of the source where every
character inside a string literal or comment is replaced by a space (newlines
kept), so that brace matching and definition-header regexes never trip on
braces/keywords inside literals. Two lexer families cover the supported
languages:

- ``c`` family (Rust, C, C++, C#, Go, Java, JavaScript, TypeScript):
  ``//`` line comments, ``/* */`` block comments (nesting for Rust),
  double-quoted strings with escapes, char literals, Rust raw strings
  ``r#"…"#``, Go raw backtick strings, JS/TS template literals (masked
  whole, including interpolations), Rust lifetimes (``'a`` is not a char).
- ``python`` family: ``#`` comments, single/double quoted strings with
  escapes, triple-quoted strings, prefix letters (r/b/f/u).
"""

from __future__ import annotations


def mask_c_family(
    src: str,
    *,
    nested_block_comments: bool = False,
    raw_strings_rust: bool = False,
    backtick_strings: bool = False,
    template_literals: bool = False,
    lifetimes: bool = False,
    hash_line_comments: bool = False,
) -> str:
    """Return src with string/comment chars replaced by spaces."""
    n = len(src)
    out = list(src)
    i = 0

    def blank(a: int, b: int) -> None:
        for k in range(a, min(b, n)):
            if out[k] != "\n":
                out[k] = " "

    while i < n:
        c = src[i]
        nxt = src[i + 1] if i + 1 < n else ""
        if c == "/" and nxt == "/":
            j = src.find("\n", i)
            j = n if j == -1 else j
            blank(i, j)
            i = j
        elif c == "#" and hash_line_comments:
            j = src.find("\n", i)
            j = n if j == -1 else j
            blank(i, j)
            i = j
        elif c == "/" and nxt == "*":
            depth = 1
            j = i + 2
            while j < n and depth > 0:
                if nested_block_comments and src[j : j + 2] == "/*":
                    depth += 1
                    j += 2
                elif src[j : j + 2] == "*/":
                    depth -= 1
                    j += 2
                else:
                    j += 1
            blank(i, j)
            i = j
        elif raw_strings_rust and c == "r" and nxt in ('"', "#"):
            # r"..."  or  r#"..."#  (any number of #)
            j = i + 1
            hashes = 0
            while j < n and src[j] == "#":
                hashes += 1
                j += 1
            if j < n and src[j] == '"':
                close = '"' + "#" * hashes
                k = src.find(close, j + 1)
                k = n if k == -1 else k + len(close)
                blank(i + 1, k)  # keep the 'r' so regexes can't match inside
                i = k
            else:
                i += 1
        elif c == '"':
            j = i + 1
            while j < n:
                if src[j] == "\\":
                    j += 2
                elif src[j] == '"' or src[j] == "\n":
                    j += 1
                    break
                else:
                    j += 1
            blank(i + 1, j - 1)
            i = j
        elif backtick_strings and c == "`":
            j = src.find("`", i + 1)
            j = n if j == -1 else j + 1
            blank(i + 1, j - 1)
            i = j
        elif template_literals and c == "`":
            j = i + 1
            while j < n:
                if src[j] == "\\":
                    j += 2
                elif src[j] == "`":
                    j += 1
                    break
                else:
                    j += 1
            blank(i + 1, j - 1)
            i = j
        elif c == "'":
            if lifetimes:
                # Rust: 'a lifetime vs 'x' char literal vs '\n' escape
                if nxt == "\\":
                    j = i + 2
                    while j < n and src[j] != "'":
                        j += 1
                    blank(i + 1, j)
                    i = j + 1
                elif i + 2 < n and src[i + 2] == "'":
                    blank(i + 1, i + 2)
                    i = i + 3
                else:
                    i += 1  # lifetime — leave alone
            else:
                j = i + 1
                while j < n:
                    if src[j] == "\\":
                        j += 2
                    elif src[j] == "'" or src[j] == "\n":
                        j += 1
                        break
                    else:
                        j += 1
                blank(i + 1, j - 1)
                i = j
        else:
            i += 1
    return "".join(out)


def mask_python(src: str) -> str:
    n = len(src)
    out = list(src)
    i = 0

    def blank(a: int, b: int) -> None:
        for k in range(a, min(b, n)):
            if out[k] != "\n":
                out[k] = " "

    while i < n:
        c = src[i]
        if c == "#":
            j = src.find("\n", i)
            j = n if j == -1 else j
            blank(i, j)
            i = j
        elif c in "\"'":
            # string start; check for triple
            q = c
            if src[i : i + 3] == q * 3:
                close = src.find(q * 3, i + 3)
                close = n if close == -1 else close + 3
                blank(i + 3, close - 3)
                i = close
            else:
                j = i + 1
                while j < n:
                    if src[j] == "\\":
                        j += 2
                    elif src[j] == q or src[j] == "\n":
                        j += 1
                        break
                    else:
                        j += 1
                blank(i + 1, j - 1)
                i = j
        else:
            i += 1
    return "".join(out)


def mask_source(language_family: str, src: str) -> str:
    # native fast path (byte-level; only safe when byte==char positions)
    if src.isascii():
        from ..native import mask_native

        masked = mask_native(language_family, src)
        if masked is not None:
            return masked
    if language_family == "python":
        return mask_python(src)
    if language_family == "rust":
        return mask_c_family(
            src, nested_block_comments=True, raw_strings_rust=True, lifetimes=True
        )
    if language_family == "go":
        return mask_c_family(src, backtick_strings=True)
    if language_family in ("js", "ts"):
        return mask_c_family(src, template_literals=True)
    if language_family in ("kotlin", "swift"):
        # both languages NEST /* */ block comments (Python-only path: the
        # native tier has no family id for these, so mask_native defers)
        return mask_c_family(src, nested_block_comments=True)
    if language_family == "php":
        # '#' starts a line comment in addition to '//' and '/* */'
        return mask_c_family(src, hash_line_comments=True)
    # c, cpp, csharp, java
    return mask_c_family(src)


def line_offsets(src: str) -> list[int]:
    """Start offset of each line (line i spans offs[i]..offs[i+1])."""
    offs = [0]
    for i, ch in enumerate(src):
        if ch == "\n":
            offs.append(i + 1)
    return offs
