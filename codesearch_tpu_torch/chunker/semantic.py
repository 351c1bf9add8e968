"""Semantic chunker: definition chunks + gap chunks + context windows + splitting.

Behavioral parity with the reference SemanticChunker (src/chunker/semantic.rs):
definitions become chunks with breadcrumb context stacks; doc comments and
attributes above a definition are attached (covered); uncovered lines become
classified gap chunks (Imports / ModuleDocs / Comment / Block); each chunk
gets ±N-line context windows; oversized chunks split with overlap and
"[Part i/N]" headers. The parsing layer is the structural scanner instead of
tree-sitter.
"""

from __future__ import annotations

import re
from pathlib import PurePath

from . import Chunk, ChunkKind, DEFAULT_CONTEXT_LINES
from ..fileio.language import Language, detect_language
from .langspec import LangSpec, get_spec
from .lexer import line_offsets, mask_source
from .scanner import DefNode, scan_brace_language, scan_python

_WS = re.compile(r"\s+")
_MAX_SIGNATURE_CHARS = 300


def normalize_path(path: str | PurePath) -> str:
    """Forward-slash path normalization (reference: cache/file_meta.rs:17-25)."""
    return str(path).replace("\\", "/")


class SemanticChunker:
    def __init__(
        self,
        max_chunk_lines: int = 100,
        max_chunk_chars: int = 2000,
        overlap_lines: int = 10,
        context_lines: int = DEFAULT_CONTEXT_LINES,
    ):
        self.max_chunk_lines = max_chunk_lines
        self.max_chunk_chars = max_chunk_chars
        self.overlap_lines = overlap_lines
        self.context_lines = context_lines

    # -- public API ---------------------------------------------------------

    def chunk_file(self, path: str | PurePath, content: str) -> list[Chunk]:
        return self.chunk_semantic(detect_language(path), path, content)

    def chunk_semantic(
        self, language: Language, path: str | PurePath, content: str
    ) -> list[Chunk]:
        spec = get_spec(language)
        if spec is None:
            return self.fallback_chunk(path, content)

        masked = mask_source(spec.family, content)
        offsets = line_offsets(content)
        if spec.python_indent:
            roots = scan_python(content, masked, offsets)
        else:
            roots = scan_brace_language(content, masked, offsets, spec)

        path_str = normalize_path(path)
        source_lines = content.split("\n")
        if source_lines and source_lines[-1] == "":
            source_lines.pop()
        covered = [False] * len(source_lines)

        chunks: list[Chunk] = []
        file_context = [f"File: {path_str}"]
        for node in roots:
            self._visit(node, content, source_lines, spec, file_context, path_str, chunks, covered)

        chunks.extend(self._extract_gaps(source_lines, covered, path_str))
        chunks.sort(key=lambda c: c.start_line)
        self._populate_context_windows(chunks, source_lines)
        out: list[Chunk] = []
        for c in chunks:
            out.extend(self.split_if_needed(c))
        return out

    # -- definition visiting ------------------------------------------------

    def _visit(
        self,
        node: DefNode,
        src: str,
        source_lines: list[str],
        spec: LangSpec,
        context_stack: list[str],
        path_str: str,
        chunks: list[Chunk],
        covered: list[bool],
    ) -> None:
        for i in range(node.start_line, min(node.end_line, len(covered))):
            covered[i] = True
        doc = self._attach_lines_above(node, source_lines, spec, covered)

        signature = self._signature(node, src, spec)
        docstring = doc
        if spec.python_indent and docstring is None:
            docstring = self._python_docstring(node, source_lines)

        label = self._label(node)
        new_context = context_stack + [label]
        content = src[node.start_off : node.end_off]
        # attributes/decorators directly above belong to the definition's
        # content (tree-sitter includes them in the item/decorated node —
        # semantic.rs attaches them; doc comments stay docstring-only)
        attr_start = node.start_line
        while attr_start - 1 >= 0 and any(
            source_lines[attr_start - 1].strip().startswith(p)
            for p in spec.attribute_prefixes
        ):
            attr_start -= 1
        if attr_start < node.start_line:
            prefix = "\n".join(source_lines[attr_start : node.start_line])
            content = prefix + "\n" + content
        chunk = Chunk(
            content=content,
            start_line=attr_start,
            end_line=node.end_line,
            kind=node.kind,
            path=path_str,
            context=new_context,
            signature=signature,
            docstring=docstring,
        )
        chunks.append(chunk)
        for child in node.children:
            self._visit(child, src, source_lines, spec, new_context, path_str, chunks, covered)

    def _label(self, node: DefNode) -> str:
        if node.name:
            return f"{node.kind.label_prefix}: {node.name}"
        return node.kind.value

    def _signature(self, node: DefNode, src: str, spec: LangSpec) -> str | None:
        header = src[node.start_off : node.body_open_off]
        # cut at '=' for value-style defs (const X: T = …)
        eq = _find_top_level_eq(header)
        if eq >= 0:
            header = header[:eq]
        sig = _WS.sub(" ", header).strip().rstrip(":").strip()
        if not sig:
            return None
        return sig[:_MAX_SIGNATURE_CHARS]

    def _attach_lines_above(
        self,
        node: DefNode,
        source_lines: list[str],
        spec: LangSpec,
        covered: list[bool],
    ) -> str | None:
        """Mark doc comments / attributes / decorators above as covered;
        return the cleaned docstring text (if doc comments were found).

        Only doc markers (///, //!, /**, /*!), attributes and decorators are
        attached — plain comments stay gap material (semantic.rs:144-175).
        """
        doc_lines: list[str] = []
        i = node.start_line - 1
        while i >= 0:
            stripped = source_lines[i].strip()
            if not stripped:
                break
            if any(stripped.startswith(p) for p in spec.attribute_prefixes):
                covered[i] = True
                i -= 1
                continue
            if any(stripped.startswith(p) for p in spec.doc_line_prefixes):
                covered[i] = True
                doc_lines.append(stripped)
                i -= 1
                continue
            if spec.doc_block and stripped.endswith("*/"):
                # walk up to the /** or /*! opener
                j = i
                while j >= 0:
                    s2 = source_lines[j].strip()
                    if s2.startswith("/**") or s2.startswith("/*!"):
                        for k in range(j, i + 1):
                            covered[k] = True
                            doc_lines.append(source_lines[k].strip())
                        i = j - 1
                        break
                    j -= 1
                else:
                    break
                continue
            break
        if not doc_lines:
            return None
        doc_lines.reverse()
        return _clean_doc("\n".join(doc_lines))

    def _python_docstring(self, node: DefNode, source_lines: list[str]) -> str | None:
        # first non-blank line after the header line that opened the body
        header_line = None
        for i in range(node.start_line, min(node.end_line, len(source_lines))):
            if source_lines[i].rstrip().endswith(":"):
                header_line = i
                break
        if header_line is None:
            return None
        i = header_line + 1
        while i < min(node.end_line, len(source_lines)) and not source_lines[i].strip():
            i += 1
        if i >= min(node.end_line, len(source_lines)):
            return None
        s = source_lines[i].strip()
        m = re.match(r"^[rbuRBU]{0,2}('''|\"\"\"|'|\")", s)
        if not m:
            return None
        quote = m.group(1)
        rest = s[m.end() :]
        if quote in ("'''", '"""'):
            end = rest.find(quote)
            if end >= 0:
                return rest[:end].strip() or None
            lines = [rest]
            for j in range(i + 1, min(node.end_line, len(source_lines))):
                t = source_lines[j]
                end = t.find(quote)
                if end >= 0:
                    lines.append(t[:end])
                    return "\n".join(ln.strip() for ln in lines).strip() or None
                lines.append(t)
            return None
        end = rest.find(quote)
        if end >= 0:
            return rest[:end].strip() or None
        return None

    # -- gaps ----------------------------------------------------------------

    def _extract_gaps(
        self, source_lines: list[str], covered: list[bool], path_str: str
    ) -> list[Chunk]:
        gaps: list[Chunk] = []
        context = [f"File: {path_str}"]
        start: int | None = None

        def flush(start_line: int, end_line: int) -> None:
            gap_content = "\n".join(source_lines[start_line:end_line])
            if not gap_content.strip():
                return
            kind = classify_gap(gap_content)
            line_count = end_line - start_line
            gaps.append(
                Chunk(
                    content=gap_content,
                    start_line=start_line,
                    end_line=end_line,
                    kind=kind,
                    path=path_str,
                    context=list(context),
                    signature=gap_signature(kind, line_count),
                )
            )

        for i, is_covered in enumerate(covered):
            if not is_covered:
                if start is None:
                    start = i
            else:
                if start is not None:
                    flush(start, i)
                    start = None
        if start is not None:
            flush(start, len(source_lines))
        return gaps

    # -- context windows ------------------------------------------------------

    def _populate_context_windows(
        self, chunks: list[Chunk], source_lines: list[str]
    ) -> None:
        total = len(source_lines)
        for chunk in chunks:
            if chunk.start_line > 0 and self.context_lines > 0:
                prev_start = max(0, chunk.start_line - self.context_lines)
                prev = "\n".join(source_lines[prev_start : chunk.start_line])
                if prev.strip():
                    chunk.context_prev = prev
            if chunk.end_line < total and self.context_lines > 0:
                nxt_end = min(total, chunk.end_line + self.context_lines)
                nxt = "\n".join(source_lines[chunk.end_line : nxt_end])
                if nxt.strip():
                    chunk.context_next = nxt

    # -- splitting -------------------------------------------------------------

    def split_if_needed(self, chunk: Chunk) -> list[Chunk]:
        if (
            chunk.line_count <= self.max_chunk_lines
            and chunk.size_bytes <= self.max_chunk_chars
        ):
            return [chunk]
        lines = chunk.content.split("\n")
        stride = max(self.max_chunk_lines - self.overlap_lines, 1)
        splits: list[Chunk] = []
        i = 0
        split_index = 0
        while i < len(lines):
            end = min(i + self.max_chunk_lines, len(lines))
            piece = lines[i:end]
            if piece:
                c = Chunk(
                    content="\n".join(piece),
                    start_line=chunk.start_line + i,
                    end_line=chunk.start_line + end,
                    kind=chunk.kind,
                    path=chunk.path,
                    context=list(chunk.context),
                    signature=chunk.signature,
                    docstring=chunk.docstring if split_index == 0 else None,
                    is_complete=False,
                    split_index=split_index,
                )
                splits.append(c)
                split_index += 1
            i += stride
        total = len(splits)
        for c in splits:
            header = f"// [Part {(c.split_index or 0) + 1}/{total}] {c.signature or '(continued)'}\n"
            c.content = header + c.content
            c.hash = ""
            c.__post_init__()
        return splits

    # -- fallback ---------------------------------------------------------------

    def fallback_chunk(self, path: str | PurePath, content: str) -> list[Chunk]:
        lines = content.split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        path_str = normalize_path(path)
        context = [f"File: {path_str}"]
        stride = max(self.max_chunk_lines - self.overlap_lines, 1)
        chunks: list[Chunk] = []
        i = 0
        while i < len(lines):
            end = min(i + self.max_chunk_lines, len(lines))
            piece = lines[i:end]
            if piece and "\n".join(piece).strip():
                chunks.append(
                    Chunk(
                        content="\n".join(piece),
                        start_line=i,
                        end_line=end,
                        kind=ChunkKind.BLOCK,
                        path=path_str,
                        context=list(context),
                    )
                )
            i += stride
        self._populate_context_windows(chunks, lines)
        return chunks


def _find_top_level_eq(s: str) -> int:
    depth = 0
    for i, c in enumerate(s):
        if c in "([{<":
            depth += 1
        elif c in ")]}>":
            depth -= 1
        elif c == "=" and depth <= 0:
            # ignore ==, =>, <=, >=, != which are not assignments
            if i + 1 < len(s) and s[i + 1] in "=>":
                continue
            if i > 0 and s[i - 1] in "<>!=":
                continue
            return i
    return -1


def classify_gap(content: str) -> ChunkKind:
    """Classify a gap chunk (reference: semantic.rs:443-487)."""
    trimmed = content.strip()
    total_lines = len(trimmed.split("\n"))
    import_count = sum(
        1
        for line in trimmed.split("\n")
        if line.strip().startswith(("import ", "from ", "use ", "#include"))
    )
    if total_lines > 0 and import_count > total_lines // 2:
        return ChunkKind.IMPORTS
    if trimmed.startswith("//!") or trimmed.startswith("/*!"):
        return ChunkKind.MODULE_DOCS
    comment_count = sum(
        1
        for line in trimmed.split("\n")
        if line.strip().startswith(("//", "/*", "*", "#")) or not line.strip()
    )
    if total_lines > 0 and comment_count > total_lines // 2:
        return ChunkKind.COMMENT
    return ChunkKind.BLOCK


def gap_signature(kind: ChunkKind, line_count: int) -> str:
    if kind is ChunkKind.IMPORTS:
        return f"imports ({line_count} lines)"
    if kind is ChunkKind.MODULE_DOCS:
        return f"module docs ({line_count} lines)"
    if kind is ChunkKind.COMMENT:
        return f"comment block ({line_count} lines)"
    return f"block ({line_count} lines)"


_DOC_MARKERS = re.compile(r"^(///?!?|/\*\*|/\*!|\*/|\*|//!|///)\s?")


def _clean_doc(text: str) -> str:
    out = []
    for line in text.split("\n"):
        line = line.strip()
        line = _DOC_MARKERS.sub("", line)
        line = line.rstrip("*/").rstrip()
        out.append(line)
    cleaned = "\n".join(out).strip()
    return cleaned
