"""Per-language definition recognition specs for the structural scanner.

Each language gets a ``LangSpec``: its lexer family, a list of ``DefRule``
header patterns (applied to masked text at statement starts), whether
generic "callable" detection applies (C-family function definitions whose
headers a single regex cannot capture), and docstring conventions.

Replaces the reference's per-language tree-sitter extractors
(src/chunker/extractor.rs:96-1065) with pattern-based recognition over
lexically masked source.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from . import ChunkKind
from ..fileio.language import Language

# Body styles:
#   brace         — span extends to the matching closing brace
#   brace_or_semi — `;` before any `{` ends the span (e.g. `struct X;`)
#   semi          — span ends at the first `;` at depth 0
BRACE = "brace"
BRACE_OR_SEMI = "brace_or_semi"
SEMI = "semi"


@dataclass
class DefRule:
    kind: ChunkKind
    pattern: str
    body: str = BRACE
    method_kind: ChunkKind | None = None  # kind when nested in a type body
    recurse: bool = False                 # scan body for nested definitions
    regex: re.Pattern = field(init=False)

    def __post_init__(self) -> None:
        self.regex = re.compile(self.pattern, re.MULTILINE)


@dataclass
class CallableSpec:
    """Generic function/method definition detection for C-family languages.

    Matches ``name ( balanced-args ) [trailer] {`` where the trailer contains
    no ``;`` ``=`` ``{`` ``}`` (filters declarations, calls, initializers;
    allows ctor-init lists, `const`, `throws`, trailing returns).
    """

    kind: ChunkKind
    method_kind: ChunkKind
    only_in_type_body: bool = False   # Java/C#/JS methods exist only in types
    keyword_blacklist: frozenset = frozenset(
        [
            "if", "for", "while", "switch", "catch", "return", "else",
            "do", "new", "delete", "sizeof", "typeof", "assert", "throw",
            "synchronized", "using", "lock", "foreach", "match", "await",
            "case", "defer", "select", "static_assert", "alignas",
            "decltype", "super", "this",
        ]
    )


@dataclass
class LangSpec:
    family: str
    rules: list[DefRule]
    callable_spec: CallableSpec | None = None
    attribute_prefixes: tuple[str, ...] = ()   # lines attached to next def
    doc_line_prefixes: tuple[str, ...] = ()    # doc comments above defs
    doc_block: bool = False                    # /** ... */ blocks above defs
    python_indent: bool = False


_RUST = LangSpec(
    family="rust",
    attribute_prefixes=("#[", "#!["),
    doc_line_prefixes=("///", "//!"),
    doc_block=True,
    rules=[
        DefRule(
            ChunkKind.FUNCTION,
            r"[ \t]*(?:pub(?:\([^)]*\))?[ \t]+)?(?:default[ \t]+)?(?:const[ \t]+)?"
            r"(?:async[ \t]+)?(?:unsafe[ \t]+)?(?:extern[ \t]+\S+[ \t]+)?"
            r"fn[ \t]+(?P<name>\w+)",
            BRACE_OR_SEMI,  # trait method decls end with ';'
            method_kind=ChunkKind.METHOD,
        ),
        DefRule(
            ChunkKind.STRUCT,
            r"[ \t]*(?:pub(?:\([^)]*\))?[ \t]+)?struct[ \t]+(?P<name>\w+)",
            BRACE_OR_SEMI,
        ),
        DefRule(
            ChunkKind.ENUM,
            r"[ \t]*(?:pub(?:\([^)]*\))?[ \t]+)?enum[ \t]+(?P<name>\w+)",
            BRACE,
        ),
        DefRule(
            ChunkKind.TRAIT,
            r"[ \t]*(?:pub(?:\([^)]*\))?[ \t]+)?(?:unsafe[ \t]+)?trait[ \t]+(?P<name>\w+)",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.IMPL,
            r"[ \t]*(?:unsafe[ \t]+)?impl\b",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.MOD,
            r"[ \t]*(?:pub(?:\([^)]*\))?[ \t]+)?mod[ \t]+(?P<name>\w+)",
            BRACE_OR_SEMI,
            recurse=True,
        ),
        DefRule(
            ChunkKind.TYPE_ALIAS,
            r"[ \t]*(?:pub(?:\([^)]*\))?[ \t]+)?type[ \t]+(?P<name>\w+)",
            SEMI,
        ),
        DefRule(
            ChunkKind.CONST,
            r"[ \t]*(?:pub(?:\([^)]*\))?[ \t]+)?const[ \t]+(?P<name>\w+)[ \t]*:",
            SEMI,
        ),
        DefRule(
            ChunkKind.STATIC,
            r"[ \t]*(?:pub(?:\([^)]*\))?[ \t]+)?static[ \t]+(?:mut[ \t]+)?(?P<name>\w+)[ \t]*:",
            SEMI,
        ),
    ],
)

_PYTHON = LangSpec(
    family="python",
    python_indent=True,
    attribute_prefixes=("@",),
    rules=[
        DefRule(
            ChunkKind.FUNCTION,
            r"(?P<indent>[ \t]*)(?:async[ \t]+)?def[ \t]+(?P<name>\w+)",
            method_kind=ChunkKind.METHOD,
        ),
        DefRule(
            ChunkKind.CLASS,
            r"(?P<indent>[ \t]*)class[ \t]+(?P<name>\w+)",
            recurse=True,
        ),
    ],
)

_JS_TS = LangSpec(
    family="ts",
    attribute_prefixes=("@",),
    doc_block=True,
    rules=[
        DefRule(
            ChunkKind.FUNCTION,
            r"[ \t]*(?:export[ \t]+)?(?:default[ \t]+)?(?:async[ \t]+)?"
            r"function[ \t]*\*?[ \t]*(?P<name>[\w$]+)",
            BRACE,
        ),
        DefRule(
            ChunkKind.CLASS,
            r"[ \t]*(?:export[ \t]+)?(?:default[ \t]+)?(?:abstract[ \t]+)?"
            r"class[ \t]+(?P<name>[\w$]+)",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.INTERFACE,
            r"[ \t]*(?:export[ \t]+)?(?:declare[ \t]+)?interface[ \t]+(?P<name>[\w$]+)",
            BRACE,
        ),
        DefRule(
            ChunkKind.ENUM,
            r"[ \t]*(?:export[ \t]+)?(?:declare[ \t]+)?(?:const[ \t]+)?enum[ \t]+(?P<name>[\w$]+)",
            BRACE,
        ),
        DefRule(
            ChunkKind.TYPE_ALIAS,
            r"[ \t]*(?:export[ \t]+)?type[ \t]+(?P<name>[\w$]+)[ \t<]",
            SEMI,
        ),
        DefRule(
            ChunkKind.MOD,
            r"[ \t]*(?:export[ \t]+)?(?:declare[ \t]+)?namespace[ \t]+(?P<name>[\w$.]+)",
            BRACE,
            recurse=True,
        ),
        DefRule(
            # const foo = (...) =>  /  const foo = async x =>
            ChunkKind.FUNCTION,
            r"[ \t]*(?:export[ \t]+)?(?:const|let|var)[ \t]+(?P<name>[\w$]+)"
            r"(?::[^=\n]+)?[ \t]*=[ \t]*(?:async[ \t]*)?(?:\([^)\n]*\)|[\w$]+)"
            r"[ \t]*(?::[^=\n{]+)?=>",
            BRACE_OR_SEMI,
        ),
    ],
    callable_spec=CallableSpec(
        kind=ChunkKind.METHOD,
        method_kind=ChunkKind.METHOD,
        only_in_type_body=True,
    ),
)

_GO = LangSpec(
    family="go",
    doc_line_prefixes=(),  # godoc uses plain //, which the reference leaves as gaps
    rules=[
        DefRule(
            ChunkKind.METHOD,
            r"[ \t]*func[ \t]*\([^)]*\)[ \t]*(?P<name>\w+)",
            BRACE,
        ),
        DefRule(
            ChunkKind.FUNCTION,
            r"[ \t]*func[ \t]+(?P<name>\w+)",
            BRACE,
        ),
        DefRule(
            ChunkKind.STRUCT,
            r"[ \t]*type[ \t]+(?P<name>\w+)[ \t]+struct\b",
            BRACE,
        ),
        DefRule(
            ChunkKind.INTERFACE,
            r"[ \t]*type[ \t]+(?P<name>\w+)[ \t]+interface\b",
            BRACE,
        ),
        DefRule(
            ChunkKind.TYPE_ALIAS,
            r"[ \t]*type[ \t]+(?P<name>\w+)[ \t]+[^\s{]",
            SEMI,
        ),
    ],
)

_C = LangSpec(
    family="c",
    doc_block=True,
    doc_line_prefixes=("///",),
    rules=[
        DefRule(
            ChunkKind.STRUCT,
            r"[ \t]*(?:typedef[ \t]+)?struct[ \t]+(?P<name>\w+)[ \t]*\{",
            BRACE,
        ),
        DefRule(
            ChunkKind.ENUM,
            r"[ \t]*(?:typedef[ \t]+)?enum[ \t]+(?P<name>\w+)[ \t]*\{",
            BRACE,
        ),
        DefRule(
            ChunkKind.TYPE_ALIAS,
            r"[ \t]*typedef[ \t]+(?!struct\b|enum\b|union\b)[^;{]*?(?P<name>\w+)[ \t]*;",
            SEMI,
        ),
    ],
    callable_spec=CallableSpec(kind=ChunkKind.FUNCTION, method_kind=ChunkKind.FUNCTION),
)

_CPP = LangSpec(
    family="cpp",
    doc_block=True,
    doc_line_prefixes=("///",),
    rules=[
        DefRule(
            ChunkKind.CLASS,
            r"[ \t]*(?:template[ \t]*<[^>\n]*>[ \t\n]*)?class[ \t]+(?:\w+[ \t]+)?(?P<name>\w+)"
            r"[ \t]*(?::[^;{]*)?\{",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.STRUCT,
            r"[ \t]*(?:template[ \t]*<[^>\n]*>[ \t\n]*)?struct[ \t]+(?P<name>\w+)"
            r"[ \t]*(?::[^;{]*)?\{",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.ENUM,
            r"[ \t]*enum[ \t]+(?:class[ \t]+|struct[ \t]+)?(?P<name>\w+)[^;{\n]*\{",
            BRACE,
        ),
        DefRule(
            ChunkKind.MOD,
            r"[ \t]*namespace[ \t]+(?P<name>[\w:]+)[ \t]*\{",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.TYPE_ALIAS,
            r"[ \t]*using[ \t]+(?P<name>\w+)[ \t]*=",
            SEMI,
        ),
    ],
    callable_spec=CallableSpec(kind=ChunkKind.FUNCTION, method_kind=ChunkKind.METHOD),
)

_CSHARP = LangSpec(
    family="csharp",
    attribute_prefixes=("[",),
    doc_line_prefixes=("///",),
    doc_block=True,
    rules=[
        DefRule(
            ChunkKind.MOD,
            r"[ \t]*namespace[ \t]+(?P<name>[\w.]+)",
            BRACE_OR_SEMI,  # C# 10 file-scoped namespaces end with ';'
            recurse=True,
        ),
        DefRule(
            ChunkKind.CLASS,
            r"[ \t]*(?:(?:public|private|protected|internal|static|abstract|sealed|partial)[ \t]+)*"
            r"class[ \t]+(?P<name>\w+)",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.STRUCT,
            r"[ \t]*(?:(?:public|private|protected|internal|readonly|partial)[ \t]+)*"
            r"struct[ \t]+(?P<name>\w+)",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.INTERFACE,
            r"[ \t]*(?:(?:public|private|protected|internal|partial)[ \t]+)*"
            r"interface[ \t]+(?P<name>\w+)",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.ENUM,
            r"[ \t]*(?:(?:public|private|protected|internal)[ \t]+)*enum[ \t]+(?P<name>\w+)",
            BRACE,
        ),
        DefRule(
            ChunkKind.CLASS,
            r"[ \t]*(?:(?:public|private|protected|internal|readonly|partial|sealed)[ \t]+)*"
            r"record[ \t]+(?:class[ \t]+|struct[ \t]+)?(?P<name>\w+)",
            BRACE_OR_SEMI,
        ),
    ],
    callable_spec=CallableSpec(
        kind=ChunkKind.METHOD, method_kind=ChunkKind.METHOD, only_in_type_body=True
    ),
)

_JAVA = LangSpec(
    family="java",
    attribute_prefixes=("@",),
    doc_block=True,
    rules=[
        DefRule(
            ChunkKind.CLASS,
            r"[ \t]*(?:(?:public|private|protected|static|abstract|final|sealed|non-sealed)[ \t]+)*"
            r"class[ \t]+(?P<name>\w+)",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.INTERFACE,
            r"[ \t]*(?:(?:public|private|protected|static|abstract|sealed|non-sealed)[ \t]+)*"
            r"interface[ \t]+(?P<name>\w+)",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.ENUM,
            r"[ \t]*(?:(?:public|private|protected|static)[ \t]+)*enum[ \t]+(?P<name>\w+)",
            BRACE,
        ),
        DefRule(
            ChunkKind.CLASS,
            r"[ \t]*(?:(?:public|private|protected|static|final)[ \t]+)*record[ \t]+(?P<name>\w+)",
            BRACE,
        ),
    ],
    callable_spec=CallableSpec(
        kind=ChunkKind.METHOD, method_kind=ChunkKind.METHOD, only_in_type_body=True
    ),
)

# --- beyond the reference's 9 grammars: Kotlin, Swift, PHP are brace
# languages the structural scanner extends to for free -----------------------

_KOTLIN = LangSpec(
    family="kotlin",
    attribute_prefixes=("@",),
    doc_block=True,
    rules=[
        DefRule(
            ChunkKind.FUNCTION,
            r"[ \t]*(?:(?:public|private|protected|internal|open|override|suspend|inline|"
            r"operator|infix|tailrec|external|abstract|final)[ \t]+)*"
            r"fun[ \t]+(?:<[^>\n]*>[ \t]+)?(?:[\w.]+\.)?(?P<name>\w+)",
            BRACE_OR_SEMI,  # expression bodies end without braces
            method_kind=ChunkKind.METHOD,
        ),
        DefRule(
            ChunkKind.CLASS,
            r"[ \t]*(?:(?:public|private|protected|internal|open|abstract|final|sealed|"
            r"data|inner|enum|annotation)[ \t]+)*class[ \t]+(?P<name>\w+)",
            BRACE_OR_SEMI,
            recurse=True,
        ),
        DefRule(
            ChunkKind.INTERFACE,
            r"[ \t]*(?:(?:public|private|internal|sealed|fun)[ \t]+)*interface[ \t]+(?P<name>\w+)",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.MOD,
            r"[ \t]*(?:(?:public|private|internal)[ \t]+)*object[ \t]+(?P<name>\w+)",
            BRACE,
            recurse=True,
        ),
    ],
)

_SWIFT = LangSpec(
    family="swift",
    attribute_prefixes=("@",),
    doc_line_prefixes=("///",),
    doc_block=True,
    rules=[
        DefRule(
            ChunkKind.FUNCTION,
            r"[ \t]*(?:(?:public|private|internal|open|fileprivate|static|final|override|"
            r"mutating|class)[ \t]+)*func[ \t]+(?P<name>\w+)",
            BRACE,
            method_kind=ChunkKind.METHOD,
        ),
        DefRule(
            ChunkKind.CLASS,
            r"[ \t]*(?:(?:public|private|internal|open|final)[ \t]+)*class[ \t]+(?P<name>\w+)",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.STRUCT,
            r"[ \t]*(?:(?:public|private|internal)[ \t]+)*struct[ \t]+(?P<name>\w+)",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.ENUM,
            r"[ \t]*(?:(?:public|private|internal|indirect)[ \t]+)*enum[ \t]+(?P<name>\w+)",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.INTERFACE,
            r"[ \t]*(?:(?:public|private|internal)[ \t]+)*protocol[ \t]+(?P<name>\w+)",
            BRACE,
        ),
        DefRule(
            ChunkKind.IMPL,
            r"[ \t]*(?:(?:public|private|internal)[ \t]+)*extension[ \t]+(?P<name>[\w.]+)",
            BRACE,
            recurse=True,
        ),
    ],
)

_PHP = LangSpec(
    family="php",
    attribute_prefixes=("#[",),
    doc_block=True,
    rules=[
        DefRule(
            ChunkKind.FUNCTION,
            r"[ \t]*(?:(?:public|private|protected|static|abstract|final)[ \t]+)*"
            r"function[ \t]+&?(?P<name>\w+)",
            BRACE_OR_SEMI,  # abstract/interface methods end with ';'
            method_kind=ChunkKind.METHOD,
        ),
        DefRule(
            ChunkKind.CLASS,
            r"[ \t]*(?:(?:abstract|final|readonly)[ \t]+)*class[ \t]+(?P<name>\w+)",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.INTERFACE,
            r"[ \t]*interface[ \t]+(?P<name>\w+)",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.TRAIT,
            r"[ \t]*trait[ \t]+(?P<name>\w+)",
            BRACE,
            recurse=True,
        ),
        DefRule(
            ChunkKind.ENUM,
            r"[ \t]*enum[ \t]+(?P<name>\w+)",
            BRACE,
            recurse=True,
        ),
    ],
)

_SPECS: dict[Language, LangSpec] = {
    Language.RUST: _RUST,
    Language.PYTHON: _PYTHON,
    Language.JAVASCRIPT: _JS_TS,
    Language.TYPESCRIPT: _JS_TS,
    Language.GO: _GO,
    Language.C: _C,
    Language.CPP: _CPP,
    Language.CSHARP: _CSHARP,
    Language.JAVA: _JAVA,
    Language.KOTLIN: _KOTLIN,
    Language.SWIFT: _SWIFT,
    Language.PHP: _PHP,
}


def get_spec(language: Language) -> LangSpec | None:
    return _SPECS.get(language)
