"""Language detection by extension and extensionless filename.

Behavioral parity with the reference's 23-variant language map
(src/file/language.rs:4-111): extension first, then known extensionless
filenames (Dockerfile, Makefile, …). JSX/TSX map to TypeScript; txt maps to
Markdown-like.
"""

from __future__ import annotations

import enum
from pathlib import Path, PurePath


class Language(enum.Enum):
    RUST = "Rust"
    PYTHON = "Python"
    JAVASCRIPT = "JavaScript"
    TYPESCRIPT = "TypeScript"
    GO = "Go"
    JAVA = "Java"
    C = "C"
    CPP = "C++"
    CSHARP = "C#"
    RUBY = "Ruby"
    PHP = "PHP"
    SWIFT = "Swift"
    KOTLIN = "Kotlin"
    SHELL = "Shell"
    MARKDOWN = "Markdown"
    JSON = "JSON"
    YAML = "YAML"
    TOML = "TOML"
    SQL = "SQL"
    HTML = "HTML"
    CSS = "CSS"
    XML = "XML"
    UNKNOWN = "Unknown"

    @property
    def display_name(self) -> str:
        return self.value

    def is_indexable(self) -> bool:
        return self is not Language.UNKNOWN

    def supports_structural_chunking(self) -> bool:
        """Languages with a definition-aware extractor (reference's 9
        tree-sitter grammars, language.rs:100-111)."""
        return self in _STRUCTURAL


_STRUCTURAL = {
    Language.RUST, Language.PYTHON, Language.JAVASCRIPT, Language.TYPESCRIPT,
    Language.C, Language.CPP, Language.CSHARP, Language.GO, Language.JAVA,
    # beyond the reference's 9 grammars (brace languages come cheap here)
    Language.KOTLIN, Language.SWIFT, Language.PHP,
}

_BY_EXTENSION: dict[str, Language] = {
    "rs": Language.RUST,
    "py": Language.PYTHON, "pyw": Language.PYTHON, "pyi": Language.PYTHON,
    "js": Language.JAVASCRIPT, "mjs": Language.JAVASCRIPT, "cjs": Language.JAVASCRIPT,
    "ts": Language.TYPESCRIPT, "mts": Language.TYPESCRIPT, "cts": Language.TYPESCRIPT,
    "tsx": Language.TYPESCRIPT, "jsx": Language.TYPESCRIPT,
    "go": Language.GO,
    "java": Language.JAVA,
    "c": Language.C, "h": Language.C,
    "cpp": Language.CPP, "cc": Language.CPP, "cxx": Language.CPP,
    "hpp": Language.CPP, "hxx": Language.CPP,
    "cs": Language.CSHARP,
    "rb": Language.RUBY, "rake": Language.RUBY,
    "php": Language.PHP,
    "swift": Language.SWIFT,
    "kt": Language.KOTLIN, "kts": Language.KOTLIN,
    "sh": Language.SHELL, "bash": Language.SHELL, "zsh": Language.SHELL,
    "md": Language.MARKDOWN, "markdown": Language.MARKDOWN, "txt": Language.MARKDOWN,
    "json": Language.JSON,
    "yaml": Language.YAML, "yml": Language.YAML,
    "toml": Language.TOML,
    "sql": Language.SQL,
    "html": Language.HTML, "htm": Language.HTML,
    "css": Language.CSS, "scss": Language.CSS, "sass": Language.CSS, "less": Language.CSS,
    "xml": Language.XML, "csproj": Language.XML, "props": Language.XML,
    "targets": Language.XML, "resx": Language.XML, "config": Language.XML,
}

_BY_FILENAME: dict[str, Language] = {
    "Dockerfile": Language.SHELL, "Containerfile": Language.SHELL,
    "Makefile": Language.SHELL, "GNUmakefile": Language.SHELL, "makefile": Language.SHELL,
    "Jenkinsfile": Language.RUBY, "Vagrantfile": Language.RUBY, "Fastfile": Language.RUBY,
    "Appfile": Language.RUBY, "Podfile": Language.RUBY,
    ".env": Language.SHELL, ".envrc": Language.SHELL,
    "CMakeLists": Language.SHELL,
}


def from_extension(ext: str) -> Language:
    return _BY_EXTENSION.get(ext.lower(), Language.UNKNOWN)


def from_filename(name: str) -> Language:
    return _BY_FILENAME.get(name, Language.UNKNOWN)


def detect_language(path: str | PurePath) -> Language:
    p = PurePath(path)
    ext = p.suffix[1:] if p.suffix else ""
    lang = from_extension(ext)
    if lang is not Language.UNKNOWN:
        return lang
    return from_filename(p.name)
