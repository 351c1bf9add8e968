"""Database discovery + global repo registry.

Parity with src/db_discovery/mod.rs: find ``.codesearch.db`` in cwd →
direct children (skipping hidden dirs / node_modules / target) → up to 5
parent levels → the global ``~/.codesearch/repos.json`` registry. A valid
database has metadata.json + the vector matrix file + fts/ (adapted from
the reference's metadata.json + data.mdb + fts/, mod.rs:49).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path

from ..utils.constants import (
    DB_DIR_NAME,
    FTS_DIR_NAME,
    METADATA_FILE_NAME,
    REPOS_CONFIG_FILE,
    VEC_MANIFEST_FILE,
    get_config_dir,
)

PARENT_SEARCH_LEVELS = 5
_SKIP_CHILD_DIRS = {"node_modules", "target", "dist", "build", "__pycache__"}


def is_valid_database(db_path: Path) -> bool:
    return (
        (db_path / METADATA_FILE_NAME).exists()
        and (db_path / VEC_MANIFEST_FILE).exists()
        and (db_path / FTS_DIR_NAME).exists()
    )


@dataclass
class DbIntegrity:
    valid: bool
    has_metadata: bool
    has_vectors: bool
    has_fts: bool


def check_integrity(db_path: Path) -> DbIntegrity:
    hm = (db_path / METADATA_FILE_NAME).exists()
    hv = (db_path / VEC_MANIFEST_FILE).exists()
    hf = (db_path / FTS_DIR_NAME).exists()
    return DbIntegrity(valid=hm and hv and hf, has_metadata=hm, has_vectors=hv, has_fts=hf)


def find_databases(start: Path | None = None) -> list[Path]:
    """All valid databases findable from ``start`` (mod.rs:97)."""
    start = (start or Path.cwd()).resolve()
    found: list[Path] = []
    seen: set[Path] = set()

    def consider(p: Path) -> None:
        if p in seen:
            return
        seen.add(p)
        if p.is_dir() and is_valid_database(p):
            found.append(p)

    consider(start / DB_DIR_NAME)
    try:
        for child in sorted(start.iterdir()):
            if not child.is_dir():
                continue
            if child.name.startswith(".") or child.name in _SKIP_CHILD_DIRS:
                continue
            consider(child / DB_DIR_NAME)
    except OSError:
        pass
    cur = start
    for _ in range(PARENT_SEARCH_LEVELS):
        parent = cur.parent
        if parent == cur:
            break
        consider(parent / DB_DIR_NAME)
        cur = parent
    reg = _read_registry()
    for repo in reg.get("repos", []):
        consider(Path(repo) / DB_DIR_NAME)
    # globally-tracked databases (--global): the db lives under the config
    # dir, not the project tree (reference README: find_databases covers
    # "globally tracked repositories")
    for db in reg.get("global_dbs", {}).values():
        consider(Path(db))
    return found


def find_best_database(start: Path | None = None) -> Path | None:
    """Closest valid database: cwd, children, parents, registry (mod.rs:176)."""
    start = (start or Path.cwd()).resolve()
    direct = start / DB_DIR_NAME
    if is_valid_database(direct):
        return direct
    try:
        for child in sorted(start.iterdir()):
            if not child.is_dir():
                continue
            if child.name.startswith(".") or child.name in _SKIP_CHILD_DIRS:
                continue
            c = child / DB_DIR_NAME
            if is_valid_database(c):
                return c
    except OSError:
        pass
    cur = start
    for _ in range(PARENT_SEARCH_LEVELS):
        parent = cur.parent
        if parent == cur:
            break
        p = parent / DB_DIR_NAME
        if is_valid_database(p):
            return p
        cur = parent
    g = lookup_global_db(start)
    if g is not None:
        return g
    for repo in registered_repos():
        p = Path(repo) / DB_DIR_NAME
        if is_valid_database(p):
            return p
    return None


def resolve_database_with_message(start: Path | None = None) -> tuple[Path | None, str]:
    db = find_best_database(start)
    if db is not None:
        return db, f"using database: {db}"
    return None, (
        "no index found — run `codesearch index` to create one "
        f"(searched cwd, children, {PARENT_SEARCH_LEVELS} parent levels, registry)"
    )


# ---------------------------------------------------------------------------
# global registry (~/.codesearch/repos.json)
# ---------------------------------------------------------------------------

def _registry_path() -> Path:
    return get_config_dir() / REPOS_CONFIG_FILE


def _read_registry() -> dict:
    p = _registry_path()
    if not p.exists():
        return {}
    try:
        return json.loads(p.read_text())
    except (json.JSONDecodeError, OSError):
        return {}


def _write_registry(data: dict) -> None:
    p = _registry_path()
    tmp = p.with_suffix(".tmp")
    tmp.write_text(json.dumps(data))
    os.replace(tmp, p)


def registered_repos() -> list[str]:
    return list(_read_registry().get("repos", []))


# -- global databases (reference: --global places the db under the config
#    dir for read-only project trees; index/mod.rs:76-108) -------------------

def global_db_path(project_root: Path) -> Path:
    """Deterministic per-project db location under the config dir."""
    import hashlib

    key = hashlib.sha256(str(Path(project_root).resolve()).encode()).hexdigest()[:16]
    name = Path(project_root).resolve().name or "root"
    return get_config_dir() / "dbs" / f"{name}-{key}" / DB_DIR_NAME


def register_global_db(project_root: Path, db_path: Path) -> None:
    data = _read_registry()
    dbs = data.setdefault("global_dbs", {})
    dbs[str(Path(project_root).resolve())] = str(db_path)
    _write_registry(data)


def lookup_global_db(start: Path) -> Path | None:
    """Global db for start or any of its parents."""
    dbs = _read_registry().get("global_dbs", {})
    cur = Path(start).resolve()
    while True:
        hit = dbs.get(str(cur))
        if hit and is_valid_database(Path(hit)):
            return Path(hit)
        if cur.parent == cur:
            return None
        cur = cur.parent


def register_repo(repo_root: Path) -> None:
    data = _read_registry()
    repos = set(data.get("repos", []))
    repos.add(str(Path(repo_root).resolve()))
    data["repos"] = sorted(repos)
    _write_registry(data)


def unregister_repo(repo_root: Path) -> None:
    data = _read_registry()
    repos = set(data.get("repos", []))
    repos.discard(str(Path(repo_root).resolve()))
    data["repos"] = sorted(repos)
    data.get("global_dbs", {}).pop(str(Path(repo_root).resolve()), None)
    _write_registry(data)
