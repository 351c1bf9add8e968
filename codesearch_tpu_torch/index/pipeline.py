"""Indexing pipeline on torch: full + incremental builds (the port of
``codesearch_tpu/index/pipeline.py``; parity with src/index/mod.rs:364-961).

Walk, diff against the file manifest, chunk on the host, embed in slabs on
``device`` with one slab in flight, insert into the vector and FTS stores,
commit with atomic snapshots. ``build_index`` is O(1) (no ANN trees). The
files written — stores, manifest, ``metadata.json`` — are the JAX
package's format, so either package searches the other's index.

Placement logic: git-root-smart — the database lives at the repository root
(worktree `.git` files parsed; multiple sibling repos is an error), parity
with index/mod.rs:35-268.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import shutil
import time
from dataclasses import dataclass
from pathlib import Path

from ..chunker import (
    INDEX_MAX_CHUNK_CHARS,
    INDEX_MAX_CHUNK_LINES,
    INDEX_OVERLAP_LINES,
    SemanticChunker,
)
from ..chunker.dedup import ChunkDeduplicator
from ..embed import EmbeddingService
from ..fileio import FileWalker
from ..fts import FtsStore
from ..utils.constants import (
    DB_DIR_NAME,
    EMBEDDER_VERSION,
    FTS_DIR_NAME,
    METADATA_FILE_NAME,
    is_shutdown_requested,
)
from ..utils.errors import IndexError_
from ..utils.output import ProgressLine, info_print, warn_print
from ..vectordb import ChunkMetadata, VectorStore
from .db_discovery import find_best_database, global_db_path, register_global_db
from .file_meta import FileMetaStore, normalize_path

__all__ = ["IndexOptions", "IndexStats", "index", "read_metadata", "write_metadata"]


FTS_COMMIT_EVERY = 1000  # chunks between FTS commits (index/mod.rs:751)
EMBED_FILES_PER_BATCH = 64  # files per embed+insert transaction


@dataclass
class IndexOptions:
    model: str = "code-hash-384"
    force: bool = False
    quiet: bool = False
    store_path: Path | None = None  # explicit db location override
    int8: bool = False              # quantized device corpus (halves HBM)
    global_db: bool = False         # place db under ~/.codesearch/dbs/
    dry_run: bool = False           # preview what would be indexed, no writes
    # extra top-level names for the walker to skip (benchmark harnesses
    # exclude self-referential dirs; mirrors FileWalker.extra_excludes)
    extra_excludes: tuple = ()
    # drop repeated-content chunks (license headers, vendored/generated
    # code) before embedding — first occurrence wins, within one index run
    # (chunker/dedup.py; the reference ships the same component unwired,
    # dedup.rs:17-108). Off by default: a dropped duplicate belongs to ONE
    # file's manifest, so deleting that file also drops the content for
    # the files that still contain it until their next reindex.
    dedup: bool = False


@dataclass
class IndexStats:
    db_path: Path
    files_walked: int = 0
    files_indexed: int = 0
    files_unchanged: int = 0
    files_deleted: int = 0
    chunks_added: int = 0
    chunks_deleted: int = 0
    chunks_deduped: int = 0
    cancelled: bool = False
    elapsed_s: float = 0.0
    primary_language: str | None = None
    int8: bool = False


def find_git_root(start_path: Path) -> Path | None:
    """Walk up for `.git` (dir or worktree file) and return that directory.

    For worktrees the `.git` *file* marks the worktree root — the database
    belongs there (the gitdir reference inside is only needed by the HEAD
    watcher, watch/mod.rs:329-353).
    """
    current = Path(start_path).resolve()
    while True:
        if (current / ".git").exists():
            return current
        if current.parent == current:
            return None
        current = current.parent


def multiple_child_repos(path: Path) -> list[Path]:
    """Direct children that are git repos (multi-repo guard, mod.rs:240-268)."""
    out = []
    try:
        for child in sorted(path.iterdir()):
            if child.is_dir() and (child / ".git").exists():
                out.append(child)
    except OSError:
        pass
    return out


def get_db_path_smart(
    project_path: Path,
    store_path: Path | None = None,
    force: bool = False,
    global_db: bool = False,
) -> tuple[Path, Path]:
    """Returns (db_path, project_root). ``global_db`` places the database
    under the config dir (for read-only project trees) and registers the
    mapping (reference: --global, index/mod.rs:76-108)."""
    project_path = Path(project_path).resolve()
    if store_path is not None:
        return Path(store_path), project_path
    if global_db:
        root = find_git_root(project_path) or project_path
        db = global_db_path(root)
        db.parent.mkdir(parents=True, exist_ok=True)
        register_global_db(root, db)
        return db, root
    if not force:
        existing = find_best_database(project_path)
        if existing is not None:
            return existing, existing.parent
    git_root = find_git_root(project_path)
    if git_root is None:
        children = multiple_child_repos(project_path)
        if len(children) > 1:
            raise IndexError_(
                f"{project_path} contains multiple git repositories "
                f"({', '.join(c.name for c in children[:5])}); index each one "
                "separately or pass an explicit --store path"
            )
        root = project_path
    else:
        root = git_root
    return root / DB_DIR_NAME, root


def ensure_db_ignored(project_root: Path) -> None:
    """Make sure `.codesearch.db/` is git-ignored at the project root
    (reference behavior: ALWAYS_EXCLUDED entries are added to .gitignore
    automatically, constants.rs:185-189)."""
    if not (project_root / ".git").exists():
        return
    gi = project_root / ".gitignore"
    try:
        existing = gi.read_text() if gi.exists() else ""
        if DB_DIR_NAME not in existing:
            sep = "" if existing.endswith("\n") or not existing else "\n"
            with open(gi, "a") as f:
                f.write(f"{sep}{DB_DIR_NAME}/\n")
    except OSError:
        pass


def read_metadata(db_path: Path) -> dict:
    p = Path(db_path) / METADATA_FILE_NAME
    if not p.exists():
        return {}
    try:
        return json.loads(p.read_text())
    except (OSError, json.JSONDecodeError):
        return {}


def write_metadata(db_path: Path, service: EmbeddingService, stats: IndexStats) -> None:
    p = Path(db_path) / METADATA_FILE_NAME
    existing = read_metadata(db_path)

    payload = {
        "model": service.model_name,
        "dimensions": service.dims,
        "created_at": existing.get("created_at") or _dt.datetime.now().isoformat(),
        "indexed_at": _dt.datetime.now().isoformat(),
        "primary_language": stats.primary_language,
        "version": 1,
        "embedder_version": EMBEDDER_VERSION,
        "int8": bool(getattr(stats, "int8", False)),
    }
    tmp = p.with_suffix(".tmp")
    tmp.write_text(json.dumps(payload, indent=2))
    os.replace(tmp, p)


def index(path: str | Path = ".", options: IndexOptions | None = None,
          device=None) -> IndexStats:
    """Full or incremental index of a repository; stores open from the
    resolved database path on ``device``."""
    options = options or IndexOptions()
    t0 = time.time()
    project = Path(path).resolve()
    db_path, root = get_db_path_smart(project, options.store_path, options.force,
                                      options.global_db)
    stats = IndexStats(db_path=db_path, int8=options.int8)
    if options.dry_run:
        raise NotImplementedError("index --dry-run is not ported yet (ROADMAP.md Queue 1)")

    if options.force and db_path.exists():
        info_print(f"force rebuild: deleting {db_path}")
        shutil.rmtree(db_path, ignore_errors=True)
    meta = read_metadata(db_path)
    model_name = meta.get("model", options.model) if not options.force else options.model
    service = EmbeddingService(model_name, db_path=db_path, device=device)
    if meta and meta.get("embedder_version", 1) != EMBEDDER_VERSION:
        info_print(f"embedder version changed (v{meta.get('embedder_version', 1)} "
                   f"→ v{EMBEDDER_VERSION}): full rebuild")
        shutil.rmtree(db_path, ignore_errors=True)
        meta = {}

    db_path.mkdir(parents=True, exist_ok=True)
    if db_path.parent == root:
        ensure_db_ignored(root)
    stats.int8 = options.int8 or bool(meta.get("int8", False))
    store = VectorStore(db_path, dims=service.dims, int8=stats.int8, device=device)
    fts = FtsStore(db_path / FTS_DIR_NAME, device=device)
    file_meta = FileMetaStore.load_or_create(db_path, service.model_name)

    # ---- walk + incremental diff ----------------------------------------
    files, walk_stats = FileWalker(root, extra_excludes=list(options.extra_excludes)).walk()
    stats.files_walked = len(files)
    if walk_stats.by_language:
        stats.primary_language = max(walk_stats.by_language.items(), key=lambda kv: kv[1])[0]
    changed: list = []
    hashes: dict[str, str] = {}
    for f in files:
        check = file_meta.check_file(f.path)
        if check.changed:
            changed.append(f)
            if check.sha256:
                hashes[normalize_path(f.path)] = check.sha256
        else:
            stats.files_unchanged += 1
    for dpath in file_meta.find_deleted_files({str(f.path) for f in files}):
        old_ids = file_meta.remove_file(dpath)
        if old_ids:
            stats.chunks_deleted += store.delete_chunks(old_ids)
            for cid in old_ids:
                fts.delete_chunk(cid)
        stats.files_deleted += 1
    info_print(f"indexing {len(changed)} changed files "
               f"({stats.files_unchanged} unchanged, {stats.files_deleted} deleted)")

    # ---- chunk -> embed -> insert, one embed slab in flight ---------------
    chunker = SemanticChunker(INDEX_MAX_CHUNK_LINES, INDEX_MAX_CHUNK_CHARS, INDEX_OVERLAP_LINES)
    deduper = ChunkDeduplicator() if options.dedup else None
    progress = ProgressLine(len(changed))
    since_commit = 0
    pending = None

    def _finalize(p) -> None:
        nonlocal since_commit
        per_file, flat, finish = p
        ids: list[int] = []
        if flat:
            embs = finish()
            metas = [
                ChunkMetadata(
                    path=c.path, content=c.content, start_line=c.start_line,
                    end_line=c.end_line, kind=c.kind.value, context=c.context,
                    signature=c.signature, docstring=c.docstring, hash=c.hash,
                    language=getattr(c, "_language", None))
                for c in flat
            ]
            ids = store.insert_chunks_with_ids(embs, metas)
            try:
                fts.add_chunks([(cid, m.content, m.path, m.signature, m.kind)
                                for cid, m in zip(ids, metas)])
                since_commit += len(ids)
                if since_commit >= FTS_COMMIT_EVERY:
                    fts.commit()
                    since_commit = 0
            except Exception as e:  # FTS failures are non-fatal: vectors stay usable
                warn_print(f"FTS indexing failed (vector search unaffected): {e}")
            stats.chunks_added += len(flat)
        cursor = 0
        for fpath, cs in per_file:
            file_meta.update_file(fpath, ids[cursor:cursor + len(cs)],
                                  hashes.get(normalize_path(fpath)))
            cursor += len(cs)
        stats.files_indexed += len(per_file)
        progress.update(stats.files_indexed, extra=f", {stats.chunks_added} chunks")

    i = 0
    while i < len(changed):
        if is_shutdown_requested():
            progress.finish()
            info_print("cancelling — committing partial progress …")
            stats.cancelled = True
            break
        batch_files = changed[i:i + EMBED_FILES_PER_BATCH]
        i += len(batch_files)
        per_file: list[tuple[Path, list]] = []
        for f in batch_files:
            try:
                content = f.path.read_text(encoding="utf-8", errors="replace")
            except OSError:
                continue
            rel = f.path.relative_to(root) if f.path.is_relative_to(root) else f.path
            chunks = chunker.chunk_semantic(f.language, rel, content)
            if deduper is not None:
                chunks = deduper.deduplicate(chunks)
            for c in chunks:
                c._language = f.language.display_name  # type: ignore[attr-defined]
            per_file.append((f.path, chunks))
        for fpath, _ in per_file:
            old_ids = file_meta.chunk_ids_for(fpath)
            if old_ids:
                stats.chunks_deleted += store.delete_chunks(old_ids)
                for cid in old_ids:
                    fts.delete_chunk(cid)
        flat = [c for _, cs in per_file for c in cs]
        finish = service.embed_chunks_matrix_async(flat) if flat else None
        if pending is not None:
            _finalize(pending)
        pending = (per_file, flat, finish)
    if pending is not None:
        _finalize(pending)

    # ---- finalize -----------------------------------------------------------
    progress.finish()
    store.build_index()
    store.save()
    try:
        fts.commit()
    except Exception as e:  # non-fatal, as above
        warn_print(f"FTS commit failed: {e}")
    file_meta.save()
    write_metadata(db_path, service, stats)
    if deduper is not None:
        stats.chunks_deduped = deduper.stats.duplicates
    stats.elapsed_s = time.time() - t0
    if stats.cancelled:
        info_print("indexing cancelled — partial progress saved; re-run to complete")
    return stats
