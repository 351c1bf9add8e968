"""Command line of the port: ``python -m codesearch_tpu_torch.cli`` (or
``codesearch-torch``). It takes the JAX CLI's arguments and runs every one
of its subcommands on torch: ``index`` (with the registry actions ``add``,
``remove``/``rm`` and ``list``, and ``--dry-run``), ``search`` (and
``--all-repos``), ``stats``, ``clear``, ``list``, ``cache``, ``setup``,
``doctor``, ``mcp``, ``serve`` and ``train``. ``--platform cpu`` runs on the
CPU; otherwise the first CUDA device, and a subcommand that opens a store or
a model raises when there is none. ``clear``, ``cache``, ``setup``, the
registry actions and ``--dry-run`` touch files only."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
from pathlib import Path

from .. import __version__
from ..utils import constants
from ..utils.logger import init_logger
from ..utils.output import error_print, info_print, result_print, set_quiet

def _install_sigint() -> None:
    """First CTRL-C requests graceful shutdown; second force-exits
    (reference: main.rs:50-66)."""
    state = {"count": 0}

    def handler(signum, frame):
        state["count"] += 1
        if state["count"] == 1:
            constants.request_shutdown()
            info_print("shutdown requested — finishing current batch (CTRL-C again to force)")
        else:
            sys.exit(130)

    try:
        signal.signal(signal.SIGINT, handler)
    except ValueError:
        pass  # not the main thread


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="codesearch-torch",
        description="Local semantic code search on PyTorch/CUDA",
    )
    p.add_argument("--version", action="version",
                   version=f"codesearch-tpu-torch {__version__}")
    p.add_argument("--loglevel", default="warn",
                   choices=["trace", "debug", "info", "warn", "error"])
    p.add_argument(
        "--platform",
        default=os.environ.get("CODESEARCH_PLATFORM", "auto"),
        choices=["auto", "cuda", "cpu"],
        help="device: auto/cuda = the first CUDA device, cpu = the CPU",
    )
    p.add_argument("--quiet", "-q", action="store_true", help="suppress non-result output")
    p.add_argument("--store", type=Path, default=None, help="explicit database path")
    p.add_argument("--model", default=None, help="embedding model (see `codesearch setup --list`)")
    sub = p.add_subparsers(dest="command")

    s = sub.add_parser("search", help="search the codebase")
    s.add_argument("query")
    _add_model_after(s)
    s.add_argument("path", nargs="?", default=".")
    # parity: the reference CLI shows 25 results by default (cli/mod.rs:89);
    # SearchOptions (library/MCP) stays at 10 like its SearchOptions default
    s.add_argument("--limit", "-n", "-m", type=int, default=25)
    s.add_argument("--vector-only", action="store_true", help="skip BM25/hybrid fusion")
    s.add_argument("--rerank", action="store_true", help="neural cross-encoder rerank")
    s.add_argument("--filter", dest="path_filter", default=None, help="substring path filter")
    s.add_argument("--min-score", type=float, default=None)
    s.add_argument("--json", action="store_true", dest="json_out")
    s.add_argument("--compact", action="store_true")
    s.add_argument("--full", action="store_true",
                   help="print full chunk content instead of 3-line snippets "
                        "(reference parity: cli/mod.rs:97-99)")
    s.add_argument("--scores", action="store_true", help="show stage timings")
    s.add_argument("--sync", action="store_true", help="incremental refresh before searching")
    s.add_argument("--no-expand", action="store_true", help="disable query expansion")
    s.add_argument("--files-only", action="store_true",
                   help="print matching file paths only (like grep -l)")
    s.add_argument("--max-per-file", type=int, default=None,
                   help="max results shown per file")
    s.add_argument("--rrf-k", type=float, default=None,
                   help="fixed RRF k for fusion (default: adaptive)")
    s.add_argument("--rerank-top", type=int, default=None,
                   help="number of top results to rerank (default 100)")
    # parity: the reference auto-creates a missing index on first search
    # (search/mod.rs:413-435); --no-create-index opts out
    s.add_argument("--create-index", dest="create_index", action="store_true",
                   default=True, help="build the index first if none exists (default)")
    s.add_argument("--no-create-index", dest="create_index", action="store_false",
                   help="fail instead of auto-indexing when no index exists")
    s.add_argument("--all-repos", action="store_true",
                   help="federated: run the query against every discoverable "
                        "index (cwd/parents + global registry), grouped per repo")

    i = sub.add_parser("index", help="build or refresh the index")
    _add_model_after(i)
    i.add_argument("args", nargs="*", default=[],
                   help="[add|remove|rm|list] [path] — registry subcommands, "
                        "or just a path to index")
    i.add_argument("--force", "-f", action="store_true", help="full rebuild")
    i.add_argument("--dry-run", action="store_true",
                   help="show what would be indexed without indexing")
    i.add_argument("--register", action="store_true", help="add repo to the global registry")
    i.add_argument("--dedup", action="store_true",
                   help="drop repeated-content chunks (license headers, "
                        "vendored code) before embedding; first occurrence "
                        "wins within the run")
    i.add_argument("--int8", action="store_true",
                   help="int8-quantized device corpus (halves device memory; ~same ranking)")
    i.add_argument("--global", dest="global_db", action="store_true",
                   help="place the database under ~/.codesearch/dbs "
                        "(for read-only project trees)")

    st = sub.add_parser("stats", help="index statistics")
    st.add_argument("path", nargs="?", default=".")
    st.add_argument("--json", action="store_true", dest="json_out")

    c = sub.add_parser("clear", help="delete the index")
    c.add_argument("path", nargs="?", default=".")
    c.add_argument("--yes", "-y", action="store_true")

    d = sub.add_parser("doctor", help="health checks")
    d.add_argument("path", nargs="?", default=".")
    d.add_argument("--fix", action="store_true")
    d.add_argument("--json", action="store_true", dest="json_out")
    d.add_argument(
        "--device", action="store_true",
        help="also probe the device with a bounded compute+readback round trip",
    )

    setup = sub.add_parser("setup", help="model management")
    setup.add_argument("--list", action="store_true", dest="list_models")
    setup.add_argument("--import", dest="import_dir", type=Path, default=None,
                       help="copy local model assets (model.safetensors, "
                            "tokenizer.json/vocab.txt) into the models cache")
    setup.add_argument("--as", dest="import_as", default=None,
                       help="registry short name to import as (with --import)")

    m = sub.add_parser("mcp", help="MCP stdio server")
    m.add_argument("path", nargs="?", default=".")
    m.add_argument("--no-create-index", action="store_true")

    srv = sub.add_parser("serve", help="HTTP server")
    srv.add_argument("path", nargs="?", default=".")
    srv.add_argument("--host", default="127.0.0.1")
    srv.add_argument("--port", type=int, default=7878)
    srv.add_argument("--no-create-index", action="store_true",
                     help="fail if no index exists instead of building one")

    t = sub.add_parser("train", help="fine-tune the embedding model on this repo")
    t.add_argument("path", nargs="?", default=".")
    t.add_argument("--epochs", type=int, default=15)
    t.add_argument("--lr", type=float, default=0.3)
    t.add_argument("--cross-encoder", action="store_true", dest="cross_encoder",
                   help="train a small local cross-encoder reranker on mined "
                        "pairs (activates --rerank's real cross-encoder mode "
                        "with zero downloads)")

    cache = sub.add_parser("cache", help="embedding cache management")
    cache_sub = cache.add_subparsers(dest="cache_command")
    cache_sub.add_parser("stats")
    cc = cache_sub.add_parser("clear")
    cc.add_argument("--yes", "-y", action="store_true")

    listp = sub.add_parser("list", help="list discovered databases")
    listp.add_argument("path", nargs="?", default=".")
    return p


def _add_model_after(sub: argparse.ArgumentParser) -> None:
    """`index --model bge-small <repo>` as well as `--model bge-small index`."""
    sub.add_argument("--model", default=argparse.SUPPRESS,
                     help="embedding model (default: the index's own; code-hash-384 "
                          "for a new index)")


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help(sys.stderr)
        return 2
    set_quiet(args.quiet)
    _install_sigint()
    init_logger(level=args.loglevel if args.loglevel != "warn" else "warning",
                quiet=args.quiet)
    device = "cpu" if args.platform == "cpu" else None
    try:
        return _COMMANDS[args.command](args, device)
    except KeyboardInterrupt:
        return 130
    except Exception as e:  # the CLI boundary: report, exit non-zero
        error_print(str(e))
        if args.loglevel in ("trace", "debug"):
            raise
        return 1


def _cmd_mcp(args, device) -> int:
    from ..server.mcp import run_mcp_server

    return run_mcp_server(Path(args.path), create_index=not args.no_create_index,
                          device=device)


def _cmd_serve(args, device) -> int:
    from ..server.http import serve

    return serve(Path(args.path), host=args.host, port=args.port,
                 initial_index=not args.no_create_index, device=device)


def _cmd_search(args, device) -> int:
    from ..models import parse_model
    from ..search import SearchOptions, search

    if args.model is not None and parse_model(args.model) is None:
        error_print(f"unknown model: {args.model!r}")
        return 1
    if args.files_only and (args.json_out or args.compact):
        error_print("--files-only cannot combine with --json/--compact")
        return 1
    options = SearchOptions(
        limit=args.limit, mode="vector" if args.vector_only else "hybrid",
        rerank=args.rerank, path_filter=args.path_filter, min_score=args.min_score,
        model=args.model, sync=args.sync, create_index=args.create_index,
        no_expand=args.no_expand, rrf_k=args.rrf_k, rerank_top=args.rerank_top,
        per_file=args.max_per_file, store_path=args.store,
    )
    if args.all_repos:
        return _search_all_repos(args, options, device)
    resp = search(args.query, args.path, options, device=device)
    if args.json_out:
        result_print(json.dumps(_response_json(resp, args.scores), indent=2))
    else:
        _print_hits(resp, args)
    return 0


def _print_hits(resp, args) -> None:
    """One response as ``--files-only``, ``--compact`` or the pretty text."""
    if args.files_only:
        for p in dict.fromkeys(h.path for h in resp.hits):
            result_print(p)
    elif args.compact:
        for h in resp.hits:
            result_print(f"{h.path}:{h.start_line + 1}-{h.end_line} {h.score:.3f} "
                         f"{h.kind} {h.signature or ''}".rstrip())
    else:
        _pretty_print(resp, args.scores, full=args.full)


def _search_all_repos(args, options, device) -> int:
    """Federated output: one section per database, results grouped (RRF
    scores compare only within a corpus). Unopenable databases are reported
    and skipped; exit 1 when no database answered with a hit."""
    from ..search import search_all

    grouped = search_all(args.query, args.path, options, device=device)
    if not grouped:
        error_print("no indexes found (cwd/parents or global registry)")
        return 1
    if args.json_out:
        result_print(json.dumps(
            [{"db_path": db, "error": str(resp)} if isinstance(resp, Exception)
             else {"db_path": db, **_response_json(resp, args.scores)}
             for db, resp in grouped], indent=2))
        return 0
    any_hits = False
    for db, resp in grouped:
        if isinstance(resp, Exception):
            error_print(f"[{db}] skipped: {resp}")
            continue
        result_print(f"=== {db} ({resp.total_chunks} chunks)")
        _print_hits(resp, args)
        any_hits = any_hits or bool(resp.hits)
    return 0 if any_hits else 1


def _response_json(resp, scores: bool) -> dict:
    out = {
        "query": resp.query,
        "mode": resp.mode,
        "total_chunks": resp.total_chunks,
        "results": [
            {
                "path": h.path,
                "start_line": h.start_line + 1,
                "end_line": h.end_line,
                "score": round(h.score, 4),
                "kind": h.kind,
                "signature": h.signature,
                "context": h.context,
                "content": h.content,
            }
            for h in resp.hits
        ],
    }
    if resp.rerank_mode:
        out["rerank_mode"] = resp.rerank_mode
    if scores:
        out["timings_ms"] = {k: round(v, 2) for k, v in resp.timings_ms.items()}
    return out


def _pretty_print(resp, scores: bool, full: bool = False) -> None:
    if not resp.hits:
        result_print(f"no results for {resp.query!r}")
        return
    lines = []
    for i, h in enumerate(resp.hits, 1):
        lines.append(
            f"{i}. {h.path}:{h.start_line + 1}-{h.end_line}  "
            f"[{h.kind}]  score={h.score:.3f}"
        )
        if h.signature:
            lines.append(f"   {h.signature}")
        snippet = h.content.strip().split("\n")
        shown = snippet if full else snippet[:3]
        for sline in shown:
            lines.append(f"   | {sline if full else sline[:120]}")
        if len(snippet) > len(shown):
            lines.append(f"   | … ({len(snippet) - len(shown)} more lines)")
        lines.append("")
    if resp.rerank_mode == "proxy-bi-encoder":
        lines.append(
            "note: reranked with the weights-free bi-encoder proxy "
            "(place jina-reranker-v1-turbo-en weights in the models cache "
            "for true cross-encoder quality)"
        )
    if scores:
        t = resp.timings_ms
        lines.append(
            "timings: " + ", ".join(f"{k}={v:.1f}ms" for k, v in t.items())
        )
    result_print("\n".join(lines))


def _cmd_index(args, device) -> int:
    from ..index import (
        IndexOptions,
        index,
        read_metadata,
        register_repo,
        registered_repos,
        unregister_repo,
    )

    rest = list(args.args)
    action = rest.pop(0) if rest and rest[0] in ("add", "remove", "rm", "list") else None
    path = rest[0] if rest else "."
    if action == "add":
        register_repo(Path(path).resolve())
        info_print(f"registered {Path(path).resolve()}")
        return 0
    if action in ("remove", "rm"):      # rm: the reference's alias (cli/mod.rs:23)
        unregister_repo(Path(path).resolve())
        info_print(f"unregistered {Path(path).resolve()}")
        return 0
    if action == "list":
        for repo in registered_repos():
            result_print(repo)
        return 0
    stats = index(path, IndexOptions(
        model=args.model or "code-hash-384", force=args.force, quiet=args.quiet,
        store_path=args.store, int8=args.int8, global_db=args.global_db,
        dry_run=args.dry_run, dedup=args.dedup), device=device)
    if args.dry_run:
        return 0
    if args.register:
        register_repo(Path(path).resolve())
    info_print(f"indexed {stats.files_indexed} files ({stats.chunks_added} chunks) "
               f"in {stats.elapsed_s:.1f}s — db: {stats.db_path}")
    # the weights-free default model gains from fine-tuning on the repo
    # (benchmarks/trained_table.md: 7/9 -> 9/9 top-3 on the labeled set); key
    # on the model the index uses (its metadata overrides the CLI default)
    if (read_metadata(stats.db_path).get("model", "").startswith("code-hash")
            and stats.chunks_added > 0
            and not (stats.db_path / "hash_table.npz").exists()):
        info_print("tip: `codesearch-torch train` fine-tunes retrieval on this "
                   "repo (no downloads; measured 7/9 → 9/9 top-3)")
    return 130 if stats.cancelled else 0


def _named_db(args):
    """The index ``stats`` and ``train`` read: ``--store`` or the one found
    from the path (None after printing why)."""
    from ..index import resolve_database_with_message

    if args.store is not None:
        return Path(args.store)
    db, msg = resolve_database_with_message(Path(args.path))
    if db is None:
        error_print(msg)
    return db


def _cmd_stats(args, device) -> int:
    from ..index import db_stats

    db = _named_db(args)
    if db is None:
        return 1
    s = db_stats(db, device=device)
    if args.json_out:
        result_print(json.dumps(s, indent=2))
        return 0
    fts = s["fts"]
    result_print(
        f"database: {s['db_path']}\n"
        f"model: {s['model']} ({s['vector'].get('dims', '?')}d)\n"
        f"files: {s['files']}  chunks: {s['vector'].get('chunks', '?')}\n"
        f"fts terms: {fts['docs']} docs / {fts['terms']} terms\n"
        f"bloat ratio: {s['vector'].get('bloat_ratio', 1.0)}"
        "  (allocated/live rows; >2.0: rebuild reclaims device memory)\n"
        f"serving: planes {'on' if fts['planes_enabled'] else 'OFF'} "
        f"({fts['plane_rows_used']}/{fts['plane_rows_cap']} rows, "
        f"{fts['plane_builds']} builds, {fts['plane_evictions']} evictions), "
        f"exact tiers: {fts['exact_tier_sidecars']} sidecar(s)\n"
        f"indexed_at: {s['indexed_at']}\n"
        f"primary_language: {s['primary_language']}")
    return 0


def _cmd_clear(args, device) -> int:
    from ..index import clear_database, resolve_database_with_message

    db, msg = resolve_database_with_message(Path(args.path))
    if db is None:
        error_print(msg)
        return 1
    if not args.yes:
        error_print(f"would delete {db} — pass --yes to confirm")
        return 1
    clear_database(db)
    info_print(f"deleted {db}")
    return 0


def _cmd_doctor(args, device) -> int:
    from .doctor import run_doctor

    return run_doctor(Path(args.path), fix=args.fix, json_out=args.json_out,
                      device=args.device, platform=args.platform)


def _cmd_setup(args, device) -> int:
    """``setup --list`` prints the registry; ``setup --import DIR --as NAME``
    copies local model files into the models cache (nothing is downloaded)."""
    from ..models import all_models, parse_model
    from ..utils.constants import get_global_models_cache_dir

    if args.import_dir is None:
        result_print("\n".join(
            f"{spec.short_name:20s} {spec.dims:5d}d  {spec.full_name}"
            + (" (no download needed)" if spec.kind == "hash" else "")
            for spec in all_models()))
        return 0
    if not args.import_as:
        error_print("--import requires --as <short-name> (see setup --list)")
        return 1
    spec = parse_model(args.import_as)
    if spec is None:
        error_print(f"unknown model name: {args.import_as}")
        return 1
    dest = get_global_models_cache_dir() / spec.short_name
    copied = [name for name in ("model.safetensors", "tokenizer.json", "vocab.txt",
                                "config.json") if (args.import_dir / name).exists()]
    if not copied:
        error_print(f"no model assets found in {args.import_dir}")
        return 1
    dest.mkdir(parents=True, exist_ok=True)
    for name in copied:
        shutil.copy2(args.import_dir / name, dest / name)
    info_print(f"imported {', '.join(copied)} → {dest}")
    return 0


def _cmd_cache(args, device) -> int:
    """``cache stats`` (the default): bytes under the embedding cache, by
    cache directory; ``cache clear --yes`` deletes it."""
    from ..utils.constants import get_config_dir

    cache_root = get_config_dir() / "embedding_cache"
    if args.cache_command == "clear":
        if not args.yes:
            error_print(f"would delete {cache_root} — pass --yes to confirm")
            return 1
        shutil.rmtree(cache_root, ignore_errors=True)
        info_print("embedding cache cleared")
        return 0
    per_model = {}
    if cache_root.exists():
        for model_dir in sorted(cache_root.iterdir()):
            per_model[model_dir.name] = sum(f.stat().st_size for f in model_dir.rglob("*")
                                            if f.is_file())
    result_print(json.dumps({"total_bytes": sum(per_model.values()), "models": per_model},
                            indent=2))
    return 0


def _cmd_list(args, device) -> int:
    from ..index import db_stats, find_databases

    dbs = find_databases(Path(args.path))
    if not dbs:
        result_print("no databases found")
        return 0
    for db in dbs:
        s = db_stats(db, device=device)
        result_print(f"{db}  model={s['model']}  files={s['files']}  "
                     f"chunks={s['vector'].get('chunks', '?')}")
    return 0


def _mined_pairs(db: Path, meta: dict, device) -> list:
    from ..models import parse_model
    from ..train.data import mine_pairs
    from ..vectordb import VectorStore

    spec = parse_model(meta.get("model", "code-hash-384"))
    dims = int(meta.get("dimensions", spec.dims if spec else 384))
    store = VectorStore(db, dims=dims, readonly=True, int8=bool(meta.get("int8", False)),
                        device=device)
    return mine_pairs([m for _, m in store.iter_chunks()])


def _cmd_train(args, device) -> int:
    """Fine-tune the hash table on pairs mined from the index, save it as
    ``<db>/hash_table.npz``, delete the indexed chunks and the file manifest
    and re-index with the trained table; with ``--cross-encoder``, train and
    install the local reranker instead."""
    from ..index import IndexOptions, index, read_metadata
    from ..models import parse_model

    db = _named_db(args)
    if db is None:
        return 1
    meta = read_metadata(db)
    if args.cross_encoder:
        return _cmd_train_cross_encoder(args, db, meta, device)
    spec = parse_model(meta.get("model", "code-hash-384"))
    if spec is None or spec.kind != "hash":
        error_print(
            f"train currently supports the hash models; index uses {meta.get('model')!r} "
            "(BERT-family fine-tuning: use codesearch_tpu_torch.train.contrastive)")
        return 1
    pairs = _mined_pairs(db, meta, device)
    if len(pairs) < 16:
        error_print(f"only {len(pairs)} training pairs mined — index more code first")
        return 1
    from ..models.hash_embedder import make_table, save_table
    from ..train.hash_finetune import finetune_table

    info_print(f"fine-tuning on {len(pairs)} mined pairs ({args.epochs} epochs)")
    trained, losses = finetune_table(make_table(spec.dims, device=device), pairs,
                                     epochs=args.epochs, learning_rate=args.lr)
    if not losses:
        error_print("training produced no steps")
        return 1
    save_table(trained, db / "hash_table.npz")
    info_print(f"loss {losses[0]:.4f} → {losses[-1]:.4f}; re-embedding corpus")
    _drop_indexed_chunks(db, meta, spec.dims, device)
    stats = index(args.path, IndexOptions(model=spec.short_name, quiet=args.quiet,
                                          store_path=args.store), device=device)
    info_print(f"re-indexed {stats.files_indexed} files ({stats.chunks_added} chunks) "
               f"with the trained table")
    return 0


def _drop_indexed_chunks(db: Path, meta: dict, dims: int, device) -> None:
    """Delete every manifest file's chunks from the vector store and the
    FTS (as ``index`` does for a deleted file), then the manifest, so the
    re-index after ``train`` embeds every file anew with the trained table
    and keeps none of the earlier rows. (The JAX CLI drops only the
    manifest, and its stores keep the untrained rows beside the new ones.)"""
    from ..fts import FtsStore
    from ..index import FileMetaStore
    from ..utils.constants import FILE_META_DB_NAME, FTS_DIR_NAME
    from ..vectordb import VectorStore

    fm = FileMetaStore.load_or_create(db)
    store = VectorStore(db, dims=dims, int8=bool(meta.get("int8", False)), device=device)
    fts = FtsStore(db / FTS_DIR_NAME, device=device)
    for path in list(fm.files):
        ids = fm.remove_file(path)
        if ids:
            store.delete_chunks(ids)
            for cid in ids:
                fts.delete_chunk(cid)
    store.save()
    fts.commit()
    (db / FILE_META_DB_NAME).unlink(missing_ok=True)


def _cmd_train_cross_encoder(args, db: Path, meta: dict, device) -> int:
    """``train --cross-encoder``: train and install the local reranker, so
    ``search --rerank`` runs a real cross-encoder with no download."""
    from ..train.cross_encoder_train import train_and_export
    from ..utils.constants import get_global_models_cache_dir

    pairs = _mined_pairs(db, meta, device)
    if len(pairs) < 16:
        error_print(f"only {len(pairs)} training pairs mined — index more code first")
        return 1
    epochs = max(1, min(args.epochs, 10))
    info_print(f"training local cross-encoder on {len(pairs)} mined pairs ({epochs} epochs)")
    out, losses = train_and_export(
        pairs, get_global_models_cache_dir(), epochs=epochs, device=device,
        on_epoch=lambda e, n, ls: info_print(f"  epoch {e}/{n}: loss {ls:.4f}"))
    if not losses:
        error_print("training produced no steps")
        return 1
    info_print(f"loss {losses[0]:.4f} → {losses[-1]:.4f}; installed at {out}")
    info_print("`codesearch-torch search --rerank ...` now runs the real "
               "cross-encoder (rerank_mode=cross-encoder)")
    return 0


_COMMANDS = {
    "search": _cmd_search, "index": _cmd_index, "stats": _cmd_stats, "clear": _cmd_clear,
    "doctor": _cmd_doctor, "setup": _cmd_setup, "mcp": _cmd_mcp, "serve": _cmd_serve,
    "train": _cmd_train, "cache": _cmd_cache, "list": _cmd_list,
}
PORTED = tuple(_COMMANDS)    # every subcommand of the JAX CLI
