"""Command line of the port: ``python -m codesearch_tpu_torch.cli`` (or
``codesearch-torch``). It takes the JAX CLI's arguments; ``index`` and
``search`` run on torch, every other subcommand exits 2 as not yet ported.
``--platform cpu`` runs on the CPU; otherwise the first CUDA device."""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
from pathlib import Path

from .. import __version__
from ..utils import constants
from ..utils.logger import init_logger
from ..utils.output import error_print, info_print, result_print, set_quiet

PORTED = ("index", "search")


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
    if args.command not in PORTED:
        error_print(f"`{args.command}` is not yet ported to the torch package "
                    "(ROADMAP.md Queue 1); the JAX CLI `codesearch` has it")
        return 2
    set_quiet(args.quiet)
    _install_sigint()
    init_logger(level=args.loglevel if args.loglevel != "warn" else "warning",
                quiet=args.quiet)
    device = "cpu" if args.platform == "cpu" else None
    try:
        if args.command == "search":
            return _cmd_search(args, device)
        return _cmd_index(args, device)
    except KeyboardInterrupt:
        return 130
    except Exception as e:  # the CLI boundary: report, exit non-zero
        error_print(str(e))
        if args.loglevel in ("trace", "debug"):
            raise
        return 1


def _cmd_search(args, device) -> int:
    from ..models import parse_model
    from ..search import SearchOptions, search

    if args.model is not None and parse_model(args.model) is None:
        error_print(f"unknown model: {args.model!r}")
        return 1
    if args.all_repos:
        error_print("--all-repos is not yet ported to the torch package")
        return 2
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
    resp = search(args.query, args.path, options, device=device)
    if args.files_only:
        for p in dict.fromkeys(h.path for h in resp.hits):
            result_print(p)
    elif args.json_out:
        result_print(json.dumps(_response_json(resp, args.scores), indent=2))
    elif args.compact:
        for h in resp.hits:
            result_print(f"{h.path}:{h.start_line + 1}-{h.end_line} {h.score:.3f} "
                         f"{h.kind} {h.signature or ''}".rstrip())
    else:
        _pretty_print(resp, args.scores, full=args.full)
    return 0


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
    if scores:
        t = resp.timings_ms
        lines.append(
            "timings: " + ", ".join(f"{k}={v:.1f}ms" for k, v in t.items())
        )
    result_print("\n".join(lines))


def _cmd_index(args, device) -> int:
    from ..index import IndexOptions, index, register_repo

    rest = list(args.args)
    if rest and rest[0] in ("add", "remove", "rm", "list"):
        error_print("index registry subcommands are not yet ported; use `codesearch index`")
        return 2
    path = rest[0] if rest else "."
    stats = index(path, IndexOptions(
        model=args.model or "code-hash-384", force=args.force, quiet=args.quiet,
        store_path=args.store, int8=args.int8, global_db=args.global_db,
        dry_run=args.dry_run, dedup=args.dedup), device=device)
    if args.register:
        register_repo(Path(path).resolve())
    info_print(f"indexed {stats.files_indexed} files ({stats.chunks_added} chunks) "
               f"in {stats.elapsed_s:.1f}s — db: {stats.db_path}")
    return 130 if stats.cancelled else 0
