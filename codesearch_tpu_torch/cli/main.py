"""Command line of the port: ``python -m codesearch_tpu_torch.cli`` (or
``codesearch-torch``). It takes the JAX CLI's arguments; ``index`` and
``search`` run on torch, every other subcommand exits 2 as not yet ported.
``--platform cpu`` runs on the CPU; otherwise the first CUDA device."""

from __future__ import annotations

import json
import sys
from pathlib import Path

from codesearch_tpu.cli.main import _install_sigint, _pretty_print, _response_json
from codesearch_tpu.cli.main import build_parser as _build_parser
from codesearch_tpu.utils.logger import init_logger
from codesearch_tpu.utils.output import error_print, info_print, result_print, set_quiet

PORTED = ("index", "search")


def build_parser():
    p = _build_parser()
    p.prog = "codesearch-torch"
    p.description = "Local semantic code search on PyTorch/CUDA"
    for action in p._actions:
        if action.dest == "platform":
            action.choices = ["auto", "cuda", "cpu"]
            action.help = "device: auto/cuda = the first CUDA device, cpu = the CPU"
    return p


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
    from codesearch_tpu.models import parse_model

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


def _cmd_index(args, device) -> int:
    from codesearch_tpu.index import register_repo

    from ..index import IndexOptions, index

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
