"""Command-line interface.

Subcommand parity with searchlite-cli (`searchlite-cli/src/main.rs:31-105`):
init / add / update / delete / commit / search / http / inspect / compact.
JSONL ingest, full-request JSON via --request/--request-stdin, --aggs /
--aggs-file, --sort "field:asc,other:desc", vector flags, BM25 defaults
k1=0.9 b=0.4 (`main.rs:196-197`).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from searchlite.api.types import IndexOptions, SearchRequest
from searchlite.errors import SearchliteError
from searchlite.index import Index
from searchlite.index.manifest import Schema


def options(path: str, create: bool) -> IndexOptions:
    return IndexOptions(path=path, create_if_missing=create,
                        enable_positions=True, bm25_k1=0.9, bm25_b=0.4)


def cmd_init(args) -> int:
    with open(args.schema) as f:
        schema = Schema.from_json(json.load(f))
    Index.create(options(args.index, True), schema)
    print(f"initialized index at {args.index}")
    return 0


def _read_jsonl(path: str):
    source = sys.stdin if path == "-" else open(path)
    try:
        for line in source:
            line = line.strip()
            if line:
                yield json.loads(line)
    finally:
        if source is not sys.stdin:
            source.close()


def cmd_add(args) -> int:
    index = Index.open(options(args.index, False))
    writer = index.writer()
    count = 0
    # batched adds: one WAL append per chunk, with the file's raw line
    # bytes spliced through as the WAL payloads (no re-serialization)
    source = sys.stdin if args.doc == "-" else open(args.doc)
    try:
        docs, raws = [], []
        for line in source:
            line = line.strip()
            if not line:
                continue
            docs.append(json.loads(line))
            raws.append(line.encode())
            if len(docs) >= 10_000:
                writer.add_documents(docs, raws=raws)
                count += len(docs)
                docs, raws = [], []
        if docs:
            writer.add_documents(docs, raws=raws)
            count += len(docs)
    finally:
        if source is not sys.stdin:
            source.close()
    print(f"buffered {count} documents (run `commit` to persist)")
    return 0


def cmd_delete(args) -> int:
    index = Index.open(options(args.index, False))
    writer = index.writer()
    with open(args.ids) as f:
        ids = [line.strip() for line in f if line.strip()]
    writer.delete_documents(ids)
    print(f"buffered {len(ids)} deletes (run `commit` to persist)")
    return 0


def cmd_commit(args) -> int:
    index = Index.open(options(args.index, False))
    writer = index.writer()
    pending = writer.pending_ops
    writer.commit()
    # async auto-merge runs on a daemon thread; a one-shot CLI process
    # would exit before it fires, so drain here (servers keep the
    # thread and never block on this)
    from searchlite.api.writer import wait_for_background_merges

    wait_for_background_merges(timeout=None)
    print(f"committed {pending} pending operations")
    return 0


def _parse_sort(spec: str) -> list[dict]:
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            field, order = part.rsplit(":", 1)
            out.append({"field": field, "order": order})
        else:
            out.append({"field": part})
    return out


def build_search_request(args) -> dict:
    if args.request or args.request_stdin:
        if args.request_stdin:
            return json.load(sys.stdin)
        with open(args.request) as f:
            return json.load(f)
    req: dict = {"limit": args.limit, "execution": args.execution,
                 "return_hits": args.return_hits,
                 "return_stored": args.return_stored}
    vector_query = None
    if args.vector_field and args.vector:
        vector_query = {
            "field": args.vector_field,
            "vector": json.loads(args.vector),
            "alpha": args.alpha,
        }
        if args.vector_k is not None:
            vector_query["k"] = args.vector_k
        if args.vector_ef_search is not None:
            vector_query["ef_search"] = args.vector_ef_search
        if args.vector_candidates is not None:
            vector_query["candidate_size"] = args.vector_candidates
    if args.query is not None:
        req["query"] = args.query
    elif vector_query is not None:
        req["query"] = dict(vector_query, type="vector")
    else:
        raise SearchliteError(
            "search query is required unless --request or --request-stdin "
            "is provided")
    if vector_query is not None and args.query is not None:
        req["vector_query"] = vector_query
    if args.bmw_block_size is not None:
        req["bmw_block_size"] = args.bmw_block_size
    if args.fields:
        req["fields"] = [f.strip() for f in args.fields.split(",")]
    if args.highlight:
        req["highlight_field"] = args.highlight
    if args.cursor:
        req["cursor"] = args.cursor
    if args.sort:
        req["sort"] = _parse_sort(args.sort)
    aggs_json = None
    if args.aggs:
        aggs_json = json.loads(args.aggs)
    elif args.aggs_file:
        with open(args.aggs_file) as f:
            aggs_json = json.load(f)
    if aggs_json:
        req["aggs"] = aggs_json
    return req


def _cli_mesh(spec):
    """--mesh auto|N -> a ("query","shard") device mesh, or None when
    unset / only one device is visible (parallel/mesh.py holds the
    shared spec parser); bad specs exit as a CLI error, not a
    traceback."""
    from searchlite.parallel.mesh import parse_mesh_spec

    try:
        return parse_mesh_spec(spec)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2) from None


def cmd_search(args) -> int:
    index = Index.open(options(args.index, False))
    reader = index.reader()
    request = SearchRequest.from_json(build_search_request(args))
    result = reader.search(request, mesh=_cli_mesh(args.mesh))
    print(json.dumps(result.to_json(), indent=2, ensure_ascii=False))
    return 0


def cmd_search_batch(args) -> int:
    """Extension: batch of structured queries, one device launch.

    --queries-file lines are query strings, or JSON objects
    {"query": ..., "filter": ..., "limit": ...} for per-query knobs;
    --filter applies one shared filter to every query."""
    index = Index.open(options(args.index, False))
    reader = index.reader()
    shared_filter = json.loads(args.filter) if args.filter else None
    queries: list[str] = []
    filters: list = []
    limits: list[int] = []
    for q in args.query or []:
        queries.append(q)
        filters.append(shared_filter)
        limits.append(args.limit)
    if args.queries_file:
        with open(args.queries_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("{"):
                    obj = json.loads(line)
                    queries.append(obj["query"])
                    filters.append(obj.get("filter", shared_filter))
                    limits.append(int(obj.get("limit", args.limit)))
                else:
                    queries.append(line)
                    filters.append(shared_filter)
                    limits.append(args.limit)
    rows = reader.search_batch(
        queries, limit=max(limits, default=args.limit),
        execution=args.execution,
        filters=filters if any(f is not None for f in filters) else None,
        limits=limits, mesh=_cli_mesh(args.mesh))
    print(json.dumps({"results": [
        [{"doc_id": d, "score": s} for d, s in row] for row in rows
    ]}, indent=2, ensure_ascii=False))
    return 0


def cmd_inspect(args) -> int:
    index = Index.open(options(args.index, False))
    print(json.dumps(index.manifest.to_json(), indent=2))
    return 0


def cmd_compact(args) -> int:
    index = Index.open(options(args.index, False))
    index.compact()
    print("compacted")
    return 0


def cmd_merge(args) -> int:
    index = Index.open(options(args.index, False))
    n = index.merge_segments(max_docs=args.max_docs)
    print(f"merged {n} segments" if n else "nothing to merge")
    return 0


def cmd_http(args) -> int:
    from searchlite.http_server import run_server

    run_server(index_path=args.index, bind=args.bind,
               require_existing_index=args.require_existing_index,
               mesh=args.mesh)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="searchlite",
        description="Embedded full-text search engine (JAX)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("init", help="Initialize a new index with a schema")
    p.add_argument("index")
    p.add_argument("schema")
    p.set_defaults(fn=cmd_init)

    for name, help_text in (("add", "Add documents from a JSONL file"),
                            ("update", "Upsert documents from a JSONL file")):
        p = sub.add_parser(name, help=help_text)
        p.add_argument("index")
        p.add_argument("doc")
        p.set_defaults(fn=cmd_add)

    p = sub.add_parser("delete",
                       help="Delete documents by id (newline-delimited)")
    p.add_argument("index")
    p.add_argument("ids")
    p.set_defaults(fn=cmd_delete)

    p = sub.add_parser("commit", help="Commit pending documents")
    p.add_argument("index")
    p.set_defaults(fn=cmd_commit)

    p = sub.add_parser("search", help="Execute a search query")
    p.add_argument("index")
    p.add_argument("-q", "--query")
    p.add_argument("--limit", type=int, default=10)
    p.add_argument("--execution", default="wand",
                   choices=("bm25", "wand", "bmw"))
    p.add_argument("--bmw-block-size", type=int, default=None)
    p.add_argument("--fields")
    p.add_argument("--return-stored", action="store_true")
    p.add_argument("--highlight")
    p.add_argument("--cursor")
    p.add_argument("--return-hits", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--sort")
    p.add_argument("--request")
    p.add_argument("--request-stdin", action="store_true")
    p.add_argument("--vector-field")
    p.add_argument("--vector")
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--vector-k", type=int, default=None)
    p.add_argument("--vector-ef-search", type=int, default=None)
    p.add_argument("--vector-candidates", type=int, default=None)
    p.add_argument("--aggs")
    p.add_argument("--aggs-file")
    p.add_argument("--mesh", default=None, help='doc-shard query execution over a device mesh: "auto" = all local devices, N = that many (single-device hosts ignore it)')
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser(
        "search-batch",
        help="Batched search: many query strings in one device launch")
    p.add_argument("index")
    p.add_argument("-q", "--query", action="append",
                   help="query string (repeatable)")
    p.add_argument("--queries-file",
                   help="file with one query per line: a plain string "
                        "or a JSON object {query, filter?, limit?}")
    p.add_argument("--limit", type=int, default=10)
    p.add_argument("--execution", default="bm25",
                   choices=["bm25", "wand", "bmw"])
    p.add_argument("--filter",
                   help="shared filter JSON applied to every query")
    p.add_argument("--mesh", default=None, help='doc-shard query execution over a device mesh: "auto" = all local devices, N = that many (single-device hosts ignore it)')
    p.set_defaults(fn=cmd_search_batch)

    p = sub.add_parser("http", help="Start the HTTP server for one index")
    p.add_argument("index")
    p.add_argument("--bind", default="127.0.0.1:7700")
    p.add_argument("--require-existing-index", action="store_true")
    p.add_argument("--mesh", default=None, help='doc-shard query execution over a device mesh: "auto" = all local devices, N = that many (single-device hosts ignore it)')
    p.set_defaults(fn=cmd_http)

    p = sub.add_parser("inspect", help="Inspect manifest and segments")
    p.add_argument("index")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("compact", help="Compact segments")
    p.add_argument("index")
    p.set_defaults(fn=cmd_compact)

    p = sub.add_parser(
        "merge", help="Structurally merge segments (no stored fields "
        "required; tombstones expunged)")
    p.add_argument("index")
    p.add_argument("--max-docs", type=int, default=None,
                   help="only merge segments at or under this many docs")
    p.set_defaults(fn=cmd_merge)

    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except SearchliteError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # downstream pager/head closed the pipe: exit quietly, the
        # POSIX convention (re-opening devnull avoids a second
        # BrokenPipeError from the interpreter's stdout flush at exit)
        try:
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        except OSError:
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
