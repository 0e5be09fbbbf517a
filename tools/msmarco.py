"""MS MARCO passage benchmark runner (BASELINE.md config 4).

Usage (requires the MS MARCO passage collection on disk — no network):

    python tools/msmarco.py --collection collection.tsv \
        --queries queries.dev.small.tsv [--limit-docs 1000000]

collection.tsv: `pid \t passage` per line; queries: `qid \t text`.
Builds the index through the full ingest path, then reports batched
exact top-10 QPS and p50 single-query latency. When the files are
absent the script exits with instructions (the sandbox has no egress).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--collection", default="collection.tsv")
    parser.add_argument("--queries", default="queries.dev.small.tsv")
    parser.add_argument("--limit-docs", type=int, default=None)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--k", type=int, default=10)
    args = parser.parse_args()

    if not os.path.exists(args.collection) or not os.path.exists(args.queries):
        print(json.dumps({
            "error": "msmarco files not found",
            "hint": "place collection.tsv and queries.dev.small.tsv in cwd "
                    "(no network egress in this sandbox)",
        }))
        return 1

    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    t0 = time.perf_counter()
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}]}))
    writer = index.writer()
    count = 0
    with open(args.collection, encoding="utf-8") as f:
        for line in f:
            pid, _, passage = line.partition("\t")
            writer.add_document({"_id": pid, "body": passage.rstrip("\n")})
            count += 1
            if count % 200_000 == 0:
                writer.commit()
                writer = index.writer()
            if args.limit_docs and count >= args.limit_docs:
                break
    writer.commit()
    build_s = time.perf_counter() - t0

    queries = []
    with open(args.queries, encoding="utf-8") as f:
        for line in f:
            _qid, _, text = line.partition("\t")
            queries.append(text.strip())

    reader = index.reader()
    batches = [queries[i:i + args.batch]
               for i in range(0, len(queries), args.batch)]
    batches = [b for b in batches if len(b) == args.batch][:12]
    for b in batches[:2]:
        reader.search_batch(b, limit=args.k)  # warm compiles
    t0 = time.perf_counter()
    n = 0
    for b in batches[2:]:
        reader.search_batch(b, limit=args.k)
        n += len(b)
    qps = n / (time.perf_counter() - t0)

    lat = []
    for q in queries[:20]:
        t1 = time.perf_counter()
        reader.search({"query": q, "limit": args.k})
        lat.append((time.perf_counter() - t1) * 1000)
    p50 = sorted(lat)[len(lat) // 2]

    print(json.dumps({
        "metric": "msmarco_batched_bm25_top10_qps",
        "value": round(qps, 2),
        "unit": "qps",
        "detail": {"docs": count, "index_build_s": round(build_s, 1),
                   "p50_single_query_ms": round(p50, 1)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
