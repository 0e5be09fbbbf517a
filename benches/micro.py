"""Micro-benchmarks mirroring the reference's criterion suite
(`searchlite-core/benches/end_to_end.rs`, `benches/aggs.rs`):

    index_small               50-doc commit loop
    search_small              20 docs, top-5
    search_nested_filters     40 docs, 2 nested clauses
    search_cursor_pagination  2500 docs, 20/page full drain
    aggs_terms_stats          1000 docs, terms + stats + histogram

Prints one JSON line per scenario. Run: python benches/micro.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from searchlite.utils.devguard import guard_backend  # noqa: E402

guard_backend(__file__)

from searchlite.api.types import IndexOptions, StorageType  # noqa: E402
from searchlite.errors import QueryError  # noqa: E402
from searchlite.index import Index  # noqa: E402
from searchlite.index.manifest import Schema  # noqa: E402

SCHEMA = {
    "text_fields": [{"name": "body", "analyzer": "default", "stored": True,
                     "indexed": True}],
    "keyword_fields": [{"name": "tag", "stored": True, "indexed": True,
                        "fast": True}],
    "numeric_fields": [{"name": "n", "i64": True, "fast": True,
                        "stored": True}],
    "nested_fields": [{
        "name": "attrs",
        "fields": [
            {"type": "keyword", "name": "k", "stored": True,
             "indexed": False, "fast": True},
            {"type": "numeric", "name": "v", "i64": True, "fast": True,
             "stored": True},
        ],
        "nullable": True,
    }],
}


def fresh_index():
    return Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json(SCHEMA))


def mk_doc(i: int, nested=False):
    doc = {"_id": str(i), "body": f"document number {i} with words "
                                  f"{'alpha' if i % 2 else 'beta'} gamma",
           "tag": f"t{i % 5}", "n": i}
    if nested:
        doc["attrs"] = [{"k": f"k{i % 3}", "v": i % 7},
                        {"k": f"k{(i + 1) % 3}", "v": (i + 1) % 7}]
    return doc


def timeit(fn, iters: int) -> float:
    fn()  # warmup
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def bench_index_small():
    def run():
        index = fresh_index()
        writer = index.writer()
        for i in range(50):
            writer.add_document(mk_doc(i))
        writer.commit()

    return {"bench": "index_small", "unit": "ms",
            "value": round(timeit(run, 5) * 1000, 2)}


def bench_search_small():
    index = fresh_index()
    writer = index.writer()
    for i in range(20):
        writer.add_document(mk_doc(i))
    writer.commit()
    reader = index.reader()

    def run():
        reader.search({"query": "alpha gamma", "limit": 5})

    return {"bench": "search_small", "unit": "ms",
            "value": round(timeit(run, 20) * 1000, 2)}


def bench_search_nested_filters():
    index = fresh_index()
    writer = index.writer()
    for i in range(40):
        writer.add_document(mk_doc(i, nested=True))
    writer.commit()
    reader = index.reader()
    request = {
        "query": "document", "limit": 10,
        "filter": {"And": [
            {"Nested": {"path": "attrs", "filter": {
                "KeywordEq": {"field": "k", "value": "k1"}}}},
            {"Nested": {"path": "attrs", "filter": {
                "I64Range": {"field": "v", "min": 2, "max": 6}}}},
        ]},
    }

    def run():
        reader.search(request)

    return {"bench": "search_nested_filters", "unit": "ms",
            "value": round(timeit(run, 20) * 1000, 2)}


def bench_cursor_pagination():
    index = fresh_index()
    writer = index.writer()
    for i in range(2500):
        writer.add_document(mk_doc(i))
    writer.commit()
    reader = index.reader()

    def run():
        # the engine's drain API: block fetches, page-of-20 slices —
        # identical page sequence to the sequential loop (tested in
        # tests/test_scroll.py), ~2 device round trips instead of 125
        pages = reader.search_scroll({"query": "document", "limit": 20})
        assert len(pages) >= 125

    def run_sequential():
        cursor = None
        pages = 0
        while True:
            req = {"query": "document", "limit": 20}
            if cursor:
                req["cursor"] = cursor
            res = reader.search(req)
            cursor = res.next_cursor
            pages += 1
            if cursor is None:
                break
        assert pages >= 125

    return [
        {"bench": "search_cursor_pagination_2500", "unit": "ms",
         "value": round(timeit(run, 2) * 1000, 2)},
        # the per-page loop stays measured: it is RTT-floored on a
        # remote-attached device (125 sequential round trips)
        {"bench": "search_cursor_pagination_2500_sequential",
         "unit": "ms",
         "value": round(timeit(run_sequential, 2) * 1000, 2)},
    ]


def bench_aggs():
    index = fresh_index()
    writer = index.writer()
    for i in range(1000):
        writer.add_document(mk_doc(i))
    writer.commit()
    reader = index.reader()
    request = {
        "query": "document", "limit": 1,
        "aggs": {
            "tags": {"type": "terms", "field": "tag",
                     "aggs": {"s": {"type": "stats", "field": "n"}}},
            "h": {"type": "histogram", "field": "n", "interval": 100},
        },
    }

    def run():
        reader.search(request)

    return {"bench": "aggs_terms_stats_histogram_1000", "unit": "ms",
            "value": round(timeit(run, 5) * 1000, 2)}


def bench_search_pruned():
    """Doc-tile pruned execution (execution=bmw) on a mixed-idf corpus:
    one rare + common-term query where block-max pruning has bite."""
    import os
    import random

    os.environ.setdefault("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")
    rng = random.Random(9)
    index = fresh_index()
    writer = index.writer()
    vocab = [f"t{i}" for i in range(500)]
    weights = [1.0 / (j + 1) for j in range(500)]
    for i in range(5000):
        writer.add_document({
            "_id": str(i), "tag": "a", "n": i,
            "body": " ".join(rng.choices(vocab, weights=weights,
                                         k=20))})
    writer.commit()
    reader = index.reader()
    request = {"query": "t0 t1 t400 t450", "limit": 10,
               "execution": "bmw"}
    reader.search(request)  # warm

    def run():
        reader.search(request)

    return {"bench": "search_pruned_bmw_5000", "unit": "ms",
            "value": round(timeit(run, 10) * 1000, 2)}


def bench_vector_hybrid():
    """Vector-only + hybrid alpha-blend search over 10k 64-dim cosine
    vectors (BASELINE config 5's shape; exact matmul similarity)."""
    import random

    rng = random.Random(17)
    schema = Schema.from_json({
        "text_fields": [{"name": "body", "analyzer": "default",
                         "stored": False, "indexed": True}],
        "vector_fields": [{"name": "emb", "dim": 64,
                           "metric": "Cosine"}],
    })
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY), schema)
    writer = index.writer()
    vocab = [f"t{i}" for i in range(200)]
    for i in range(10_000):
        writer.add_document({
            "_id": str(i),
            "body": " ".join(rng.choices(vocab, k=12)),
            "emb": [rng.gauss(0, 1) for _ in range(64)]})
    writer.commit()
    reader = index.reader()
    qvec = [rng.gauss(0, 1) for _ in range(64)]
    vec_only = {"query": {"type": "vector", "field": "emb",
                          "vector": qvec, "alpha": 0.0}, "limit": 10}
    hybrid = {"query": "t1 t2 t3",
              "vector_query": {"field": "emb", "vector": qvec,
                               "alpha": 0.5},
              "limit": 10}
    out = []
    for name, req in (("vector_only_10k", vec_only),
                      ("hybrid_blend_10k", hybrid)):
        try:
            reader.search(req)  # warm

            def run(req=req):
                reader.search(req)

            out.append({"bench": name, "unit": "ms",
                        "value": round(timeit(run, 10) * 1000, 2)})
        except QueryError as e:
            out.append({"bench": name, "error": str(e)})
    return out


def bench_fresh_commit_visibility():
    """Commit-to-searchable latency for a realtime segment: one 200-doc
    commit followed immediately by a query that must see the new docs.
    On an accelerator this is the host tier's headline — the fresh
    segment serves from host RAM with no HBM upload or remote compile
    (docs/architecture.md "The host tier"); the scenario measures the
    whole reopen+search path either way."""
    index = fresh_index()
    writer = index.writer()
    for i in range(500):
        writer.add_document(mk_doc(i))
    writer.commit()
    index.reader().search({"query": "alpha", "limit": 5})  # warm base
    n = [500]

    def run():
        w = index.writer()
        for i in range(n[0], n[0] + 200):
            w.add_document(mk_doc(i))
        n[0] += 200
        w.commit()
        out = index.reader().search(
            {"query": "alpha gamma", "limit": 5})
        assert out.hits

    return {"bench": "fresh_commit_visibility_200docs", "unit": "ms",
            "value": round(timeit(run, 5) * 1000, 2)}


def bench_merge_segments():
    """Structural fold of 10 x 200-doc segments into one
    (Index.merge_segments) — the log-structured write story's
    maintenance op (no re-ingestion; contrast compact)."""
    def run():
        index = fresh_index()
        for c in range(10):
            w = index.writer()
            for i in range(c * 200, (c + 1) * 200):
                w.add_document(mk_doc(i))
            w.commit()
        assert index.merge_segments() == 10

    return {"bench": "merge_10x200doc_segments", "unit": "ms",
            "value": round(timeit(run, 3) * 1000, 2)}


def main():
    for bench in (bench_index_small, bench_search_small,
                  bench_search_nested_filters, bench_cursor_pagination,
                  bench_aggs, bench_search_pruned,
                  bench_fresh_commit_visibility, bench_merge_segments):
        result = bench()
        for line in result if isinstance(result, list) else [result]:
            print(json.dumps(line), flush=True)
    for line in bench_vector_hybrid():
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
