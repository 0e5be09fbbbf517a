"""1M-doc engine benchmark: batched QPS (bm25 + wand, pairs + arrays
surfaces), in-run single-core C++ baseline on the same workload, and
warmed single-query p50 (default routing — exercises the sparse
single-query/term-split routes at this corpus size)."""

import sys
import time

sys.path.insert(0, ".")

from searchlite.utils.devguard import guard_backend  # noqa: E402

guard_backend(__file__)

import bench  # noqa: E402

bench.N_DOCS = 1_000_000
bench.VOCAB = 50_000
bench.N_BATCHES = 2


def main():
    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    t0 = time.perf_counter()
    docs = bench.build_docs()
    print(f"gen {time.perf_counter()-t0:.0f}s", flush=True)
    t0 = time.perf_counter()
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}]}))
    writer = index.writer()
    writer.add_documents(docs)
    writer.commit()
    print(f"ingest {time.perf_counter()-t0:.0f}s", flush=True)
    t0 = time.perf_counter()
    reader = index.reader()
    batches = bench.build_queries()
    for execution in ("bm25", "wand"):
        reader.search_batch(batches[0], limit=bench.K,
                            execution=execution)
    print(f"upload+warm {time.perf_counter()-t0:.0f}s", flush=True)

    stream = batches[1:] * 3
    n = sum(len(b) for b in stream)
    for execution in ("bm25", "wand"):
        for output in ("pairs", "arrays"):
            # one pipelined call over the whole stream (dispatch all,
            # one bulk fetch) — the serving pattern bench.py measures;
            # Warm EVERY distinct batch: each batch can occupy a
            # different tier-shape bucket, and a compile must not land
            # inside the first timed region.
            reader.search_batch_many(batches[1:], limit=bench.K,
                                     execution=execution,
                                     output=output)  # warm
            t0 = time.perf_counter()
            reader.search_batch_many(stream, limit=bench.K,
                                     execution=execution,
                                     output=output)
            dt = time.perf_counter() - t0
            print(f"1M-doc batched QPS [{execution}/{output}]: "
                  f"{n/dt:.0f}", flush=True)
    # batch-width scaling at 1M: the same queries re-chunked at 4096
    flat_q = [q for b in stream for q in b]
    wide = [flat_q[i:i + 4096] for i in range(0, len(flat_q), 4096)]
    reader.search_batch_many(wide, limit=bench.K, output="arrays")
    t0 = time.perf_counter()
    reader.search_batch_many(wide, limit=bench.K, output="arrays")
    dt = time.perf_counter() - t0
    print(f"1M-doc batched QPS [bm25/arrays/b4096]: "
          f"{len(flat_q)/dt:.0f}", flush=True)

    best = bench.cpp_engine_qps(reader, batches[1])
    if best is not None:
        print(f"1M-doc C++ engine (1 core, same workload): "
              f"{best[1]:.0f} qps [{best[0]}]", flush=True)

    singles = batches[1][:30]
    for q in singles[:5]:
        reader.search({"query": q, "limit": bench.K})  # warm buckets
    lat = []
    for q in singles:
        t0 = time.perf_counter()
        reader.search({"query": q, "limit": bench.K})
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    print(f"1M-doc single-query p50 (default routing): "
          f"{lat[len(lat)//2]:.1f} ms", flush=True)


if __name__ == "__main__":
    main()
