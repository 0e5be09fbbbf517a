"""Profile the HOST side of a batched search: where do the ~50ms per
1024-query batch go when the device step is ~6ms (ops/sparse.py)?

Builds the headline bench corpus shape (100k docs) on the CPU backend,
then times each host-prep stage standalone and cProfiles the full
search_batch_many stream. Run with JAX_PLATFORMS=cpu (device time then
pollutes less; the target is host work, which is platform-independent).
"""

from __future__ import annotations

import cProfile
import io
import pstats
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, ".")
import bench  # noqa: E402  (reuses the headline corpus/query builders)


def main():
    docs = bench.build_docs()
    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}]}))
    writer = index.writer()
    writer.add_documents(docs)
    writer.commit()
    reader = index.reader()
    batches = bench.build_queries()
    queries = batches[1]

    # warm everything (compiles, memos)
    reader.search_batch(queries, limit=10)

    seg = reader.segments[0]
    dseg = reader.device_segments[0]

    # stage 1: query analysis
    t0 = time.perf_counter()
    fields = [f.name for f in reader.schema.text_fields]
    analyzed = reader._analyze_batches([queries], fields)[0]
    t_analyze = time.perf_counter() - t0

    from searchlite.ops.impact import (
        build_impact_batch,
        ensure_dense_tables,
        subset_impact_batch,
    )
    from searchlite.ops.sparse import partition_sparse_batch

    # stage 2: build_impact_batch (lazy)
    t0 = time.perf_counter()
    qb = build_impact_batch(seg, dseg, analyzed, lazy_tables=True)
    t_build = time.perf_counter() - t0

    # stage 3: partition
    t0 = time.perf_counter()
    part = partition_sparse_batch(qb, 32)
    t_part = time.perf_counter() - t0

    # stage 4: heavy repack
    t0 = time.perf_counter()
    if part is not None and len(part["heavy_idx"]):
        hqb = subset_impact_batch(qb, part["heavy_idx"])
        ensure_dense_tables(hqb)
        n_heavy = len(part["heavy_idx"])
    else:
        n_heavy = 0
    t_repack = time.perf_counter() - t0

    print(f"analyze   {t_analyze * 1000:8.2f} ms")
    print(f"build     {t_build * 1000:8.2f} ms")
    print(f"partition {t_part * 1000:8.2f} ms "
          f"(light={len(part['light_idx']) if part else 0})")
    print(f"repack    {t_repack * 1000:8.2f} ms (heavy={n_heavy})")

    # full end-to-end stream on CPU backend, profiled
    stream = batches[1:] * 2
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    reader.search_batch_many(stream, limit=10)
    pr.disable()
    dt = time.perf_counter() - t0
    nq = sum(len(b) for b in stream)
    print(f"\nstream: {nq} queries in {dt:.2f}s "
          f"({nq / dt:.0f} qps cpu-backend, "
          f"{dt / len(stream) * 1000:.1f} ms/batch)")
    s = io.StringIO()
    ps = pstats.Stats(pr, stream=s).sort_stats("cumulative")
    ps.print_stats(35)
    print(s.getvalue())


if __name__ == "__main__":
    main()
