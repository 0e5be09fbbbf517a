"""Phase-split the headline batched search on the REAL device.

Answers: with the sparse scorer at ~6 ms/step, where do the other
~45 ms of the 54 ms/batch go?  Times, per batch of 1024:

  prep      analyze + build_impact_batch + partition + repack (host)
  dispatch  the _launch_batch_segment call (uploads + jit dispatches,
            returns BEFORE device completion — async)
  drain     device_get of all results (device completion + fetch)

and then a pipelined stream (dispatch all, fetch all) for the
end-to-end per-batch cost, matching bench.py's measurement.
"""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, ".")

from searchlite.utils.devguard import guard_backend  # noqa: E402

guard_backend(__file__)
import bench  # noqa: E402


def main():
    import jax

    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    docs = bench.build_docs()
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

    # warm compiles + memos
    for b in batches:
        reader.search_batch(b, limit=10)

    fields = [f.name for f in reader.schema.text_fields]
    dseg = reader.device_segments[0]
    seg = dseg.reader

    from searchlite.ops.impact import build_impact_batch
    from searchlite.ops.sparse import partition_sparse_batch

    for rep in range(3):
        tp = td = tf = 0.0
        outs = []
        for b in batches[1:]:
            t0 = time.perf_counter()
            analyzed = reader._analyze_batches([b], fields)[0]
            qb = build_impact_batch(seg, dseg, analyzed,
                                    lazy_tables=True)
            part = partition_sparse_batch(qb, 32)
            t1 = time.perf_counter()
            scores, ids = reader._launch_batch_segment(dseg, qb, 10)
            t2 = time.perf_counter()
            outs.append((scores, ids))
            tp += t1 - t0
            td += t2 - t1
        t3 = time.perf_counter()
        fetched = jax.device_get(outs)
        tf = time.perf_counter() - t3
        n = len(batches) - 1
        print(f"rep{rep}: prep {tp / n * 1000:6.1f}  "
              f"dispatch {td / n * 1000:6.1f}  "
              f"drain(all) {tf * 1000:6.1f} ms "
              f"({tf / n * 1000:.1f}/batch)")

    # end-to-end pipelined stream, same as bench.py — with the
    # reader's host-phase accounting on (the REAL path: native prep,
    # sparse tiers, term split), for both output surfaces
    import os
    os.environ["SEARCHLITE_HOST_PROFILE"] = "1"
    stream = batches[1:] * 8
    nq = sum(len(b) for b in stream)
    for output in ("pairs", "arrays"):
        reader._host_profile = None
        t0 = time.perf_counter()
        reader.search_batch_many(stream, limit=10, output=output)
        dt = time.perf_counter() - t0
        prof = reader._host_profile
        nb = max(prof["batches"], 1)
        stages = "  ".join(
            f"{k} {prof[k] / nb * 1000:5.1f}"
            for k in ("prep", "dispatch", "fetch", "fallback", "merge"))
        print(f"stream[{output}]: {nq / dt:8.0f} qps   "
              f"{dt / len(stream) * 1000:.1f} ms/batch   "
              f"host ms/batch: {stages}")


if __name__ == "__main__":
    main()
