"""Attribute the batched-stream cost on the real device.

Runs the headline workload (100k docs, 1024-query batches) through
``search_batch_many`` under several configurations and prints one line
per variant, so per-batch cost can be attributed to the query-table
upload (packed vs explicit), the heavy-query dense remainder
(mixed-idf vs all-light batches), and the result surface
(arrays vs pairs). Run idle: the host has one CPU and every number
here is host-sensitive.

Usage: python tools/probe_stream.py [n_stream_batches=16]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, ".")

from searchlite.utils.devguard import guard_backend  # noqa: E402

guard_backend(__file__)

import numpy as np  # noqa: E402

import bench  # noqa: E402


def build_reader():
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
    return index.reader()


def light_batches(n):
    """Batches built from tail tokens only (every query rides the
    sparse candidate scorer; no heavy remainder)."""
    import random

    rng = random.Random(23)
    out = []
    for _ in range(n):
        out.append([
            " ".join(f"tok{rng.randint(2000, bench.VOCAB - 1)}"
                     for _ in range(bench.TERMS_PER_QUERY))
            for _ in range(bench.BATCH)])
    return out


def run(reader, stream, output):
    nq = sum(len(b) for b in stream)
    t0 = time.perf_counter()
    out = reader.search_batch_many(stream, limit=bench.K,
                                   output=output)
    dt = time.perf_counter() - t0
    assert len(out) == len(stream)
    return nq / dt, dt / len(stream) * 1000


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    reader = build_reader()
    mixed = bench.build_queries()[1:]
    lights = light_batches(2)

    scenarios = [
        ("arrays packed mixed", dict(), mixed * 8, "arrays"),
        ("arrays explicit mixed", {"SEARCHLITE_SPARSE_PACKED": "0"},
         mixed * 8, "arrays"),
        ("arrays packed all-light", dict(), lights * 8, "arrays"),
        ("arrays explicit all-light",
         {"SEARCHLITE_SPARSE_PACKED": "0"}, lights * 8, "arrays"),
        ("pairs packed mixed", dict(), mixed * 8, "pairs"),
        # light/heavy boundary sweep: with tiered strips, wide queries
        # sit in their own tier — how far can the sparse route stretch
        # before the dense matmul's flat-in-df cost wins?
        ("arrays cap=128 mixed", {"SEARCHLITE_SPARSE_MAX_BLOCKS":
                                  "128"}, mixed * 8, "arrays"),
        ("arrays cap=512 mixed", {"SEARCHLITE_SPARSE_MAX_BLOCKS":
                                  "512"}, mixed * 8, "arrays"),
        ("arrays cap=2048 mixed", {"SEARCHLITE_SPARSE_MAX_BLOCKS":
                                   "2048"}, mixed * 8, "arrays"),
        # batch-size scaling: per-batch Python/dispatch overhead
        # amortizes with wider batches (same total queries)
        ("arrays packed mixed b3072", dict(),
         [sum(mixed, [])] * 8, "arrays"),
        ("arrays packed mixed b9216", dict(),
         [sum(mixed * 3, [])] * 4, "arrays"),
    ]
    for name, env, stream, output in scenarios:
        stream = stream[:n]
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            run(reader, stream[:2], output)  # warm compiles
            qps, ms = run(reader, stream, output)
            qps2, ms2 = run(reader, stream, output)  # repeat row
            print(f"{name:28s} {qps:9.0f} qps ({ms:5.2f} ms/batch)"
                  f"   repeat {qps2:9.0f} ({ms2:5.2f})", flush=True)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


if __name__ == "__main__":
    main()
