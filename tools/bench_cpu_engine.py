"""Measure the C++ CPU baseline engine (native/slt_cpu_engine.cpp) on
the EXACT headline bench workload (bench.py corpus + query stream) —
the strongest measurable stand-in for the Rust reference engine
(BASELINE.md addendum).

Prints per-mode single-core QPS + a correctness check against the
numpy oracle. Pure host run (pins the CPU backend).
"""

import json
import os
import sys
import time

sys.path.insert(0, ".")
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402

import bench  # noqa: E402


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema
    from searchlite.native import CpuEngine

    t0 = time.perf_counter()
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
    print(f"ingest {time.perf_counter() - t0:.1f}s", flush=True)

    reader = index.reader()
    seg = reader.segments[0]
    t0 = time.perf_counter()
    eng = CpuEngine(seg)
    print(f"engine build {time.perf_counter() - t0:.1f}s", flush=True)

    batches = bench.build_queries()
    stream = [q for b in batches[1:] for q in b] * 8  # bench's stream
    qtids = np.full((len(stream), bench.TERMS_PER_QUERY), -1,
                    dtype=np.int32)
    for qi, q in enumerate(stream):
        for ti, tok in enumerate(q.split()):
            qtids[qi, ti] = eng.tid(f"body:{tok}")

    # correctness spot-check vs the numpy oracle (16 queries)
    ids, scores = eng.search_batch(qtids[:16], k=bench.K, mode="bmw")
    for qi in range(16):
        oracle = bench._oracle_scores(reader, stream[qi])
        want = np.lexsort((np.arange(len(oracle)), -oracle))[:bench.K]
        got = [d for d in ids[qi] if d >= 0]
        assert list(want[:len(got)]) == got, (qi, stream[qi])
    print("verified vs oracle: ok", flush=True)

    out = {"metric": "cpu_engine_batched_qps_100k_docs", "unit": "qps",
           "n_queries": len(stream), "threads": 1}
    for mode in ("bm25", "wand", "bmw"):
        # warm
        eng.search_batch(qtids[:1024], k=bench.K, mode=mode)
        t0 = time.perf_counter()
        eng.search_batch(qtids, k=bench.K, mode=mode)
        dt = time.perf_counter() - t0
        out[f"qps_{mode}"] = round(len(stream) / dt, 1)
        print(f"{mode}: {len(stream) / dt:.1f} qps "
              f"({dt / len(stream) * 1e6:.1f} us/q)", flush=True)
    out["value"] = max(out["qps_bm25"], out["qps_wand"], out["qps_bmw"])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
