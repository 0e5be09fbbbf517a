"""One-batch profiling probe for the multi-M-doc batched path.

Loads a persisted bench_scale corpus (tools/bench_scale.py --path),
builds bench_scale-shaped query batches (one head term per query —
the worst case that routes nearly every row down the heavy remainder),
runs search_batch_many with SEARCHLITE_HOST_PROFILE=1, and prints the
host-phase split plus wall time per batch. Use it to attribute the
per-batch cost at 5M docs before touching the routing.

Usage: python tools/probe_scale_batch.py PATH [--batch N] [--reps N]
       [--exec bm25|wand|bmw] [--cpu]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tools.bench_scale import VOCAB, build_queries  # noqa: E402


def log(**kv):
    print(json.dumps(kv), flush=True)


def main():
    args = sys.argv[1:]
    path = args[0]
    batch = int(args[args.index("--batch") + 1]) \
        if "--batch" in args else 1024
    reps = int(args[args.index("--reps") + 1]) if "--reps" in args else 1
    execution = args[args.index("--exec") + 1] \
        if "--exec" in args else "bm25"

    import jax
    if "--cpu" in args:
        jax.config.update("jax_platforms", "cpu")
    os.environ["SEARCHLITE_HOST_PROFILE"] = "1"
    log(phase="start", backend=jax.default_backend(), path=path)

    from searchlite.api.types import IndexOptions
    from searchlite.index import Index

    t0 = time.perf_counter()
    index = Index.open(IndexOptions(path=path))
    reader = index.reader()
    n1 = reader.device_segments[0].n1
    log(phase="open", open_s=round(time.perf_counter() - t0, 1),
        n_docs=n1)

    rng = np.random.default_rng(7)
    vocab = [f"t{i}" for i in range(VOCAB)]
    queries = build_queries(rng, batch * 2, vocab)
    b0, b1 = queries[:batch], queries[batch:]

    sub = 64 if execution in ("wand", "bmw") else batch
    chunks0 = [b0[i:i + sub] for i in range(0, batch, sub)]
    chunks1 = [b1[i:i + sub] for i in range(0, batch, sub)]

    t0 = time.perf_counter()
    reader.search_batch_many(chunks0, limit=10, execution=execution)
    log(phase="warm_b0", s=round(time.perf_counter() - t0, 1),
        prof=dict(reader._host_profile))
    reader._host_profile = None
    t0 = time.perf_counter()
    reader.search_batch_many(chunks1, limit=10, execution=execution)
    log(phase="warm_b1", s=round(time.perf_counter() - t0, 1),
        prof=dict(reader._host_profile))

    for r in range(reps):
        reader._host_profile = None
        t0 = time.perf_counter()
        reader.search_batch_many(chunks1, limit=10,
                                 execution=execution)
        dt = time.perf_counter() - t0
        prof = {k: (round(v, 2) if isinstance(v, float) else v)
                for k, v in reader._host_profile.items()}
        log(phase="timed", rep=r, s=round(dt, 2),
            qps=round(batch / dt, 1), prof=prof)


if __name__ == "__main__":
    main()
