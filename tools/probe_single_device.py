"""Device-side single-query latency at scale.

The single-query route at multi-M docs is ONE jitted scorer dispatch +
ONE fetch (api/reader.py::_try_sparse_single_inner), so wall time is
host prep + round trip + device compute. This probe separates them:

  wall      p50 of reader.search() end to end (production number)
  device    (wall_INNER=N - wall_INNER=1) / (N-1) of a jitted
            fori_loop that replays ONE captured scorer call N times
            with a data-dependency chain (cc96f06 pattern: the
            previous step's top score feeds a provably-zero int32
            perturbation of the query table; XLA cannot elide it)
  rtt       p50 of a trivial scalar dispatch+fetch, same session

Reference point being contextualized: the C++ core's doc-at-a-time
BMW loop (reference searchlite-core/src/query/wand.rs:659-903)
answers the same queries in ~0.5-1 ms/q on one CPU core; the honest
question is how much of the engine's 31 ms is link, not compute.

Usage: python tools/probe_single_device.py [--path DIR] [--n 48]
                                           [--inner 16] [--cpu]
Prints one JSON line per finding.
"""

from __future__ import annotations

import json
import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def log(**kv):
    print(json.dumps(kv), flush=True)


def main():
    force_cpu = "--cpu" in sys.argv
    path = "/root/idx5m"
    if "--path" in sys.argv:
        path = sys.argv[sys.argv.index("--path") + 1]
    n_q = int(sys.argv[sys.argv.index("--n") + 1]) \
        if "--n" in sys.argv else 48
    inner = int(sys.argv[sys.argv.index("--inner") + 1]) \
        if "--inner" in sys.argv else 16

    import jax

    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        from searchlite.utils.devguard import guard_backend

        guard_backend(__file__)
    import jax.numpy as jnp

    from searchlite.api.types import IndexOptions
    from searchlite.index import Index

    # same query shape as tools/bench_scale.py (rank-skewed Zipf:
    # one head term + 1-5 mid/tail terms)
    from tools.bench_scale import VOCAB, build_queries

    log(phase="start", backend=jax.default_backend(), path=path)
    idx = Index.open(IndexOptions(path=path))
    r = idx.reader()
    rng = np.random.default_rng(23)
    vocab = [f"t{i}" for i in range(VOCAB)]
    queries = build_queries(rng, n_q, vocab)

    # ---- capture: wrap the two single-route scorer factories so the
    # first production searches record their device call args ----
    captures = {"split": [], "plain": []}

    def wrap(factory_name, kind):
        orig = getattr(r, factory_name)

        def patched():
            real = orig()

            def recording(*args, **kwargs):
                captures[kind].append((args, dict(kwargs)))
                return real(*args, **kwargs)

            recording._real = real
            return recording

        setattr(r, factory_name, patched)

    wrap("_sparse_single_split_scorer", "split")
    wrap("_sparse_candidate_scorer", "plain")

    # warm + time production wall per query (each query's first run
    # pays its (t_pad, nblk) bucket compile; time the second run)
    walls = []
    routes = {"split": 0, "plain": 0, "other": 0}
    for q in queries:
        req = {"query": q, "limit": 10}
        before = (len(captures["split"]), len(captures["plain"]))
        r.search(req)  # warm (compile if new bucket)
        t0 = time.perf_counter()
        r.search(req)
        walls.append((time.perf_counter() - t0) * 1e3)
        after = (len(captures["split"]), len(captures["plain"]))
        if after[0] > before[0]:
            routes["split"] += 1
        elif after[1] > before[1]:
            routes["plain"] += 1
        else:
            routes["other"] += 1
    walls_ms = float(np.percentile(walls, 50))
    log(phase="production_wall", p50_ms=round(walls_ms, 2),
        p90_ms=round(float(np.percentile(walls, 90)), 2),
        n=len(walls), routes=routes)

    # ---- rtt floor: trivial scalar dispatch+fetch ----
    one = jax.device_put(np.float32(1.0))
    tiny = jax.jit(lambda x: x + 1.0)
    jax.device_get(tiny(one))  # compile
    rtts = []
    for _ in range(16):
        t0 = time.perf_counter()
        jax.device_get(tiny(one))
        rtts.append((time.perf_counter() - t0) * 1e3)
    rtt_ms = float(np.percentile(rtts, 50))
    log(phase="rtt_floor", p50_ms=round(rtt_ms, 2),
        min_ms=round(min(rtts), 2))

    if not captures["split"]:
        log(phase="done", note="no split-route captures; only wall "
            "and rtt measured", wall_p50_ms=round(walls_ms, 2),
            rtt_p50_ms=round(rtt_ms, 2))
        return

    # ---- device-side repetition of the modal split capture ----
    from collections import Counter

    keys = Counter(tuple(sorted(kw.items()))
                   for _, kw in captures["split"])
    modal_kw = dict(keys.most_common(1)[0][0])
    cap_args = next(a for a, kw in captures["split"]
                    if dict(kw) == modal_kw)
    log(phase="modal_bucket", statics={k: int(v) for k, v
                                       in modal_kw.items()},
        n_captures=len(captures["split"]),
        n_buckets=len(keys))

    from searchlite.ops.sparse import (
        make_sparse_single_split_scorer,
    )

    real = make_sparse_single_split_scorer()
    (block_docs, block_impacts, hb_tbl, hb_base, hb_log2g,
     tid_tbl, maximp, tbl, hvy, sent) = cap_args
    k = modal_kw["k"]

    def make_many(n_reps):
        @jax.jit
        def many(tbl0):
            def body(_i, carry):
                tbl2, _ts, _td = carry
                ts, td, _ns, _ov, _so = real(
                    block_docs, block_impacts, hb_tbl, hb_base,
                    hb_log2g, tid_tbl, maximp, tbl2, hvy, sent,
                    **modal_kw)
                # provably-zero, data-dependent perturbation: the
                # compiler cannot fold (x != x) without knowing x is
                # never NaN, so every iteration depends on the last
                chain = (ts[0, 0] != ts[0, 0]).astype(jnp.int32)
                return tbl2 + chain, ts, td
            z = jnp.zeros((1, k), jnp.float32)
            zi = jnp.zeros((1, k), jnp.int32)
            _, ts, td = jax.lax.fori_loop(
                0, n_reps, body, (tbl0, z, zi))
            return ts, td

        return many

    tbl_dev = jax.device_put(np.asarray(tbl))
    many1 = make_many(1)
    manyn = make_many(inner)
    ref = jax.device_get(many1(tbl_dev))  # compile
    out = jax.device_get(manyn(tbl_dev))  # compile
    if not np.array_equal(ref[1], out[1]) or not np.allclose(
            ref[0], out[0]):
        log(phase="error", note="looped core diverged from single")
        return

    def sample(fn, reps=6):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.device_get(fn(tbl_dev))
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.percentile(ts, 50))

    t1 = sample(many1)
    tn = sample(manyn)
    dev_ms = max((tn - t1) / (inner - 1), 0.0)
    log(phase="device_compute", inner=inner,
        wall_inner1_ms=round(t1, 2),
        wall_innerN_ms=round(tn, 2),
        device_ms_per_query=round(dev_ms, 3))

    host_ms = max(walls_ms - rtt_ms - dev_ms, 0.0)
    log(metric="single_query_attribution",
        wall_p50_ms=round(walls_ms, 2),
        rtt_p50_ms=round(rtt_ms, 2),
        device_ms=round(dev_ms, 3),
        host_residual_ms=round(host_ms, 2),
        split_route_fraction=round(
            routes["split"] / max(len(walls), 1), 3),
        value=round(dev_ms, 3), unit="ms")


if __name__ == "__main__":
    main()
