"""Host-side routing census for the batched sparse path at scale.

Answers, without any device time: for the bench_scale query stream at
a multi-M corpus, which rows does partition_sparse_batch_split admit,
how wide are the resulting strip tiers (total gathered lanes = the
sort's traffic budget), how many rows fall back to full strips, and
how those numbers move under different term_cap / ub_ratio knobs.

The point: the 5M batched gap to the C++ BMW baseline is strip-sort
traffic, so lane totals ARE the cost model (probe_scale_batch times
lanes on the device).

Usage: python tools/probe_route_census.py [--path /root/idx5m]
           [--batch 64] [--nq 1024]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def log(**kv):
    print(json.dumps(kv), flush=True)


def census(dseg, qb, k, max_blocks, term_cap, h_max, ub_ratio):
    from searchlite.ops.impact import csr_row_lengths
    from searchlite.ops.sparse import (
        partition_sparse_batch_split,
        partition_sparse_batch_tiered,
    )

    maximp = dseg.heavy_lookup_host(term_cap)["maximp"]
    part = partition_sparse_batch_split(
        qb, max_blocks, dseg.idf32, k, term_cap, h_max,
        maximp=maximp, ub_ratio=ub_ratio)
    out = {"term_cap": term_cap, "ub_ratio": ub_ratio,
           "max_blocks": max_blocks}
    if part is None:
        part = partition_sparse_batch_tiered(qb, max_blocks,
                                             dseg.idf32, k)
        out["split"] = False
    else:
        out["split"] = True
    nq = qb["n_queries"]
    if part is None:
        out["admitted"] = 0
        out["fallback_rows"] = nq
        return out
    out["admitted"] = int(len(part["light_idx"]))
    out["fallback_rows"] = int(len(part["heavy_idx"]))
    lanes = 0
    split_lanes = 0
    tiers = []
    for g in part["groups"]:
        bl = int(g["packed"].shape[0])
        nblk = int(g["nblk"])
        lanes += bl * nblk * 128
        if g.get("hvy") is not None:
            split_lanes += bl * nblk * 128
        tiers.append([bl, nblk, bool(g.get("hvy") is not None)])
    out["groups"] = tiers
    out["strip_lanes_m"] = round(lanes / 1e6, 2)
    out["split_lanes_m"] = round(split_lanes / 1e6, 2)
    # fallback rows re-run as FULL strips at the widest row's width
    counts = csr_row_lengths(qb)
    row_of = np.repeat(np.arange(nq, dtype=np.int64), counts)
    ent_bcnt = qb["slot_bcnt"][qb["qs_slot"]].astype(np.int64)
    row_blocks = np.bincount(row_of, weights=ent_bcnt,
                             minlength=nq).astype(np.int64)
    if len(part["heavy_idx"]):
        hb = row_blocks[part["heavy_idx"]]
        from searchlite.ops.sparse import pow15_bucket
        wide = pow15_bucket(int(hb.max()), minimum=16)
        out["fallback_full_strip_lanes_m"] = round(
            len(hb) * wide * 128 / 1e6, 2)
        out["fallback_row_blocks"] = [int(x) for x in np.sort(hb)[-8:]]
    else:
        out["fallback_full_strip_lanes_m"] = 0.0
    out["total_lanes_m"] = round(
        out["strip_lanes_m"] + out["fallback_full_strip_lanes_m"], 2)
    return out


def main():
    args = sys.argv[1:]

    def opt(name, default):
        return args[args.index(name) + 1] if name in args else default

    path = opt("--path", "/root/idx5m")
    sub = int(opt("--batch", "64"))
    nq = int(opt("--nq", "1024"))
    k = int(opt("--k", "10"))

    import jax

    jax.config.update("jax_platforms", "cpu")

    from searchlite.api.types import IndexOptions
    from searchlite.index import Index
    from searchlite.ops.impact import build_impact_batch_native
    from tools.bench_scale import VOCAB, build_queries

    index = Index.open(IndexOptions(path=path))
    reader = index.reader()
    seg = reader.segments[0]
    dseg = reader.device_segments[0]
    n1 = dseg.n1
    log(phase="open", n_docs=int(n1))

    rng = np.random.default_rng(7)
    vocab = [f"t{i}" for i in range(VOCAB)]
    queries = build_queries(rng, nq, vocab)

    # per-row df census of the workload itself
    from searchlite.ops.impact import csr_row_lengths

    qb = build_impact_batch_native(
        seg, dseg, queries, ["body"], reader.analysis, reader.schema,
        lazy_tables=True)
    counts = csr_row_lengths(qb)
    row_of = np.repeat(np.arange(qb["n_queries"], dtype=np.int64),
                       counts)
    ent_bcnt = qb["slot_bcnt"][qb["qs_slot"]].astype(np.int64)
    row_blocks = np.bincount(row_of, weights=ent_bcnt,
                             minlength=qb["n_queries"]).astype(np.int64)
    row_maxb = np.zeros(qb["n_queries"], dtype=np.int64)
    np.maximum.at(row_maxb, row_of, ent_bcnt)
    log(phase="workload", n_queries=int(qb["n_queries"]),
        row_blocks_p50=int(np.median(row_blocks)),
        row_blocks_p90=int(np.percentile(row_blocks, 90)),
        row_blocks_max=int(row_blocks.max()),
        row_max_term_blocks_p50=int(np.median(row_maxb)),
        row_max_term_blocks_p90=int(np.percentile(row_maxb, 90)),
        row_max_term_blocks_max=int(row_maxb.max()))

    # default 5M params (mirrors _try_sparse_candidates shard path)
    max_blocks = max(512, 2 * (n1 // 640))
    term_cap_dflt = max_blocks // 2 if max_blocks > 512 else max_blocks
    term_cap_dflt = max(512, term_cap_dflt)

    # census over sub-batches, summed — the bench runs 64-query waves
    sweeps = [
        (term_cap_dflt, 0.5),   # shipped defaults
        (term_cap_dflt, 1.0),
        (term_cap_dflt, 2.0),
        (term_cap_dflt, 0.0),   # no ub gate
        (2048, 0.5), (2048, 2.0), (2048, 0.0),
        (1024, 0.0), (512, 0.0), (512, 2.0),
    ]
    from searchlite.ops.impact import subset_impact_batch

    for cap, ratio in sweeps:
        tot = None
        for c0 in range(0, qb["n_queries"], sub):
            rows = np.arange(c0, min(c0 + sub, qb["n_queries"]),
                             dtype=np.int64)
            sqb = subset_impact_batch(qb, rows)
            r = census(dseg, sqb, k, max_blocks, cap, 4, ratio)
            if tot is None:
                tot = dict(r)
                tot.pop("groups", None)
                tot["n_waves"] = 1
            else:
                for key in ("admitted", "fallback_rows",
                            "strip_lanes_m", "split_lanes_m",
                            "fallback_full_strip_lanes_m",
                            "total_lanes_m"):
                    tot[key] = round(tot[key] + r[key], 2)
                tot["n_waves"] += 1
        tot["est_sort_ms_at_2ms_per_mlane"] = round(
            tot["total_lanes_m"] * 2, 1)
        log(phase="census", **tot)


if __name__ == "__main__":
    main()
