"""Host-only partition analysis for the 5M batched pathology.

Opens a persisted bench_scale corpus (tools/bench_scale.py --path),
builds one bench_scale-shaped query batch, and reports where the
term-split partition (ops/sparse.py::partition_sparse_batch_split)
sends every row under the given knobs: eligible/ineligible counts,
per-tier row histograms, heavy-slot stats, and the hub/lmax routing
predictor distribution. Pure numpy — no device work. Use it to pick SEARCHLITE_SPARSE_MAX_BLOCKS /
SEARCHLITE_HEAVY_TERM_BLOCKS scaling before paying a device run.

Usage: python tools/probe_split_partition.py PATH [--batch N]
       [--max-blocks N] [--term-cap N] [--hmax N] [--ub-ratio F]
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


def arg(flag, default, cast=int):
    a = sys.argv
    return cast(a[a.index(flag) + 1]) if flag in a else default


def main():
    path = sys.argv[1]
    batch = arg("--batch", 1024)
    import jax

    jax.config.update("jax_platforms", "cpu")

    from searchlite.api.types import IndexOptions
    from searchlite.index import Index
    from searchlite.ops.impact import build_impact_batch_native
    from searchlite.ops.sparse import tier_bounds

    t0 = time.perf_counter()
    index = Index.open(IndexOptions(path=path))
    reader = index.reader()
    dseg = reader.device_segments[0]
    seg = dseg.reader
    n1 = dseg.n1
    print(json.dumps({"phase": "open",
                      "s": round(time.perf_counter() - t0, 1),
                      "n_docs": n1}), flush=True)

    max_blocks = arg("--max-blocks",
                     int(os.environ.get("SEARCHLITE_SPARSE_MAX_BLOCKS",
                                        "512")))
    term_cap = arg("--term-cap",
                   int(os.environ.get("SEARCHLITE_HEAVY_TERM_BLOCKS",
                                      str(max_blocks))))
    h_max = arg("--hmax", 4)
    ub_ratio = arg("--ub-ratio", 0.5, float)

    rng = np.random.default_rng(7)
    vocab = [f"t{i}" for i in range(VOCAB)]
    queries = build_queries(rng, batch, vocab)
    fields = [f.name for f in reader.schema.text_fields]
    qb = build_impact_batch_native(
        seg, dseg, queries, fields, reader.analysis, reader.schema,
        lazy_tables=True)
    assert qb is not None

    from searchlite.ops.impact import csr_row_lengths

    nq = qb["n_queries"]
    counts = csr_row_lengths(qb)
    row_of = np.repeat(np.arange(nq, dtype=np.int64), counts)
    ent_bcnt = qb["slot_bcnt"][qb["qs_slot"]].astype(np.int64)
    ent_tids = qb["slot_tids"][qb["qs_slot"]]

    # per-entry df percentile context
    heavy_e = ent_bcnt > term_cap
    n_heavy = np.bincount(row_of[heavy_e], minlength=nq)
    light_blocks = np.bincount(
        row_of[~heavy_e], weights=ent_bcnt[~heavy_e],
        minlength=nq).astype(np.int64)
    n_light = np.bincount(row_of[~heavy_e], minlength=nq)
    eligible = ((light_blocks <= max_blocks) & (n_heavy <= h_max)
                & ((n_light > 0) | (n_heavy == 0)))
    hub = lmax = None
    hl = dseg.heavy_lookup_host(term_cap)
    maximp = hl["maximp"]
    ent_ub = qb["qs_w"] * maximp[ent_tids].astype(np.float32)
    hub = np.bincount(row_of[heavy_e], weights=ent_ub[heavy_e],
                      minlength=nq)
    lmax = np.zeros(nq, dtype=np.float64)
    np.maximum.at(lmax, row_of[~heavy_e], ent_ub[~heavy_e])
    pred_ok = (n_heavy == 0) | (hub < ub_ratio * lmax)
    final_eligible = eligible & pred_ok

    # tier histogram of the eligible rows
    bounds = tier_bounds(max_blocks)
    tiers = {}
    lb = light_blocks[final_eligible]
    prev = -1
    for bound in bounds:
        sel = (lb > prev) & (lb <= bound)
        prev = bound
        if sel.any():
            tiers[str(bound)] = int(sel.sum())

    blocked_sum = int(light_blocks[final_eligible].sum())
    ineligible = np.flatnonzero(~final_eligible)
    why = {
        "light_over_cap": int((light_blocks > max_blocks).sum()),
        "too_many_heavy": int((n_heavy > h_max).sum()),
        "no_light_entry": int(
            ((n_light == 0) & (n_heavy > 0)).sum()),
        "predictor_reject": int((eligible & ~pred_ok).sum()),
    }
    # dense-fallback cost proxy: slots the ineligible rows carry
    from searchlite.ops.impact import subset_impact_batch

    s_pad_bad = 0
    if len(ineligible):
        hqb = subset_impact_batch(qb, ineligible)
        s_pad_bad = int(hqb["s_pad"])

    q = lambda a, p: [round(float(np.percentile(a, x)), 1) for x in p]
    print(json.dumps({
        "phase": "partition",
        "knobs": {"max_blocks": max_blocks, "term_cap": term_cap,
                  "h_max": h_max, "ub_ratio": ub_ratio},
        "rows": nq,
        "eligible": int(final_eligible.sum()),
        "ineligible": int(len(ineligible)),
        "why_ineligible": why,
        "tier_rows": tiers,
        "light_blocks_pct_50_90_99_max": q(
            light_blocks, [50, 90, 99]) + [int(light_blocks.max())],
        "n_heavy_pct_50_90_99_max": q(
            n_heavy, [50, 90, 99]) + [int(n_heavy.max())],
        "hub_pct_50_90_99": q(hub[n_heavy > 0], [50, 90, 99])
        if (n_heavy > 0).any() else [],
        "lmax_pct_10_50_90": q(lmax[n_heavy > 0], [10, 50, 90])
        if (n_heavy > 0).any() else [],
        "hub_over_lmax_pct_50_90_99": q(
            (hub[n_heavy > 0]
             / np.maximum(lmax[n_heavy > 0], 1e-9)), [50, 90, 99])
        if (n_heavy > 0).any() else [],
        "strip_blocks_total_eligible": blocked_sum,
        "dense_fallback_s_pad": s_pad_bad,
        "heavy_lookup_entries": int(len(hl["tbl"])),
    }), flush=True)

    # df landscape of the query terms, for knob design
    dfs = seg.postings.term_df[ent_tids]
    print(json.dumps({
        "phase": "entry_df",
        "df_pct_50_90_99_max": q(dfs, [50, 90, 99]) + [int(dfs.max())],
        "blocks_pct_50_90_99_max": q(
            ent_bcnt, [50, 90, 99]) + [int(ent_bcnt.max())],
        "entries_over_512_blocks": int((ent_bcnt > 512).sum()),
        "entries_over_2048_blocks": int((ent_bcnt > 2048).sum()),
        "entries_over_4096_blocks": int((ent_bcnt > 4096).sum()),
        "entries_over_8192_blocks": int((ent_bcnt > 8192).sum()),
    }), flush=True)


if __name__ == "__main__":
    main()
