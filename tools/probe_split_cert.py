"""Exact host simulation of the term-split soundness certificate.

For each bench_scale query at a multi-M corpus and each candidate
``term_cap``, replays what _candidate_core_split would compute —
candidate strip from the light terms, top-kp cut by TAIL score, heavy
contributions added by lookup, θ = k-th final score, HUB = Σ_h
w_h·maximp_h — and reports how many rows would certify sound
(θ > HUB, and tail_kp + HUB < θ when the kp cut truncated).

This decides whether lowering the oversized-corpus term_cap (the
routing census showed 4-14x strip-lane savings at term_cap 512-2048
vs the shipped 7812) costs double-scoring: an unsound row is re-run
on a full strip, so the lever only pays if the certificate passes for
nearly every row. Pure numpy; no device.

Usage: python tools/probe_split_cert.py [--path /root/idx5m]
           [--nq 256] [--k 10]
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


def next_pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


def main():
    args = sys.argv[1:]

    def opt(name, default):
        return args[args.index(name) + 1] if name in args else default

    path = opt("--path", "/root/idx5m")
    nq = int(opt("--nq", "256"))
    k = int(opt("--k", "10"))

    import jax

    jax.config.update("jax_platforms", "cpu")

    from searchlite.api.types import IndexOptions
    from searchlite.index import Index
    from searchlite.ops.impact import (build_impact_batch_native,
                                           csr_row_lengths)
    from tools.bench_scale import VOCAB, build_queries

    index = Index.open(IndexOptions(path=path))
    reader = index.reader()
    seg = reader.segments[0]
    dseg = reader.device_segments[0]
    log(phase="open", n_docs=int(dseg.n1))

    rng = np.random.default_rng(7)
    vocab = [f"t{i}" for i in range(VOCAB)]
    queries = build_queries(rng, nq, vocab)
    qb = build_impact_batch_native(
        seg, dseg, queries, ["body"], reader.analysis, reader.schema,
        lazy_tables=True)

    postings = seg.postings
    df = postings.term_df.astype(np.int64)
    tstart = np.concatenate([[0], np.cumsum(df)])
    docs_flat = dseg.docs_flat_np
    imps_flat = dseg.impacts_flat_np
    counts = csr_row_lengths(qb)
    row_of = np.repeat(np.arange(qb["n_queries"], dtype=np.int64),
                       counts)
    ent_tid = qb["slot_tids"][qb["qs_slot"]].astype(np.int64)
    ent_w = qb["qs_w"].astype(np.float64)
    ent_bcnt = qb["slot_bcnt"][qb["qs_slot"]].astype(np.int64)

    # per-term max impact (matches build_heavy_lookup_host.maximp)
    hl = dseg.heavy_lookup_host(1 << 30)
    maximp = hl["maximp"].astype(np.float64)

    for term_cap in (512, 1024, 2048, 3906):
        stats = {"rows": 0, "no_heavy": 0, "sound": 0,
                 "fail_theta": 0, "fail_tail": 0}
        lanes_saved = 0
        for q in range(qb["n_queries"]):
            e = np.flatnonzero(row_of == q)
            if not len(e):
                continue
            heavy = ent_bcnt[e] > term_cap
            stats["rows"] += 1
            if not heavy.any():
                stats["no_heavy"] += 1
                continue
            light_e = e[~heavy]
            heavy_e = e[heavy]
            # candidate strip: light terms' postings, combined per doc
            segs_d, segs_v = [], []
            for ei in light_e:
                t = ent_tid[ei]
                lo, hi = tstart[t], tstart[t + 1]
                segs_d.append(docs_flat[lo:hi])
                segs_v.append(imps_flat[lo:hi].astype(np.float64)
                              * ent_w[ei])
            if segs_d:
                d = np.concatenate(segs_d)
                v = np.concatenate(segs_v)
                ud, inv = np.unique(d, return_inverse=True)
                tail = np.bincount(inv, weights=v)
            else:
                ud = np.zeros(0, dtype=np.int64)
                tail = np.zeros(0)
            # kp cut by tail score (conservative: real groups bucket
            # nblk UP, so the real kp is >= this estimate)
            lblocks = int(ent_bcnt[light_e].sum())
            kp = next_pow2(min(max(64, max(lblocks, 1) * 128 // 64),
                               2048))
            order = np.argsort(-tail, kind="stable")
            keep = order[:kp]
            truncated = len(ud) > kp
            tail_kp = tail[order[kp - 1]] if truncated else -np.inf
            cd, cv = ud[keep], tail[keep]
            # heavy contributions at kept candidates + HUB
            hub = 0.0
            for ei in heavy_e:
                t = ent_tid[ei]
                lo, hi = tstart[t], tstart[t + 1]
                hd = docs_flat[lo:hi]
                pos = np.searchsorted(hd, cd)
                pos_c = np.minimum(pos, len(hd) - 1)
                hit = hd[pos_c] == cd
                cv = cv + np.where(
                    hit, imps_flat[lo:hi][pos_c].astype(np.float64)
                    * ent_w[ei], 0.0)
                hub += ent_w[ei] * maximp[ent_tid[ei]]
                lanes_saved += (hi - lo)
            top = np.sort(cv)[::-1]
            theta = top[k - 1] if len(top) >= k else -np.inf
            if theta <= hub:
                stats["fail_theta"] += 1
            elif truncated and tail_kp + hub >= theta:
                stats["fail_tail"] += 1
            else:
                stats["sound"] += 1
        stats["sound_pct"] = round(
            100.0 * stats["sound"]
            / max(stats["rows"] - stats["no_heavy"], 1), 1)
        stats["lanes_saved_m"] = round(lanes_saved / 1e6, 2)
        log(phase="cert", term_cap=term_cap, **stats)


if __name__ == "__main__":
    main()
