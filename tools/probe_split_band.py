"""Band-size census for the term-split certificate's tail condition.

For each with-heavy row (term_cap partition), computes:
- theta_kp: the k-th final score when heavy terms are looked up at the
  top-kp tail candidates (kp = 2048, today's cap);
- band = #{candidates: tail + HUB >= theta_kp} — every candidate that
  could still enter the top-k, i.e. the set a doc-at-a-time WAND would
  actually score. If band is small, looking up heavy terms at the
  BAND (not just top-kp) makes the row provably exact with no size
  cap beyond the band budget.

Prints per-cap distribution of band sizes + the certified fraction at
several band budgets. Pure numpy. Usage mirrors probe_split_cert.
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


def main():
    args = sys.argv[1:]

    def opt(name, default):
        return args[args.index(name) + 1] if name in args else default

    path = opt("--path", "/root/idx5m")
    nq = int(opt("--nq", "256"))
    k = int(opt("--k", "10"))
    kp = int(opt("--kp", "2048"))

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

    df = seg.postings.term_df.astype(np.int64)
    tstart = np.concatenate([[0], np.cumsum(df)])
    docs_flat = dseg.docs_flat_np
    imps_flat = dseg.impacts_flat_np
    counts = csr_row_lengths(qb)
    row_of = np.repeat(np.arange(qb["n_queries"], dtype=np.int64),
                       counts)
    ent_tid = qb["slot_tids"][qb["qs_slot"]].astype(np.int64)
    ent_w = qb["qs_w"].astype(np.float64)
    ent_bcnt = qb["slot_bcnt"][qb["qs_slot"]].astype(np.int64)
    hl = dseg.heavy_lookup_host(1 << 30)
    maximp = hl["maximp"].astype(np.float64)

    for term_cap in (512, 2048):
        bands = []
        strips = []
        sound_at = {b: 0 for b in (2048, 8192, 32768, 131072)}
        n_heavy_rows = 0
        for q in range(qb["n_queries"]):
            e = np.flatnonzero(row_of == q)
            if not len(e):
                continue
            heavy = ent_bcnt[e] > term_cap
            if not heavy.any():
                continue
            n_heavy_rows += 1
            light_e, heavy_e = e[~heavy], e[heavy]
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
            strips.append(len(ud))
            hub = float(sum(ent_w[ei] * maximp[ent_tid[ei]]
                            for ei in heavy_e))
            order = np.argsort(-tail, kind="stable")
            keep = order[:kp]
            cd, cv = ud[keep], tail[keep]
            for ei in heavy_e:
                t = ent_tid[ei]
                lo, hi = tstart[t], tstart[t + 1]
                hd = docs_flat[lo:hi]
                pos = np.minimum(np.searchsorted(hd, cd), len(hd) - 1)
                hit = hd[pos] == cd
                cv = cv + np.where(
                    hit, imps_flat[lo:hi][pos].astype(np.float64)
                    * ent_w[ei], 0.0)
            top = np.sort(cv)[::-1]
            theta = top[k - 1] if len(top) >= k else -np.inf
            band = int((tail + hub >= theta).sum())
            bands.append(band)
            for b in sound_at:
                if band <= b:
                    sound_at[b] += 1
        bands = np.asarray(bands or [0])
        strips = np.asarray(strips or [0])
        log(phase="band", term_cap=term_cap, kp=kp,
            heavy_rows=n_heavy_rows,
            strip_p50=int(np.median(strips)),
            strip_p90=int(np.percentile(strips, 90)),
            band_p50=int(np.median(bands)),
            band_p90=int(np.percentile(bands, 90)),
            band_max=int(bands.max()),
            sound_pct_at={str(b): round(100.0 * c
                                        / max(n_heavy_rows, 1), 1)
                          for b, c in sound_at.items()})


if __name__ == "__main__":
    main()
