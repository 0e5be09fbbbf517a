"""A/B probe: sort-free strip combine (_strip_prune_core) vs the
production sort+scan core, on synthetic Zipf candidate strips shaped
like the headline workload.

Answers, per (shape, overselect width C):
  - kernel step time for both cores (pipelined x8, fetched)
  - certificate pass rate (rows the prune core answers exactly)
  - exactness: prune results == numpy oracle on every certified row
    (docs exact, scores to f32 summation-order tolerance)

The prune core only replaces the sort if (time_prune + fail_rate *
time_sort) < time_sort on the device — run this there before any
reader wiring. Usage:

    python tools/probe_strip_prune.py [B] [nblk] [t_pad]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from searchlite.utils.devguard import guard_backend  # noqa: E402

guard_backend(__file__)

import numpy as np  # noqa: E402

import searchlite  # noqa: E402,F401


def build_strips(B: int, nblk: int, t_pad: int, n1: int, seed: int):
    """Strips laid out like _strip_gather_scan's output: per row,
    slot-contiguous ascending doc runs (block-padded with sentinel),
    Zipf df per slot, contributions = idf-ish weight x tf impact."""
    rng = np.random.default_rng(seed)
    L = nblk * 128
    sent = n1 - 1
    d = np.full((B, L), sent, dtype=np.int32)
    v = np.zeros((B, L), dtype=np.float32)
    t_of = np.zeros((B, L), dtype=np.int32)
    for b in range(B):
        pos = 0
        slots = rng.integers(2, t_pad + 1)
        # split the strip budget across slots, Zipf-skewed
        raw = rng.zipf(1.4, size=slots).astype(np.float64)
        share = raw / raw.sum()
        for t in range(slots):
            df = int(min(max(16, share[t] * L * 0.7), n1 - 2,
                         L - pos - (slots - t - 1) * 16))
            if df <= 0:
                continue
            docs = np.sort(rng.choice(n1 - 1, size=df, replace=False))
            blocks = -(-df // 128)
            if pos + blocks * 128 > L:
                blocks = (L - pos) // 128
                df = min(df, blocks * 128)
                docs = docs[:df]
            if df <= 0:
                continue
            w = 1.0 / (1.0 + share[t] * 10.0)  # head terms weigh less
            imps = (1.0 + rng.lognormal(0.0, 0.4, size=df)) * w
            d[b, pos:pos + df] = docs
            v[b, pos:pos + df] = imps.astype(np.float32)
            t_of[b, pos:pos + blocks * 128] = t
            pos += blocks * 128
    return d, v, t_of, sent


def oracle_topk(d, v, sent, k):
    out_s, out_d = [], []
    for b in range(d.shape[0]):
        mask = (d[b] != sent) & (v[b] > 0)
        docs = d[b][mask].astype(np.int64)
        vals = v[b][mask].astype(np.float64)
        agg: dict[int, float] = {}
        for doc, val in zip(docs, vals):
            agg[doc] = agg.get(doc, 0.0) + val
        items = [(doc, s) for doc, s in agg.items() if s > 0]
        items.sort(key=lambda x: (-x[1], x[0]))
        out_s.append([s for _d, s in items[:k]])
        out_d.append([doc for doc, _s in items[:k]])
    return out_s, out_d


def real_strips(B: int, t_pad: int, seed: int):
    """Strips gathered from the HEADLINE bench corpus itself: builds
    bench.py's index (100k Zipf docs), draws bench-style 4-term
    queries, and runs the production `_strip_gather` over the real
    block arrays — the exact (d, v, t_of) the packed scorer sees for
    its light rows (rows over the light block cap are redrawn, as the
    partition would route them to the split/dense paths)."""
    import random

    import jax
    import jax.numpy as jnp

    import bench
    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema
    from searchlite.ops.sparse import _strip_gather

    docs = bench.build_docs()
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({"text_fields": [
            {"name": "body", "analyzer": "default", "stored": False,
             "indexed": True}]}))
    w = index.writer()
    w.add_documents(docs)
    w.commit()
    reader = index.reader()
    dseg = reader.device_segments[0]
    postings = dseg.reader.postings
    term_of = {t: i for i, t in enumerate(postings.terms)}
    starts = postings.term_block_start.astype(np.int64)
    counts = postings.term_block_count.astype(np.int64)
    idf = np.asarray(dseg.idf_table, dtype=np.float64)
    cap = int(os.environ.get("SEARCHLITE_SPARSE_MAX_BLOCKS", "512"))

    rng = random.Random(seed)
    bstart = np.zeros((B, t_pad), dtype=np.int32)
    bcnt = np.zeros((B, t_pad), dtype=np.int32)
    wts = np.zeros((B, t_pad), dtype=np.float32)
    filled = 0
    while filled < B:
        terms = [f"body:tok{rng.randint(10, bench.VOCAB - 1)}"
                 for _ in range(bench.TERMS_PER_QUERY)]
        tids = [term_of[t] for t in terms if t in term_of]
        if not tids or sum(int(counts[t]) for t in set(tids)
                           ) > cap:
            continue
        occ: dict[int, int] = {}
        for t in tids:
            occ[t] = occ.get(t, 0) + 1
        for s, (t, o) in enumerate(occ.items()):
            bstart[filled, s] = starts[t]
            bcnt[filled, s] = counts[t]
            wts[filled, s] = np.float32(o * idf[t])
        filled += 1
    nblk = int(bcnt.sum(axis=1).max())
    nblk = 1 << (nblk - 1).bit_length()
    sent_row = dseg.n_block_rows
    sent_doc = int(dseg.n1) - 1

    def gather(bs, bc, ww):
        return _strip_gather(
            jax, jnp, dseg.block_docs, dseg.block_impacts,
            bs, bc, ww, sent_row, t_pad=t_pad, nblk=nblk)

    d, v, t_of = jax.jit(gather)(
        jnp.asarray(bstart), jnp.asarray(bcnt), jnp.asarray(wts))
    return (np.asarray(d), np.asarray(v), np.asarray(t_of),
            sent_doc, nblk)


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    use_real = "--real" in sys.argv[1:]
    B = int(args[0]) if len(args) > 0 else 256
    nblk = int(args[1]) if len(args) > 1 else 32
    t_pad = int(args[2]) if len(args) > 2 else 8
    n1 = 100_001
    k = 10
    reps = 8

    import jax
    import jax.numpy as jnp

    from searchlite.ops.sparse import make_strip_prune_probe

    prune, sort_core = make_strip_prune_probe()
    if use_real:
        d_np, v_np, t_of_np, sent, nblk = real_strips(B, t_pad, 11)
    else:
        d_np, v_np, t_of_np, sent = build_strips(B, nblk, t_pad, n1, 7)
    d = jnp.asarray(d_np)
    v = jnp.asarray(v_np)
    t_of = jnp.asarray(t_of_np)
    o_s, o_d = oracle_topk(d_np, v_np, sent, k)

    L = nblk * 128
    print(f"strips B={B} nblk={nblk} t_pad={t_pad} L={L} "
          f"({B * L / 1e6:.1f}M candidates)", flush=True)

    def timed(fn, **kw):
        refs = fn(d, v, t_of, sent, t_pad=t_pad, **kw)
        jax.device_get(refs)          # compile + settle
        t0 = time.perf_counter()
        out = [fn(d, v, t_of, sent, t_pad=t_pad, **kw)
               for _ in range(reps)]
        fetched = [jax.device_get(r) for r in out]
        dt = (time.perf_counter() - t0) / reps
        return dt, fetched[-1]

    t_sort, (ss, sd, _) = timed(sort_core, k=k, c=64)
    print(f"sort core   : {t_sort * 1000:8.2f} ms/step", flush=True)

    # sort core vs oracle (sanity)
    bad = sum(1 for b in range(B)
              if list(sd[b][: len(o_d[b])]) != o_d[b])
    print(f"  sort vs oracle doc mismatches: {bad}/{B}")

    for c in (max(2 * k, 16), 64, 128, 256):
        if c > L:
            continue
        t_p, (ps, pd, ok) = timed(prune, k=k, c=c)
        ok = np.asarray(ok)
        rate = float(ok.mean())
        mism = 0
        for b in range(B):
            if not ok[b]:
                continue
            want_d = o_d[b]
            got_d = list(pd[b][: len(want_d)])
            if got_d != want_d or not np.allclose(
                    ps[b][: len(o_s[b])], o_s[b], rtol=2e-5,
                    atol=1e-5):
                mism += 1
        eff = t_p + (1.0 - rate) * t_sort
        print(f"prune C={c:4d}: {t_p * 1000:8.2f} ms/step  "
              f"cert pass {rate * 100:5.1f}%  "
              f"effective {eff * 1000:8.2f} ms  "
              f"exactness violations on certified rows: {mism}",
              flush=True)


if __name__ == "__main__":
    main()
