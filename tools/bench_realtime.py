"""Realtime serving benchmark: sustained commits + concurrent search.

The log-structured serving story in one number set: a writer thread
commits small batches continuously (tiered auto-merge folding them)
while a searcher thread runs queries against freshly reopened readers.
Reports commit throughput, search latency percentiles, and
commit-to-visible lag (time from commit() returning to a reader
seeing the batch's sentinel doc).

Direct API (no HTTP) so the numbers are the engine's own; run
tools/soak_http.py for the server-surface correctness soak. Set
SEARCHLITE_HOST_TIER_DOCS to measure the opt-in host tier (fresh
segments served from the cpu backend).

Reading the numbers: per-bucket XLA executor compiles amortize over a
server's lifetime but dominate short windows whenever the fold walks
into a new doc-axis bucket (a stable warmed index serves ~30 ms/query
on this host INCLUDING a reader reopen per query; the first query
after a new bucket appears pays seconds of compile once per process).
The prewarm phase covers the buckets a default run crosses; runs
shorter than a few minutes still measure a compile-heavy transient,
and on a 1-CPU host the writer/merge work time-shares with searches.

Usage: python tools/bench_realtime.py [seconds] [--batch N]
       [--base N] [--no-auto-merge]
Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# default: host-only (the CPU backend). Pass --device to keep the
# accelerator backend.
if "--device" not in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    seconds = int(args[0]) if args else 30
    batch = 200
    base_docs = 100_000
    if "--batch" in sys.argv:
        batch = int(sys.argv[sys.argv.index("--batch") + 1])
    if "--base" in sys.argv:
        base_docs = int(sys.argv[sys.argv.index("--base") + 1])
    auto_merge = "--no-auto-merge" not in sys.argv
    upsert_frac = 0.0
    if "--upsert" in sys.argv:
        upsert_frac = float(sys.argv[sys.argv.index("--upsert") + 1])

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    import tempfile

    import numpy as np

    from searchlite.api.types import IndexOptions
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    schema = Schema.from_json({
        "text_fields": [{"name": "body", "analyzer": "default",
                         "stored": False, "indexed": True}]})
    opts = IndexOptions(path=tempfile.mkdtemp(prefix="rtbench_"),
                        create_if_missing=True,
                        auto_merge_segments=4 if auto_merge else 0)
    idx = Index.create(opts, schema)
    rng = np.random.default_rng(3)
    ranks = np.arange(1, 20_001)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    vocab = np.array([f"w{i}" for i in range(20_000)])

    t_base = time.perf_counter()
    w = idx.writer()
    toks = rng.choice(vocab, size=(base_docs, 30), p=probs)
    w.add_documents([{"_id": str(i), "body": " ".join(row)}
                     for i, row in enumerate(toks)])
    w.commit()
    print("WARM:", json.dumps({
        "base_docs": base_docs,
        "base_ingest_s": round(time.perf_counter() - t_base, 1)}),
        file=sys.stderr, flush=True)
    # prewarm the executor compile caches for every doc-axis bucket
    # the run will cross (fresh batches + their growing auto-merge
    # folds bucket to 1024/4096/16384/65536), so the measured window
    # is steady-state serving, not XLA compile. In a long-lived
    # server these compiles happen once per process.
    warm_id = 0  # prewarm docs also carry the sentinel term: the
    # visibility threshold below must count them or it is satisfied
    # before the probed batch is even searchable
    #
    # cover every pow4 doc-axis bucket the run's folds can walk into:
    # a longer run accumulates more fresh docs, and the first search
    # after a fold crosses a bucket boundary pays that bucket's XLA
    # compile — prewarm must pay it
    # instead, or the measured window is compile, not serving
    sizes = [batch, 700, 2500, 10_000, 40_000]
    exp_docs = base_docs + int(seconds * 8 * batch)  # generous rate
    nxt = 160_000
    while nxt < exp_docs:
        sizes.append(nxt)
        nxt *= 4
    # attribute the fresh-process prewarm bill. Each
    # bucket's ingest / commit / search cost prints to stderr as it
    # happens (a killed run still yields the attribution), and
    # --log-compiles turns on jax's compile logging so cache hits vs
    # real XLA compiles are distinguishable in the trace.
    if "--log-compiles" in sys.argv:
        import jax

        jax.config.update("jax_log_compiles", True)
    t_warm0 = time.perf_counter()
    for size in sizes:
        t0 = time.perf_counter()
        wtr = idx.writer()
        rows = rng.choice(vocab, size=(size, 8), p=probs)
        wtr.add_documents([{"_id": f"warm{warm_id + i}",
                            "body": " ".join(row) + " freshsentinel"}
                           for i, row in enumerate(rows)])
        warm_id += size
        wtr.commit()
        t1 = time.perf_counter()
        r = idx.reader()
        r.search({"query": "w3 w17", "limit": 10})
        t2 = time.perf_counter()
        r.search({"query": "freshsentinel", "limit": 1})
        t3 = time.perf_counter()
        print("WARM:", json.dumps({
            "bucket_docs": size,
            "ingest_commit_s": round(t1 - t0, 1),
            "search_multi_s": round(t2 - t1, 1),
            "search_single_s": round(t3 - t2, 1),
            "total_warm_s": round(t3 - t_warm0, 1)}),
            file=sys.stderr, flush=True)

    stop = threading.Event()
    lock = threading.Lock()
    stats = {"commits": 0, "docs": 0, "searches": 0, "errors": []}
    vis_lags: list[float] = []
    search_ms: list[float] = []
    latest_sentinel = [None]  # (doc_id, commit-return time)

    def writer_loop():
        n = base_docs
        gen = np.random.default_rng(5)
        while not stop.is_set():
            try:
                wtr = idx.writer()
                rows = gen.choice(vocab, size=(batch, 30), p=probs)
                docs = []
                for i, row in enumerate(rows):
                    # --upsert F: that fraction of each batch rewrites
                    # existing base-corpus ids — every commit then
                    # tombstones docs in the base segment, driving the
                    # tombstone-delta clone + upsert-locate paths
                    if gen.random() < upsert_frac:
                        did = str(int(gen.integers(0, base_docs)))
                    else:
                        did = str(n)
                        n += 1
                    docs.append({"_id": did,
                                 "body": " ".join(row)
                                 + " freshsentinel"})
                wtr.add_documents(docs)
                wtr.commit()
                with lock:
                    stats["commits"] += 1
                    stats["docs"] += batch
                    # one in-flight visibility probe at a time: only
                    # arm a new sentinel once the searcher consumed
                    # the previous one
                    if latest_sentinel[0] is None:
                        # arm: batch is visible once the total match
                        # count of the sentinel term reaches the docs
                        # committed so far (every fresh doc AND every
                        # prewarm doc carries it)
                        latest_sentinel[0] = (warm_id + stats["docs"],
                                              time.perf_counter())
            except Exception as e:  # noqa: BLE001
                with lock:
                    stats["errors"].append(f"writer: {e}")
                    stop.set()

    slow_log: list[dict] = []

    def searcher_loop():
        gen = np.random.default_rng(7)
        while not stop.is_set():
            try:
                q = " ".join(gen.choice(vocab[:2000], size=2))
                t0 = time.perf_counter()
                reader = idx.reader()
                t1 = time.perf_counter()
                reader.search({"query": q, "limit": 10})
                t2 = time.perf_counter()
                dt = (t2 - t0) * 1000
                n_segs = len(reader.segments)
                with lock:
                    stats["searches"] += 1
                    search_ms.append(dt)
                    pending = latest_sentinel[0]
                # visibility probe: search for the newest committed
                # sentinel batch; lag = now - commit-return
                t3 = t2
                if pending is not None:
                    out = reader.search(
                        {"query": "freshsentinel", "limit": 1})
                    t3 = time.perf_counter()
                    if out.total_hits_estimate >= pending[0]:
                        with lock:
                            vis_lags.append(
                                time.perf_counter() - pending[1])
                            latest_sentinel[0] = None
                # stage attribution for post-hoc stall analysis: which
                # searches stalled, on what (reopen vs main search vs
                # visibility count), over how many segments, and how
                # many docs the newest segment held (a fold crossing
                # the host-tier threshold pays its device upload +
                # bucket compile in whichever search touches it first)
                if (t3 - t0) * 1000 > 500:
                    with lock:
                        slow_log.append({
                            "at_s": round(t0 - t_start, 1),
                            "reopen_ms": round((t1 - t0) * 1e3, 1),
                            "search_ms": round((t2 - t1) * 1e3, 1),
                            "vis_ms": round((t3 - t2) * 1e3, 1),
                            "n_segs": n_segs,
                            "seg_docs": [
                                int(s.doc_count) for s in
                                reader.segments[-3:]],
                        })
            except Exception as e:  # noqa: BLE001
                with lock:
                    stats["errors"].append(f"searcher: {e}")
                    stop.set()

    threads = [threading.Thread(target=writer_loop, daemon=True),
               threading.Thread(target=searcher_loop, daemon=True)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    while time.perf_counter() - t_start < seconds and not stop.is_set():
        time.sleep(0.25)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    wall = time.perf_counter() - t_start

    def pct(xs, p):
        if not xs:
            return None
        return round(float(np.percentile(np.asarray(xs), p)), 2)

    summary = {
        "bench": "realtime_mixed",
        "seconds": round(wall, 1),
        "base_docs": base_docs,
        "batch": batch,
        "auto_merge": auto_merge,
        "upsert_frac": upsert_frac,
        "commits_per_s": round(stats["commits"] / wall, 2),
        "docs_per_s": round(stats["docs"] / wall, 1),
        "searches": stats["searches"],
        "search_p50_ms": pct(search_ms, 50),
        "search_p99_ms": pct(search_ms, 99),
        "search_steady_p50_ms": pct(search_ms[len(search_ms) // 2:],
                                    50),
        "visibility_p50_ms": pct([v * 1000 for v in vis_lags], 50),
        "visibility_max_ms": pct([v * 1000 for v in vis_lags], 100),
        "final_segments": len(idx.manifest.segments),
        "n_errors": len(stats["errors"]),
    }
    print(json.dumps(summary), flush=True)
    # stall attribution: the slowest search iterations with their
    # stage split (reopen / main search / visibility count) — stderr
    # so the one-JSON-line stdout contract holds
    for rec in sorted(
            slow_log, key=lambda r: -(r["reopen_ms"] + r["search_ms"]
                                      + r["vis_ms"]))[:8]:
        print("SLOW:", json.dumps(rec), file=sys.stderr)
    for e in stats["errors"][:5]:
        print("ERR:", e, file=sys.stderr)
    sys.exit(1 if stats["errors"] else 0)


if __name__ == "__main__":
    main()
