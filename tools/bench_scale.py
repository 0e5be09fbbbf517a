"""MS-MARCO-shaped scale benchmark: ingest + batched QPS at millions of
docs through the doc-sharded path.

This generates a synthetic corpus with the shape of the MS MARCO
passages (tools/msmarco.py reads the real collection when it is on
disk): ~8.8M passages of ~60 tokens drawn from a Zipf-distributed
vocabulary. Queries mix head and tail terms like the real query log
(2-6 terms, rank-skewed).

Usage:
    python tools/bench_scale.py [n_docs] [--exec bm25|bmw] [--cpu]
        [--cpu-engine] [--path DIR]

--path DIR persists the index on disk and reuses it on later runs
(ingest at 5M is ~10 min per probe; repeated measurement sessions skip
it — the generated corpus is deterministic, seed 7, so a reused index
is identical to a fresh one at the same n_docs).

--cpu-engine additionally measures the single-core C++ baseline engine
(native/slt_cpu_engine.cpp, the Rust-reference stand-in — BASELINE.md)
on the same corpus and query stream, in all three strategies.

Prints one JSON line per phase and a final summary line. Positions are
disabled (the workload has no phrase queries) to keep host memory
proportional to postings.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

VOCAB = 120_000
AVG_LEN = 60
BATCH = 1024
K = 10
CHUNK = 200_000


def log(**kv):
    print(json.dumps(kv), flush=True)


N_CATS = 16

# the corpus schema: the passage text plus fast fields that filters,
# aggregations and sorts work on
SCHEMA = {
    "text_fields": [{"name": "body", "analyzer": "default",
                     "stored": False, "indexed": True}],
    "keyword_fields": [{"name": "cat", "stored": False,
                        "indexed": False, "fast": True}],
    "numeric_fields": [{"name": "year", "i64": True, "stored": False,
                        "fast": True},
                       {"name": "price", "i64": False, "stored": False,
                        "fast": True}]}


def corpus_model():
    """(Zipf term probabilities, vocabulary) of the synthetic corpus."""
    ranks = np.arange(1, VOCAB + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    return probs, [f"t{i}" for i in range(VOCAB)]


def fast_values(d):
    """Fast-field values of doc numbers ``d`` (int array): category
    index (``cat`` is ``f"c{cat}"``), ``year`` and ``price``."""
    d = np.asarray(d, dtype=np.int64)
    return d % N_CATS, 1990 + (d * 9) % 35, (d % 997).astype(np.float64)


def gen_chunk(rng, probs, vocab, n, base):
    """Docs ``base .. base+n-1``: 30-120 Zipf-drawn tokens each, plus
    the fast fields of ``fast_values``."""
    lengths = rng.integers(AVG_LEN // 2, AVG_LEN * 2, size=n)
    toks = rng.choice(VOCAB, size=int(lengths.sum()), p=probs)
    cats, years, prices = fast_values(np.arange(base, base + n))
    docs = []
    cursor = 0
    for i in range(n):
        ln = int(lengths[i])
        docs.append({
            "_id": str(base + i),
            "body": " ".join(vocab[t]
                             for t in toks[cursor:cursor + ln]),
            "cat": f"c{cats[i]}",
            "year": int(years[i]),
            "price": float(prices[i]),
        })
        cursor += ln
    return docs


def build_queries(rng, n_queries, vocab):
    """Rank-skewed queries: one head term (zipf), 1-5 mid/tail terms —
    the mixed-idf shape where block-max pruning has bite."""
    ranks = np.arange(1, VOCAB + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    out = []
    for _ in range(n_queries):
        n_terms = int(rng.integers(2, 7))
        terms = [vocab[int(rng.choice(VOCAB, p=probs))]]
        terms += [vocab[int(t)] for t in
                  rng.integers(100, VOCAB, size=n_terms - 1)]
        out.append(" ".join(terms))
    return out


def main():
    args = [a for a in sys.argv[1:]]
    n_docs = int(args[0]) if args and not args[0].startswith("-") \
        else 5_000_000
    force_cpu = "--cpu" in args
    executions = ["bm25", "bmw"]
    if "--exec" in args:
        executions = [args[args.index("--exec") + 1]]
        if executions == ["none"]:  # cpu-engine-only runs
            executions = []

    import jax
    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        from searchlite.utils.devguard import guard_backend

        guard_backend(__file__)
    log(phase="start", n_docs=n_docs, backend=jax.default_backend())

    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    rng = np.random.default_rng(7)
    probs, vocab = corpus_model()

    path = args[args.index("--path") + 1] if "--path" in args else ""
    schema = Schema.from_json(SCHEMA)
    if path and os.path.exists(os.path.join(path, "MANIFEST.json")):
        index = Index.open(IndexOptions(path=path))
        log(phase="reuse", path=path)
    else:
        index = Index.create(
            IndexOptions(path=path, create_if_missing=True,
                         storage=(StorageType.FILESYSTEM if path
                                  else StorageType.IN_MEMORY),
                         enable_positions=False),
            schema)
        writer = index.writer()
        t0 = time.perf_counter()
        done = 0
        while done < n_docs:
            n = min(CHUNK, n_docs - done)
            writer.add_documents(gen_chunk(rng, probs, vocab, n, done))
            done += n
            log(phase="gen+buffer", docs=done,
                elapsed_s=round(time.perf_counter() - t0, 1))
        t1 = time.perf_counter()
        writer.commit()
        t2 = time.perf_counter()
        log(phase="ingest", docs=n_docs,
            gen_buffer_s=round(t1 - t0, 1), commit_s=round(t2 - t1, 1),
            docs_per_s=round(n_docs / (t2 - t0), 1))

    if "--build-only" in args:
        # persist the corpus for a later device session without paying
        # any search/upload phases (host restarts wipe /root/idx*)
        log(phase="build_only_done", path=path)
        return

    t0 = time.perf_counter()
    reader = index.reader()
    dseg = reader.device_segments[0]
    # host-side accounting: block arrays upload lazily per path, so
    # touching the device copies here would force a 4 GB upload the
    # sharded/pruned paths never need
    post_bytes = int(dseg.block_docs_np.size * 4
                     + dseg.block_impacts_np.size * 4)
    log(phase="upload", upload_s=round(time.perf_counter() - t0, 1),
        hbm_block_bytes=post_bytes,
        n_blocks=int(dseg.n_block_rows))

    queries = build_queries(rng, BATCH * 3, vocab)
    batches = [queries[i * BATCH:(i + 1) * BATCH] for i in range(3)]

    summary = {"metric": f"scale_batched_qps_{n_docs // 1_000_000}m",
               "unit": "qps", "n_docs": n_docs}

    if "--cpu-engine" in args:
        from searchlite.native import CpuEngine

        seg = reader.segments[0]
        t0 = time.perf_counter()
        eng = CpuEngine(seg)
        log(phase="cpu_engine_build",
            build_s=round(time.perf_counter() - t0, 1))
        tpq = max(len(q.split()) for q in queries)
        qtids = np.full((len(queries), tpq), -1, dtype=np.int32)
        for qi, q in enumerate(queries):
            for ti, tok in enumerate(q.split()):
                qtids[qi, ti] = eng.tid(f"body:{tok}")
        for mode in ("bm25", "wand", "bmw"):
            eng.search_batch(qtids[:64], k=K, mode=mode)  # warm
            t0 = time.perf_counter()
            eng.search_batch(qtids, k=K, mode=mode)
            dt = time.perf_counter() - t0
            log(phase="cpu_engine", mode=mode,
                qps=round(len(queries) / dt, 1),
                ms_per_q=round(dt / len(queries) * 1e3, 2))
            summary[f"cpu_engine_qps_{mode}"] = round(
                len(queries) / dt, 1)
        # the engine holds its own full postings copy (~GBs at multi-M
        # docs); free it before the device phases or 8.8M runs OOM
        del eng
    want_aggs = "--no-aggs" not in args and (
        bool(executions) or "--aggs-only" in args)
    for execution in executions:
        # pruning can't engage when a huge batch's seed tiles cover the
        # whole corpus; bmw runs 64-query sub-batches through the
        # pipelined API (3 bulk fetches for the whole stream)
        sub = 64 if execution in ("wand", "bmw") else BATCH
        stream = [b[i:i + sub] for b in batches[1:]
                  for i in range(0, len(b), sub)]
        # warm EVERY distinct batch the timed region will run —
        # distinct batches occupy distinct tier-shape buckets, and a
        # cold bucket is a minutes-long XLA compile at multi-M docs
        # (the same hole class fixed in bench.py / bench_1m, 5854503)
        t0 = time.perf_counter()
        reader.search_batch_many(
            [batches[0][i:i + sub] for i in range(0, BATCH, sub)],
            limit=K, execution=execution)
        reader.search_batch_many(stream, limit=K, execution=execution)
        warm = time.perf_counter() - t0
        rep_qps = []
        n = 0
        t0 = time.perf_counter()
        for _rep in range(2):
            t1 = time.perf_counter()
            reader.search_batch_many(stream, limit=K,
                                     execution=execution)
            nq = sum(len(b) for b in stream)
            rep_qps.append(round(nq / (time.perf_counter() - t1), 1))
            n += nq
        dt = time.perf_counter() - t0
        log(phase="batched", execution=execution, sub_batch=sub,
            warm_s=round(warm, 1), qps=round(n / dt, 1),
            rep_qps=rep_qps)
        summary[f"qps_{execution}"] = round(n / dt, 1)

        if execution == "bm25":
            # wide-batch serving config (the headline protocol's b4096
            # row): same query stream re-chunked into one 4096-wide
            # launch — per-batch host fixed costs amortize 4x further
            wide = [batches[1] + batches[2] + batches[1] + batches[2]]
            reader.search_batch_many(wide, limit=K, output="arrays",
                                     execution=execution)  # warm
            t0 = time.perf_counter()
            reader.search_batch_many(wide, limit=K, output="arrays",
                                     execution=execution)
            dt = time.perf_counter() - t0
            log(phase="batched_wide", execution=execution,
                batch=len(wide[0]), qps=round(len(wide[0]) / dt, 1))
            summary["qps_bm25_arrays_b4096"] = round(
                len(wide[0]) / dt, 1)

        # p50 single-query latency: warm one pass first (distinct term
        # counts land in distinct pow4 shape buckets; a cold bucket is
        # an XLA compile, minutes at 5M docs — steady state is the
        # number that matters)
        for q in queries[:9]:
            reader.search({"query": q, "limit": K,
                           "execution": execution})
        lat = []
        for q in queries[:9]:
            t1 = time.perf_counter()
            reader.search({"query": q, "limit": K,
                           "execution": execution})
            lat.append((time.perf_counter() - t1) * 1000)
        summary[f"p50_single_ms_{execution}"] = round(
            sorted(lat)[len(lat) // 2], 1)

    # aggregation p50 at scale: terms + stats + histogram over the
    # match set of a mid-frequency query (device-side partials vs the
    # host-collector mask-fetch path)
    if want_aggs:
        agg_req = {
            "query": queries[0], "limit": 5,
            "aggs": {
                "cats": {"type": "terms", "field": "cat"},
                "price_stats": {"type": "stats", "field": "price"},
                "price_hist": {"type": "histogram", "field": "price",
                               "interval": 100.0},
            }}
        for dev_flag, label in (("1", "device"), ("0", "host")):
            os.environ["SEARCHLITE_DEVICE_AGGS"] = dev_flag
            reader.search(agg_req)  # warm
            lat = []
            for _ in range(5):
                t1 = time.perf_counter()
                reader.search(agg_req)
                lat.append((time.perf_counter() - t1) * 1000)
            p50 = sorted(lat)[len(lat) // 2]
            log(phase="aggs", mode=label, p50_ms=round(p50, 1))
            summary[f"agg_p50_ms_{label}"] = round(p50, 1)
        os.environ.pop("SEARCHLITE_DEVICE_AGGS", None)

    # terms WITH a stats sub-agg: the sub-agg doc
    # grouping is the owner-sorted vectorized path; this row proves it
    # holds at a multi-M matched set rather than only on test shapes
    if want_aggs:
        subagg_req = {
            "query": queries[0], "limit": 5,
            "aggs": {
                "cats": {"type": "terms", "field": "cat",
                         "aggs": {"price_stats": {
                             "type": "stats", "field": "price"}}},
            }}
        reader.search(subagg_req)  # warm
        lat = []
        for _ in range(5):
            t1 = time.perf_counter()
            reader.search(subagg_req)
            lat.append((time.perf_counter() - t1) * 1000)
        p50 = sorted(lat)[len(lat) // 2]
        log(phase="subagg", p50_ms=round(p50, 1))
        summary["subagg_p50_ms"] = round(p50, 1)

    # bounded-memory collectors at scale: t-digest
    # percentiles (match set >> the 4096 exact window) + cardinality
    # with a precision_threshold forced below the field's 997 distinct
    # values, so the HLL sketch path is the one timed
    if want_aggs:
        bounded_req = {
            "query": queries[0], "limit": 5,
            "aggs": {
                "price_pctl": {"type": "percentiles", "field": "price"},
                "price_card": {"type": "cardinality", "field": "price",
                               "precision_threshold": 500},
                "cat_card": {"type": "cardinality", "field": "cat"},
            }}
        reader.search(bounded_req)  # warm
        lat = []
        for _ in range(5):
            t1 = time.perf_counter()
            reader.search(bounded_req)
            lat.append((time.perf_counter() - t1) * 1000)
        p50 = sorted(lat)[len(lat) // 2]
        log(phase="bounded_aggs", p50_ms=round(p50, 1))
        summary["bounded_agg_p50_ms"] = round(p50, 1)

    # field-sort p50 at scale: order the same mid-frequency match set
    # by a numeric fast field
    if want_aggs:
        sort_req = {"query": queries[0], "limit": K,
                    "sort": [{"field": "price", "order": "desc"}]}
        reader.search(sort_req)  # warm
        lat = []
        for _ in range(5):
            t1 = time.perf_counter()
            reader.search(sort_req)
            lat.append((time.perf_counter() - t1) * 1000)
        p50 = sorted(lat)[len(lat) // 2]
        log(phase="field_sort", p50_ms=round(p50, 1))
        summary["sort_p50_ms"] = round(p50, 1)

    summary["value"] = summary.get("qps_bm25") or next(
        (summary[f"qps_{e}"] for e in executions
         if f"qps_{e}" in summary), 0)
    log(**summary)


if __name__ == "__main__":
    main()
