"""Benchmark: batched BM25 top-10 QPS through the real engine.

Builds a Zipf-distributed synthetic corpus through the full ingest path
(validation → tokenize via the C++ accelerator → block-native postings →
fast fields → docstore), opens a reader (uploads the HBM block layout),
then measures batched multi-term query throughput via
``IndexReader.search_batch`` — exact top-10, identical results to the
single-query path (enforced by tests/test_batch_search.py).

Prints ONE JSON line:
    {"metric": ..., "value": QPS, "unit": "qps", "vs_baseline": ...}

vs_baseline compares against a single-thread numpy implementation of the
same exact scoring over the same index (a stand-in for the reference's
single-node CPU engine until the Rust baseline runs on this host).

The benchmark runs on the GPU only. When JAX's default backend is not
the GPU it exits non-zero and prints no result; only
``SEARCHLITE_BENCH_FORCE_CPU=1`` runs it on the CPU backend, and the
result then says ``"platform": "cpu"`` and ``"forced_cpu": true``. A
deadline watchdog emits whatever was measured so far as a
partial-but-honest JSON line instead of hanging the harness.

Every timed configuration is gated against the numpy reference in
``searchlite/oracle.py``.
"""

from __future__ import annotations

import json
import os
import random
import sys
import threading
import time

import numpy as np

N_DOCS = 100_000
VOCAB = 10_000
AVG_LEN = 60
BATCH = 1024
N_BATCHES = 3
TERMS_PER_QUERY = 4
K = 10

METRIC = f"engine_batched_bm25_top{K}_qps_{N_DOCS // 1000}k_docs"

# Mutable result snapshot; the deadline watchdog prints whatever is in
# here if the run overshoots, so every phase updates it as it lands.
RESULT = {"metric": METRIC, "value": 0, "unit": "qps", "vs_baseline": 0}
_EMITTED = threading.Event()


def emit(**extra):
    if _EMITTED.is_set():
        return
    _EMITTED.set()
    out = dict(RESULT)
    out.update(extra)
    print(json.dumps(out), flush=True)


def build_docs(seed=7):
    rng = np.random.default_rng(seed)
    # Zipf-ish token distribution over the vocabulary
    ranks = np.arange(1, VOCAB + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    lengths = rng.integers(AVG_LEN // 2, AVG_LEN * 2, size=N_DOCS)
    docs = []
    vocab = [f"tok{i}" for i in range(VOCAB)]
    all_tokens = rng.choice(VOCAB, size=int(lengths.sum()), p=probs)
    cursor = 0
    for i in range(N_DOCS):
        n = int(lengths[i])
        body = " ".join(vocab[t] for t in all_tokens[cursor:cursor + n])
        cursor += n
        docs.append({"_id": str(i), "body": body})
    return docs


def build_queries(seed=11):
    rng = random.Random(seed)
    batches = []
    for _ in range(N_BATCHES + 1):
        batch = []
        for _q in range(BATCH):
            # skew away from pure stopwords
            terms = [f"tok{rng.randint(10, VOCAB - 1)}"
                     for _ in range(TERMS_PER_QUERY)]
            batch.append(" ".join(terms))
        batches.append(batch)
    return batches


def cpp_engine_qps(reader, queries):
    """Best-mode single-core QPS of the C++ baseline engine on this
    workload, or None when no toolchain. Returns (mode, qps)."""
    try:
        from searchlite.native import CpuEngine

        eng = CpuEngine(reader.segments[0])
    except Exception:  # noqa: BLE001 — no toolchain / ABI issues
        return None
    qtids = np.full((len(queries), TERMS_PER_QUERY), -1, dtype=np.int32)
    for qi, q in enumerate(queries):
        for ti, tok in enumerate(q.split()):
            qtids[qi, ti] = eng.tid(f"body:{tok}")
    best = None
    for mode in ("bm25", "wand", "bmw"):
        eng.search_batch(qtids[:64], k=K, mode=mode)  # warm
        t0 = time.perf_counter()
        eng.search_batch(qtids, k=K, mode=mode)
        mode_qps = len(queries) / (time.perf_counter() - t0)
        if best is None or mode_qps > best[1]:
            best = (mode, mode_qps)
    return best


def cpu_reference_qps(oracle, queries, n_queries=8):
    """Single-thread numpy exact scoring over the same postings arrays."""
    t0 = time.perf_counter()
    for raw in queries[:n_queries]:
        scores = oracle.scores(raw.split())[0]
        _ = np.argpartition(-scores, K)[:K]
    dt = time.perf_counter() - t0
    return n_queries / dt


def verify_vs_oracle(oracle, queries, results) -> bool:
    """The measured path's results must be the reference's top-k
    (searchlite/oracle.py; the gate accepts near-tie reorderings within
    the precision mode's tolerance)."""
    for raw, got in zip(queries, results):
        hits = [(*oracle.locate(d), float(s)) for d, s in got]
        if oracle.check(oracle.scores(raw.split()), hits, K) is not None:
            return False
    return True


def main():
    deadline_s = float(os.environ.get("SEARCHLITE_BENCH_DEADLINE", "2400"))

    def _deadline():
        time.sleep(deadline_s)
        emit(error=f"bench exceeded {deadline_s:.0f}s deadline; "
                   "partial results")
        os._exit(3)

    threading.Thread(target=_deadline, daemon=True).start()

    force_cpu = os.environ.get("SEARCHLITE_BENCH_FORCE_CPU") == "1"
    import jax
    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        print(f"bench.py: the default JAX backend is "
              f"{jax.default_backend()!r}, not 'gpu'; set "
              "SEARCHLITE_BENCH_FORCE_CPU=1 for a CPU run",
              file=sys.stderr, flush=True)
        _EMITTED.set()  # no result line for a run off the GPU
        raise SystemExit(3)
    dev = jax.devices()[0]
    RESULT["detail"] = {"platform": dev.platform,
                        "device_kind": dev.device_kind,
                        "device_count": len(jax.devices()),
                        "forced_cpu": force_cpu}

    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    t_build = time.perf_counter()
    docs = build_docs()
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}]}))
    writer = index.writer()
    writer.add_documents(docs)
    writer.commit()
    build_s = time.perf_counter() - t_build
    RESULT["detail"]["index_build_s"] = round(build_s, 2)

    reader = index.reader()
    batches = build_queries()
    from searchlite.oracle import Bm25Oracle

    oracle = Bm25Oracle(reader)

    # warmup pass: compiles every shape bucket the workload produces
    for batch in batches:
        reader.search_batch(batch, limit=K)

    # sustained throughput: a stream of batches through the pipelined
    # API (dispatch all, one bulk fetch) — the serving pattern.
    # Both batched strategies are measured: `bm25` (dense W@M) and
    # `wand` (per-query doc-tile pruning — the reference's own default
    # strategy); results are identical (oracle-verified below), so the
    # headline is the faster one.
    stream = batches[1:] * 8  # ~1.5s of measurement at 16k QPS
    n_queries = sum(len(b) for b in stream)
    qps_by_exec = {}
    for execution in ("bm25", "wand"):
        # warm EVERY batch in the stream: distinct batches can occupy
        # distinct tier-shape buckets, and the stream is batches[1:]
        # (bm25 was covered by the general warmup pass above, which
        # runs execution=bm25)
        reader.search_batch_many(batches, limit=K,
                                 execution=execution)  # warm compiles
        t0 = time.perf_counter()
        reader.search_batch_many(stream, limit=K, execution=execution)
        dt = time.perf_counter() - t0
        qps_by_exec[execution] = round(n_queries / dt, 2)
        RESULT["detail"][f"qps_{execution}"] = qps_by_exec[execution]
    # arrays output: raw (scores, doc ords) per batch — the SAME result
    # surface the C++ baseline engine (and the reference's own benches)
    # measure at; the pairs rows above additionally pay per-hit Python
    # tuple + doc-id string materialization
    t0 = time.perf_counter()
    arr_out = reader.search_batch_many(stream, limit=K,
                                       output="arrays")
    dt = time.perf_counter() - t0
    assert len(arr_out) == len(stream)
    qps_by_exec["bm25_arrays"] = round(n_queries / dt, 2)
    RESULT["detail"]["qps_bm25_arrays"] = qps_by_exec["bm25_arrays"]
    # pinned cross-round protocol row: "value" was the b1024 arrays
    # figure through round 2; quote THIS field for round-over-round
    # comparisons, never "value" (which is now max over configs)
    RESULT["detail"]["qps_protocol_b1024"] = qps_by_exec["bm25_arrays"]
    # batch-width scaling row: the SAME query stream re-chunked at
    # 4096/batch (per-batch host fixed costs — dispatch, upload, fetch
    # sync — amortize 4x). The stream is only re-chunked, so results
    # must be identical per query — but the 4096-wide batch occupies
    # its OWN tier-shape buckets, so its timed output is verified
    # against the oracle below and the row is gated out of headline
    # contention if that fails. Skipped on a forced CPU run.
    wide_out = None
    if not force_cpu:
        flat_q = [q for b in stream for q in b]
        wide = [flat_q[i:i + 4096]
                for i in range(0, len(flat_q), 4096)]
        # warm every wide batch once — tier occupancy differs per
        # batch and a compile must not land inside the timed region
        reader.search_batch_many(wide, limit=K, output="arrays")
        t0 = time.perf_counter()
        wide_out = reader.search_batch_many(wide, limit=K,
                                            output="arrays")
        dt = time.perf_counter() - t0
        qps_by_exec["bm25_arrays_b4096"] = round(len(flat_q) / dt, 2)
        RESULT["detail"]["qps_bm25_arrays_b4096"] = (
            qps_by_exec["bm25_arrays_b4096"])

    # correctness gate — runs BEFORE headline selection so a failing
    # config cannot produce RESULT.value. Both strategies' results must
    # be the oracle's exact top-k (catches silent backend corruption —
    # the QPS number is meaningless otherwise).
    verify_queries = batches[1][:16]
    ok = True
    for execution in ("bm25", "wand"):
        verify_results = reader.search_batch(verify_queries, limit=K,
                                             execution=execution)
        ok = ok and verify_vs_oracle(oracle, verify_queries,
                                     verify_results)

    def _materialize(rows, qn=len(verify_queries)):
        a_scores, a_ids, a_segs = rows
        out = []
        for qi in range(qn):
            n = int((a_scores[qi] != -np.inf).sum())
            out.append([
                (reader.segments[int(a_segs[qi, j])].doc_id(
                    int(a_ids[qi, j])), float(a_scores[qi, j]))
                for j in range(n)])
        return out

    # the arrays surface is verified from the TIMED run's own output:
    # stream[0] == batches[1], so arr_out[0] rows :16 are exactly
    # verify_queries in the shape bucket the throughput row measured
    ok = ok and verify_vs_oracle(oracle, verify_queries,
                                 _materialize(arr_out[0]))
    if wide_out is not None:
        # same for the wide config: flat_q[:16] == batches[1][:16]
        ok4096 = verify_vs_oracle(oracle, verify_queries,
                                  _materialize(wide_out[0]))
        RESULT["detail"]["verified_b4096_vs_oracle"] = ok4096
        if not ok4096:
            qps_by_exec.pop("bm25_arrays_b4096", None)
    RESULT["detail"]["verified_vs_oracle"] = ok
    RESULT["detail"]["score_mode"] = (
        "f32_strict" if os.environ.get(
            "SEARCHLITE_PRECISION") == "f32_strict"
        else os.environ.get("SEARCHLITE_PRECISION", "fast-f32"))

    # headline = best verified serving configuration (strategy x batch
    # width); which one won is disclosed in detail. The b1024 rows stay
    # measured every round for cross-round comparability
    # (detail.qps_protocol_b1024).
    best = max(qps_by_exec, key=qps_by_exec.get)
    qps = qps_by_exec[best]
    RESULT["value"] = qps
    RESULT["detail"]["headline_execution"] = best
    RESULT["detail"]["batch"] = 4096 if best.endswith("b4096") else BATCH
    RESULT["detail"]["terms_per_query"] = TERMS_PER_QUERY

    cpu_qps = cpu_reference_qps(oracle, batches[0])
    RESULT["detail"]["cpu_oracle_qps"] = round(cpu_qps, 2)

    def _rerun_config(name):
        """One more timed pass of a measured serving config."""
        if name == "bm25_arrays_b4096":
            t0 = time.perf_counter()
            reader.search_batch_many(wide, limit=K, output="arrays")
            return len(flat_q) / (time.perf_counter() - t0)
        if name == "bm25_arrays":
            t0 = time.perf_counter()
            reader.search_batch_many(stream, limit=K, output="arrays")
            return n_queries / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        reader.search_batch_many(stream, limit=K, execution=name)
        return n_queries / (time.perf_counter() - t0)

    # the baseline denominator: the single-core C++ engine implementing
    # the reference's three strategies over the same postings
    # (native/slt_cpu_engine.cpp; exactness-tested) — the strongest
    # measurable stand-in for the Rust CPU engine. Best mode wins
    # (brute TAAT at this corpus size). Protocol: >=3 INTERLEAVED
    # engine/baseline alternations in the same window, medians quoted —
    # host-clock samples of either side vary between runs.
    eng_samples = [qps]
    cpp_samples = []
    for _rep in range(3):
        s = cpp_engine_qps(reader, batches[1])
        if s is None:
            break
        cpp_samples.append(s)
        eng_samples.append(_rerun_config(best))
    if cpp_samples:
        cpp_samples.sort(key=lambda ms: ms[1])
        mode, qps_cpp = cpp_samples[len(cpp_samples) // 2]
        eng_med = sorted(eng_samples)[len(eng_samples) // 2]
        qps = round(eng_med, 2)
        RESULT["value"] = qps
        RESULT["vs_baseline"] = round(qps / qps_cpp, 2)
        RESULT["detail"]["cpp_engine_qps"] = round(qps_cpp, 1)
        RESULT["detail"]["cpp_engine_qps_samples"] = [
            round(q, 1) for _, q in cpp_samples]
        RESULT["detail"]["engine_qps_samples"] = [
            round(q, 1) for q in eng_samples]
        RESULT["detail"]["cpp_engine_mode"] = mode
        RESULT["detail"]["baseline_kind"] = "cpp-engine-1core"
        RESULT["detail"]["vs_baseline_b1024"] = round(
            qps_by_exec["bm25_arrays"] / qps_cpp, 2)
        if "bm25_arrays_b4096" in qps_by_exec:
            RESULT["detail"]["vs_baseline_b4096"] = round(
                qps_by_exec["bm25_arrays_b4096"] / qps_cpp, 2)
    else:
        RESULT["vs_baseline"] = round(qps / cpu_qps, 2)
        RESULT["detail"]["baseline_kind"] = "numpy-oracle-proxy"

    # p50 single-query latency (warm shapes; the BASELINE metric).
    # Warm EVERY query once first: distinct singles can occupy
    # distinct block-count buckets, so warming only singles[0] left
    # bucket compiles inside the timed loop in a fresh process.
    singles = batches[0][:9]
    for q in singles:
        reader.search({"query": q, "limit": K})  # warm every bucket
    lat = []
    for q in singles:
        t1 = time.perf_counter()
        reader.search({"query": q, "limit": K})
        lat.append((time.perf_counter() - t1) * 1000)
    RESULT["detail"]["p50_single_query_ms"] = round(
        sorted(lat)[len(lat) // 2], 1)
    # record the routing the default-execution single takes
    prof = reader.search({"query": singles[0], "limit": K,
                          "profile": True}).profile
    if prof:
        RESULT["detail"]["p50_route_stats"] = {
            k: v for k, v in prof["execution"].items()
            if isinstance(v, (int, float, bool, str))}
        if prof["execution"].get("pruning_simulated"):
            # when the dense/sparse route answered the query,
            # postings_advanced is the COUNTERFACTUAL count a block-max
            # pruned traversal would have touched, not a measurement
            RESULT["detail"]["p50_route_stats_note"] = (
                "pruning_simulated=true: postings_advanced is a "
                "counterfactual block-max model (the dense/sparse "
                "route ran; real tile-path counters appear only when "
                "the pruned route answers — see docs/pruning.md)")

    emit()


if __name__ == "__main__":
    try:
        main()
    except BaseException as exc:  # emit honest partial on any failure
        if not isinstance(exc, SystemExit):
            emit(error=f"{type(exc).__name__}: {exc}")
            raise
        raise
