"""Vector + hybrid search scale benchmark.

The reference's vector feature is a single-layer HNSW walked serially
per query (`vectors/hnsw.rs:77-271`, m=16 ef=40); this engine replaces
it with exact brute-force similarity as a matmul (`ops/vector.py` —
SURVEY §7 sanctions the swap). This bench measures that trade at
scale: N docs x D dims, batched vector queries (exact top-k) and
hybrid (BM25 + vector blend) singles.

Usage:  python tools/bench_vectors.py [n_docs] [dim]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def log(**kv):
    print(json.dumps(kv), flush=True)


def main():
    n_docs = int(sys.argv[1]) if len(sys.argv) > 1 else 500_000
    dim = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    force_cpu = "--cpu" in sys.argv

    import jax

    if force_cpu:
        jax.config.update("jax_platforms", "cpu")

    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    rng = np.random.default_rng(5)
    vocab = [f"t{i}" for i in range(5000)]
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY,
                     enable_positions=False),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "vector_fields": [{"name": "emb", "dim": dim,
                               "metric": "cosine"}]}))
    writer = index.writer()
    t0 = time.perf_counter()
    done = 0
    CHUNK = 100_000
    while done < n_docs:
        n = min(CHUNK, n_docs - done)
        vecs = rng.standard_normal((n, dim), dtype=np.float32)
        toks = rng.integers(0, 5000, size=(n, 8))
        writer.add_documents([
            {"_id": str(done + i),
             "body": " ".join(vocab[t] for t in toks[i]),
             "emb": vecs[i].tolist()} for i in range(n)])
        done += n
    writer.commit()
    log(phase="ingest", docs=n_docs, dim=dim,
        s=round(time.perf_counter() - t0, 1))

    reader = index.reader()
    queries = rng.standard_normal((64, dim)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)

    def vreq(i, k=10):
        return {"query": {"type": "vector", "field": "emb",
                          "vector": queries[i].tolist(),
                          "alpha": 0.0},
                "limit": k}

    reader.search(vreq(0))  # warm compile
    t0 = time.perf_counter()
    for i in range(32):
        reader.search(vreq(i))
    dt = time.perf_counter() - t0
    vec_qps = round(32 / dt, 1)
    log(phase="vector_single", p50_ish_ms=round(dt / 32 * 1e3, 1),
        qps=vec_qps)

    # exactness spot check vs numpy at k=10
    seg = reader.segments[0]
    vecs_np = reader.device_segments[0].reader.vectors["emb"]
    want_ok = True
    raw = np.asarray(vecs_np.vectors, dtype=np.float32)
    for i in range(4):
        res = reader.search(vreq(i))
        sims = raw @ queries[i]
        top = np.argsort(-sims)[:10]
        got = [h.doc_id for h in res.hits]
        want = [seg.doc_id(int(t)) for t in top]
        if got != want:
            # allow near-tie reorderings
            gs = np.sort(np.asarray(
                [float(h.score) for h in res.hits]))[::-1]
            ws = np.sort(sims[top])[::-1]
            if not np.allclose(gs, ws, rtol=2e-2, atol=1e-3):
                want_ok = False
    log(phase="vector_exactness", ok=want_ok)

    # hybrid singles (BM25 + blend)
    hreq = {"query": {"type": "bool", "must": [
                {"type": "query_string", "query": "t10 t20 t33"},
                {"type": "vector", "field": "emb",
                 "vector": queries[0].tolist(), "alpha": 0.5}]},
            "limit": 10}
    reader.search(hreq)
    t0 = time.perf_counter()
    for _ in range(16):
        reader.search(hreq)
    dt = time.perf_counter() - t0
    log(phase="hybrid_single", p50_ish_ms=round(dt / 16 * 1e3, 1))

    print(json.dumps({
        "metric": f"vector_exact_qps_{n_docs // 1000}k_{dim}d",
        "unit": "qps", "value": vec_qps}))


if __name__ == "__main__":
    main()
