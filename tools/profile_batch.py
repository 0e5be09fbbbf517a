"""Stage-level profile of IndexReader.search_batch on the live device.

Times: query analysis, host batch-arg build (build_impact_batch),
device launch+fetch, and host merge — plus a pure-device breakdown of
the compiled scorer stages (M scatter, W densify+matmul, top-k) using
the same shapes the bench produces.
"""

import sys
import time

sys.path.insert(0, ".")

from searchlite.utils.devguard import guard_backend  # noqa: E402

guard_backend(__file__)

import numpy as np  # noqa: E402

import bench  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema
    from searchlite.ops.impact import build_impact_batch, build_m

    print("devices:", jax.devices(), flush=True)
    t0 = time.perf_counter()
    docs = bench.build_docs()
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}]}))
    writer = index.writer()
    writer.add_documents(docs)
    writer.commit()
    print(f"ingest {time.perf_counter()-t0:.1f}s", flush=True)

    reader = index.reader()
    batches = bench.build_queries()
    for batch in batches:
        reader.search_batch(batch, limit=bench.K)
    print("warm", flush=True)

    # ---- stage timings through the public path (instrumented inline)
    dseg = reader.device_segments[0]
    seg = dseg.reader
    fields = ["body"]
    reps = 3
    t_analyze = t_build = t_device = t_merge = 0.0
    for _ in range(reps):
        for batch in batches[1:]:
            t1 = time.perf_counter()
            analyzed = []
            from searchlite.query.parser import parse_query
            for raw in batch:
                pairs = []
                parsed = parse_query(raw)
                for term in parsed.terms:
                    for field in fields:
                        analyzer = reader.analysis.search_analyzer(field)
                        for tok in analyzer.analyze(term.term):
                            pairs.append((field, tok.text))
                analyzed.append(pairs)
            t2 = time.perf_counter()
            qb = build_impact_batch(seg, dseg, analyzed)
            t3 = time.perf_counter()
            scorer = reader._batched_scorer()
            scores, ids = scorer(
                dseg.block_docs, dseg.block_impacts, dseg.deleted,
                jnp.asarray(qb["blk_idx"]), jnp.asarray(qb["slot_row"]),
                jnp.asarray(qb["w_idx"]), jnp.asarray(qb["w_val"]),
                jnp.zeros((1, 1), dtype=bool),
                jnp.zeros(1, dtype=jnp.int32),
                k=bench.K, s_pad=qb["s_pad"], n_queries=qb["n_queries"])
            scores, ids = jax.device_get((scores, ids))
            t4 = time.perf_counter()
            merged = [dict() for _ in batch]
            for qi in range(len(batch)):
                for score, doc in zip(scores[qi].tolist(), ids[qi].tolist()):
                    if score == -np.inf:
                        continue
                    merged[qi][(0, int(doc))] = float(score)
            results = []
            for qi in range(len(batch)):
                ranked = sorted(merged[qi].items(),
                                key=lambda kv: (-kv[1], kv[0]))[:bench.K]
                results.append([(seg.doc_id(doc), s)
                                for (_o, doc), s in ranked])
            t5 = time.perf_counter()
            t_analyze += t2 - t1
            t_build += t3 - t2
            t_device += t4 - t3
            t_merge += t5 - t4
    n = reps * (len(batches) - 1)
    print(f"per-batch: analyze {t_analyze/n*1e3:.1f}ms  "
          f"hostbuild {t_build/n*1e3:.1f}ms  device {t_device/n*1e3:.1f}ms  "
          f"merge {t_merge/n*1e3:.1f}ms", flush=True)

    # ---- device-only stage breakdown at the same shapes
    qb = build_impact_batch(seg, dseg, [
        [("body", t) for t in raw.split()] for raw in batches[1]])
    p_pad = qb["p_pad"]
    s_pad = len(qb["slot_start"])
    nq = qb["n_queries"]
    n1 = dseg.n1
    print(f"shapes: s_pad={s_pad} p_pad={p_pad} nq={nq} n1={n1}",
          flush=True)

    from searchlite.ops.impact import build_m_from_blocks

    blk_idx = jnp.asarray(qb["blk_idx"])
    slot_row = jnp.asarray(qb["slot_row"])
    w_idx = jnp.asarray(qb["w_idx"])
    w_val = jnp.asarray(qb["w_val"])

    @jax.jit
    def stage_m(bd, bi, bx, sr):
        return build_m_from_blocks(jnp, bd, bi, bx, sr, n1, s_pad).sum()

    @jax.jit
    def stage_mm(bd, bi, bx, sr, wi, wv):
        m = build_m_from_blocks(jnp, bd, bi, bx, sr, n1, s_pad)
        w = jnp.zeros((nq * s_pad,), jnp.float32).at[wi].add(
            wv, mode="drop").reshape(nq, s_pad)
        return (w @ m).sum()

    @jax.jit
    def stage_full(bd, bi, bx, sr, wi, wv):
        m = build_m_from_blocks(jnp, bd, bi, bx, sr, n1, s_pad)
        w = jnp.zeros((nq * s_pad,), jnp.float32).at[wi].add(
            wv, mode="drop").reshape(nq, s_pad)
        scores = w @ m
        top, idx = jax.lax.top_k(scores, bench.K)
        return top.sum() + idx.sum()

    def timeit(label, fn, *args):
        fn(*args).block_until_ready()
        out = jax.device_get(fn(*args))  # force
        t1 = time.perf_counter()
        for _ in range(5):
            out = jax.device_get(fn(*args))
        dt = (time.perf_counter() - t1) / 5
        print(f"{label}: {dt*1e3:.1f}ms", flush=True)
        return out

    timeit("device M-build only", stage_m, dseg.block_docs,
           dseg.block_impacts, blk_idx, slot_row)
    timeit("device M+matmul", stage_mm, dseg.block_docs,
           dseg.block_impacts, blk_idx, slot_row, w_idx, w_val)
    timeit("device M+matmul+topk", stage_full, dseg.block_docs,
           dseg.block_impacts, blk_idx, slot_row, w_idx, w_val)


if __name__ == "__main__":
    main()
