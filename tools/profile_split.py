"""Stage-level device profile of the DEFAULT batched path (the
dense/sparse split scorer) at the headline bench shapes.

Times each device stage PIPELINED (dispatch N, one bulk fetch): the
bench's serving pattern is pipelined.

Stages: sparse-M scatter build (at several nb_pad paddings), dense row
gather, W densify, scoring matmul(s), mask+top-k, and the composed
split scorer — plus bf16 variants of the scatter and matmul inputs.
"""

import sys
import time

sys.path.insert(0, ".")

from searchlite.utils.devguard import guard_backend  # noqa: E402

guard_backend(__file__)

import numpy as np  # noqa: E402

import bench  # noqa: E402


def timeit(label, make_refs, fetch, reps=8):
    """Pipelined: dispatch all reps, then one bulk fetch."""
    refs = make_refs(1)
    fetch(refs)  # warm/compile
    t0 = time.perf_counter()
    refs = make_refs(reps)
    fetch(refs)
    dt = (time.perf_counter() - t0) / reps
    print(f"{label}: {dt * 1e3:.1f}ms/step (pipelined x{reps})",
          flush=True)
    return dt


def main():
    import jax
    import jax.numpy as jnp

    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema
    from searchlite.ops.impact import (
        build_impact_batch, build_m_from_blocks, split_impact_batch,
        _densify_w)

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
    print(f"ingest {time.perf_counter() - t0:.1f}s", flush=True)

    reader = index.reader()
    dseg = reader.device_segments[0]
    seg = dseg.reader
    batches = bench.build_queries()
    analyzed = [[("body", t) for t in raw.split()] for raw in batches[1]]
    qb = build_impact_batch(seg, dseg, analyzed)
    n1 = dseg.n1
    nq = qb["n_queries"]
    K = bench.K

    import os

    dense_budget = int(os.environ.get(
        "SEARCHLITE_DENSE_M_BYTES", 1024**3))
    dense = dseg.dense_rows(dense_budget)
    n_rows = len(dense["row_of_tid"])
    split = split_impact_batch(qb, dense["row_of_tid"],
                               n_rows=n_rows, n1=n1)
    print(f"shapes: n1={n1} nq={nq} "
          f"nosplit(nb_pad={qb['nb_pad']}, s_pad={qb['s_pad']}) "
          f"split(nb_pad={split['blk_idx'].shape[0]}, "
          f"s_pad={split['s_pad']}, R={n_rows}, "
          f"m_dense_dtype={dense['m_dense'].dtype})",
          flush=True)

    bd, bi = dseg.block_docs, dseg.block_impacts
    bi16 = bi.astype(jnp.bfloat16)
    md = dense["m_dense"]
    deleted = dseg.deleted
    sp_blk = jnp.asarray(split["blk_idx"])
    sp_row = jnp.asarray(split["slot_row"])
    wd_idx = jnp.asarray(split["wd_idx"])
    wd_val = jnp.asarray(split["wd_val"])
    ws_idx = jnp.asarray(split["ws_idx"])
    ws_val = jnp.asarray(split["ws_val"])
    s_pad, d_pad = split["s_pad"], n_rows + 1

    # truncated / padded sparse block tables, to scale nb_pad
    def blk_tables(n_pad):
        t = min(n_pad, split["blk_idx"].shape[0])
        blk = np.full(n_pad, qb["sentinel_row"], dtype=np.int32)
        row = np.zeros(n_pad, dtype=np.int32)
        blk[:t] = split["blk_idx"][:t]
        row[:t] = split["slot_row"][:t]
        return jnp.asarray(blk), jnp.asarray(row)

    def sum_fetch(refs):
        return jax.device_get(tuple(refs))

    # --- stage: sparse scatter M build at several paddings -----------
    for n_pad in (8192, 6912, 4096):
        blk, row = blk_tables(n_pad)

        @jax.jit
        def stage_m(bd, bi, blk=blk, row=row):
            return build_m_from_blocks(
                jnp, bd, bi, blk, row, n1, s_pad).sum()

        timeit(f"sparse scatter M [nb_pad={n_pad}] f32",
               lambda r, f=stage_m: [f(bd, bi) for _ in range(r)],
               sum_fetch)

    # bf16 scatter values at the real padding
    blk, row = blk_tables(split["blk_idx"].shape[0])

    @jax.jit
    def stage_m16(bd, bi):
        nb = blk.shape[0]
        docs2d = bd[blk]
        imps2d = bi[blk]
        pos = jnp.arange(nb * 128, dtype=jnp.int32).reshape(nb, 128)
        is_pad = docs2d == (n1 - 1)
        flat_idx = jnp.where(is_pad, s_pad * n1 + pos,
                             row[:, None] * n1 + docs2d).reshape(-1)
        m_flat = jnp.zeros(s_pad * n1 + nb * 128, dtype=jnp.bfloat16)
        m_flat = m_flat.at[flat_idx].set(
            imps2d.reshape(-1), unique_indices=True,
            mode="promise_in_bounds")
        return m_flat[: s_pad * n1].reshape(s_pad, n1).sum()

    timeit("sparse scatter M bf16 store",
           lambda r: [stage_m16(bd, bi16) for _ in range(r)], sum_fetch)

    # --- stage: direct dense matmul over the resident m_dense --------
    w_dense = jnp.asarray(np.random.default_rng(1).random(
        (nq, d_pad), dtype=np.float32)).astype(md.dtype)

    @jax.jit
    def stage_dense_mm(w, md):
        return jnp.dot(w, md, preferred_element_type=jnp.float32).sum()

    timeit(f"direct dense matmul [{nq},{d_pad}]x[{d_pad},{n1}] "
           f"{md.dtype}",
           lambda r: [stage_dense_mm(w_dense, md) for _ in range(r)],
           sum_fetch)

    # --- stage: W densify --------------------------------------------
    @jax.jit
    def stage_w(wd_idx, wd_val, ws_idx, ws_val):
        wd = _densify_w(jnp, wd_idx, wd_val, nq, d_pad)
        ws = _densify_w(jnp, ws_idx, ws_val, nq, s_pad)
        return wd.sum() + ws.sum()

    timeit("W densify (both)",
           lambda r: [stage_w(wd_idx, wd_val, ws_idx, ws_val)
                      for _ in range(r)], sum_fetch)

    # --- stage: bare matmuls -----------------------------------------
    rng = np.random.default_rng(0)
    w_s = jnp.asarray(rng.random((nq, s_pad), dtype=np.float32))
    w_d = jnp.asarray(rng.random((nq, d_pad), dtype=np.float32))
    m_s = jnp.asarray(rng.random((s_pad, n1), dtype=np.float32))

    @jax.jit
    def stage_mm(w_s, m_s):
        return jnp.dot(w_s, m_s, preferred_element_type=jnp.float32).sum()

    timeit(f"bare matmul [{nq},{s_pad}]x[{s_pad},{n1}] fast-f32",
           lambda r: [stage_mm(w_s, m_s) for _ in range(r)], sum_fetch)

    w16, m16 = w_s.astype(jnp.bfloat16), m_s.astype(jnp.bfloat16)

    @jax.jit
    def stage_mm16(w, m):
        return jnp.dot(w, m, preferred_element_type=jnp.float32).sum()

    timeit("bare matmul bf16 inputs",
           lambda r: [stage_mm16(w16, m16) for _ in range(r)], sum_fetch)

    # --- stage: matmul + mask + topk ---------------------------------
    @jax.jit
    def stage_mm_topk(w_s, m_s):
        scores = jnp.dot(w_s, m_s, preferred_element_type=jnp.float32)
        ok = (scores > 0.0) & ~deleted[None, :]
        masked = jnp.where(ok, scores, -jnp.inf)
        s, i = jax.lax.top_k(masked, K)
        return s.sum() + i.sum()

    timeit("matmul+mask+topk",
           lambda r: [stage_mm_topk(w_s, m_s) for _ in range(r)],
           sum_fetch)

    # --- composed: the real split scorer -----------------------------
    scorer = reader._split_batched_scorer()
    packed = jnp.asarray(split["packed"])

    def full(r):
        out = []
        for _ in range(r):
            s, i = scorer(
                bd, bi, md, deleted, packed,
                jnp.zeros((1, 1), dtype=bool),
                jnp.zeros(1, dtype=jnp.int32),
                k=K, s_pad=s_pad, n_queries=nq,
                nb_pad=split["nb_pad"], wd_pad=split["wd_pad"],
                ws_pad=split["ws_pad"])
            out.append(s)
            out.append(i)
        return out

    timeit("FULL split scorer (default path)", full, sum_fetch)

    # --- composed: no-split scorer (for reference) -------------------
    scorer0 = reader._batched_scorer()
    blk0 = jnp.asarray(qb["blk_idx"])
    row0 = jnp.asarray(qb["slot_row"])
    w_idx0 = jnp.asarray(qb["w_idx"])
    w_val0 = jnp.asarray(qb["w_val"])

    def full0(r):
        out = []
        for _ in range(r):
            s, i = scorer0(
                bd, bi, deleted, blk0, row0, w_idx0, w_val0,
                jnp.zeros((1, 1), dtype=bool),
                jnp.zeros(1, dtype=jnp.int32),
                k=K, s_pad=qb["s_pad"], n_queries=nq)
            out.append(s)
            out.append(i)
        return out

    timeit("FULL no-split scorer", full0, sum_fetch)


if __name__ == "__main__":
    main()
