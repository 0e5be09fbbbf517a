"""Device probe for the sparse batched-candidate pipeline.

Times each stage of the proposed fully-sparse batched executor at
headline-like shapes: block-row gather of postings, per-row sort by
doc id, within-row segment-sum (duplicate-doc accumulation), and
top-k over candidates — i.e. scoring WITHOUT materializing the
[B, n_docs] score matrix or running the big W@M matmul.

The question this answers: is XLA's row sort fast enough that
  gather + sort + scan + topk  <<  scatter-M + matmul + topk?

Measurement pattern: dispatch all reps, ONE bulk jax.device_get at the
end (per-ref fetches would add a round trip each); stage outputs are
reduced to scalars so no stage pays transfer.

Usage: python tools/probe_sparse.py [B L reps]
"""

import sys
import time

sys.path.insert(0, ".")

from searchlite.utils.devguard import guard_backend  # noqa: E402

guard_backend(__file__)

import numpy as np  # noqa: E402


def timeit(label, make_refs, reps=8):
    import jax
    jax.device_get(tuple(jax.tree_util.tree_leaves(make_refs(1))))
    t0 = time.perf_counter()
    refs = make_refs(reps)
    jax.device_get(tuple(jax.tree_util.tree_leaves(refs)))
    dt = (time.perf_counter() - t0) / reps * 1000
    print(f"{label}: {dt:.2f} ms/step (pipelined x{reps})", flush=True)
    return dt


def main():
    B, L, reps = 1024, 4096, 8
    if len(sys.argv) > 3:
        B, L, reps = (int(x) for x in sys.argv[1:4])
    import jax
    import jax.numpy as jnp

    print("devices:", jax.devices(), flush=True)
    rng = np.random.default_rng(0)

    NB = 200_000  # resident posting blocks (bigger than the 100k corpus needs)
    blocks_doc = jnp.asarray(rng.integers(0, 100_000, (NB, 128), dtype=np.int32))
    blocks_imp = jnp.asarray(rng.random((NB, 128), dtype=np.float32))
    nblk = L // 128
    blk_idx = jnp.asarray(rng.integers(0, NB, (B, nblk), dtype=np.int32))
    blk_w = jnp.asarray(rng.random((B, nblk), dtype=np.float32))

    docs = jnp.asarray(rng.integers(0, 100_000, (B, L), dtype=np.int32))
    vals = jnp.asarray(rng.random((B, L), dtype=np.float32))

    @jax.jit
    def gather_stage(bi, bw):
        d = blocks_doc[bi]                      # [B, nblk, 128]
        v = blocks_imp[bi] * bw[:, :, None]     # [B, nblk, 128]
        return d.sum(), v.sum()

    @jax.jit
    def sort_stage(d, v):
        d2, v2 = jax.lax.sort((d, v), num_keys=1, dimension=1)
        return d2.sum(), v2.sum()

    def segsum(d, v):
        # d sorted per row; accumulate equal-doc runs, keep sum at run end
        cum = jnp.cumsum(v.astype(jnp.float32), axis=1)
        nxt_differs = jnp.concatenate(
            [d[:, 1:] != d[:, :-1], jnp.ones((d.shape[0], 1), bool)], axis=1)
        start_differs = jnp.concatenate(
            [jnp.ones((d.shape[0], 1), bool), d[:, 1:] != d[:, :-1]], axis=1)
        before = jnp.where(start_differs, jnp.roll(cum, 1, axis=1), -jnp.inf)
        before = before.at[:, 0].set(jnp.where(start_differs[:, 0], 0.0, -jnp.inf))
        run_before = jax.lax.cummax(before, axis=1)
        score = cum - run_before
        return jnp.where(nxt_differs, score, -jnp.inf)

    @jax.jit
    def segsum_stage(d, v):
        return segsum(d, v).sum()

    @jax.jit
    def topk_stage(score):
        s, i = jax.lax.top_k(score, 10)
        return s.sum(), i.sum()

    @jax.jit
    def full(bi, bw):
        d = blocks_doc[bi].reshape(B, -1)
        v = (blocks_imp[bi] * bw[:, :, None]).reshape(B, -1)
        d, v = jax.lax.sort((d, v), num_keys=1, dimension=1)
        s = segsum(d, v)
        ts, tp = jax.lax.top_k(s, 10)
        td = jnp.take_along_axis(d, tp, axis=1)
        return ts, td

    print(f"shapes: B={B} L={L} (nblk={nblk})")
    timeit("gather [B,nblk]->[B,L]",
           lambda r: [gather_stage(blk_idx, blk_w) for _ in range(r)], reps)
    timeit("row sort (i32 key + f32 val)",
           lambda r: [sort_stage(docs, vals) for _ in range(r)], reps)
    ds, vs = jax.lax.sort((docs, vals), num_keys=1, dimension=1)
    timeit("segment-sum scan",
           lambda r: [segsum_stage(ds, vs) for _ in range(r)], reps)
    sc = jax.jit(segsum)(ds, vs)
    timeit("top_k(10)",
           lambda r: [topk_stage(sc) for _ in range(r)], reps)
    timeit("FULL sparse pipeline",
           lambda r: [full(blk_idx, blk_w) for _ in range(r)], reps)

    # correctness spot-check of segsum on row 0
    d0 = np.asarray(ds[0]); v0 = np.asarray(vs[0]); s0 = np.asarray(sc[0])
    want = {}
    for dd, vv in zip(d0, v0):
        want[dd] = want.get(dd, 0.0) + float(vv)
    got = {int(d0[i]): float(s0[i]) for i in range(len(s0)) if np.isfinite(s0[i])}
    assert len(got) == len(want), (len(got), len(want))
    for k in want:
        assert abs(got[k] - want[k]) < 1e-3 * max(1.0, abs(want[k])), (k, got[k], want[k])
    print("segsum exactness: ok")


if __name__ == "__main__":
    main()
