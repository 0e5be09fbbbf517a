"""Stage attribution for the sparse candidate-strip scorer on device.

The strip path (ops/sparse.py::_strip_gather_scan + top-k) is the
batched headline's workhorse; at 1M docs its strips grow to hundreds of
blocks and the C++ baseline engine's bmw is the number to beat
(BASELINE.md: 6.3k QPS at 1M). This probe times each stage of the
strip pipeline IN ISOLATION at configurable (B, nblk, t_pad) shapes —
block gather, doc sort (2-operand, the suspected superlinear term:
O(n log^2 n) for a sorting network vs the C++ engine's O(n) merge),
segmented combine scan, top-k — plus the fused whole, so a hardware run shows which stage to attack .

Run on the device:  python tools/profile_strips.py [B] [nblk] [t_pad]
Defaults: B=256 nblk=512 t_pad=8 (the 1M-doc heavy-tier shape).

Each stage is timed over a pipelined window with a device fetch per
step.
"""

from __future__ import annotations

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from searchlite.utils.devguard import guard_backend  # noqa: E402

guard_backend(__file__)

import numpy as np  # noqa: E402


def timed(fn, args, reps: int = 8) -> float:
    """ms/step, pipelined: dispatch all, fetch a scalar probe of each."""
    import jax

    outs = [fn(*args) for _ in range(2)]  # warm + compile
    jax.device_get(outs[-1])
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(reps)]
    for o in outs:
        jax.device_get(o)
    return (time.perf_counter() - t0) / reps * 1000


def main() -> None:
    args = sys.argv[1:]
    B = int(args[0]) if len(args) > 0 else 256
    nblk = int(args[1]) if len(args) > 1 else 512
    t_pad = int(args[2]) if len(args) > 2 else 8
    k = 10
    n_blocks = 200_000
    n1 = n_blocks * 16  # plausible docs-per-block density

    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    block_docs = np.sort(
        rng.integers(0, n1 - 1, size=(n_blocks + 1, 128)),
        axis=1).astype(np.int32)
    block_docs[-1] = n1 - 1
    block_imps = rng.random((n_blocks + 1, 128), dtype=np.float32)
    block_imps[-1] = 0
    bstart = rng.integers(0, n_blocks - nblk,
                          size=(B, t_pad)).astype(np.int32)
    bcnt = rng.integers(0, max(nblk // t_pad, 2),
                        size=(B, t_pad)).astype(np.int32)
    w = rng.random((B, t_pad), dtype=np.float32)
    log2_run = max((t_pad - 1).bit_length(), 1)

    bd = jnp.asarray(block_docs)
    bi = jnp.asarray(block_imps)
    bs = jnp.asarray(bstart)
    bc = jnp.asarray(bcnt)
    wj = jnp.asarray(w)

    L = nblk * 128

    @partial(jax.jit, static_argnames=("nblk",))
    def stage_gather(bd, bi, bs, bc, w, *, nblk):
        cum = jnp.cumsum(bc, axis=1)
        total = cum[:, -1]
        pos = jnp.arange(nblk, dtype=jnp.int32)
        t_of = (pos[None, None, :] >= cum[:, :, None]).sum(
            axis=1).astype(jnp.int32)
        valid = pos[None, :] < total[:, None]
        t_safe = jnp.minimum(t_of, w.shape[1] - 1)
        begin = cum - bc
        blk = (jnp.take_along_axis(bs, t_safe, axis=1)
               + (pos[None, :] - jnp.take_along_axis(begin, t_safe,
                                                     axis=1)))
        blk_idx = jnp.where(valid, blk, bd.shape[0] - 1)
        d = bd[blk_idx].reshape(bs.shape[0], nblk * 128)
        v = (bi[blk_idx]
             * jnp.take_along_axis(w, t_safe, axis=1)[:, :, None]
             ).reshape(bs.shape[0], nblk * 128)
        return d, v

    d0, v0 = stage_gather(bd, bi, bs, bc, wj, nblk=nblk)
    d0.block_until_ready()

    @jax.jit
    def stage_sort(d, v):
        return jax.lax.sort((d, v), num_keys=1, dimension=1)

    @partial(jax.jit, static_argnames=("log2_run",))
    def stage_scan(d, v, *, log2_run):
        off = 1
        for _ in range(log2_run):
            same = d[:, off:] == d[:, :-off]
            v = jnp.concatenate(
                [v[:, :off],
                 v[:, off:] + jnp.where(same, v[:, :-off], 0.0)],
                axis=1)
            off *= 2
        return v

    @partial(jax.jit, static_argnames=("k",))
    def stage_topk(d, v, *, k):
        B = d.shape[0]
        run_end = jnp.concatenate(
            [d[:, 1:] != d[:, :-1], jnp.ones((B, 1), dtype=bool)],
            axis=1)
        score = jnp.where(run_end & (v > 0.0), v, -jnp.inf)
        ts, tp = jax.lax.top_k(score, k)
        return ts, jnp.take_along_axis(d, tp, axis=1)

    from searchlite.ops.sparse import _candidate_core

    @partial(jax.jit, static_argnames=("k", "t_pad", "nblk",
                                       "log2_run"))
    def fused(bd, bi, bs, bc, w, *, k, t_pad, nblk, log2_run):
        return _candidate_core(jax, jnp, bd, bi, bs, bc, w,
                               bd.shape[0] - 1, n1 - 1, k=k,
                               t_pad=t_pad, nblk=nblk,
                               log2_run=log2_run, with_counts=False)

    ds, vs = stage_sort(d0, v0)
    print(f"shape B={B} nblk={nblk} t_pad={t_pad} L={L} "
          f"({B * L / 1e6:.1f}M candidates/launch)", flush=True)
    print(f"gather : {timed(partial(stage_gather, nblk=nblk), (bd, bi, bs, bc, wj)):8.2f} ms", flush=True)
    print(f"sort   : {timed(stage_sort, (d0, v0)):8.2f} ms", flush=True)
    print(f"scan   : {timed(partial(stage_scan, log2_run=log2_run), (ds, vs)):8.2f} ms", flush=True)
    print(f"topk   : {timed(partial(stage_topk, k=k), (ds, vs)):8.2f} ms", flush=True)
    print(f"fused  : {timed(partial(fused, k=k, t_pad=t_pad, nblk=nblk, log2_run=log2_run), (bd, bi, bs, bc, wj)):8.2f} ms", flush=True)


if __name__ == "__main__":
    main()
