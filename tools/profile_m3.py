"""Is a 128-wide block-row gather fast where element gathers are slow?
And: full candidate M-build pipeline (row-gather + elementwise +
unsorted-unique scatter) vs the current build_m."""

import sys
import time

sys.path.insert(0, ".")

from searchlite.utils.devguard import guard_backend  # noqa: E402

guard_backend(__file__)

import numpy as np  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    N1 = 100_001
    S = 4096
    P = 4_194_304
    NB = P // 128            # 32768 block rows gathered
    NBLK = 40_000            # segment block count
    OUT = S * N1 + P

    block_docs = np.sort(
        rng.integers(0, N1 - 1, size=(NBLK, 128)).astype(np.int32), axis=1)
    block_imps = rng.random((NBLK, 128), dtype=np.float32)
    blk_idx = jnp.asarray(
        rng.integers(0, NBLK, size=NB).astype(np.int32))
    slot_row = jnp.asarray(
        np.repeat(np.arange(NB // 8, dtype=np.int32), 8))
    bd = jnp.asarray(block_docs)
    bi = jnp.asarray(block_imps)

    @jax.jit
    def f_rowgather(bd, bi, blk_idx):
        return bd[blk_idx].sum() + bi[blk_idx].sum()

    @jax.jit
    def f_full(bd, bi, blk_idx, slot_row):
        docs2d = bd[blk_idx]                        # [NB, 128]
        imps2d = bi[blk_idx]
        pos = jnp.arange(NB * 128, dtype=jnp.int32).reshape(NB, 128)
        is_pad = docs2d >= N1 - 1
        flat_idx = jnp.where(
            is_pad, S * N1 + pos,
            slot_row[:, None] * N1 + docs2d).reshape(-1)
        m_flat = jnp.zeros(OUT, jnp.float32).at[flat_idx].set(
            imps2d.reshape(-1), unique_indices=True,
            mode="promise_in_bounds")
        return m_flat[:8]

    def timeit(label, fn, *args, n=6):
        jax.device_get(fn(*args))
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn(*args)
        jax.tree_util.tree_map(lambda x: x.block_until_ready(), out)
        jax.device_get(out)
        dt = (time.perf_counter() - t0) / n
        print(f"{label}: {dt*1e3:.1f}ms", flush=True)

    timeit("block-row gather 2x [32k,128]", f_rowgather, bd, bi, blk_idx)
    timeit("candidate full M build", f_full, bd, bi, blk_idx, slot_row)


if __name__ == "__main__":
    main()
