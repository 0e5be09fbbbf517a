"""Which op inside build_m is slow: the gathers, the cumsum, or the
sorted-unique scatter? And does scatter cost scale with output size?"""

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
    NNZ = 3_400_000
    OUT = S * N1 + P

    docs_np = np.sort(
        rng.integers(0, N1 - 1, size=NNZ).astype(np.int32).reshape(
            3400, -1), axis=1)
    flat_idx_np = (np.arange(3400, dtype=np.int64)[:, None] * N1
                   + docs_np).reshape(-1)
    pad_idx = S * N1 + np.arange(P - NNZ, dtype=np.int64)
    flat_idx_np = np.concatenate([flat_idx_np, pad_idx]).astype(np.int32)
    flat_idx = jnp.asarray(flat_idx_np)
    vals = jnp.asarray(rng.random(P, dtype=np.float32))
    gidx = jnp.asarray(
        rng.integers(0, NNZ, size=P).astype(np.int32))
    src = jnp.asarray(rng.random(NNZ, dtype=np.float32))

    @jax.jit
    def f_gather(src, gidx):
        return src[gidx].sum()

    @jax.jit
    def f_cumsum(marksrc):
        return jnp.cumsum(marksrc.astype(jnp.int32)).sum()

    @jax.jit
    def f_scatter_big(flat_idx, vals):
        out = jnp.zeros(OUT, jnp.float32).at[flat_idx].set(
            vals, indices_are_sorted=True, unique_indices=True,
            mode="promise_in_bounds")
        return out[:8]

    @jax.jit
    def f_scatter_small(vals):
        # same update count, 8M-element output (indices strided)
        idx = (jnp.arange(P, dtype=jnp.int32) * 2) % (8 * 1024 * 1024)
        out = jnp.zeros(8 * 1024 * 1024, jnp.float32).at[idx].set(
            vals, mode="promise_in_bounds")
        return out[:8]

    @jax.jit
    def f_zeros_slice(flat_idx):
        out = jnp.zeros(OUT, jnp.float32)
        return (out + 1.0)[::65536].sum()

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

    timeit("gather 4.2M random", f_gather, src, gidx)
    timeit("cumsum 4.2M", f_cumsum, vals)
    timeit("zeros(410M)+1 read/write", f_zeros_slice, flat_idx)
    timeit("scatter 4.2M -> 410M sorted-unique", f_scatter_big,
           flat_idx, vals)
    timeit("scatter 4.2M -> 8M unsorted", f_scatter_small, vals)


if __name__ == "__main__":
    main()
