"""Pin down where the batched scorer's device time goes.

Pipelines N async launches and fetches only the last result, so the
round trip is paid once, not per call.
"""

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
    NQ = 1024
    P = 4_194_304
    NNZ = 3_400_000  # live postings in the batch

    # synthetic slot-major doc-ascending postings
    slot_len_np = np.full(S, 0, np.int32)
    slot_len_np[:3400] = NNZ // 3400
    slot_start_np = np.zeros(S, np.int32)
    slot_start_np[1:] = np.cumsum(slot_len_np)[:-1]
    docs_np = np.sort(
        rng.integers(0, N1 - 1, size=NNZ).astype(np.int32).reshape(
            3400, -1), axis=1).reshape(-1)
    docs_flat = jnp.asarray(docs_np)
    impacts_flat = jnp.asarray(
        rng.random(NNZ, dtype=np.float32) + 0.5)
    slot_start = jnp.asarray(slot_start_np)
    slot_len = jnp.asarray(slot_len_np)
    w_dense = jnp.asarray(rng.random((NQ, S), dtype=np.float32))
    deleted = jnp.zeros(N1, bool)

    from searchlite.ops.impact import build_m

    @jax.jit
    def f_scatter(df, imf, ss, sl):
        m = build_m(jnp, df, imf, ss, sl, N1, P)
        return m[:1, :8]

    @jax.jit
    def f_mread(df, imf, ss, sl):
        m = build_m(jnp, df, imf, ss, sl, N1, P)
        return m.T @ jnp.ones((S, 1), jnp.float32)

    @jax.jit
    def f_matmul(df, imf, ss, sl, w):
        m = build_m(jnp, df, imf, ss, sl, N1, P)
        return (w @ m)[:, :8]

    @jax.jit
    def f_matmul_bf16(df, imf, ss, sl, w):
        m = build_m(jnp, df, imf, ss, sl, N1, P)
        return (w.astype(jnp.bfloat16) @ m.astype(jnp.bfloat16))[:, :8]

    @jax.jit
    def f_mm_only(m, w):
        return (w @ m)[:, :8]

    @jax.jit
    def f_topk(scores):
        return jax.lax.top_k(scores, 10)

    @jax.jit
    def f_mask_topk(scores, deleted):
        masked = jnp.where((scores > 0.0) & ~deleted[None, :],
                           scores, -jnp.inf)
        return jax.lax.top_k(masked, 10)

    @jax.jit
    def make_m(df, imf, ss, sl):
        return build_m(jnp, df, imf, ss, sl, N1, P)

    m_const = make_m(docs_flat, impacts_flat, slot_start, slot_len)
    # full [NQ, N1] score matrix for the top-k stages
    scores_const = jax.jit(lambda m, w: w @ m)(m_const, w_dense)
    # force m materialized
    _ = jax.device_get(m_const[:1, :4])

    def timeit(label, fn, *args, n=6):
        jax.device_get(fn(*args))  # compile+warm
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn(*args)  # async, pipelined
        jax.tree_util.tree_map(
            lambda x: x.block_until_ready(), out)
        jax.device_get(out)
        dt = (time.perf_counter() - t0) / n
        print(f"{label}: {dt*1e3:.1f}ms", flush=True)

    timeit("scatter-only (build M, fetch corner)", f_scatter,
           docs_flat, impacts_flat, slot_start, slot_len)
    timeit("M read (M.T @ ones)", f_mread,
           docs_flat, impacts_flat, slot_start, slot_len)
    timeit("build M + W@M f32", f_matmul,
           docs_flat, impacts_flat, slot_start, slot_len, w_dense)
    timeit("build M + W@M bf16", f_matmul_bf16,
           docs_flat, impacts_flat, slot_start, slot_len, w_dense)
    timeit("W@M only (M resident) f32", f_mm_only, m_const, w_dense)
    timeit("topk only", f_topk, scores_const)
    timeit("mask+topk", f_mask_topk, scores_const, deleted)


if __name__ == "__main__":
    main()
