"""Exact vector similarity as a matmul, with opt-in quantization.

Replaces the reference's single-layer HNSW graph (`vectors/hnsw.rs`) —
a pointer-chasing beam search that maps badly to accelerators — with exact
brute-force similarity: one ``[n_docs, dim] @ [dim, n_queries]`` matmul
plus on-device top-k. Exact search strictly dominates the
ANN graph on recall and is faster on this hardware for corpus sizes the
reference targets; it also realizes the reference's stubbed ``gpu``
rerank path (`gpu/rerank.rs:1-6`).

Quantization (realizing the reference's stub `vectors/quant.rs:1-3`,
opt-in per vector field via the schema):
- ``bf16``: vectors and queries cast to bfloat16 with f32 accumulation
  (half the device memory, ~2x matmul throughput, ~3 significant digits).
- ``int8``: symmetric per-vector quantization ``q = round(v·127/max|v|)``
  with f32 scales; the dot runs as an int8 matmul accumulating in
  int32, rescaled ``dot·scale_v·scale_q`` in f32. L2 uses the exact f32
  norms with the quantized cross-term.

Metric semantics parity (`vectors/mod.rs:83-129`):
- cosine: dot product over ingest-normalized vectors
- l2: negated euclidean distance (higher is better)
Missing vectors never match (the caller blends the missing penalty).

Device residency: quantized (or f32) vector buffers are cached on the
``VectorData`` object, so repeated searches re-upload only the query.
"""

from __future__ import annotations

from functools import partial

import numpy as np


def make_vector_topk():
    from searchlite.ops.precision import apply_matmul_precision

    apply_matmul_precision()
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("k", "metric", "quantization"))
    def run(vectors, v_scale, v_sq, present, mask, queries, q_scale,
            *, k: int, metric: str, quantization: str):
        """vectors [N, D] (f32 / bf16 / int8); v_scale/v_sq [N] f32;
        present/mask [N]; queries [Q, D] (matching dtype); q_scale [Q]
        f32 → (scores [Q, k], ids [Q, k])."""
        if quantization == "int8":
            dots = jnp.dot(queries.astype(jnp.int8), vectors.T,
                           preferred_element_type=jnp.int32)
            dots = dots.astype(jnp.float32) * \
                (q_scale[:, None] * v_scale[None, :])
        else:
            dots = jnp.dot(queries, vectors.T,
                           preferred_element_type=jnp.float32)
        if metric == "cosine":
            sims = dots
        else:
            # -||v - q|| expanded via the matmul-friendly identity,
            # with exact f32 norms regardless of quantization
            q_sq = jnp.sum(
                (queries.astype(jnp.float32) * q_scale[:, None]
                 if quantization == "int8"
                 else queries.astype(jnp.float32)) ** 2, axis=1)
            sims = -jnp.sqrt(jnp.maximum(
                v_sq[None, :] + q_sq[:, None] - 2.0 * dots, 0.0))
        ok = (present & mask)[None, :]
        masked = jnp.where(ok, sims, -jnp.inf)
        return jax.lax.top_k(masked, k)

    return run


_TOPK = None


def quantize_int8(vectors: np.ndarray):
    """Symmetric per-row int8: returns (q [N,D] int8, scale [N] f32)."""
    amax = np.abs(vectors).max(axis=1) if vectors.size else \
        np.zeros(vectors.shape[0], dtype=np.float32)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(vectors / scale[:, None]), -127, 127)
    return q.astype(np.int8), scale


def _device_vectors(vdata, quantization: str):
    """Upload (and cache on vdata) the device-resident buffers for the
    requested quantization level."""
    import jax.numpy as jnp

    cache = vdata.__dict__.setdefault("_device_cache", {})
    hit = cache.get(quantization)
    if hit is not None:
        return hit
    vecs = vdata.vectors
    v_sq = np.sum(vecs.astype(np.float32) ** 2, axis=1)
    if quantization == "int8":
        q, scale = quantize_int8(vecs)
        entry = (jnp.asarray(q), jnp.asarray(scale), jnp.asarray(v_sq),
                 jnp.asarray(vdata.present))
    elif quantization == "bf16":
        entry = (jnp.asarray(vecs, dtype=jnp.bfloat16),
                 jnp.ones(vecs.shape[0], jnp.float32),
                 jnp.asarray(v_sq), jnp.asarray(vdata.present))
    else:
        entry = (jnp.asarray(vecs),
                 jnp.ones(vecs.shape[0], jnp.float32),
                 jnp.asarray(v_sq), jnp.asarray(vdata.present))
    cache[quantization] = entry
    return entry


def vector_topk(vdata, mask: np.ndarray, queries: np.ndarray, k: int,
                metric: str, quantization: str | None = None):
    """vdata: VectorData (vectors [N,D] f32 + present [N]). Returns
    (scores [Q,k], ids [Q,k]) numpy."""
    global _TOPK
    import jax.numpy as jnp

    if _TOPK is None:
        _TOPK = make_vector_topk()
    quant = quantization or "none"
    n = vdata.vectors.shape[0]
    k = min(k, n) if n else 0
    if k == 0 or n == 0:
        q = queries.shape[0]
        return (np.zeros((q, 0), dtype=np.float32),
                np.zeros((q, 0), dtype=np.int64))
    vectors, v_scale, v_sq, present = _device_vectors(vdata, quant)
    if quant == "int8":
        q_int8, q_scale = quantize_int8(queries.astype(np.float32))
        dq = jnp.asarray(q_int8)
        dqs = jnp.asarray(q_scale)
    elif quant == "bf16":
        dq = jnp.asarray(queries, dtype=jnp.bfloat16)
        dqs = jnp.ones(queries.shape[0], jnp.float32)
    else:
        dq = jnp.asarray(queries)
        dqs = jnp.ones(queries.shape[0], jnp.float32)
    scores, ids = _TOPK(vectors, v_scale, v_sq, present,
                        jnp.asarray(mask), dq, dqs,
                        k=k, metric=metric, quantization=quant)
    return np.asarray(scores), np.asarray(ids)


_SHARDED_TOPK: dict = {}


def vector_topk_sharded(vdata, mask: np.ndarray, queries: np.ndarray,
                        k: int, metric: str, mesh,
                        quantization: str | None = None):
    """Mesh form of :func:`vector_topk`: vector rows shard over the
    mesh's chips (parallel/query.py::make_sharded_vector_topk), local
    exact similarity + top-k per slice, all_gather merge. Identical
    results to the single-chip kernel."""
    import jax.numpy as jnp

    from searchlite.parallel.query import make_sharded_vector_topk

    quant = quantization or "none"
    n = vdata.vectors.shape[0]
    k = min(k, n) if n else 0
    if k == 0 or n == 0:
        q = queries.shape[0]
        return (np.zeros((q, 0), dtype=np.float32),
                np.zeros((q, 0), dtype=np.int64))
    n_shards = mesh.shape["shard"]
    n_pad = -(-n // n_shards) * n_shards

    cache = vdata.__dict__.setdefault("_sharded_cache", {})
    entry = cache.get((quant, n_pad))
    if entry is None:
        vecs = vdata.vectors
        v_sq = np.zeros(n_pad, dtype=np.float32)
        v_sq[:n] = np.sum(vecs.astype(np.float32) ** 2, axis=1)
        present = np.zeros(n_pad, dtype=bool)
        present[:n] = vdata.present
        if quant == "int8":
            qv, scale = quantize_int8(vecs)
            vp = np.zeros((n_pad, qv.shape[1]), dtype=np.int8)
            vp[:n] = qv
            sp = np.ones(n_pad, dtype=np.float32)
            sp[:n] = scale
            entry = (jnp.asarray(vp), jnp.asarray(sp),
                     jnp.asarray(v_sq), jnp.asarray(present))
        else:
            dtype = jnp.bfloat16 if quant == "bf16" else jnp.float32
            vp = np.zeros((n_pad, vecs.shape[1]), dtype=np.float32)
            vp[:n] = vecs
            entry = (jnp.asarray(vp, dtype=dtype),
                     jnp.ones(n_pad, jnp.float32),
                     jnp.asarray(v_sq), jnp.asarray(present))
        cache[(quant, n_pad)] = entry
    vectors, v_scale, v_sq, present = entry

    run = _SHARDED_TOPK.get(id(mesh))
    if run is None:
        run = make_sharded_vector_topk(mesh)
        _SHARDED_TOPK[id(mesh)] = run

    mask_pad = np.zeros(n_pad, dtype=bool)
    mask_pad[:len(mask)] = mask
    if quant == "int8":
        q_int8, q_scale = quantize_int8(queries.astype(np.float32))
        dq, dqs = jnp.asarray(q_int8), jnp.asarray(q_scale)
    elif quant == "bf16":
        dq = jnp.asarray(queries, dtype=jnp.bfloat16)
        dqs = jnp.ones(queries.shape[0], jnp.float32)
    else:
        dq = jnp.asarray(queries)
        dqs = jnp.ones(queries.shape[0], jnp.float32)
    scores, ids = run(vectors, v_scale, v_sq, present,
                      jnp.asarray(mask_pad), dq, dqs,
                      k=k, metric=metric, quantization=quant)
    return np.asarray(scores), np.asarray(ids)
