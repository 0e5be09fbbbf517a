"""Matmul precision policy (divergence D8, COMPONENTS.md).

On a GPU, XLA's default precision lets an f32 dot run on the tensor
cores as TF32: inputs keep about 10 mantissa bits (2^-11 relative),
products accumulate in f32. Device BM25 scores then carry that noise on
top of the bf16 impact storage below (about 2^-9 relative), and top-k
near-ties can order differently than an exact f32 oracle; the
reference's Rust engine computes exact f32.

Policy:

- ``SEARCHLITE_PRECISION`` unset / ``f32`` (default): keep the fast
  default dots and bf16 impact storage. Scores are good to about 3
  decimal digits; near-tie order may differ from exact f32.
- ``f32_strict``: force ``jax_default_matmul_precision=highest`` (full
  f32 dots) and f32 impact storage. Score parity with the CPU oracle.
- ``bf16``: bf16 storage AND inputs (ops/impact.py scorers) — the
  explicit speed opt-in, layered on top of either of the above.

The pruned execution's upper bounds are inflated by UB_SAFETY so
bound-vs-threshold comparisons stay sound under fast-mode rounding
(an underestimated bound could otherwise prune a true top-k doc's
tile); exactness of returned scores is unaffected (scored tiles are
scored with the same dots the dense path uses).
"""

from __future__ import annotations

import os

# 2% > 2^-7: covers TF32 input rounding (2^-11) and bf16 input or
# storage rounding (2^-9 to 2^-8), both well below 2^-7, with headroom
# for the f32 accumulation of non-negative terms
UB_SAFETY = 1.02

_applied: str | None = None


def apply_matmul_precision() -> None:
    """Idempotent per mode; call from scorer factories BEFORE tracing/
    compiling (factories run once per process per config, ahead of
    first use). Re-checks the env each call so enabling f32_strict
    after an earlier scorer was built still takes effect for newly
    built scorers (already-compiled traces keep their precision)."""
    global _applied
    want = "highest" if strict() else None
    if want == _applied:
        return
    if want is not None:
        import jax

        jax.config.update("jax_default_matmul_precision", want)
        _applied = want


def strict() -> bool:
    return os.environ.get("SEARCHLITE_PRECISION") == "f32_strict"


def m_store_dtype(precision: str):
    """Storage dtype for SCATTER-BUILT impact matrices (the sparse M):
    f32 in every mode (``precision`` is accepted for symmetry with
    ``dense_store_dtype``). bf16 halves bytes only where no scatter
    writes the rows — the precomputed dense rows
    (``dense_store_dtype``)."""
    import jax.numpy as jnp

    return jnp.float32


def impacts_store_dtype(platform: str | None = None):
    """DEVICE storage dtype for posting impacts (block_impacts,
    impacts_flat, and the doc-shard copies). bf16 on accelerators in
    the fast/bf16 modes: upload bytes, device residency and M-build
    gather traffic halve, and every scoring path sees impacts rounded
    to bf16 (about 2^-9 relative) — within the D8 fast-mode tolerance
    that the oracle gate (searchlite/oracle.py) verifies. Host arrays
    stay f32 (pruning bounds, the C++ engine, and ingest are
    unaffected).

    f32 under ``f32_strict`` or ``SEARCHLITE_DEVICE_IMPACTS=f32``;
    CPU backends keep f32 (exact math for tests) unless
    ``SEARCHLITE_DEVICE_IMPACTS=bf16`` forces the quantized layout
    (used by the equivalence tests). ``platform`` overrides the
    default-backend check for arrays placed on a non-default device
    (the host tier stores f32: no HBM/link bandwidth to save on the
    local cpu backend)."""
    import jax
    import jax.numpy as jnp

    forced = os.environ.get("SEARCHLITE_DEVICE_IMPACTS")
    if strict() or forced == "f32":
        return jnp.float32
    if forced == "bf16":
        return jnp.bfloat16
    if (platform or jax.default_backend()) == "cpu":
        return jnp.float32
    return jnp.bfloat16


def dense_store_dtype(precision: str):
    """Storage dtype for the PRECOMPUTED dense impact rows (m_dense):
    no scatter ever writes them, so bf16 halves device bytes, upload
    and matmul read traffic, at bf16 rounding of the stored impacts
    (within the D8 fast-mode tolerance). CPU backends and f32_strict
    keep f32 (exact-f32 dots)."""
    import jax
    import jax.numpy as jnp

    if precision == "bf16":
        return jnp.bfloat16
    if precision == "f32_strict" or strict():
        return jnp.float32
    if jax.default_backend() == "cpu":
        return jnp.float32
    return jnp.bfloat16
