"""searchlite — an embedded full-text search engine whose scoring runs
as JAX programs on an accelerator.

A from-scratch rebuild of the capabilities of davidkelley/searchlite
(an embedded, SQLite-flavored search engine):

- The on-disk inverted index is loaded into a device-resident layout:
  postings padded into fixed-width ``[n_blocks, 128]`` doc-id/tf blocks
  with per-block max-score sidecars.
- BM25 scoring is either a matrix product (per-posting impacts are
  precomputed at upload, query terms densified into an impact matrix,
  scores computed as ``W @ M``) or a gather-sort-combine over each
  query's candidate postings, both followed by an on-device top-k
  instead of a per-posting heap.
- Fast-field filters are vectorized columnar predicates producing doc
  masks fused into the scoring pass.
- Vector search is exact brute-force similarity as a matrix product.
- Multi-device scale-out shards postings across a
  ``jax.sharding.Mesh`` with the top-k merged by collectives.

The durable host-side format (WAL, manifest, segments) mirrors the
reference's crash-safety semantics (single writer, atomic manifest
swaps, WAL replay).
"""

__version__ = "0.1.0"


def _tune_numpy_allocator() -> None:
    """Disable numpy's MADV_HUGEPAGE on large allocations (opt back in
    with SEARCHLITE_NUMPY_HUGEPAGE=1). On virtualized hosts where
    hugepage faults are backed lazily by the hypervisor, first-touch
    of a fresh large array measured 53 s/GB with the madvise vs
    1.4 s/GB without (this sandbox's microVM); on bare metal the
    madvise saves a few percent at most. Ingest, segment open, and
    batch prep all allocate-and-fill large arrays, so the slow path
    taxes everything."""
    import os
    import sys

    if sys.platform != "linux":
        return
    if os.environ.get("SEARCHLITE_NUMPY_HUGEPAGE") == "1":
        return
    os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
    try:
        try:
            from numpy._core import multiarray as _ma
        except ImportError:  # numpy 1.x
            from numpy.core import multiarray as _ma
        _ma._set_madvise_hugepage(False)
    except Exception:  # noqa: BLE001 — tuning only, never fatal
        pass


_tune_numpy_allocator()


def compile_cache_dir() -> str:
    """Where JAX's persistent compilation cache lives: the directory
    ``JAX_COMPILATION_CACHE_DIR`` names when it is set, otherwise
    ``<checkout>/.jax_cache``. The path is part of the cache key, so it
    is fixed rather than per-user or per-run."""
    import os

    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")


def _enable_compile_cache() -> None:
    """Turn on JAX's persistent compilation cache (opt out with
    SEARCHLITE_COMPILE_CACHE=0). A fresh serving process pays an XLA
    compile per (plan, shape-bucket) executor, and nothing else carries
    those across process restarts. When ``JAX_COMPILATION_CACHE_DIR``
    is set, JAX reads it itself and nothing is set here."""
    import os

    if os.environ.get("SEARCHLITE_COMPILE_CACHE") == "0":
        return
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    cache = compile_cache_dir()
    try:
        os.makedirs(cache, exist_ok=True)
    except OSError:
        return
    import sys

    if "jax" not in sys.modules:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = cache
        return
    # JAX binds env-var config defaults when it is imported; once it is,
    # set the live config (valid any time before the cache's first use)
    import jax

    jax.config.update("jax_compilation_cache_dir", cache)


_enable_compile_cache()


def __getattr__(name):  # lazy top-level exports to keep import light
    if name in ("IndexOptions", "SearchRequest", "StorageType"):
        from searchlite.api import types

        return getattr(types, name)
    if name == "Index":
        from searchlite.index import Index

        return Index
    if name == "IndexBuilder":
        from searchlite.api.builder import IndexBuilder

        return IndexBuilder
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
