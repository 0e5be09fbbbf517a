"""Sharded query execution over a jax.sharding.Mesh.

The reference is single-node (`docs/intro.md:48-51`); its per-segment
sequential loop + cross-segment merge (`api/reader.rs:2742-2778`) maps
onto chips as segment≈shard. The design (SURVEY §2.7):

- Mesh axes: ``("query", "shard")`` — query batching is the
  data-parallel axis, postings blocks shard across ``shard``.
- Each chip scores its local posting blocks into a partial dense score
  vector, then a ``psum_scatter`` leaves each chip with the
  COMPLETE scores for its slice of the doc space (a doc's score has
  contributions from blocks on many chips).
- Each chip top-ks its doc slice, then an ``all_gather`` of the k
  locals + a final top-k reproduces the reference's cross-segment merge
  semantics (score desc, doc id asc).

Query layout matches ops/batch.py: one posting block per slot,
``q_blk [Q, T]`` holding GLOBAL block ids; each chip masks slots to its
local block range. Everything is shape-static and jit-compiled once per
(batch, slots, k) bucket.
"""

from __future__ import annotations

from functools import partial

import numpy as np


def parse_mesh_spec(spec):
    """``--mesh`` / ``SEARCHLITE_MESH`` value -> a ("query", "shard")
    mesh, or None when unset/disabled or only one device would
    participate. Accepts "auto" (all local devices), an integer count,
    and the off sentinels ""/"off"/"none"/"0". Shared by the CLI and
    the HTTP server so the two surfaces can't drift."""
    if spec in (None, "", "off", "none", "0", 0):
        return None
    import jax

    if spec == "auto":
        n = None
    else:
        try:
            n = int(spec)
        except (TypeError, ValueError):
            raise ValueError(
                f"invalid mesh spec {spec!r}: expected `auto` or a "
                "device count") from None
    if (n or len(jax.devices())) <= 1:
        return None
    return make_mesh(n)


def make_mesh(n_devices: int | None = None, query_axis: int = 1):
    """Create a ("query", "shard") mesh over the available devices."""
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if query_axis > 1 and n % query_axis == 0:
        shape = (query_axis, n // query_axis)
    else:
        shape = (1, n)
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names=("query", "shard"))


def shard_blocks(block_docs: np.ndarray, block_tfs: np.ndarray,
                 n_shards: int):
    """Pad the block arrays to a multiple of n_shards (padding rows are
    sentinel-only so they score zero)."""
    n_blocks, width = block_docs.shape
    per = -(-max(n_blocks, 1) // n_shards)
    total = per * n_shards
    docs = np.full((total, width), np.iinfo(np.int32).max, dtype=np.int32)
    tfs = np.zeros((total, width), dtype=np.float32)
    docs[:n_blocks] = block_docs
    tfs[:n_blocks] = block_tfs
    return docs, tfs, per


def make_sharded_scorer(mesh, n1: int):
    """Build the sharded batched scorer.

    Inputs (global logical shapes):
        block_docs/tfs [B, 128]        sharded over "shard" (rows)
        doc_len [F, N1], avgdl [F]     replicated
        q_* [Q, T]                     sharded over "query"
        block_base [n_shards]          per-chip first global block id
    Output: (scores [Q, k], doc_ids [Q, k]) replicated over "shard".

    ``n1`` must be a multiple of the shard count (callers pad the doc
    space) so psum_scatter can tile the doc axis.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    n_shards = mesh.shape["shard"]
    assert n1 % n_shards == 0, "doc space must pad to the shard count"
    slice_len = n1 // n_shards

    def local_step(block_docs, block_tfs, doc_len, avgdl, deleted,
                   q_blk, q_weight, q_field, q_valid,
                   k1, b, block_base, k):
        n_local_blocks = block_docs.shape[0]
        n_docs = n1 - 1
        base_scalar = block_base[0]

        def score_partial(blk, weights, fields, valid):
            local = blk - base_scalar
            in_range = (local >= 0) & (local < n_local_blocks)
            ok_slot = valid & in_range
            local = jnp.where(ok_slot, local, 0)
            docs = block_docs[local]          # [T, 128]
            tfs = block_tfs[local]
            ok = ok_slot[:, None] & (docs < n_docs)
            docs = jnp.where(ok, docs, n_docs)
            dl = doc_len[fields[:, None], docs]
            avg = avgdl[fields][:, None]
            norm = jnp.where(avg > 0, dl / jnp.where(avg > 0, avg, 1.0),
                             1.0)
            denom = jnp.maximum(tfs + k1 * (1.0 - b + b * norm), 1e-6)
            sc = weights[:, None] * tfs * (k1 + 1.0) / denom
            sc = jnp.where(ok, sc, 0.0)
            partial_scores = jnp.zeros(n1, dtype=jnp.float32).at[
                docs.reshape(-1)].add(sc.reshape(-1))
            matched = jnp.zeros(n1, dtype=jnp.float32).at[
                docs.reshape(-1)].max(ok.reshape(-1).astype(jnp.float32))
            return partial_scores, matched

        partial_scores, matched = jax.vmap(score_partial)(
            q_blk, q_weight, q_field, q_valid)

        # complete each chip's doc slice (sum partials), then local
        # top-k over the slice, then all_gather + merge.
        my_scores = jax.lax.psum_scatter(
            partial_scores, "shard", scatter_dimension=1, tiled=True)
        my_matched = jax.lax.psum_scatter(
            matched, "shard", scatter_dimension=1, tiled=True)
        shard_idx = jax.lax.axis_index("shard")
        base = shard_idx * slice_len
        local_deleted = jax.lax.dynamic_slice_in_dim(
            deleted, base, slice_len, axis=0)
        masked = jnp.where((my_matched > 0) & ~local_deleted[None, :],
                           my_scores, -jnp.inf)
        loc_scores, loc_idx = jax.lax.top_k(masked, k)
        loc_ids = loc_idx + base
        # merge: candidates laid out shard-major (ascending doc id), so
        # top_k's lowest-index tie-break preserves doc-id-asc order.
        all_scores = jax.lax.all_gather(loc_scores, "shard", axis=1,
                                        tiled=True)     # [Q, S*k]
        all_ids = jax.lax.all_gather(loc_ids, "shard", axis=1, tiled=True)
        final_scores, pos = jax.lax.top_k(all_scores, k)
        final_ids = jnp.take_along_axis(all_ids, pos, axis=1)
        return final_scores, final_ids

    def run(block_docs, block_tfs, doc_len, avgdl, deleted,
            q_blk, q_weight, q_field, q_valid,
            k1, b, block_base, *, k: int):
        fn = shard_map(
            partial(local_step, k=k),
            mesh=mesh,
            in_specs=(
                P("shard", None), P("shard", None),   # blocks
                P(None, None), P(None,), P(None,),    # doc_len, avgdl, del
                P("query", None), P("query", None), P("query", None),
                P("query", None),
                P(), P(), P("shard"),
            ),
            out_specs=(P("query", None), P("query", None)),
            check_vma=False,
        )
        return fn(block_docs, block_tfs, doc_len, avgdl, deleted,
                  q_blk, q_weight, q_field, q_valid, k1, b, block_base)

    import jax

    return jax.jit(run, static_argnames=("k",))


def block_bases(n_blocks_padded: int, n_shards: int) -> np.ndarray:
    per = n_blocks_padded // n_shards
    return (np.arange(n_shards, dtype=np.int32) * per)


# ---------------------------------------------------------------------------
# Impact-matmul sharded scorer (the production path; see ops/impact.py)
# ---------------------------------------------------------------------------

def shard_flat_postings(docs_flat: np.ndarray, impacts_flat: np.ndarray,
                        n_shards: int):
    """Pad the flat posting arrays to a multiple of n_shards; padding
    rows carry zero impact so they never contribute."""
    nnz = len(docs_flat)
    per = -(-max(nnz, 1) // n_shards)
    total = per * n_shards
    docs = np.zeros(total, dtype=np.int32)
    imps = np.zeros(total, dtype=np.float32)
    docs[:nnz] = docs_flat
    imps[:nnz] = impacts_flat
    return docs, imps, per


def make_sharded_impact_scorer(mesh, n1: int):
    """Sharded BM25 impact-matmul:

    1. each chip densifies its local slice of the flat posting arrays
       into a partial M [S, n1] (sorted-unique scatter, local rows only),
    2. ``psum_scatter`` completes M for each chip's doc slice
       [S, n1/D] (a term's postings live on many chips),
    3. per-chip matmul W [Q, S] @ M_slice → scores [Q, n1/D]
       (FLOPs scale 1/D),
    4. local top-k, ``all_gather``, final top-k — preserving the
       (score desc, doc asc) merge contract.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    n_shards = mesh.shape["shard"]
    assert n1 % n_shards == 0, "doc space must pad to the shard count"
    slice_len = n1 // n_shards

    def local_step(docs_flat, impacts_flat, deleted,
                   slot_start, slot_len, w, posting_base, k, p_pad):
        n_local = docs_flat.shape[0]
        s_count = slot_start.shape[0]
        base = posting_base[0]

        # local intersection of each slot's global posting range
        local_start = jnp.clip(slot_start - base, 0, n_local)
        local_end = jnp.clip(slot_start + slot_len - base, 0, n_local)
        local_len = jnp.maximum(local_end - local_start, 0)

        ends = jnp.cumsum(local_len)
        total = ends[-1]
        positions = jnp.arange(p_pad, dtype=jnp.int32)
        # marks+cumsum instead of searchsorted (see ops/impact.py)
        marks = jnp.zeros(p_pad, dtype=jnp.int32).at[ends].add(
            1, mode="drop")
        seg_id = jnp.cumsum(marks)
        valid = positions < total
        seg_safe = jnp.minimum(seg_id, s_count - 1)
        begin = ends - local_len
        p_idx = local_start[seg_safe] + (positions - begin[seg_safe])
        p_idx = jnp.where(valid, jnp.minimum(p_idx, n_local - 1), 0)
        docs = docs_flat[p_idx]
        impacts = jnp.where(valid, impacts_flat[p_idx], 0.0)
        if impacts.dtype != jnp.float32:  # bf16 device storage (D8)
            impacts = impacts.astype(jnp.float32)
        flat_idx = jnp.where(
            valid,
            seg_safe * n1 + docs,
            s_count * n1 + (positions - total))
        m_flat = jnp.zeros(s_count * n1 + p_pad, dtype=jnp.float32)
        m_flat = m_flat.at[flat_idx].set(
            impacts, indices_are_sorted=True, unique_indices=True,
            mode="promise_in_bounds")
        m_partial = m_flat[: s_count * n1].reshape(s_count, n1)

        # complete each chip's doc slice of M
        m_slice = jax.lax.psum_scatter(
            m_partial, "shard", scatter_dimension=1, tiled=True)

        shard_idx = jax.lax.axis_index("shard")
        doc_base = shard_idx * slice_len
        local_deleted = jax.lax.dynamic_slice_in_dim(
            deleted, doc_base, slice_len, axis=0)
        scores = jnp.dot(w, m_slice, preferred_element_type=jnp.float32)
        masked = jnp.where((scores > 0.0) & ~local_deleted[None, :],
                           scores, -jnp.inf)
        loc_scores, loc_idx = jax.lax.top_k(masked, k)
        loc_ids = loc_idx + doc_base
        all_scores = jax.lax.all_gather(loc_scores, "shard", axis=1,
                                        tiled=True)
        all_ids = jax.lax.all_gather(loc_ids, "shard", axis=1, tiled=True)
        final_scores, pos = jax.lax.top_k(all_scores, k)
        final_ids = jnp.take_along_axis(all_ids, pos, axis=1)
        return final_scores, final_ids

    def run(docs_flat, impacts_flat, deleted,
            slot_start, slot_len, w, posting_base, *, k: int, p_pad: int):
        fn = shard_map(
            partial(local_step, k=k, p_pad=p_pad),
            mesh=mesh,
            in_specs=(
                P("shard"), P("shard"), P(None,),
                P(None,), P(None,), P("query", None), P("shard"),
            ),
            out_specs=(P("query", None), P("query", None)),
            check_vma=False,
        )
        return fn(docs_flat, impacts_flat, deleted,
                  slot_start, slot_len, w, posting_base)

    import jax

    return jax.jit(run, static_argnames=("k", "p_pad"))
