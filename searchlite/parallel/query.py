"""Full query execution sharded over a device mesh.

Round 1's mesh path (`parallel/mesh.py`) covered plain batched BM25
top-k. This module shards the ENTIRE single-query executor — matcher
trees, filter masks, phrase masks, fast-field columns, custom-score
trees — over the ``shard`` axis of a ``("query", "shard")`` mesh, using
DOC-SHARDED postings (``DeviceSegment.doc_shards``): each chip owns a
contiguous doc range and holds exactly the postings that land in it, so

- the impact matrix M is built purely locally per chip — NO collective
  is needed to complete it (unlike the flat-sharded + psum_scatter
  variant in parallel/mesh.py), and per-chip HBM scales 1/D;
- every doc-axis mask/column input (filters, phrases, root filter,
  fast-field columns, deleted) shards over the same doc tiling, so the
  CompiledQuery core (ops/score.py::_core — the same traced code the
  single-chip executor runs) evaluates per chip on its slice with zero
  communication;
- collectives carry only the small things: score-sorted top-k merges as
  local top-k → ``all_gather`` → final top-k (candidates are laid out
  shard-major / doc-ascending, so top_k's lowest-index tie-break
  preserves the reference's (score desc, doc_id asc) merge contract,
  `api/reader.rs:2742-2778`); ``match_count`` is a ``psum``;
- the full final_mask / adjusted-score / text-mask arrays come back as
  doc-sharded outputs the host reassembles, feeding the general result
  path (field-sort key merges, cursors, collapse, aggregations) with
  EXACTLY the single-chip semantics;
- ``make_sharded_terms_counts`` / ``make_sharded_stats_partial`` /
  ``make_sharded_range_counts`` merge aggregation intermediates on
  device (per-chip one-hot-contraction counts / masked reductions →
  ``psum``/``pmin``/``pmax``), mirroring the reference's cross-segment
  intermediate merge (`query/aggs/mod.rs:2049-2068`).
"""

from __future__ import annotations

from functools import partial

import numpy as np


def _shard_map():
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map
    return shard_map


def pad_doc_axis(arr: np.ndarray, n1p: int, fill) -> np.ndarray:
    """Pad the trailing (doc) axis of a host array to n1p."""
    n = arr.shape[-1]
    if n == n1p:
        return arr
    out = np.full(arr.shape[:-1] + (n1p,), fill, dtype=arr.dtype)
    out[..., :n] = arr
    return out


def make_sharded_query_executor(mesh, compiled, width: int):
    """Sharded analogue of ``CompiledQuery._build_executor`` (cursorless;
    the host general path applies cursor semantics). ``width`` is the
    per-chip doc-slice width (n1p = width * n_shards). Returns a jitted

        (docs_local, impacts_local, deleted,
         slot_start, slot_len, w_leaf, leaf_ind, group_ind,
         phrase_masks, filter_masks, col_vals, col_has, root_mask,
         k=, p_pad=, has_scored_terms=, need_scores=)
        -> (top_scores [k], top_idx [k], match_count,
            final_mask [n1p], adjusted [n1p], text_mask [n1p])

    where docs_local/impacts_local are the doc-sharded postings
    ([D*per], LOCAL doc coordinates) and slot_start/slot_len are
    per-chip [D, S] tables into them.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    n_shards = mesh.shape["shard"]

    def local_step(docs_local, impacts_local, deleted,
                   slot_start, slot_len, w_leaf, leaf_ind, group_ind,
                   phrase_masks, filter_masks, col_vals, col_has,
                   root_mask, *, k, p_pad, has_scored_terms,
                   need_scores):
        from searchlite.ops.impact import build_m

        # per-chip M over this chip's doc slice — postings are
        # doc-sharded, so the build is purely local (no collective)
        m = build_m(jnp, docs_local, impacts_local,
                    slot_start[0], slot_len[0], width, p_pad)

        final_mask, adjusted, matcher_mask, _ones = compiled._core(
            m, deleted, w_leaf, leaf_ind, group_ind,
            phrase_masks, filter_masks, col_vals, col_has, root_mask,
            has_scored_terms, need_scores)

        match_count = jax.lax.psum(final_mask.sum(), "shard")

        shard_idx = jax.lax.axis_index("shard")
        doc_base = shard_idx * width
        masked = jnp.where(final_mask, adjusted,
                           -jnp.inf).astype(jnp.float32)
        kk = min(k, width)
        loc_scores, loc_idx = jax.lax.top_k(masked, kk)
        loc_ids = loc_idx + doc_base
        all_scores = jax.lax.all_gather(loc_scores, "shard", axis=0,
                                        tiled=True)   # [D*kk]
        all_ids = jax.lax.all_gather(loc_ids, "shard", axis=0,
                                     tiled=True)
        final_scores, pos = jax.lax.top_k(
            all_scores, min(k, width * n_shards))
        final_ids = jnp.take_along_axis(all_ids, pos, axis=0)
        text_mask = matcher_mask & ~deleted
        return (final_scores, final_ids, match_count, final_mask,
                adjusted, text_mask)

    def run(docs_local, impacts_local, deleted,
            slot_start, slot_len, w_leaf, leaf_ind, group_ind,
            phrase_masks, filter_masks, col_vals, col_has, root_mask,
            *, k: int, p_pad: int, has_scored_terms: bool,
            need_scores: bool):
        fn = _shard_map()(
            partial(local_step, k=k, p_pad=p_pad,
                    has_scored_terms=has_scored_terms,
                    need_scores=need_scores),
            mesh=mesh,
            in_specs=(
                P("shard"), P("shard"), P("shard"),
                P("shard", None), P("shard", None),
                P(None, None), P(None, None), P(None, None),
                P(None, "shard"), P(None, "shard"),
                P(None, "shard"), P(None, "shard"),
                P("shard"),
            ),
            out_specs=(P(), P(), P(), P("shard"), P("shard"),
                       P("shard")),
            check_vma=False,
        )
        return fn(docs_local, impacts_local, deleted,
                  slot_start, slot_len, w_leaf, leaf_ind, group_ind,
                  phrase_masks, filter_masks, col_vals, col_has,
                  root_mask)

    import jax

    return jax.jit(run, static_argnames=(
        "k", "p_pad", "has_scored_terms", "need_scores"))


def make_sharded_batch_scorer(mesh):
    """Doc-sharded BATCHED sparse candidate scorer — the round-3
    single-chip headline path (ops/sparse.py packed candidate strips)
    over a device mesh. Each chip gathers every query row's candidate
    strip from its OWN doc range's blocks
    (``DeviceSegment.mesh_sparse_tables``): strip gather, sort,
    segmented combine, and local top-k are all collective-free; the
    collectives carry only the [B, D·k'] top-k merge (``all_gather`` + final
    ``top_k`` — shard-major layout keeps the reference's (score desc,
    doc asc) tie contract exactly as in ``make_sharded_query_executor``,
    since shard order IS global doc order). Per-batch transfer is the
    same ONE packed [B, t_pad] int32 table the single-chip path ships
    (replicated), plus the rare weight-override COO.

    The reference engine scores a batch by looping queries on one core
    (`query/wand.rs:459-566`); this is the scale-out analogue:
    per-chip work scales 1/D in both postings touched and device
    memory.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from searchlite.ops.sparse import (
        TID_BITS,
        TID_LIMIT,
        _candidate_core,
    )

    n_shards = mesh.shape["shard"]

    def local_step(block_docs, block_impacts, tid_tbl, packed, ovr,
                   sent, *, k, t_pad, nblk, log2_run, n_ovr):
        tid_tbl = tid_tbl[0]                       # [1,3,T] -> [3,T]
        # (sentinel block row, per-shard width) ride as TRACED scalars
        # — neither affects a shape, and per-segment values as statics
        # would recompile every (k, t_pad, nblk) bucket per segment
        # (the round-3 recompile-pollution lesson; the single-chip
        # scorer's sent[2] contract, ops/sparse.py)
        sent_row = sent[0]
        width = sent[1]
        tid = packed & (TID_LIMIT - 1)
        occ = jax.lax.shift_right_logical(packed, TID_BITS)
        bstart = tid_tbl[0][tid]
        bcnt = jnp.where(occ > 0, tid_tbl[1][tid], 0)
        idf = jax.lax.bitcast_convert_type(tid_tbl[2][tid], jnp.float32)
        w = occ.astype(jnp.float32) * idf
        if n_ovr:
            B = packed.shape[0]
            wf = w.reshape(B * t_pad)
            wf = wf.at[ovr[0]].set(
                jax.lax.bitcast_convert_type(ovr[1], jnp.float32),
                mode="drop")
            w = wf.reshape(B, t_pad)
        kk = min(k, nblk * 128)
        ts, td = _candidate_core(
            jax, jnp, block_docs, block_impacts, bstart, bcnt, w,
            sent_row, width, k=kk, t_pad=t_pad, nblk=nblk,
            log2_run=log2_run, with_counts=False)
        gd = td + jax.lax.axis_index("shard") * width
        all_s = jax.lax.all_gather(ts, "shard", axis=1, tiled=True)
        all_d = jax.lax.all_gather(gd, "shard", axis=1, tiled=True)
        fs, pos = jax.lax.top_k(all_s, min(k, all_s.shape[1]))
        fd = jnp.take_along_axis(all_d, pos, axis=1)
        if fs.shape[1] < k:                        # tiny strips: pad
            pad = k - fs.shape[1]
            fs = jnp.pad(fs, ((0, 0), (0, pad)),
                         constant_values=-jnp.inf)
            fd = jnp.pad(fd, ((0, 0), (0, pad)))
        return fs, fd

    def run(block_docs, block_impacts, tid_tbl, packed, ovr, sent, *,
            k: int, t_pad: int, nblk: int, log2_run: int, n_ovr: int):
        fn = _shard_map()(
            partial(local_step, k=k, t_pad=t_pad, nblk=nblk,
                    log2_run=log2_run, n_ovr=n_ovr),
            mesh=mesh,
            in_specs=(P("shard", None), P("shard", None),
                      P("shard", None, None),
                      P(None, None), P(None, None), P(None)),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return fn(block_docs, block_impacts, tid_tbl, packed, ovr,
                  sent)

    import jax

    return jax.jit(run, static_argnames=(
        "k", "t_pad", "nblk", "log2_run", "n_ovr"))


def make_sharded_dense_batch_scorer(mesh, precision: str = "f32"):
    """Doc-sharded DENSE batched scorer — the heavy (head-term)
    remainder of ``search_batch_many(mesh=)``. Each chip builds the
    batch's impact matrix M over ITS doc slice only (block-gather +
    unique scatter over the shard-local block layout,
    ``DeviceSegment.mesh_sparse_tables`` — per-chip M is
    [S, width+1], 1/D of the single-chip matrix), runs the same
    ``W @ M`` matmul, and merges local top-k with collectives exactly like
    ``make_sharded_batch_scorer``. Tombstoned docs' impacts are zeroed
    in the shard tables, so the single-chip ``score > 0`` match mask
    carries over unchanged."""
    from searchlite.ops.precision import (
        apply_matmul_precision,
        m_store_dtype,
    )

    apply_matmul_precision()
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    m_dtype = m_store_dtype(precision)

    def local_step(block_docs, block_impacts, blk_idx, slot_row,
                   w_idx, w_val, *, k, s_pad, n_queries, width):
        from searchlite.ops.impact import build_m_from_blocks

        blk_idx = blk_idx[0]                     # [1, nb] -> [nb]
        slot_row = slot_row[0]
        m = build_m_from_blocks(jnp, block_docs, block_impacts,
                                blk_idx, slot_row, width + 1, s_pad,
                                dtype=m_dtype)
        w_flat = jnp.zeros(n_queries * s_pad + w_idx.shape[0],
                           dtype=jnp.float32)
        w_flat = w_flat.at[w_idx].set(
            w_val, indices_are_sorted=True, unique_indices=True,
            mode="promise_in_bounds")
        w = w_flat[: n_queries * s_pad].reshape(n_queries, s_pad)
        if m.dtype != w.dtype:
            w = w.astype(m.dtype)
        scores = jnp.dot(w, m, preferred_element_type=jnp.float32)
        masked = jnp.where(scores > 0.0, scores, -jnp.inf)
        kk = min(k, width + 1)
        ls, li = jax.lax.top_k(masked, kk)
        gd = li + jax.lax.axis_index("shard") * width
        all_s = jax.lax.all_gather(ls, "shard", axis=1, tiled=True)
        all_d = jax.lax.all_gather(gd, "shard", axis=1, tiled=True)
        fs, pos = jax.lax.top_k(all_s, min(k, all_s.shape[1]))
        fd = jnp.take_along_axis(all_d, pos, axis=1)
        if fs.shape[1] < k:
            pad = k - fs.shape[1]
            fs = jnp.pad(fs, ((0, 0), (0, pad)),
                         constant_values=-jnp.inf)
            fd = jnp.pad(fd, ((0, 0), (0, pad)))
        return fs, fd

    def run(block_docs, block_impacts, blk_idx, slot_row, w_idx,
            w_val, *, k: int, s_pad: int, n_queries: int, width: int):
        fn = _shard_map()(
            partial(local_step, k=k, s_pad=s_pad,
                    n_queries=n_queries, width=width),
            mesh=mesh,
            in_specs=(P("shard", None), P("shard", None),
                      P("shard", None), P("shard", None),
                      P(None), P(None)),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return fn(block_docs, block_impacts, blk_idx, slot_row,
                  w_idx, w_val)

    import jax

    return jax.jit(run, static_argnames=(
        "k", "s_pad", "n_queries", "width"))


def make_sharded_vector_topk(mesh):
    """Vector similarity over the mesh: vector rows (docs) shard over
    chips, each chip runs the exact similarity matmul + local top-k on its
    slice, and an ``all_gather`` + final top-k merges — same (score
    desc, doc asc) contract as the text path. Covers cosine and L2 with
    the same quantization levels as ops/vector.py."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    def local_step(vectors, v_scale, v_sq, present, mask, queries,
                   q_scale, *, k, metric, quantization):
        n_local = vectors.shape[0]
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
            q_sq = jnp.sum(
                (queries.astype(jnp.float32) * q_scale[:, None]
                 if quantization == "int8"
                 else queries.astype(jnp.float32)) ** 2, axis=1)
            sims = -jnp.sqrt(jnp.maximum(
                v_sq[None, :] + q_sq[:, None] - 2.0 * dots, 0.0))
        ok = (present & mask)[None, :]
        masked = jnp.where(ok, sims, -jnp.inf)
        kk = min(k, n_local)
        loc_scores, loc_idx = jax.lax.top_k(masked, kk)
        base = jax.lax.axis_index("shard") * n_local
        loc_ids = loc_idx + base
        all_scores = jax.lax.all_gather(loc_scores, "shard", axis=1,
                                        tiled=True)
        all_ids = jax.lax.all_gather(loc_ids, "shard", axis=1,
                                     tiled=True)
        final_scores, pos = jax.lax.top_k(
            all_scores, min(k, all_scores.shape[1]))
        final_ids = jnp.take_along_axis(all_ids, pos, axis=1)
        return final_scores, final_ids

    def run(vectors, v_scale, v_sq, present, mask, queries, q_scale,
            *, k: int, metric: str, quantization: str):
        fn = _shard_map()(
            partial(local_step, k=k, metric=metric,
                    quantization=quantization),
            mesh=mesh,
            in_specs=(P("shard", None), P("shard"), P("shard"),
                      P("shard"), P("shard"), P(None, None), P(None,)),
            out_specs=(P(), P()),
            check_vma=False,
        )
        return fn(vectors, v_scale, v_sq, present, mask, queries,
                  q_scale)

    import jax

    return jax.jit(run, static_argnames=("k", "metric", "quantization"))


def make_sharded_terms_counts(mesh):
    """Device-side bucket-count partial merge over the mesh: each chip
    counts bucket codes over its doc slice of the matched mask, then a
    ``psum`` merges the per-chip intermediates — the semantics of the
    reference's cross-segment aggregation-intermediate merge
    (`query/aggs/mod.rs:2049-2068`) on the mesh. Serves terms
    (dictionary ids) and histogram (host-computed exact bucket codes,
    ops/device_aggs.py) alike.

    The local count is the one-hot matmul contraction from
    ops/device_aggs.py, not a bincount scatter-add with colliding
    indices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from searchlite.ops.device_aggs import bucket_counts_local

    def local_step(dict_ids, mask, *, n_buckets):
        counts = bucket_counts_local(jnp, dict_ids, mask, n_buckets)
        return jax.lax.psum(counts, "shard")

    def run(dict_ids, mask, *, n_buckets: int):
        fn = _shard_map()(
            partial(local_step, n_buckets=n_buckets),
            mesh=mesh,
            in_specs=(P("shard"), P("shard")),
            out_specs=P(),
            check_vma=False,
        )
        return fn(dict_ids, mask)

    import jax

    return jax.jit(run, static_argnames=("n_buckets",))


def make_sharded_stats_partial(mesh):
    """Device-side stats partial over the mesh: per-chip (count, sum,
    sum_sq, min, max) over its doc slice, merged with psum/pmin/pmax.
    Same precision contract as the single-chip kernel
    (ops/device_aggs.py): count/min/max exact, sums f32-accumulated."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    def local_step(vals, has, mask):
        ok = has & mask
        okf = ok.astype(jnp.float32)
        masked = jnp.where(ok, vals, 0.0)
        count = jax.lax.psum(jnp.sum(okf, dtype=jnp.float32), "shard")
        total = jax.lax.psum(jnp.sum(masked, dtype=jnp.float32),
                             "shard")
        total_sq = jax.lax.psum(
            jnp.sum(masked * masked, dtype=jnp.float32), "shard")
        vmin = jax.lax.pmin(jnp.min(jnp.where(ok, vals, jnp.inf)),
                            "shard")
        vmax = jax.lax.pmax(jnp.max(jnp.where(ok, vals, -jnp.inf)),
                            "shard")
        return count, total, total_sq, vmin, vmax

    def run(vals, has, mask):
        fn = _shard_map()(
            local_step,
            mesh=mesh,
            in_specs=(P("shard"), P("shard"), P("shard")),
            out_specs=(P(), P(), P(), P(), P()),
            check_vma=False,
        )
        return fn(vals, has, mask)

    import jax

    return jax.jit(run)


def make_sharded_range_counts(mesh):
    """Device-side range-agg partial over the mesh: rows are host-f64
    membership bools ([R, n1p], ranges may overlap) sharded on the doc
    axis; per-chip counts psum across chips. Exact integers."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    def local_step(rows, mask):
        local = jnp.dot(rows.astype(jnp.float32),
                        mask.astype(jnp.float32),
                        preferred_element_type=jnp.float32)
        return jax.lax.psum(local.astype(jnp.int32), "shard")

    def run(rows, mask):
        fn = _shard_map()(
            local_step,
            mesh=mesh,
            in_specs=(P(None, "shard"), P("shard")),
            out_specs=P(),
            check_vma=False,
        )
        return fn(rows, mask)

    import jax

    return jax.jit(run)
