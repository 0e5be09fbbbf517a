"""Impact-matmul scoring: BM25 as a matrix product.

The scatter-add formulation (ops/batch.py) scatters with colliding
indices, which serialize. This kernel removes the colliding scatter
entirely:

1. **Index time**: the tf-saturation term of BM25 depends only on index
   statistics, never on the query:

       impact(t, d) = tf·(k1+1) / (tf + k1·(1 − b + b·dl/avgdl))

   so each posting's impact is precomputed once per segment
   (``DeviceSegment.impacts_flat`` — "impact-ordered postings").

2. **Query time**: the batch's distinct terms become rows of a dense
   matrix ``M [S, n_docs]``: the terms' posting BLOCKS are pulled with
   one row gather of ``[nb, 128]`` (contiguous 128-wide rows rather
   than element gathers) and placed with ONE unique-index scatter
   (pads route to a dump zone past ``S·n1`` so indices stay unique
   and XLA keeps its vectorized path — COLLIDING scatters serialize).

3. Scoring is a matmul:

       scores [Q, n1] = W [Q, S] @ M [S, n1]

   with W holding idf·boost per (query, term slot). A doc matches iff
   its score is positive (impacts > 0, idf ≥ 1), so no separate match
   scatter is needed. ``lax.top_k`` finishes per query.

This is the SPLADE-style "sparse retrieval as dense matmul" mapping; it
turns the engine's hottest loop into the operation accelerators are
built for.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def pow4_bucket(n: int, minimum: int = 4096) -> int:
    """Round up to the pow-4 ladder (4096, 16384, 65536, ...): coarse
    shape buckets keep XLA recompiles rare across varied queries."""
    out = minimum
    while out < n:
        out *= 4
    return out


def pow2_bucket(n: int, minimum: int = 4096) -> int:
    """Round up to the pow-2 ladder. Used where the padded extent sets
    the DEVICE cost (the M scatter is update-count-bound, so every pad
    slot is a wasted update): pow-4 padding wastes up to 4x updates
    (measured 60% pads at the headline bench shapes), pow-2 at most 2x,
    for only one extra compile bucket per octave."""
    out = minimum
    while out < n:
        out *= 2
    return out


def pow15_bucket(n: int, minimum: int = 512) -> int:
    """Round up to the {pow2, 0.75·pow2} ladder (512, 768, 1024, 1536,
    2048, 3072, ...): at most 33% overshoot. Used for the batched
    scorers' hot extents (sparse slot count, gathered block count),
    where pow-2's worst-case 2x pad directly doubles matmul K or
    scatter updates; two buckets per octave keeps compile counts
    bounded for steady serving."""
    out = pow2_bucket(n, minimum=minimum)
    if out * 3 // 4 >= max(n, minimum):
        return out * 3 // 4
    return out


def build_m_from_blocks(jnp, block_docs, block_impacts, blk_idx,
                        slot_row, n1: int, s_count: int, dtype=None):
    """Densify term slots into M [s_count, n1] from the 128-wide block
    layout. The ragged per-slot posting expansion becomes ONE row
    gather of [nb, 128] blocks where the flat-CSR variant below needs
    two element gathers plus a cumsum over millions of positions.

    block_docs/block_impacts: [n_blocks+1, 128] with a trailing
    all-sentinel row (doc = n1-1, impact 0) used for padding blk_idx.
    blk_idx [nb]: segment block rows for each slot, concatenated.
    slot_row [nb]: owning slot of each gathered block.
    Block pads (doc == sentinel) and gather pads route to the dump zone
    past s_count*n1 at unique positions, so the scatter stays
    unique-index (its cost grows with the update count)."""
    nb = blk_idx.shape[0]
    docs2d = block_docs[blk_idx]
    imps2d = block_impacts[blk_idx]
    # upcast right after the gather: impacts may be stored bf16 on
    # device (ops/precision.py::impacts_store_dtype) but the scatter
    # stores f32 — a bf16 scatter store measured SLOWER (sub-word
    # writes), and fast-f32 matmuls round inputs to bf16 anyway
    target = dtype if dtype is not None else jnp.float32
    if imps2d.dtype != target:
        imps2d = imps2d.astype(target)
    pos = jnp.arange(nb * 128, dtype=jnp.int32).reshape(nb, 128)
    is_pad = docs2d == (n1 - 1)
    flat_idx = jnp.where(
        is_pad,
        s_count * n1 + pos,
        slot_row[:, None] * n1 + docs2d).reshape(-1)
    m_flat = jnp.zeros(s_count * n1 + nb * 128, dtype=imps2d.dtype)
    m_flat = m_flat.at[flat_idx].set(
        imps2d.reshape(-1), unique_indices=True,
        mode="promise_in_bounds")
    return m_flat[: s_count * n1].reshape(s_count, n1)


def build_m(jnp, docs_flat, impacts_flat, slot_start, slot_len,
            n1: int, p_pad: int, dtype=None):
    """Densify the batch's term slots into M [S, n1] with one
    sorted-unique scatter from flat CSR postings. Still used where
    postings arrive without the block layout (doc-sharded slices,
    multi-chip posting shards); the block variant above is the fast
    path on whole segments."""
    s_count = slot_start.shape[0]
    ends = jnp.cumsum(slot_len)
    total = ends[-1]
    positions = jnp.arange(p_pad, dtype=jnp.int32)
    # seg_id[p] = #{s : ends[s] <= p} — computed as a scatter of 4k marks
    # + cumsum instead of searchsorted over millions of positions
    marks = jnp.zeros(p_pad, dtype=jnp.int32).at[ends].add(
        1, mode="drop")
    seg_id = jnp.cumsum(marks)
    valid = positions < total
    seg_safe = jnp.minimum(seg_id, s_count - 1)
    begin = ends - slot_len
    p_idx = slot_start[seg_safe] + (positions - begin[seg_safe])
    p_idx = jnp.where(valid, p_idx, 0)
    docs = docs_flat[p_idx]
    impacts = jnp.where(valid, impacts_flat[p_idx], 0.0)
    target = dtype if dtype is not None else jnp.float32
    if impacts.dtype != target:
        impacts = impacts.astype(target)
    flat_idx = jnp.where(
        valid,
        seg_safe * n1 + docs,
        s_count * n1 + (positions - total))
    m_flat = jnp.zeros(s_count * n1 + p_pad, dtype=impacts.dtype)
    m_flat = m_flat.at[flat_idx].set(
        impacts, indices_are_sorted=True, unique_indices=True,
        mode="promise_in_bounds")
    return m_flat[: s_count * n1].reshape(s_count, n1)


def make_impact_scorer(precision: str = "f32"):
    """Batched scorer over the block layout (the fast path).

    M's storage dtype follows ops/precision.py::m_store_dtype — bf16 on
    accelerator backends (bit-identical to the default fast-f32 matmul,
    which rounds its inputs to bf16 anyway; halves scatter writes and
    matmul reads), f32 on CPU or under f32_strict."""
    from searchlite.ops.precision import (
        apply_matmul_precision,
        m_store_dtype,
    )

    apply_matmul_precision()
    import jax
    import jax.numpy as jnp

    m_dtype = m_store_dtype(precision)

    @partial(jax.jit,
             static_argnames=("k", "s_pad", "n_queries", "use_filters"))
    def scorer(block_docs, block_impacts, deleted, blk_idx, slot_row,
               w_idx, w_val, filter_rows, fidx,
               *, k: int, s_pad: int, n_queries: int,
               use_filters: bool = False):
        """block_docs/block_impacts: [n_blocks+1, 128] segment posting
        blocks (+sentinel row). blk_idx/slot_row: [nb] gathered block
        rows and their owning slots. (w_idx, w_val): sorted COO of the
        [Q, S] idf·boost weight matrix (w_idx = q*S + s; pads point
        past Q*S). With use_filters, filter_rows [F+1, n1] holds the
        batch's DISTINCT filter masks (row 0 = match-all) and fidx [Q]
        selects each query's row. Returns (scores [Q,k], ids [Q,k])."""
        m = build_m_from_blocks(jnp, block_docs, block_impacts,
                                blk_idx, slot_row, deleted.shape[0],
                                s_pad, dtype=m_dtype)
        return _score_m(jax, jnp, m, deleted, w_idx, w_val,
                        k, s_pad, n_queries,
                        filter_rows if use_filters else None, fidx)

    return scorer


def _score_m(jax, jnp, m, deleted, w_idx, w_val, k, s_count, n_queries,
             filter_rows=None, fidx=None):
    """Shared scorer tail: densify the COO weight matrix, W @ M,
    mask non-matches/deleted (+ per-query filter rows), top-k.
    W is cast to M's dtype (a cheap [Q, S] pass) so a bf16 M runs a
    clean bf16×bf16 matmul with f32 accumulation."""
    w_flat = jnp.zeros(n_queries * s_count + w_idx.shape[0],
                       dtype=jnp.float32)
    w_flat = w_flat.at[w_idx].set(
        w_val, indices_are_sorted=True, unique_indices=True,
        mode="promise_in_bounds")
    w = w_flat[: n_queries * s_count].reshape(n_queries, s_count)
    if m.dtype != w.dtype:
        w = w.astype(m.dtype)
    scores = jnp.dot(w, m, preferred_element_type=jnp.float32)
    ok = (scores > 0.0) & ~deleted[None, :]
    if filter_rows is not None:
        ok = ok & filter_rows[fidx]
    masked = jnp.where(ok, scores, -jnp.inf)
    return jax.lax.top_k(masked, k)


def make_flat_impact_scorer(precision: str = "f32"):
    """Batched scorer over flat CSR posting slices — used by the
    doc-sharded path, whose per-shard slices have no block layout."""
    from searchlite.ops.precision import (
        apply_matmul_precision,
        m_store_dtype,
    )

    apply_matmul_precision()
    import jax
    import jax.numpy as jnp

    m_dtype = m_store_dtype(precision)

    @partial(jax.jit,
             static_argnames=("k", "p_pad", "n_queries", "use_filters"))
    def scorer(docs_flat, impacts_flat, deleted,
               slot_start, slot_len, w_idx, w_val, filter_rows, fidx,
               *, k: int, p_pad: int, n_queries: int,
               use_filters: bool = False):
        s_count = slot_start.shape[0]
        m = build_m(jnp, docs_flat, impacts_flat, slot_start, slot_len,
                    deleted.shape[0], p_pad, dtype=m_dtype)
        return _score_m(jax, jnp, m, deleted, w_idx, w_val,
                        k, s_count, n_queries,
                        filter_rows if use_filters else None, fidx)

    return scorer


def build_impact_batch(seg, dseg, queries: list[list[tuple[str, str]]],
                       slot_bucket: int = 64,
                       lazy_tables: bool = False):
    """Host-side prep: dedupe the batch's terms into slots, build the
    per-slot posting ranges and the [Q, S] weight matrix. Per-term
    metadata (tid, ranges, idf) is memoized on the DeviceSegment across
    batches — term lookups are a bisect each and workloads repeat terms
    heavily (measured ~20% of stream host time before memoization).

    ``lazy_tables`` skips the dense scorers' per-batch tables (w COO,
    block gather tables) — the sparse candidate path (ops/sparse.py)
    never reads them; a dense/heavy fallback calls
    :func:`ensure_dense_tables` before use."""
    postings = seg.postings
    idf_table = dseg.idf_table
    term_meta = getattr(dseg, "_term_meta", None)
    if term_meta is None:
        term_meta = dseg._term_meta = {}
    slots: dict[str, int] = {}
    slot_start: list[int] = []
    slot_len: list[int] = []
    slot_idf: list[float] = []
    slot_tids: list[int] = []
    slot_bstart: list[int] = []
    slot_bcnt: list[int] = []
    q = len(queries)
    q_nblk = np.zeros(q, dtype=np.int64)
    qs_start = np.zeros(q + 1, dtype=np.int64)
    qs_slot_l: list[int] = []
    qs_w_l: list[float] = []
    qs_cnt_l: list[int] = []
    for qi, query in enumerate(queries):
        row: dict[int, float] = {}
        nblk = 0
        for field, token in query:
            key = f"{field}:{token}"
            slot = slots.get(key)
            if slot is None:
                meta = term_meta.get(key)
                if meta is None:
                    tid = seg.terms.get(key)
                    if tid is None:
                        term_meta[key] = False
                        continue
                    length = int(postings.term_df[tid])
                    meta = (int(dseg.posting_base[tid]), length,
                            float(idf_table[tid]), int(tid),
                            int(postings.term_block_start[tid]),
                            int(postings.term_block_count[tid]))
                    term_meta[key] = meta
                elif meta is False:
                    continue
                slot = len(slot_start)
                slots[key] = slot
                slot_start.append(meta[0])
                slot_len.append(meta[1])
                slot_idf.append(meta[2])
                slot_tids.append(meta[3])
                slot_bstart.append(meta[4])
                slot_bcnt.append(meta[5])
            if slot not in row:
                nblk += slot_bcnt[slot]
            row[slot] = row.get(slot, 0) + 1
        q_nblk[qi] = nblk
        # weight = occurrence count x idf (multiplication, not serial
        # addition, so the native prep path is bit-identical)
        for slot in sorted(row):
            qs_slot_l.append(slot)
            qs_w_l.append(row[slot] * slot_idf[slot])
            qs_cnt_l.append(row[slot])
        qs_start[qi + 1] = len(qs_slot_l)
    s_pad = next_pow2(max(len(slot_start), slot_bucket))
    out = {
        "s_pad": s_pad,
        "n_queries": q,
        "slot_tids": np.asarray(slot_tids, dtype=np.int64),
        "n_slots": len(slot_start),
        "slot_bstart": np.asarray(slot_bstart, dtype=np.int64),
        "slot_bcnt": np.asarray(slot_bcnt, dtype=np.int64),
        "slot_len_list": np.asarray(slot_len, dtype=np.int64),
        "slot_start_list": np.asarray(slot_start, dtype=np.int64),
        "sentinel_row": dseg.n_block_rows,
        "n1": dseg.n1,
        # per-query (slot, weight) rows in CSR form, slots sorted
        # ascending within each row — the per-query pruned batch path
        # and the sparse candidate path build their [Q, tpq] tables
        # from these with vectorized scatters (and the native prep
        # fast path emits this format directly)
        "qs_start": qs_start,
        "qs_slot": np.asarray(qs_slot_l, dtype=np.int32),
        "qs_w": np.asarray(qs_w_l, dtype=np.float32),
        "qs_cnt": np.asarray(qs_cnt_l, dtype=np.int32),
        "q_nblk": q_nblk,
    }
    # flat scatter extent of the dense [s_pad, n1] M build (same value
    # ensure_dense_tables' block tables produce); callers that densify
    # over the full doc axis must route to a doc-sharded or tile path
    # when this exceeds int32 indexing
    nb_pad = pow15_bucket(max(int(sum(slot_bcnt)), 1), minimum=32)
    out["flat_extent"] = s_pad * dseg.n1 + nb_pad * 128
    if not lazy_tables:
        ensure_dense_tables(out)
    return out


def _native_prep_for(seg, dseg, fields, analysis, schema):
    """Cached (NativeQueryPrep, field prefixes, field flags) for a
    (segment, fields) pair, or None when any field's search analyzer
    has no native profile / needs a second stopword set / isn't a text
    field. The handle is shared across field sets with the same
    stopword set (term-id lookups memoize inside it)."""
    cache = getattr(dseg, "_qprep_cache", None)
    if cache is None:
        cache = dseg._qprep_cache = {}
    key = tuple(fields)
    hit = cache.get(key)
    if hit is not None:
        return hit if hit is not False else None
    result = None
    prefixes: list[str] = []
    flags = np.zeros(len(fields), dtype=np.uint8)
    stop_set: frozenset | None = None
    ok = True
    for i, field in enumerate(fields):
        if schema.field_kind(field) != "text":
            ok = False
            break
        analyzer = analysis.search_analyzer(field)
        if analyzer is None or analyzer.native_profile is None:
            ok = False
            break
        tok, stop, stem = analyzer.native_profile
        if stop is not None:
            stop = frozenset(stop)
            if stop_set is None:
                stop_set = stop
            elif stop_set != stop:
                ok = False  # one stopword set per native handle
                break
            flags[i] |= 1
        if stem:
            flags[i] |= 2
        if tok == "unicode":
            flags[i] |= 4
        prefixes.append(f"{field}:")
    if ok:
        handles = getattr(dseg, "_qprep_handles", None)
        if handles is None:
            handles = dseg._qprep_handles = {}
        handle = handles.get(stop_set)
        if handle is None:
            try:
                from searchlite.native import NativeQueryPrep, get_lib
                if get_lib() is not None:
                    handle = NativeQueryPrep(
                        seg.terms._terms, stop_set)
                    handles[stop_set] = handle
            except (RuntimeError, OSError):
                handle = None
        if handle is not None:
            result = (handle, prefixes, flags)
    cache[key] = result if result is not None else False
    return result


def build_impact_batch_native(seg, dseg, queries: list[str], fields,
                              analysis, schema, slot_bucket: int = 64,
                              lazy_tables: bool = False):
    """Native-prep fast path of :func:`build_impact_batch`: raw query
    strings go through the C++ analyzer + dictionary (one call per
    batch) and the qb tables are assembled with numpy gathers — no
    per-query Python. Returns None when the batch needs the Python
    path (unsupported analyzer/field config, or query syntax beyond
    plain terms — the native side rejects ':', '-', '\"' and non-ASCII
    under the default tokenizer). Output is bit-identical to the
    Python builder (same idf table, same count x idf weights),
    equivalence-fuzzed in tests/test_native_qprep.py."""
    if os.environ.get("SEARCHLITE_DISABLE_NATIVE_QPREP"):
        return None
    info = _native_prep_for(seg, dseg, fields, analysis, schema)
    if info is None:
        return None
    prep, prefixes, flags = info
    out = prep.prep_batch(queries, prefixes, flags)
    if out is None:
        return None
    qs_start, qs_slot, qs_cnt, slot_tids = out
    postings = seg.postings
    idf_slots = dseg.idf_table[slot_tids]
    slot_bstart = postings.term_block_start[slot_tids].astype(np.int64)
    slot_bcnt = postings.term_block_count[slot_tids].astype(np.int64)
    slot_len = postings.term_df[slot_tids].astype(np.int64)
    slot_start = dseg.posting_base[slot_tids]
    qs_w = (idf_slots[qs_slot] * qs_cnt).astype(np.float32)
    nb_of_entry = slot_bcnt[qs_slot]
    c = np.zeros(len(nb_of_entry) + 1, dtype=np.int64)
    np.cumsum(nb_of_entry, out=c[1:])
    q_nblk = c[qs_start[1:]] - c[qs_start[:-1]]
    s_pad = next_pow2(max(len(slot_tids), slot_bucket))
    qb = {
        "s_pad": s_pad,
        "n_queries": len(queries),
        "slot_tids": slot_tids,
        "n_slots": len(slot_tids),
        "slot_bstart": slot_bstart,
        "slot_bcnt": slot_bcnt,
        "slot_len_list": slot_len,
        "slot_start_list": slot_start,
        "sentinel_row": dseg.n_block_rows,
        "n1": dseg.n1,
        "qs_start": qs_start,
        "qs_slot": qs_slot,
        "qs_w": qs_w,
        "qs_cnt": qs_cnt,
        "q_nblk": q_nblk,
    }
    nb_pad = pow15_bucket(max(int(slot_bcnt.sum()), 1), minimum=32)
    qb["flat_extent"] = s_pad * dseg.n1 + nb_pad * 128
    if not lazy_tables:
        ensure_dense_tables(qb)
    return qb


def csr_row_lengths(qb) -> np.ndarray:
    """Per-query entry counts of a qb's (slot, weight) CSR."""
    return np.diff(qb["qs_start"])


def csr_take_rows(qs_start, counts, row_idx):
    """Gather CSR rows ``row_idx``: returns (flat entry indices,
    per-row counts, within-row positions) — all vectorized."""
    sc = counts[row_idx]
    total = int(sc.sum())
    ends = np.cumsum(sc)
    pos = np.arange(total, dtype=np.int64) - np.repeat(ends - sc, sc)
    idx = np.repeat(qs_start[row_idx], sc) + pos
    return idx, sc, pos


def ensure_dense_tables(qb):
    """Build the dense scorers' per-batch tables in place if missing:
    the sorted [Q, S] weight COO, the padded slot_start/slot_len
    arrays, and the block gather tables. Split from build_impact_batch
    so sparse-candidate batches never pay for them."""
    if "w_idx" in qb:
        return qb
    q = qb["n_queries"]
    s_pad = qb["s_pad"]
    slot_start = qb["slot_start_list"]
    slot_len = qb["slot_len_list"]
    # weight matrix as sorted COO (w_idx = q*S + s ascending): densified
    # on device with the sorted-unique scatter fast path — transfers
    # O(nnz) instead of O(Q*S). The CSR is sorted by (query, slot), so
    # the COO indices come out ascending with no sort.
    qs_slot = qb["qs_slot"]
    qs_w = qb["qs_w"]
    n_entries = len(qs_slot)
    rep_q = np.repeat(
        np.arange(q, dtype=np.int64), csr_row_lengths(qb))
    w_pad = next_pow2(max(n_entries, 16))
    w_idx = np.empty(w_pad, dtype=np.int32)
    w_val = np.zeros(w_pad, dtype=np.float32)
    w_idx[:n_entries] = rep_q * s_pad + qs_slot
    w_val[:n_entries] = qs_w
    # pads point past Q*S into the dump zone, keeping indices sorted+unique
    w_idx[n_entries:] = q * s_pad + np.arange(
        w_pad - n_entries, dtype=np.int32)
    blk_idx, slot_row, nb_pad = build_block_tables(
        qb["slot_bstart"], qb["slot_bcnt"],
        sentinel_row=qb["sentinel_row"])
    qb["w_idx"] = w_idx
    qb["w_val"] = w_val
    qb["p_pad"] = pow2_bucket(int(sum(slot_len)))
    qb["blk_idx"] = blk_idx
    qb["slot_row"] = slot_row
    qb["nb_pad"] = nb_pad
    qb["slot_start"] = np.zeros(s_pad, dtype=np.int32)
    qb["slot_len"] = np.zeros(s_pad, dtype=np.int32)
    qb["slot_start"][:len(slot_start)] = slot_start
    qb["slot_len"][:len(slot_len)] = slot_len
    return qb


def subset_impact_batch(qb, q_idx, min_queries: int = 32):
    """Re-pack a build_impact_batch() output for a SUBSET of its
    queries (the heavy remainder of the sparse-candidate split —
    api/reader.py routes head-term queries back through the dense
    scorers). Slots unused by the subset are dropped and the rest
    reindexed; the query axis is padded to a pow15 bucket with empty
    rows so the dense scorer's n_queries stays in a small compile-shape
    family. Pad rows produce no weight entries → all scores mask to
    -inf, same as a no-match query."""
    q_idx = np.asarray(q_idx, dtype=np.int64)
    counts = csr_row_lengths(qb)
    idx, sc, _pos = csr_take_rows(qb["qs_start"], counts, q_idx)
    sub_slot = qb["qs_slot"][idx]
    sub_w = qb["qs_w"][idx]
    # remap to the subset's compacted slot ids (np.unique is sorted,
    # so the remap is monotonic and rows stay slot-ascending)
    slots_used, new_slot = np.unique(sub_slot, return_inverse=True)
    bstart = qb["slot_bstart"][slots_used]
    bcnt = qb["slot_bcnt"][slots_used]
    start_list = qb["slot_start_list"][slots_used]
    len_list = qb["slot_len_list"][slots_used]
    tids = qb["slot_tids"]
    n_slots = len(slots_used)
    s_pad = next_pow2(max(n_slots, 8))
    nq = len(q_idx)
    nq_pad = pow15_bucket(max(nq, 1), minimum=min_queries)
    n_entries = len(sub_slot)
    rep_q = np.repeat(np.arange(nq, dtype=np.int64), sc)
    w_pad = next_pow2(max(n_entries, 16))
    w_idx = np.empty(w_pad, dtype=np.int32)
    w_val = np.zeros(w_pad, dtype=np.float32)
    w_idx[:n_entries] = rep_q * s_pad + new_slot
    w_val[:n_entries] = sub_w
    w_idx[n_entries:] = nq_pad * s_pad + np.arange(
        w_pad - n_entries, dtype=np.int32)
    qs_start2 = np.zeros(nq_pad + 1, dtype=np.int64)
    qs_start2[1:nq + 1] = np.cumsum(sc)
    qs_start2[nq + 1:] = n_entries
    blk_idx, slot_row, nb_pad = build_block_tables(
        bstart, bcnt, sentinel_row=qb["sentinel_row"])
    n1 = qb["n1"]
    slot_start = np.zeros(s_pad, dtype=np.int32)
    slot_len = np.zeros(s_pad, dtype=np.int32)
    if n_slots:
        slot_start[:n_slots] = start_list
        slot_len[:n_slots] = len_list
    # qs_cnt rides along so the subset stays eligible for the PACKED
    # sparse partitions (ops/sparse.py::_packed_applies): without it
    # the oversized-corpus full-strip fallback fell through to the
    # legacy un-chunked table and compiled a [bl, nblk*128] sort that
    # OOM'd HBM at 5M docs (192 rows x 6.29M lanes = 18 GB)
    qs_cnt = qb.get("qs_cnt")
    return {
        **({"qs_cnt": qs_cnt[idx]} if qs_cnt is not None else {}),
        "slot_start": slot_start,
        "slot_len": slot_len,
        "slot_start_list": start_list,
        "slot_len_list": len_list,
        "w_idx": w_idx,
        "w_val": w_val,
        "p_pad": pow2_bucket(int(sum(len_list))),
        "blk_idx": blk_idx,
        "slot_row": slot_row,
        "nb_pad": nb_pad,
        "s_pad": s_pad,
        "n_queries": nq_pad,
        "slot_tids": tids[slots_used] if n_slots else
        np.zeros(0, dtype=np.int64),
        "n_slots": n_slots,
        "slot_bstart": bstart,
        "slot_bcnt": bcnt,
        "sentinel_row": qb["sentinel_row"],
        "n1": n1,
        "qs_start": qs_start2,
        "qs_slot": new_slot.astype(np.int32),
        "qs_w": sub_w,
        "q_nblk": np.concatenate(
            [qb["q_nblk"][q_idx],
             np.zeros(nq_pad - nq, dtype=np.int64)]),
        "flat_extent": s_pad * n1 + nb_pad * 128,
    }


def expand_block_tables_dev(jnp, bstart, bcnt, sentinel_row, nb_pad: int):
    """Device-side build_block_tables: expand per-slot block ranges
    into (blk_idx, slot_row) gather tables without shipping
    O(total_blocks) tables over the host link — at 5M docs the host
    tables are ~64 MB per batch; the per-slot ranges are KBs. Segmented iota, same pattern as build_m_from_runs.
    sentinel_row is a traced scalar so shard launches share one trace
    across segments."""
    s = bcnt.shape[0]
    ends = jnp.cumsum(bcnt)
    total = ends[s - 1]
    begin = ends - bcnt
    positions = jnp.arange(nb_pad, dtype=jnp.int32)
    marks = jnp.zeros(nb_pad, dtype=jnp.int32).at[ends].add(
        1, mode="drop")
    rid = jnp.cumsum(marks)
    valid = positions < total
    rid_safe = jnp.minimum(rid, s - 1)
    blk = bstart[rid_safe] + (positions - begin[rid_safe])
    blk_idx = jnp.where(valid, blk, sentinel_row)
    slot_row = jnp.where(valid, rid_safe, 0)
    return blk_idx, slot_row


def make_expand_impact_scorer(precision: str = "f32"):
    """Batched block-layout scorer that expands its block gather tables
    on device (see expand_block_tables_dev). Drop-in for
    make_impact_scorer where the caller holds per-slot (block_start,
    block_count) ranges — the doc-sharded path's per-batch uploads drop
    from O(blocks) to O(slots)."""
    from searchlite.ops.precision import apply_matmul_precision

    apply_matmul_precision()
    import jax
    import jax.numpy as jnp

    from searchlite.ops.precision import m_store_dtype

    m_dtype = m_store_dtype(precision)

    @partial(jax.jit,
             static_argnames=("k", "s_pad", "nb_pad", "n_queries",
                              "use_filters"))
    def scorer(block_docs, block_impacts, deleted, slot_bstart,
               slot_bcnt, sentinel_row, w_idx, w_val, filter_rows, fidx,
               *, k: int, s_pad: int, nb_pad: int, n_queries: int,
               use_filters: bool = False):
        blk_idx, slot_row = expand_block_tables_dev(
            jnp, slot_bstart, slot_bcnt, sentinel_row, nb_pad)
        m = build_m_from_blocks(jnp, block_docs, block_impacts,
                                blk_idx, slot_row, deleted.shape[0],
                                s_pad, dtype=m_dtype)
        return _score_m(jax, jnp, m, deleted, w_idx, w_val,
                        k, s_pad, n_queries,
                        filter_rows if use_filters else None, fidx)

    return scorer


def make_split_impact_scorer(precision: str = "f32"):
    """Batched scorer with the dense/sparse slot split: high-df slots
    score through ONE direct matmul over the whole resident dense
    impact matrix ``m_dense [R+1, n1]`` — the weight matrix indexes
    dense ROWS, so there is no per-batch row gather (the K≈R matmul
    scales with R, not with the batch's selection). The sparse tail
    goes through the f32 block scatter. Scores are the sum of two
    matmuls — identical results to the plain scorer, far fewer
    update-bound scatter cycles on Zipf workloads."""
    from searchlite.ops.precision import (
        apply_matmul_precision,
        m_store_dtype,
    )

    apply_matmul_precision()
    import jax
    import jax.numpy as jnp

    m_dtype = m_store_dtype(precision)

    @partial(jax.jit,
             static_argnames=("k", "s_pad", "n_queries", "nb_pad",
                              "wd_pad", "ws_pad", "use_filters"))
    def scorer(block_docs, block_impacts, m_dense, deleted,
               packed, filter_rows, fidx,
               *, k: int, s_pad: int, n_queries: int, nb_pad: int,
               wd_pad: int, ws_pad: int, use_filters: bool = False):
        # packed int32 [2·nb_pad + 2·wd_pad + 2·ws_pad] — ONE per-batch
        # upload; sections sliced by the static bucketed lengths, f32
        # weight values bit-cast back (see split_impact_batch)
        bits = jax.lax.bitcast_convert_type
        o = 0
        blk_idx = packed[o:o + nb_pad]; o += nb_pad
        slot_row = packed[o:o + nb_pad]; o += nb_pad
        wd_idx = packed[o:o + wd_pad]; o += wd_pad
        wd_val = bits(packed[o:o + wd_pad], jnp.float32); o += wd_pad
        ws_idx = packed[o:o + ws_pad]; o += ws_pad
        ws_val = bits(packed[o:o + ws_pad], jnp.float32)
        n1 = deleted.shape[0]
        r1 = m_dense.shape[0]  # R+1 (last row zeros), static per array
        m_sparse = build_m_from_blocks(jnp, block_docs, block_impacts,
                                       blk_idx, slot_row, n1, s_pad,
                                       dtype=m_dtype)
        wd = _densify_w(jnp, wd_idx, wd_val, n_queries, r1)
        ws = _densify_w(jnp, ws_idx, ws_val, n_queries, s_pad)
        if m_dense.dtype != wd.dtype:
            wd = wd.astype(m_dense.dtype)
        if m_sparse.dtype != ws.dtype:
            ws = ws.astype(m_sparse.dtype)
        scores = (jnp.dot(wd, m_dense,
                          preferred_element_type=jnp.float32)
                  + jnp.dot(ws, m_sparse,
                            preferred_element_type=jnp.float32))
        ok = (scores > 0.0) & ~deleted[None, :]
        if use_filters:
            ok = ok & filter_rows[fidx]
        masked = jnp.where(ok, scores, -jnp.inf)
        return jax.lax.top_k(masked, k)

    return scorer


def _densify_w(jnp, w_idx, w_val, n_queries: int, s_count: int):
    w_flat = jnp.zeros(n_queries * s_count + w_idx.shape[0],
                       dtype=jnp.float32)
    w_flat = w_flat.at[w_idx].set(
        w_val, indices_are_sorted=True, unique_indices=True,
        mode="promise_in_bounds")
    return w_flat[: n_queries * s_count].reshape(n_queries, s_count)


def split_impact_batch(qb, dense_map: dict, n_rows: int, n1: int):
    """Re-arrange a build_impact_batch() output for the dense/sparse
    split scorer: slots whose term id is in ``dense_map`` become weight
    entries over the RESIDENT dense matrix's row axis ([Q, n_rows+1]
    COO — the scorer matmuls the whole m_dense, no row gather); the
    rest keep their block-gather tables. Vectorized (the headline path
    runs this per batch; a python per-entry loop cost ~10 ms). Returns
    None when no batch slot is dense (caller uses the plain scorer)."""
    tids = qb["slot_tids"]
    n_slots = qb["n_slots"]
    # per-slot dense row (−1 = sparse); dict lookups once per SLOT,
    # everything per-ENTRY below is numpy
    row_of = np.full(max(n_slots, 1), -1, dtype=np.int64)
    for s in range(n_slots):
        row_of[s] = dense_map.get(int(tids[s]), -1)
    if not (row_of >= 0).any():
        return None
    is_sparse = row_of < 0
    sp_of = np.cumsum(is_sparse) - 1  # sparse position per slot
    n_sparse = int(is_sparse.sum())
    s_pad = pow15_bucket(max(n_sparse, 8), minimum=8)
    r1 = n_rows + 1
    # sparse block tables
    sp_slots = np.flatnonzero(is_sparse)
    blk_idx, slot_row, nb_pad = build_block_tables(
        qb["slot_bstart"][sp_slots],
        qb["slot_bcnt"][sp_slots],
        sentinel_row=qb["sentinel_row"])
    # split the sorted COO weights (w_idx = qi*S_old + s_old)
    s_old = len(qb["slot_start"])
    nq = qb["n_queries"]
    w_idx = qb["w_idx"].astype(np.int64)
    w_val = qb["w_val"]
    qi = w_idx // s_old
    s = w_idx - qi * s_old
    real = qi < nq
    s_safe = np.minimum(s, max(n_slots - 1, 0))
    dense_e = real & (row_of[s_safe] >= 0)
    sparse_e = real & ~dense_e
    # dense entries: key = qi*(R+1) + row — rows aren't monotone in
    # slot order, so sort (stable, small array)
    wd_keys = qi[dense_e] * r1 + row_of[s_safe[dense_e]]
    order = np.argsort(wd_keys, kind="stable")
    wd_keys = wd_keys[order]
    wd_vals = w_val[dense_e][order]
    # sparse entries: sp_of is monotone in slot order, so entries stay
    # sorted by (qi, sparse position) — no sort needed
    ws_keys = qi[sparse_e] * s_pad + sp_of[s_safe[sparse_e]]
    ws_vals = w_val[sparse_e]

    def pack(keys, vals, width):
        pad = next_pow2(max(len(keys), 16))
        idxs = np.empty(pad, dtype=np.int32)
        out_vals = np.zeros(pad, dtype=np.float32)
        idxs[:len(keys)] = keys
        out_vals[:len(keys)] = vals
        idxs[len(keys):] = nq * width + np.arange(
            pad - len(keys), dtype=np.int32)
        return idxs, out_vals

    wd_idx, wd_val = pack(wd_keys, wd_vals, r1)
    ws_idx, ws_val = pack(ws_keys, ws_vals, s_pad)
    if s_pad * n1 + nb_pad * 128 >= 2**31:
        raise OverflowError(
            "impact matrix exceeds int32 indexing; shard the doc space")
    # one upload per batch (each eager transfer is a dispatch):
    # f32 weight values ride bit-cast in the same int32 vector, and the
    # scorer re-slices by the (bucketed, so static) section lengths
    packed = np.concatenate([
        blk_idx, slot_row,
        wd_idx, wd_val.view(np.int32),
        ws_idx, ws_val.view(np.int32)])
    return {
        "s_pad": s_pad,
        "packed": packed,
        "nb_pad": nb_pad,
        "wd_pad": len(wd_idx),
        "ws_pad": len(ws_idx),
        "blk_idx": blk_idx, "slot_row": slot_row,
        "wd_idx": wd_idx, "wd_val": wd_val,
        "ws_idx": ws_idx, "ws_val": ws_val,
    }


def build_block_tables(slot_bstart, slot_bcnt, sentinel_row: int,
                       min_blocks: int = 32, coarse: bool = False):
    """Expand per-slot block ranges into (blk_idx, slot_row) gather
    tables, padded to a pow-2 block bucket with the segment's sentinel
    block row (all pad docs → dump zone). Every pad slot is a wasted
    scatter update (the M build is update-count-bound), so the bucket
    ladder is pow-2 by default; ``coarse=True`` keeps the old pow-4
    ladder for compile-latency-sensitive callers (the single-query UB
    wave, whose scatter is tiny but whose shapes vary per query)."""
    starts = np.asarray(slot_bstart, dtype=np.int64)
    cnts = np.asarray(slot_bcnt, dtype=np.int64)
    total = int(cnts.sum())
    if coarse:
        nb_pad = pow4_bucket(max(total, 1), minimum=min_blocks)
    else:
        nb_pad = pow15_bucket(max(total, 1), minimum=min_blocks)
    blk_idx = np.full(nb_pad, sentinel_row, dtype=np.int32)
    slot_row = np.zeros(nb_pad, dtype=np.int32)
    if total:
        prev = np.concatenate([[0], np.cumsum(cnts)[:-1]])
        blk_idx[:total] = (np.repeat(starts - prev, cnts)
                           + np.arange(total)).astype(np.int32)
        slot_row[:total] = np.repeat(
            np.arange(len(cnts), dtype=np.int32), cnts)
    return blk_idx, slot_row, nb_pad
