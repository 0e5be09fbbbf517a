"""Doc-tile pruned execution: device-side block-max (WAND/BMW) pruning.

The reference prunes with a doc-at-a-time pivot loop over posting
cursors (`/root/reference/searchlite-core/src/query/wand.rs:659-903`):
term upper bounds + per-block max scores let it skip candidate docs
whose best-possible score can't reach the running top-k threshold. That
loop is inherently serial. The device formulation keeps the *bound
semantics* but changes the granularity to fixed doc-space tiles so the
bound check itself becomes a matmul:

1. **Index time** (host, cached per segment): the doc axis is cut into
   tiles of ``T`` docs. For every (term, tile) with postings, store the
   posting run (start, len) and the tile-max impact. Because postings
   are (term, doc)-sorted, each (term, tile) run is contiguous — the
   whole table is one vectorized pass. Tile maxes are packed into the
   same 128-wide block layout postings use, so the UB pass reuses the
   block-gather M build.

2. **Wave 1 — bounds**: ``UB[q, tile] = Σ_s W[q,s] · tilemax[s, tile]``
   — one small matmul (n_tiles ≈ n_docs/T columns). ``UB`` soundly
   bounds every doc's score in the tile: impacts ≥ 0, idf ≥ 1, and the
   score tree is a sum/dis-max (≤ sum for tie_breaker ≤ 1) of
   non-negative leaf scores.

3. **Wave 2 — seed**: exactly score the per-query top-C tiles by UB.
   All slots' postings inside a chosen tile are gathered (so every doc
   in a scored tile gets its COMPLETE score — matcher masks, must_not,
   filters all evaluate exactly there), densified into a compacted
   ``M2 [S, n_sel·T]`` and scored with ``W @ M2``. The k-th exact score
   per query is the threshold θ_q.

4. **Wave 3 — survivors** (often empty): score every remaining tile
   with ``UB[q, tile] ≥ θ_q`` for some q. After this wave every
   unscored tile has UB < θ for every query, so the merged per-query
   top-k is exact — including scores and the (score desc, doc asc) tie
   order: any doc tying the threshold lives in a tile with UB ≥ θ and
   was therefore scored. At most 3 waves, deterministically.

Exactness argument (the ``tests/pruning.rs:44-105`` contract): a true
top-k doc d has score(d) ≥ θ_q (θ_q is the k-th best of a subset of
exact scores), so d's tile has UB ≥ score(d) ≥ θ_q and is scored —
with ALL of d's postings, hence exactly. A doc in an unscored tile has
score ≤ UB < θ_q ≤ every true top-k score, so it can't displace one.

Pruned tiles are never gathered, never scattered, and never widen the
scoring matmul — unlike posting-block pruning, doc-tiles also capture
the docID-intersection effect (a rare term's tiles discipline a common
term's bound), which is where WAND's wins actually come from.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from searchlite.ops.impact import (
    build_block_tables,
    build_m_from_blocks,
    next_pow2,
    pow2_bucket,
    pow4_bucket,
)


def default_tile_width(n1: int, max_tiles: int = 4096,
                       minimum: int = 512) -> int:
    """Tile width: fine enough to prune, coarse enough that the UB
    matrix stays small (n_tiles ≤ max_tiles). Multiple of 128."""
    t = minimum
    while -(-n1 // t) > max_tiles:
        t += 128
    return t


class TileIndex:
    """Per-segment doc-tile tables (host + device), built lazily from a
    DeviceSegment's flat impact-ordered postings."""

    def __init__(self, dseg, tile_width: int | None = None):
        import jax.numpy as jnp  # noqa: PLC0415

        self.dseg = dseg
        n1 = dseg.n1
        T = tile_width or default_tile_width(n1)
        self.T = T
        self.n_tiles = -(-n1 // T)

        docs = dseg.docs_flat_np
        imps = dseg.impacts_flat_np
        postings = dseg.reader.postings
        term_df = postings.term_df.astype(np.int64)
        n_terms = len(term_df)
        # docs_flat_np is padded to length 1 for empty segments; guard
        total = int(term_df.sum())
        docs = docs[:total]
        imps = imps[:total]

        term_of = np.repeat(np.arange(n_terms, dtype=np.int64), term_df)
        tile_of = (docs // T).astype(np.int64)
        key = term_of * self.n_tiles + tile_of
        if total:
            is_start = np.empty(total, dtype=bool)
            is_start[0] = True
            np.not_equal(key[1:], key[:-1], out=is_start[1:])
            entry_start = np.flatnonzero(is_start).astype(np.int64)
            entry_len = np.diff(np.append(entry_start, total))
            self.entry_term = term_of[entry_start]
            self.entry_tile = tile_of[entry_start].astype(np.int32)
            self.entry_max = np.maximum.reduceat(imps, entry_start)
        else:
            entry_start = np.zeros(0, dtype=np.int64)
            entry_len = np.zeros(0, dtype=np.int64)
            self.entry_term = np.zeros(0, dtype=np.int64)
            self.entry_tile = np.zeros(0, dtype=np.int32)
            self.entry_max = np.zeros(0, dtype=np.float32)
        self.entry_start = entry_start
        self.entry_len = entry_len
        # per-term entry CSR (entry_term ascending)
        self.entry_base = np.searchsorted(
            self.entry_term, np.arange(n_terms + 1))

        # pack (tile, max) entries into the 128-wide block layout so the
        # UB pass reuses build_m_from_blocks; pad tile = n_tiles routes
        # to the scatter dump zone (n_t1 = n_tiles + 1 columns)
        n_entries = len(entry_start)
        counts = np.diff(self.entry_base)
        eb_cnt = -(-counts // 128)
        self.eb_start = np.concatenate(
            [[0], np.cumsum(eb_cnt)]).astype(np.int64)
        self.eb_cnt = eb_cnt.astype(np.int64)
        total_eb = int(self.eb_start[-1])
        tl_docs = np.full((total_eb + 1, 128), self.n_tiles,
                          dtype=np.int32)
        tl_maxes = np.zeros((total_eb + 1, 128), dtype=np.float32)
        if n_entries:
            run_of = np.repeat(np.arange(n_terms, dtype=np.int64), counts)
            offset = np.arange(n_entries, dtype=np.int64) \
                - self.entry_base[:-1][run_of]
            dest = self.eb_start[:-1][run_of] * 128 + offset
            tl_docs.reshape(-1)[dest] = self.entry_tile
            tl_maxes.reshape(-1)[dest] = self.entry_max
        self.sentinel_row = total_eb
        self.tile_docs = jnp.asarray(tl_docs)
        self.tile_maxes = jnp.asarray(tl_maxes)
        self._deleted_pad = None
        self._jnp = jnp

    # -- wave-1 helpers ------------------------------------------------------

    def clone_for(self, dseg):
        """Shallow copy bound to a tombstone-delta DeviceSegment
        clone: the tile tables (entry runs, tile maxes) are built from
        raw impacts so they stay sound and shared; only the
        deletion-derived device mask rebuilds (deleted_cols reads
        dseg.deleted_np live, deleted_tiles re-uploads lazily)."""
        import copy

        tl = copy.copy(self)
        tl.dseg = dseg
        tl._deleted_pad = None
        return tl

    def ub_block_tables(self, slot_tids):
        """Block-gather tables over the tile-max layout for the given
        slot terms ([nb], [nb], nb_pad) — same shape contract as
        build_block_tables over postings."""
        starts = self.eb_start[slot_tids] if len(slot_tids) else \
            np.zeros(0, dtype=np.int64)
        cnts = self.eb_cnt[slot_tids] if len(slot_tids) else \
            np.zeros(0, dtype=np.int64)
        return build_block_tables(starts, cnts,
                                  sentinel_row=self.sentinel_row,
                                  coarse=True)

    # -- wave-2/3 helpers ----------------------------------------------------

    def run_tables(self, slot_tids, tiles: np.ndarray):
        """Posting runs restricted to the selected (sorted) tiles.

        Returns dict with ``packed``/``packed_fmt`` (pack_runs: the
        start/off/len/slot arrays as ONE [3 or 4, r_pad] int32 upload,
        pow-4 bucketed) + p_pad + n_cols. Destination column of doc d
        in a run for tile τ at rank r: d − τ·T + r·T, i.e.
        run_off = (r − τ)·T. Runs are emitted slot-major with tiles
        ascending, and docs ascend within a run, so the scatter's flat
        indices are sorted + unique."""
        n_sel = len(tiles)
        e_hit, pos_hit, slot_hit = self._entry_hits(slot_tids, tiles)
        if len(e_hit):
            run_start = self.entry_start[e_hit]
            run_len = self.entry_len[e_hit]
            run_slot = slot_hit
            run_off = (pos_hit.astype(np.int64)
                       - self.entry_tile[e_hit]) * self.T
        else:
            run_start = np.zeros(0, dtype=np.int64)
            run_len = np.zeros(0, dtype=np.int64)
            run_slot = np.zeros(0, dtype=np.int64)
            run_off = np.zeros(0, dtype=np.int64)
        total = int(run_len.sum())
        r_pad = pow4_bucket(max(len(run_start), 1), minimum=64)
        p_pad = pow4_bucket(max(total, 1), minimum=1024)
        packed, fmt = pack_runs(run_start, run_off, run_len, run_slot,
                                r_pad)
        return {
            "packed": packed,
            "packed_fmt": fmt,
            "p_pad": p_pad,
            "n_cols": n_sel * self.T,
            "postings": total,
        }

    def pad_tiles(self, tiles: np.ndarray) -> np.ndarray:
        """Pad a sorted tile selection to a pow2 count with sentinel
        tiles (= n_tiles, past the doc space). Wave shapes then fall
        into compile-cache buckets instead of recompiling the run
        scorer per distinct survivor count. Sentinel columns are out of
        doc range: gather_cols fills them (deleted=True), run_tables
        matches no entries, so they score -inf and never surface."""
        from searchlite.ops.impact import next_pow2  # noqa: PLC0415

        n = len(tiles)
        width = next_pow2(max(n, 1))
        if width == n:
            return tiles
        out = np.full(width, self.n_tiles, dtype=np.int64)
        out[:n] = tiles
        return out

    def _entry_hits(self, slot_tids, tiles: np.ndarray):
        """Shared CSR expansion for run_tables/tile_postings: expand
        every slot's (term, tile) entry range, match against the sorted
        tile selection with one searchsorted. Returns (entry_idx,
        tile_rank, slot) arrays for the matching entries."""
        n_sel = len(tiles)
        tids = np.asarray(slot_tids, dtype=np.int64)
        if n_sel == 0 or len(tids) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z
        lo = self.entry_base[tids]
        counts = self.entry_base[tids + 1] - lo
        total = int(counts.sum())
        bases = np.concatenate([[0], np.cumsum(counts)[:-1]])
        e_idx = (np.repeat(lo - bases, counts)
                 + np.arange(total, dtype=np.int64))
        slot_of = np.repeat(np.arange(len(tids), dtype=np.int64), counts)
        etiles = self.entry_tile[e_idx]
        pos = np.searchsorted(tiles, etiles)
        pos_c = np.minimum(pos, n_sel - 1)
        hit = tiles[pos_c] == etiles
        return e_idx[hit], pos_c[hit], slot_of[hit]

    def run_tables_per_query(self, q_tids: np.ndarray,
                             q_tiles: np.ndarray, tpq_pad: int):
        """Per-QUERY posting runs: query q's OWN terms restricted to
        q's OWN selected tiles — the batched pruning formulation that
        keeps each query's candidate set private (the union-of-tiles
        wave degrades to a full corpus scan on Zipf batches; per-query
        candidate sets stay tiny, which is where WAND's wins live —
        confirmed by the C++ baseline's bmw numbers at 1M docs).

        q_tids [Q, tpq_pad] int64: term ids per query (−1 pads).
        q_tiles [Q, C] int64: each query's selected tiles, ASCENDING
        per row (sentinel = n_tiles pads, matched against nothing).

        Returns runs for build_m_from_runs over the compacted output
        space M_b [Q·tpq_pad, C·T]: destination col of doc d for
        query q, term slot ti, tile rank r is r·T + (d − tile·T), and
        run_slot = q·tpq_pad + ti — flat indices sorted + unique by
        construction ((q, ti, tile) emission order, docs ascending in
        a run).

        The four run arrays ship as ONE device upload ``packed``
        (each eager transfer costs a dispatch): ``[3, r_pad]``
        int32 with rows (start, off, slot<<16 | len) when len fits 16
        bits and slot fits 15 (always, for tile widths < 65536 and
        wave widths < 32768 rows), else the explicit ``[4, r_pad]``
        (start, off, len, slot). ``packed_fmt`` says which; the pq
        scorer unpacks on device (make_pq_run_scorer)."""
        Q, C = q_tiles.shape
        tids_flat = q_tids.reshape(-1)
        valid_t = tids_flat >= 0
        safe_tids = np.where(valid_t, tids_flat, 0)
        lo = self.entry_base[safe_tids]
        counts = np.where(valid_t,
                          self.entry_base[safe_tids + 1] - lo, 0)
        total = int(counts.sum())
        if total == 0 or C == 0:
            return {"packed": np.zeros((3, 64), dtype=np.int32),
                    "packed_fmt": 3,
                    "p_pad": 1024, "n_cols": C * self.T, "postings": 0}
        bases = np.concatenate([[0], np.cumsum(counts)[:-1]])
        e_idx = (np.repeat(lo - bases, counts)
                 + np.arange(total, dtype=np.int64))
        row_of = np.repeat(np.arange(Q * tpq_pad, dtype=np.int64),
                           counts)
        etiles = self.entry_tile[e_idx].astype(np.int64)
        # match each entry's tile against ITS query's sorted tile row
        q_of = row_of // tpq_pad
        qt = q_tiles  # [Q, C] sorted ascending per row
        pos = np.zeros(total, dtype=np.int64)
        # vectorized per-row searchsorted: flatten with per-row offsets
        # over a globally sorted key (q * (n_tiles+2) + tile)
        keys = q_of * (self.n_tiles + 2) + etiles
        flat_tiles = (np.arange(Q, dtype=np.int64)[:, None]
                      * (self.n_tiles + 2) + qt).reshape(-1)
        pos = np.searchsorted(flat_tiles, keys)
        pos_c = np.minimum(pos, Q * C - 1)
        hit = flat_tiles[pos_c] == keys
        e_hit = e_idx[hit]
        rank_hit = (pos_c[hit] % C).astype(np.int64)
        row_hit = row_of[hit]
        run_start = self.entry_start[e_hit]
        run_len = self.entry_len[e_hit]
        run_off = (rank_hit - etiles[hit]) * self.T
        total_p = int(run_len.sum())
        r_pad = next_pow2(max(len(run_start), 64))
        p_pad = pow2_bucket(max(total_p, 1), minimum=1024)
        packed, fmt = pack_runs(run_start, run_off, run_len, row_hit,
                                r_pad)
        return {
            "packed": packed,
            "packed_fmt": fmt,
            "p_pad": p_pad,
            "n_cols": C * self.T,
            "postings": total_p,
        }

    def tile_postings(self, slot_tids, tiles: np.ndarray) -> np.ndarray:
        """Posting count per selected tile, summed over the given slots
        ([n_sel] int64). Used to bound wave launches by the device-side
        posting intermediates, not just the M matrix."""
        out = np.zeros(len(tiles), dtype=np.int64)
        e_hit, pos_hit, _slot = self._entry_hits(slot_tids, tiles)
        if len(e_hit):
            np.add.at(out, pos_hit, self.entry_len[e_hit])
        return out

    def gather_cols(self, arr: np.ndarray, tiles: np.ndarray,
                    fill=0) -> np.ndarray:
        """Gather a host [-1, n1] (or [n1]) doc-axis array into tile
        space [..., n_sel·T]; positions past n1 take ``fill``."""
        n1 = self.dseg.n1
        cols = (tiles.astype(np.int64)[:, None] * self.T
                + np.arange(self.T, dtype=np.int64)[None, :]).reshape(-1)
        oob = cols >= n1
        safe = np.where(oob, 0, cols)
        out = np.asarray(arr)[..., safe].copy()
        if np.any(oob):
            out[..., oob] = fill
        return out

    def deleted_cols(self, tiles: np.ndarray) -> np.ndarray:
        """Deleted mask in tile space (out-of-range cols deleted)."""
        return self.gather_cols(self.dseg.deleted_np, tiles, fill=True)

    @property
    def deleted_tiles(self):
        """Device-resident deleted mask in tile layout [n_tiles+1, T]
        (sentinel row all-deleted). Wave launches row-gather this by
        tile instead of uploading an [n_cols] bool per launch — at 5M
        docs that upload was ~5 MB per wave over the host link; the
        row gather runs near memory speed on device."""
        if self._deleted_pad is None:
            dp = np.ones((self.n_tiles + 1, self.T), dtype=bool)
            flat = dp[: self.n_tiles].reshape(-1)
            flat[: self.dseg.n1] = self.dseg.deleted_np
            self._deleted_pad = self._jnp.asarray(dp)
        return self._deleted_pad

    def map_ids(self, tiles: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Map compacted top-k ids back to doc ordinals."""
        t = tiles[np.minimum(ids // self.T, len(tiles) - 1)]
        return t.astype(np.int64) * self.T + ids % self.T


def _pad_i32(arr, width):
    out = np.zeros(width, dtype=np.int32)
    out[:len(arr)] = arr
    return out


def pack_runs(run_start, run_off, run_len, run_slot, r_pad: int):
    """Pack the four run arrays into one [3, r_pad] int32 upload
    (start, off, slot<<16 | len) when len fits 16 bits and slot 15,
    else the explicit [4, r_pad]. Returns (packed, fmt).
    SEARCHLITE_RUNS_FMT=4 forces the explicit format (tests exercise
    the fallback end-to-end; it only engages naturally at >=2^15-row
    waves)."""
    import os  # noqa: PLC0415

    n_runs = len(run_start)
    if os.environ.get("SEARCHLITE_RUNS_FMT") == "4":
        pass  # fall through to the explicit format
    elif (n_runs == 0 or (run_len.max(initial=0) < (1 << 16)
                          and run_slot.max(initial=0) < (1 << 15))):
        packed = np.zeros((3, r_pad), dtype=np.int32)
        packed[0, :n_runs] = run_start
        packed[1, :n_runs] = run_off
        packed[2, :n_runs] = (np.asarray(run_slot) << 16) | run_len
        return packed, 3
    packed = np.zeros((4, r_pad), dtype=np.int32)
    packed[0, :n_runs] = run_start
    packed[1, :n_runs] = run_off
    packed[2, :n_runs] = run_len
    packed[3, :n_runs] = run_slot
    return packed, 4


def unpack_runs(jax, runs, fmt: int):
    """Device-side inverse of pack_runs: (start, len, slot, off)."""
    if fmt == 3:
        return (runs[0], runs[2] & 0xFFFF,
                jax.lax.shift_right_logical(runs[2], 16), runs[1])
    return runs[0], runs[2], runs[3], runs[1]


def unpack_runs_np(packed: np.ndarray, fmt: int):
    """Host (numpy) inverse of pack_runs — tests/debugging."""
    if fmt == 3:
        return (packed[0], packed[2] & 0xFFFF,
                (packed[2] >> 16) & 0x7FFF, packed[1])
    return packed[0], packed[2], packed[3], packed[1]


def get_tile_index(dseg, tile_width: int | None = None) -> TileIndex:
    """Process-cached per (segment, width). SEARCHLITE_TILE_WIDTH
    overrides the default width (tests use tiny widths to force the
    pruning machinery onto many tiles)."""
    import os

    if tile_width is None:
        tile_width = int(os.environ.get("SEARCHLITE_TILE_WIDTH", 0)) or None
    cached = getattr(dseg, "_tile_index", None)
    if cached is not None and cached.T == (tile_width or cached.T):
        return cached
    tl = TileIndex(dseg, tile_width)
    dseg._tile_index = tl
    return tl


# -- device kernels ------------------------------------------------------


def build_m_from_runs(jnp, docs_flat, impacts_flat, run_start, run_len,
                      run_slot, run_off, n_cols: int, s_pad: int,
                      p_pad: int, dtype=None):
    """Densify posting RUNS (contiguous CSR slices with per-run
    destination column offsets) into a compacted M [s_pad, n_cols].
    Generalizes build_m: runs are (slot, tile) intersections instead of
    whole slots. flat indices are sorted + unique by construction (see
    TileIndex.run_tables)."""
    ends = jnp.cumsum(run_len)
    total = ends[-1]
    positions = jnp.arange(p_pad, dtype=jnp.int32)
    marks = jnp.zeros(p_pad, dtype=jnp.int32).at[ends].add(
        1, mode="drop")
    rid = jnp.cumsum(marks)
    valid = positions < total
    n_runs = run_start.shape[0]
    rid_safe = jnp.minimum(rid, n_runs - 1)
    begin = ends - run_len
    p_idx = run_start[rid_safe] + (positions - begin[rid_safe])
    p_idx = jnp.where(valid, p_idx, 0)
    dest = docs_flat[p_idx] + run_off[rid_safe]
    impacts = jnp.where(valid, impacts_flat[p_idx], 0.0)
    target = dtype if dtype is not None else jnp.float32
    if impacts.dtype != target:
        impacts = impacts.astype(target)
    flat_idx = jnp.where(
        valid,
        run_slot[rid_safe] * n_cols + dest,
        s_pad * n_cols + (positions - total))
    m_flat = jnp.zeros(s_pad * n_cols + p_pad, dtype=impacts.dtype)
    m_flat = m_flat.at[flat_idx].set(
        impacts, indices_are_sorted=True, unique_indices=True,
        mode="promise_in_bounds")
    return m_flat[: s_pad * n_cols].reshape(s_pad, n_cols)


def make_ub_scorer():
    """Wave-1: the full UB matrix [Q, n_t1] = W @ TileMax (no top-k —
    the host needs every tile's bound for seed choice + the survivor
    check). Bounds are inflated by UB_SAFETY so fast-mode matmul
    rounding (bf16 inputs, ~2^-8 relative) can never underestimate a
    tile's true bound and unsoundly prune a top-k doc's tile
    (ops/precision.py); returned scores are unaffected."""
    from searchlite.ops.precision import (
        UB_SAFETY,
        apply_matmul_precision,
    )

    apply_matmul_precision()
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("n_t1", "s_pad", "n_queries"))
    def ub(tile_docs, tile_maxes, blk_idx, slot_row, w_idx, w_val,
           *, n_t1: int, s_pad: int, n_queries: int):
        m = build_m_from_blocks(jnp, tile_docs, tile_maxes, blk_idx,
                                slot_row, n_t1, s_pad)
        w_flat = jnp.zeros(n_queries * s_pad + w_idx.shape[0],
                           dtype=jnp.float32)
        w_flat = w_flat.at[w_idx].set(
            w_val, indices_are_sorted=True, unique_indices=True,
            mode="promise_in_bounds")
        w = w_flat[: n_queries * s_pad].reshape(n_queries, s_pad)
        return jnp.dot(w, m,
                       preferred_element_type=jnp.float32) * UB_SAFETY

    return ub


def make_seed_selector():
    """Device-side per-query tile selection: top-C tiles by UB among
    those not yet processed and strictly above (theta, 0). Returns
    (tile ids [Q, C] int32 — n_tiles sentinel where none qualify —
    and the remaining qualifying count [Q] AFTER this selection).
    Keeping selection on device avoids fetching the [Q, n_tiles] UB
    matrix over the host link (16 MB/batch at 5M docs)."""
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("c",))
    def select(ub, processed, theta, *, c: int):
        n_tiles = ub.shape[1]
        eligible = (~processed) & (ub > 0.0) \
            & (ub >= theta[:, None])
        masked = jnp.where(eligible, ub, -jnp.inf)
        vals, ids = jax.lax.top_k(masked, min(c, n_tiles))
        ids = jnp.where(vals > -jnp.inf, ids, n_tiles).astype(jnp.int32)
        remaining = jnp.maximum(
            jnp.sum(eligible, axis=1) - jnp.sum(vals > -jnp.inf, axis=1),
            0)
        marks = jax.vmap(
            lambda p, i: p.at[i].set(True, mode="drop"))(
                jnp.zeros_like(processed), ids)
        return ids, remaining, processed | marks

    return select


def make_pq_run_scorer():
    """Per-query wave scorer: M_b [Q·tpq, C·T] from per-query runs,
    batched matvec against each query's term weights, top-k over the
    query's OWN compacted columns, ids mapped back to doc ordinals on
    device. Returns (scores [Q,k], doc ids [Q,k] int32)."""
    from searchlite.ops.precision import (
        apply_matmul_precision,
        m_store_dtype,
    )

    apply_matmul_precision()
    import os

    import jax
    import jax.numpy as jnp

    m_dtype = m_store_dtype(os.environ.get("SEARCHLITE_PRECISION",
                                           "f32"))

    @partial(jax.jit,
             static_argnames=("k", "n_cols", "p_pad", "tpq_pad", "t",
                              "fmt"))
    def scorer(docs_flat, impacts_flat, deleted_tiles, tiles_b, w_b,
               runs, *, k: int, n_cols: int, p_pad: int, tpq_pad: int,
               t: int, fmt: int = 3):
        # one [fmt, r_pad] upload per wave (run_tables_per_query)
        run_start, run_len, run_slot, run_off = unpack_runs(
            jax, runs, fmt)
        q = tiles_b.shape[0]
        m = build_m_from_runs(jnp, docs_flat, impacts_flat, run_start,
                              run_len, run_slot, run_off, n_cols,
                              q * tpq_pad, p_pad, dtype=m_dtype)
        m3 = m.reshape(q, tpq_pad, n_cols)
        w3 = w_b.astype(m.dtype) if m.dtype != w_b.dtype else w_b
        scores = jnp.einsum("qt,qtc->qc", w3, m3,
                            preferred_element_type=jnp.float32)
        # deleted mask in each query's tile space (row gathers from the
        # resident padded copy; sentinel tile row is all-deleted)
        del_cols = deleted_tiles[tiles_b].reshape(q, n_cols)
        ok = (scores > 0.0) & ~del_cols
        masked = jnp.where(ok, scores, -jnp.inf)
        top, idx = jax.lax.top_k(masked, min(k, n_cols))
        # map compacted idx -> doc ordinal: tile = tiles_b[q, idx // T]
        tile_of = jnp.take_along_axis(tiles_b, idx // t, axis=1)
        doc_ids = (tile_of * t + idx % t).astype(jnp.int32)
        doc_ids = jnp.where(top > -jnp.inf, doc_ids, 0)
        return top, doc_ids

    return scorer


def make_topk_merge():
    """Device-side running top-k merge of two (scores, ids) sets with
    (score desc, doc asc) tie order, plus the per-query threshold at
    each query's own limit."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def merge(s_a, d_a, s_b, d_b, lims):
        s = jnp.concatenate([s_a, s_b], axis=1)
        d = jnp.concatenate([d_a, d_b], axis=1)
        k = s_a.shape[1]
        # (score desc, doc asc): sort by score desc with doc as the
        # secondary key folded in — scores are f32, fold via lexsort
        # emulation: primary sort on score, stable tiebreak by doc
        # using a compound key (score, -doc) is wrong for floats; use
        # argsort over a structured ordering instead: sort indices by
        # (-score, doc) via two stable argsorts
        order_doc = jnp.argsort(d, axis=1, stable=True)
        s1 = jnp.take_along_axis(s, order_doc, axis=1)
        d1 = jnp.take_along_axis(d, order_doc, axis=1)
        order_sc = jnp.argsort(-s1, axis=1, stable=True)
        s2 = jnp.take_along_axis(s1, order_sc, axis=1)[:, :k]
        d2 = jnp.take_along_axis(d1, order_sc, axis=1)[:, :k]
        valid = (s2 > -jnp.inf).sum(axis=1)
        full = valid >= lims
        li = jnp.maximum(jnp.minimum(lims, s2.shape[1]) - 1, 0)
        theta = jnp.take_along_axis(s2, li[:, None], axis=1)[:, 0]
        theta = jnp.where(full, theta, -jnp.inf)
        return s2, d2, theta

    return merge


def make_run_batch_scorer():
    """Wave-2/3 batched scorer over compacted tile columns."""
    from searchlite.ops.precision import apply_matmul_precision

    apply_matmul_precision()
    import jax
    import jax.numpy as jnp

    @partial(jax.jit,
             static_argnames=("k", "n_cols", "p_pad", "s_pad",
                              "n_queries", "use_filters", "fmt"))
    def scorer(docs_flat, impacts_flat, deleted_tiles, tiles,
               runs, w_idx, w_val, filter_rows, fidx,
               *, k: int, n_cols: int, p_pad: int, s_pad: int,
               n_queries: int, use_filters: bool = False,
               fmt: int = 3):
        run_start, run_len, run_slot, run_off = unpack_runs(
            jax, runs, fmt)
        m = build_m_from_runs(jnp, docs_flat, impacts_flat, run_start,
                              run_len, run_slot, run_off, n_cols, s_pad,
                              p_pad)
        # tile-space deleted mask: row gather from the resident padded
        # copy (no per-launch host upload)
        deleted_cols = deleted_tiles[tiles].reshape(-1)
        w_flat = jnp.zeros(n_queries * s_pad + w_idx.shape[0],
                           dtype=jnp.float32)
        w_flat = w_flat.at[w_idx].set(
            w_val, indices_are_sorted=True, unique_indices=True,
            mode="promise_in_bounds")
        w = w_flat[: n_queries * s_pad].reshape(n_queries, s_pad)
        scores = jnp.dot(w, m, preferred_element_type=jnp.float32)
        ok = (scores > 0.0) & ~deleted_cols[None, :]
        if use_filters:
            ok = ok & filter_rows[fidx]
        masked = jnp.where(ok, scores, -jnp.inf)
        return jax.lax.top_k(masked, k)

    return scorer
