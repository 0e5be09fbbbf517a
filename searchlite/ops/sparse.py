"""Fully-sparse batched scoring: top-k over gathered candidates only.

The dense batched scorer (ops/impact.py) materializes scores for EVERY
doc: ``W [Q,S] @ M [S,n1]`` — at small corpora that spends ~99.6% of
its FLOPs on zeros (the headline workload touches ~1.6k postings per
query out of 100k docs), which is why a single CPU core running the
reference's brute TAAT loop (`searchlite-core/src/query/wand.rs:459-566`,
re-measured here by native/slt_cpu_engine.cpp) beat the round-2 device
headline ~3x at 100k docs.

This scorer never touches the doc axis. Per query it gathers ONLY the
posting blocks of its own terms into a ``[B, L]`` candidate strip
(L = padded posting count), then:

1. block-row gather of (doc, impact·weight) — contiguous 128-wide
   rows rather than element gathers (ops/impact.py),
2. per-row sort by doc id (``lax.sort``; duplicate docs — a doc
   matching several query terms — become adjacent runs),
3. segmented Hillis-Steele sum combines each run in ``ceil_log2(T)``
   shifted adds (runs are at most T = terms-per-query long, so no
   long-scan machinery and no cumsum cancellation),
4. ``lax.top_k`` over the L candidates (not over n1 docs). Candidate
   positions are doc-ascending, so top_k's lowest-position tie-break
   reproduces the dense scorer's (score desc, doc asc) order exactly.

The sort's work grows with the candidates, not with the corpus, which
is why it beats the dense matmul when candidates << corpus
(tools/probe_sparse.py compares the two on the device).

The reader routes batched queries here when their padded posting count
stays under SEARCHLITE_SPARSE_MAX_BLOCKS blocks (heavy queries — ones
containing a corpus-head term — keep the dense path, whose cost is flat
in df; see api/reader.py::_launch_batch_segment). Everything here is
exact: same candidates, same f32 scoring semantics, verified in-run by
bench.py's oracle gate and fuzzed against the dense path in
tests/test_sparse_batch.py.
"""

from __future__ import annotations

import os
from functools import partial

import numpy as np

from searchlite.ops.impact import next_pow2, pow15_bucket


# Packed per-(query, slot) upload format (partition_sparse_batch_packed
# / make_sparse_candidate_scorer_packed): one int32 carries the term id
# in the low 26 bits and the within-query occurrence count in bits
# 26..30 (sign bit stays clear). Segments with >=2^26 terms or queries
# repeating one term >31 times fall back to the explicit-table path.
TID_BITS = 26
TID_LIMIT = 1 << TID_BITS
OCC_MAX = 31


def _strip_gather(jax, jnp, block_docs, block_impacts, bstart, bcnt,
                  w, sentinel_row, *, t_pad: int, nblk: int):
    """Gather each row's posting blocks into an UNSORTED candidate
    strip: (d, v, t_slot) [B, nblk·128] — docs, weighted
    contributions, and each position's owning term slot (slot
    segments are contiguous; docs ascend within a segment)."""
    B = bstart.shape[0]
    cum = jnp.cumsum(bcnt, axis=1)                       # [B, T]
    total = cum[:, -1]
    pos = jnp.arange(nblk, dtype=jnp.int32)
    # owning term slot per gathered block: #{t : cum[t] <= pos}
    t_of = (pos[None, None, :] >= cum[:, :, None]).sum(
        axis=1).astype(jnp.int32)                        # [B, nblk]
    valid = pos[None, :] < total[:, None]
    t_safe = jnp.minimum(t_of, t_pad - 1)
    begin = cum - bcnt
    blk = (jnp.take_along_axis(bstart, t_safe, axis=1)
           + (pos[None, :] - jnp.take_along_axis(begin, t_safe,
                                                 axis=1)))
    blk_idx = jnp.where(valid, blk, sentinel_row)
    w_blk = jnp.take_along_axis(w, t_safe, axis=1)
    d = block_docs[blk_idx].reshape(B, nblk * 128)
    imps = block_impacts[blk_idx]
    if imps.dtype != jnp.float32:  # bf16 device storage (D8)
        imps = imps.astype(jnp.float32)
    v = (imps * w_blk[:, :, None]).reshape(B, nblk * 128)
    t_slot = jnp.broadcast_to(
        t_safe[:, :, None], (B, nblk, 128)).reshape(B, nblk * 128)
    return d, v, t_slot


def _strip_gather_scan(jax, jnp, block_docs, block_impacts, bstart,
                       bcnt, w, sentinel_row, sentinel_doc, *,
                       t_pad: int, nblk: int, log2_run: int):
    """Gather each row's posting blocks into a candidate strip, sort
    by doc, and combine duplicate-doc runs. Operands bstart/bcnt/w are
    [B, t_pad] (block start, block count — 0 for unused slots — and
    f32 weight per slot). Returns (d, v, ok): sorted candidate docs,
    run-total values, and the run-end match mask."""
    B = bstart.shape[0]
    d, v, _t_slot = _strip_gather(
        jax, jnp, block_docs, block_impacts, bstart, bcnt, w,
        sentinel_row, t_pad=t_pad, nblk=nblk)
    d, v = jax.lax.sort((d, v), num_keys=1, dimension=1)
    # segmented inclusive scan: runs (equal doc) are <= 2^log2_run
    # long (a doc appears at most once per term slot)
    off = 1
    for _ in range(log2_run):
        same = d[:, off:] == d[:, :-off]
        v = jnp.concatenate(
            [v[:, :off],
             v[:, off:] + jnp.where(same, v[:, :-off], 0.0)],
            axis=1)
        off *= 2
    run_end = jnp.concatenate(
        [d[:, 1:] != d[:, :-1], jnp.ones((B, 1), dtype=bool)],
        axis=1)
    ok = run_end & (d != sentinel_doc) & (v > 0.0)
    return d, v, ok


def _strip_prune_core(jax, jnp, d, v, t_of, sentinel_doc, *,
                      k: int, c: int, t_pad: int, chunk: int = 512):
    """SORT-FREE strip combine — RECORDED NEGATIVE RESULT, not wired
    into any production path. The kernel is exact on certified rows
    and 2-3x cheaper than the sort at small C, but its exactness
    certificate passes ~0% of rows on strips gathered from the real
    headline corpus (BM25 impacts are nearly flat, so the missed-doc
    bound lands on θ — WAND's classic flat-impact weakness). Kept
    with tools/probe_strip_prune.py as the documented experiment; see
    docs/architecture.md "Why the strip sort stays". Mechanism:

    1. overselect the row's top-``c`` single contributions
       (``lax.top_k(v, c)`` — O(L·log c) vs the sort's O(L·log²L));
    2. combine ONLY those candidates' docs by an equality contraction
       against the whole strip, scanned in fixed-size chunks
       (``combined[b,i] = Σ_l v[b,l]·[d[b,l] = dc[b,i]]`` — dense
       elementwise work, no random access, no binary search);
    3. rank candidates by (score desc, doc asc) with a tiny [B, c]
       two-pass stable argsort;
    4. EXACTNESS CERTIFICATE per row, per-slot: every missed doc's
       combined score is ≤ ``bound = Σ_t m_t`` where ``m_t`` is the
       largest UNSELECTED contribution in slot t (a slot whose
       postings were all selected contributes 0 — tail terms usually
       vanish from the bound entirely, which is what makes it tight
       on Zipf queries). If ``bound < θ_k`` (strict — a tie could
       still displace on doc order), or ``bound ≤ 0`` (non-candidates
       can't score positive at all), the top-k is provably the
       full-sort result. Rows failing the certificate return
       ``ok=False`` and must be re-scored by the sort path (exactness
       is structural, the certificate only decides WHICH path
       answered).

    ``t_of`` [B, L] int32 is each strip position's owning slot (free
    from the gather). Summation order differs from the sort path's
    shifted-add tree (D10-class f32 ulps). Returns (ts [B,k],
    td [B,k] int32, ok [B] bool)."""
    B, L = d.shape
    c = min(max(c, k), L)
    s_c, p_c = jax.lax.top_k(v, c)
    dc = jnp.take_along_axis(d, p_c, axis=1)                # [B, c]

    # selected-position mask (unique indices per row: top_k positions)
    sel = jnp.zeros((B, L), dtype=bool)
    sel = sel.at[jnp.arange(B)[:, None], p_c].set(
        True, unique_indices=True)

    n_chunks = -(-L // chunk)
    pad = n_chunks * chunk - L
    if pad:
        d = jnp.pad(d, ((0, 0), (0, pad)),
                    constant_values=sentinel_doc)
        v = jnp.pad(v, ((0, 0), (0, pad)))
        sel = jnp.pad(sel, ((0, 0), (0, pad)),
                      constant_values=True)
        t_of = jnp.pad(t_of, ((0, 0), (0, pad)))
    d3 = d.reshape(B, n_chunks, chunk).transpose(1, 0, 2)
    v3 = v.reshape(B, n_chunks, chunk).transpose(1, 0, 2)
    s3 = sel.reshape(B, n_chunks, chunk).transpose(1, 0, 2)
    t3 = t_of.reshape(B, n_chunks, chunk).transpose(1, 0, 2)
    slot_ids = jnp.arange(t_pad, dtype=jnp.int32)

    def body(carry, xs):
        acc, m = carry
        cd, cv, cs, ct = xs
        eq = cd[:, None, :] == dc[:, :, None]               # [B,c,ch]
        acc = acc + jnp.where(eq, cv[:, None, :], 0.0).sum(-1)
        # per-slot max of UNSELECTED contributions (certificate)
        v_un = jnp.where(cs, 0.0, cv)                       # [B, ch]
        eqt = ct[:, None, :] == slot_ids[None, :, None]     # [B,T,ch]
        m = jnp.maximum(
            m, jnp.where(eqt, v_un[:, None, :], 0.0).max(-1))
        return (acc, m), None

    (combined, m_slot), _ = jax.lax.scan(
        body,
        (jnp.zeros((B, c), dtype=jnp.float32),
         jnp.zeros((B, t_pad), dtype=jnp.float32)),
        (d3, v3, s3, t3))
    bound = m_slot.sum(axis=1)                              # [B]

    # one representative per doc: drop candidates whose doc already
    # appears at an earlier-selected strip position
    dup_earlier = ((dc[:, :, None] == dc[:, None, :])
                   & (p_c[:, None, :] < p_c[:, :, None])).any(-1)
    valid = (~dup_earlier) & (combined > 0.0) & (dc != sentinel_doc)
    scores = jnp.where(valid, combined, -jnp.inf)

    # (score desc, doc asc): stable argsort by doc, then by -score
    o1 = jnp.argsort(dc, axis=1, stable=True)
    s1 = jnp.take_along_axis(scores, o1, axis=1)
    d1 = jnp.take_along_axis(dc, o1, axis=1)
    o2 = jnp.argsort(-s1, axis=1, stable=True)
    ts_full = jnp.take_along_axis(s1, o2, axis=1)
    td_full = jnp.take_along_axis(d1, o2, axis=1)
    ts = ts_full[:, :k]
    td = jnp.where(ts > -jnp.inf, td_full[:, :k], 0).astype(jnp.int32)

    theta = ts_full[:, k - 1] if c >= k else jnp.full(
        (B,), -jnp.inf, dtype=jnp.float32)
    ok = (bound <= 0.0) | (bound < theta)
    return ts, td, ok


def make_strip_prune_probe():
    """Jit wrappers over raw (d, v) strips for A/B-probing the prune
    core against the sort core (tools/probe_strip_prune.py). Not the
    production entry point — reader integration comes only if the
    probe wins on hardware."""
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("k", "c", "t_pad", "log2_run"))
    def prune(d, v, t_of, sent, *, k: int, c: int, t_pad: int,
              log2_run: int = 3):
        del log2_run
        return _strip_prune_core(jax, jnp, d, v, t_of, sent,
                                 k=k, c=c, t_pad=t_pad)

    @partial(jax.jit, static_argnames=("k", "c", "t_pad", "log2_run"))
    def sort_core(d, v, t_of, sent, *, k: int, c: int, t_pad: int,
                  log2_run: int = 3):
        del t_of, c, t_pad
        B = d.shape[0]
        d2, v2 = jax.lax.sort((d, v), num_keys=1, dimension=1)
        off = 1
        for _ in range(log2_run):
            same = d2[:, off:] == d2[:, :-off]
            v2 = jnp.concatenate(
                [v2[:, :off],
                 v2[:, off:] + jnp.where(same, v2[:, :-off], 0.0)],
                axis=1)
            off *= 2
        run_end = jnp.concatenate(
            [d2[:, 1:] != d2[:, :-1], jnp.ones((B, 1), dtype=bool)],
            axis=1)
        okm = run_end & (d2 != sent) & (v2 > 0.0)
        score = jnp.where(okm, v2, -jnp.inf)
        tsv, tp = jax.lax.top_k(score, k)
        tdv = jnp.take_along_axis(d2, tp, axis=1)
        return tsv, tdv, jnp.ones((B,), dtype=bool)

    return prune, sort_core


def _candidate_core(jax, jnp, block_docs, block_impacts, bstart, bcnt,
                    w, sentinel_row, sentinel_doc, *, k: int,
                    t_pad: int, nblk: int, log2_run: int,
                    with_counts: bool):
    """Shared body of the candidate scorers: gather each row's posting
    blocks, sort by doc, combine duplicate-doc runs, top-k."""
    d, v, ok = _strip_gather_scan(
        jax, jnp, block_docs, block_impacts, bstart, bcnt, w,
        sentinel_row, sentinel_doc, t_pad=t_pad, nblk=nblk,
        log2_run=log2_run)
    score = jnp.where(ok, v, -jnp.inf)
    ts, tp = jax.lax.top_k(score, k)
    td = jnp.take_along_axis(d, tp, axis=1)
    if with_counts:
        # exact per-row match count (the single-query route's
        # total_hits_estimate — same count the dense executor's
        # match mask produces)
        return ts, td, ok.sum(axis=1).astype(jnp.int32)
    return ts, td


def make_sparse_candidate_scorer():
    """Batched candidate scorer over the block layout.

    Static shape axes: (k, t_pad, nblk, log2_run); B and the block
    arrays' extents come from the operands. ``sentinel_row`` (the block
    arrays' all-pad trailing row) and ``sentinel_doc`` (= n1-1, the
    dead doc slot) are traced scalars so one compile serves every
    segment of the same bucket shape.
    """
    import jax
    import jax.numpy as jnp

    @partial(jax.jit,
             static_argnames=("k", "t_pad", "nblk", "log2_run",
                              "with_counts"))
    def scorer(block_docs, block_impacts, tbl, sent,
               *, k: int, t_pad: int, nblk: int, log2_run: int,
               with_counts: bool = False):
        """tbl [3, B, t_pad] int32 — ONE host upload per batch (each
        eager transfer costs a dispatch): rows are per-(query,
        term-slot) posting block starts, counts (0 for unused slots),
        and the f32 idf·boost weights bit-cast to int32. sent [2]
        int32: (sentinel block row, dead doc slot = n1-1), cached on
        device per segment. Returns (scores [B,k], doc ids [B,k]);
        non-matches are -inf (same contract as the dense scorers)."""
        bstart, bcnt = tbl[0], tbl[1]
        w = jax.lax.bitcast_convert_type(tbl[2], jnp.float32)
        return _candidate_core(
            jax, jnp, block_docs, block_impacts, bstart, bcnt, w,
            sent[0], sent[1], k=k, t_pad=t_pad, nblk=nblk,
            log2_run=log2_run, with_counts=with_counts)

    return scorer


def make_sparse_candidate_scorer_packed():
    """Candidate scorer variant whose per-batch upload is ONE packed
    [B, t_pad] int32 (tid | occurrence_count << 26) instead of the
    [3, B, t_pad] explicit table — block starts/counts and f32 idf are
    gathered from the segment-resident ``tid_tbl`` [3, n_terms_pad]
    (DeviceSegment.sparse_tid_tbl), cutting the per-batch transfer 3x.

    Weights are recomputed on device as f32(occ) * f32(idf). That
    double-rounds differently from the host definition
    f32(occ * f64(idf)) in rare cases (only possible at occ > 1), so
    the host partition ships those entries' exact f32 weights in
    ``ovr`` [2, ov_pad] int32 (flat row*t_pad+col indices bucketed to
    a static pad — pads point past B*t_pad and drop; weights bitcast)
    and the scorer scatters them over the recomputed matrix: results
    are bit-identical to the explicit-table path
    (tests/test_sparse_packed.py fuzzes this).
    """
    import jax
    import jax.numpy as jnp

    @partial(jax.jit,
             static_argnames=("k", "t_pad", "nblk", "log2_run",
                              "n_ovr", "with_counts"))
    def scorer(block_docs, block_impacts, tid_tbl, packed, ovr, sent,
               *, k: int, t_pad: int, nblk: int, log2_run: int,
               n_ovr: int = 0, with_counts: bool = False):
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
        return _candidate_core(
            jax, jnp, block_docs, block_impacts, bstart, bcnt, w,
            sent[0], sent[1], k=k, t_pad=t_pad, nblk=nblk,
            log2_run=log2_run, with_counts=with_counts)

    return scorer


def build_heavy_lookup_host(postings, block_docs_np, block_impacts_np,
                            n1: int, term_cap: int):
    """Host build of the per-segment heavy-term doc→block lookup used
    by the term-split candidate scorer (device-side batched WAND — see
    make_sparse_candidate_scorer_split).

    For every term with more than ``term_cap`` posting blocks, the doc
    axis is cut into pow-2 groups of width G (per term, G chosen so
    any group's docs lie within TWO consecutive blocks — G = 128
    always satisfies this because a 128-posting block spans ≥ 127
    docs, and wider G is used when the term's average block span
    allows). ``tbl[base + (doc >> log2g)]`` then names the first of
    the ≤ 2 blocks that can contain ``doc``: one int32 gather plus two
    128-wide block-row gathers replace the reference's posting-cursor
    skip_to (`query/wand.rs:883-891`) — no per-wave run tables, no
    per-batch upload.

    Returns dict of host arrays: ``tbl`` int32 [total_entries+1]
    (absolute block-row ids), ``base`` int32 [n_terms] (−1 = term has
    no row), ``log2g`` int32 [n_terms], ``maximp`` f32 [n_terms]
    (per-term max impact incl. tombstoned docs — a sound upper bound
    for the non-candidate pruning check)."""
    nb = postings.term_block_count.astype(np.int64)
    start = postings.term_block_start.astype(np.int64)
    n_terms = len(nb)
    base = np.full(n_terms, -1, dtype=np.int32)
    log2g = np.zeros(n_terms, dtype=np.int32)
    # per-term max impact: blocks are term-contiguous & ascending
    maximp = np.zeros(n_terms, dtype=np.float32)
    has = nb > 0
    if has.any():
        bmax = block_impacts_np[: int((start + nb).max()), :].max(
            axis=1).astype(np.float32)
        red = np.maximum.reduceat(bmax, start[has])
        maximp[has] = red
    heavy = np.flatnonzero(nb > term_cap)
    parts = []
    total = 0
    for t in heavy:
        s, c = int(start[t]), int(nb[t])
        lasts = block_docs_np[s:s + c, -1].astype(np.int64)
        g = 128
        span = max(128 * n1 // max(int(postings.term_df[t]), 1), 128)
        while g * 2 <= span:
            g *= 2
        while g > 128:
            lo = np.minimum(
                np.searchsorted(lasts, np.arange(0, n1, g)), c - 1)
            if np.all(np.diff(lo) <= 1):
                break
            g //= 2
        lo = np.minimum(
            np.searchsorted(lasts, np.arange(0, n1, g)), c - 1)
        parts.append((lo + s).astype(np.int32))
        base[t] = total
        log2g[t] = int(g).bit_length() - 1
        total += len(lo)
    tbl = (np.concatenate(parts + [np.zeros(1, dtype=np.int32)])
           if parts else np.zeros(1, dtype=np.int32))
    return {"tbl": tbl, "base": base, "log2g": log2g,
            "maximp": maximp}


def _candidate_core_split(jax, jnp, block_docs, block_impacts, bstart,
                          bcnt, w, sentinel_row, sentinel_doc,
                          hvy, hb_tbl, hb_base, hb_log2g, tid_tbl,
                          maximp, *, k: int, kp: int, t_pad: int,
                          nblk: int, log2_run: int, h_pad: int):
    """Term-split candidate scoring: the row's LIGHT terms ride the
    candidate strip exactly like _candidate_core; its HEAVY (head)
    terms are added afterwards by direct per-candidate lookup — for
    each of the top-``kp`` tail candidates, the heavy term's impact at
    that doc is found via the heavy lookup table (≤ 2 block-row
    gathers; build_heavy_lookup_host). This is batched WAND run
    backwards: instead of walking the head term's huge posting list,
    the rare terms nominate candidates and the head terms answer point
    queries.

    Exactness is certified per row (``sound`` output): with
    HUB = Σ_h w_h·maximp_h (every heavy term's best possible
    contribution), a row's result equals the dense scorer's iff
    (a) θ (its k-th final score) strictly beats HUB — no doc OUTSIDE
    the candidate strip (matching only heavy terms, tail score 0) can
    reach the top-k, and (b) the kp-th tail score + HUB strictly
    under θ — no candidate cut by the first top-kp can re-enter on
    heavy contributions. Rows with no heavy terms are sound by
    construction. Unsound rows must be re-scored by a dense path
    (the reader's fallback wave).

    hvy [2, B, h_pad] int32: heavy term ids (0-padded) and their exact
    f32 leaf weights bit-cast (0 = unused slot)."""
    d, v, ok = _strip_gather_scan(
        jax, jnp, block_docs, block_impacts, bstart, bcnt, w,
        sentinel_row, sentinel_doc, t_pad=t_pad, nblk=nblk,
        log2_run=log2_run)
    B = d.shape[0]
    n_cand = ok.sum(axis=1).astype(jnp.int32)
    score = jnp.where(ok, v, -jnp.inf)
    kp = min(kp, nblk * 128)
    tv, tp = jax.lax.top_k(score, kp)
    td = jnp.take_along_axis(d, tp, axis=1)              # [B, kp]
    # the lookup materializes [B, chunk, 128] block gathers — chunk the
    # candidate axis so deep kp windows (SEARCHLITE_SPLIT_KP raised the
    # floor to 4096; the certificate's tail condition needs kp past the
    # candidate band, probe_split_band) never scale HBM temps with
    # B·kp·128 (a 4096-row group at kp 4096 would be 8.6 GB unchunked)
    chunk = max(128, min(512, (1 << 26) // max(B * 128, 1)))
    kp_eff = kp  # the REAL cut width — the certificate's tail index
    if kp % chunk:
        pad = chunk - kp % chunk
        # padded candidates carry sentinel docs + tv=-inf: lookups on
        # them are index-clamped garbage masked by ``real`` below, the
        # same contract pad candidates inside the kp window already ride
        td = jnp.concatenate(
            [td, jnp.full((B, pad), sentinel_doc, td.dtype)], axis=1)
        tv = jnp.concatenate(
            [tv, jnp.full((B, pad), -jnp.inf, tv.dtype)], axis=1)
        kp += pad
    real = tv > -jnp.inf
    hvy_tid = hvy[0]
    hvy_w = jax.lax.bitcast_convert_type(hvy[1], jnp.float32)
    hub = jnp.zeros((B,), dtype=jnp.float32)
    n_tbl = hb_tbl.shape[0]
    slot_meta = []
    for h in range(h_pad):
        tid = hvy_tid[:, h]                              # [B]
        wh = hvy_w[:, h]
        tbase = hb_base[tid]
        lg = hb_log2g[tid]
        blk0 = tid_tbl[0][tid]
        nb_t = tid_tbl[1][tid]
        last = blk0 + jnp.maximum(nb_t - 1, 0)
        ok_h = (wh > 0.0) & (tbase >= 0) & (nb_t > 0)
        slot_meta.append((wh, tbase, lg, blk0, last, ok_h))
        hub = hub + jnp.where(ok_h, wh * maximp[tid], 0.0)

    n_ch = kp // chunk
    td_ch = td.reshape(B, n_ch, chunk).transpose(1, 0, 2)

    def lookup_chunk(carry, td_c):                       # td_c [B, chunk]
        hs = jnp.zeros((B, chunk), dtype=jnp.float32)
        for wh, tbase, lg, blk0, last, ok_h in slot_meta:
            g = jax.lax.shift_right_logical(td_c, lg[:, None])
            ent_idx = jnp.minimum(
                jnp.where(ok_h, tbase, 0)[:, None] + g, n_tbl - 1)
            ent = hb_tbl[ent_idx]                        # [B, chunk]
            b1 = jnp.clip(ent, blk0[:, None], last[:, None])
            b2 = jnp.minimum(b1 + 1, last[:, None])
            b2_ok = ok_h[:, None] & (b2 != b1)
            b1 = jnp.where(ok_h[:, None], b1, sentinel_row)
            b2 = jnp.where(b2_ok, b2, sentinel_row)
            d1 = block_docs[b1]                          # [B, chunk, 128]
            i1 = block_impacts[b1]
            d2 = block_docs[b2]
            i2 = block_impacts[b2]
            if i1.dtype != jnp.float32:  # bf16 device storage (D8)
                i1 = i1.astype(jnp.float32)
                i2 = i2.astype(jnp.float32)
            c = (jnp.where(d1 == td_c[..., None], i1, 0.0).sum(axis=-1)
                 + jnp.where(d2 == td_c[..., None], i2, 0.0)
                 .sum(axis=-1))
            hs = hs + wh[:, None] * c
        return carry, hs

    _, hs_ch = jax.lax.scan(lookup_chunk, 0, td_ch)      # [n_ch,B,chunk]
    heavy_sum = hs_ch.transpose(1, 0, 2).reshape(B, kp)
    final = jnp.where(real, tv + heavy_sum, -jnp.inf)
    # (score desc, doc asc) over the kp window: stable doc-asc sort,
    # then stable score-desc sort — the engine's tie order
    od = jnp.argsort(td, axis=1, stable=True)
    f1 = jnp.take_along_axis(final, od, axis=1)
    d1s = jnp.take_along_axis(td, od, axis=1)
    osc = jnp.argsort(-f1, axis=1, stable=True)
    fs = jnp.take_along_axis(f1, osc, axis=1)[:, :k]
    ds = jnp.take_along_axis(d1s, osc, axis=1)[:, :k]
    nreal = (fs > -jnp.inf).sum(axis=1)
    theta = jnp.where(nreal >= k, fs[:, k - 1], -jnp.inf)
    tail_k = tv[:, kp_eff - 1]
    excluded = n_cand > kp_eff
    sound = (hub <= 0.0) | (
        (theta > hub) & (~excluded | (tail_k + hub < theta)))
    return fs, ds, sound


def make_sparse_single_split_scorer():
    """Single-query term-split scorer: the query's light terms ride
    one candidate strip; up to ``h_pad`` heavy terms are added by
    point lookup at EVERY run-end position (affordable at B=1 —
    there is no kp window and therefore no tail condition: every
    strip doc is scored with ALL its heavy contributions). Soundness
    needs only θ > Σᵢ HUBᵢ — a doc outside the strip matches heavy
    terms alone, so its score is bounded by the sum of the heavy
    upper bounds. With ONE heavy term the match count is exact
    (|light ∪ heavy| = n_strip + live_df − overlap, the caller adds
    live_df host-side); with several the caller derives the lower
    bound n_strip + maxᵢ(live_dfᵢ − overlapᵢ) — within the engine's
    `total_hits_estimate` contract (reference
    `searchlite-core/src/api/reader.rs:101` names the field an
    estimate; `tests/test_pruning.py` pins pruned ≤ dense). Heavy
    lookups run in ≤32k-position chunks (`lax.map`) so HBM temps
    stay bounded at corpus-scaled strip widths. Returns (scores,
    ids, n_strip, overlap [H], sound)."""
    import jax
    import jax.numpy as jnp

    @partial(jax.jit,
             static_argnames=("k", "t_pad", "nblk", "log2_run"))
    def scorer(block_docs, block_impacts, hb_tbl, hb_base, hb_log2g,
               tid_tbl, maximp, tbl, hvy, sent,
               *, k: int, t_pad: int, nblk: int, log2_run: int):
        bstart, bcnt = tbl[0], tbl[1]
        w = jax.lax.bitcast_convert_type(tbl[2], jnp.float32)
        d, v, ok = _strip_gather_scan(
            jax, jnp, block_docs, block_impacts, bstart, bcnt, w,
            sent[0], sent[1], t_pad=t_pad, nblk=nblk,
            log2_run=log2_run)
        tid = hvy[0]                                     # [H]
        wh = jax.lax.bitcast_convert_type(hvy[1], jnp.float32)
        tbase = hb_base[tid]
        lg = hb_log2g[tid]
        blk0 = tid_tbl[0][tid]
        nb_t = tid_tbl[1][tid]
        last = blk0 + jnp.maximum(nb_t - 1, 0)
        ok_h = (wh > 0.0) & (tbase >= 0) & (nb_t > 0)
        n_tbl = hb_tbl.shape[0]
        imp_f32 = block_impacts.dtype == jnp.float32

        def lookup(dc):
            """Heavy contributions for one strip chunk: [Lc] → [H, Lc]
            (2 gathers of 128-wide block rows per (heavy, position) —
            temps are [H, Lc, 128], ~68 MB at H=4, Lc=32768)."""
            g = jax.lax.shift_right_logical(dc[None, :], lg[:, None])
            ent = hb_tbl[jnp.minimum(
                jnp.where(ok_h, tbase, 0)[:, None] + g, n_tbl - 1)]
            b1 = jnp.clip(ent, blk0[:, None], last[:, None])
            b2 = jnp.minimum(b1 + 1, last[:, None])
            b2_ok = ok_h[:, None] & (b2 != b1)
            b1 = jnp.where(ok_h[:, None], b1, sent[0])
            b2 = jnp.where(b2_ok, b2, sent[0])
            i1 = block_impacts[b1]
            i2 = block_impacts[b2]
            if not imp_f32:  # bf16 device storage (D8)
                i1 = i1.astype(jnp.float32)
                i2 = i2.astype(jnp.float32)
            return (jnp.where(block_docs[b1] == dc[None, :, None],
                              i1, 0.0).sum(axis=-1)
                    + jnp.where(block_docs[b2] == dc[None, :, None],
                                i2, 0.0).sum(axis=-1))

        L = d.shape[1]
        Lc = min(L, 32768)
        n_chunks = -(-L // Lc)
        if n_chunks > 1:
            dp = jnp.concatenate(
                [d[0], jnp.full(n_chunks * Lc - L, sent[1],
                                dtype=d.dtype)])
            c = jax.lax.map(lookup, dp.reshape(n_chunks, Lc))
            c = jnp.moveaxis(c, 1, 0).reshape(tid.shape[0], -1)[:, :L]
        else:
            c = lookup(d[0])
        hv = wh[:, None] * c                             # [H, L]
        overlap = (ok & (hv > 0.0)).sum(axis=1).astype(jnp.int32)
        score = jnp.where(ok, v + hv.sum(axis=0)[None, :], -jnp.inf)
        ts, tp = jax.lax.top_k(score, k)
        td = jnp.take_along_axis(d, tp, axis=1)
        n_strip = ok.sum(axis=1).astype(jnp.int32)
        hub = jnp.where(ok_h, wh * maximp[tid], 0.0).sum()
        nreal = (ts > -jnp.inf).sum(axis=1)
        theta = jnp.where(nreal >= k, ts[:, k - 1], -jnp.inf)
        sound = (hub <= 0.0) | (theta > hub)
        return ts, td, n_strip, overlap, sound

    return scorer


def make_sparse_candidate_scorer_split():
    """Term-split variant of the packed candidate scorer (see
    _candidate_core_split): per-batch upload is the packed light table
    + override COO (as the packed scorer) + ONE [2, B, h_pad] heavy
    table; the heavy lookup arrays and maximp are segment-resident
    (DeviceSegment.heavy_lookup). Returns (scores [B,k], ids [B,k],
    sound [B] bool)."""
    import jax
    import jax.numpy as jnp

    @partial(jax.jit,
             static_argnames=("k", "kp", "t_pad", "nblk", "log2_run",
                              "n_ovr", "h_pad"))
    def scorer(block_docs, block_impacts, tid_tbl, hb_tbl, hb_base,
               hb_log2g, maximp, packed, ovr, hvy, sent,
               *, k: int, kp: int, t_pad: int, nblk: int,
               log2_run: int, h_pad: int, n_ovr: int = 0):
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
        return _candidate_core_split(
            jax, jnp, block_docs, block_impacts, bstart, bcnt, w,
            sent[0], sent[1], hvy, hb_tbl, hb_base, hb_log2g, tid_tbl,
            maximp, k=k, kp=kp, t_pad=t_pad, nblk=nblk,
            log2_run=log2_run, h_pad=h_pad)

    return scorer


def make_group_gather():
    """Scatter the tier groups' (scores, ids) into light-row order on
    device: one [bl, k] pair out of N per-tier results. ``posmaps``
    concatenates each group's positions within the light order (pads
    carry bl — out of range, dropped)."""
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("bl",))
    def gather(group_s, group_i, posmaps, *, bl: int):
        k = group_s[0].shape[1]
        s = jnp.full((bl, k), -jnp.inf, dtype=group_s[0].dtype)
        i = jnp.zeros((bl, k), dtype=group_i[0].dtype)
        off = 0
        for gs, gi in zip(group_s, group_i):
            m = posmaps[off:off + gs.shape[0]]
            s = s.at[m].set(gs, mode="drop")
            i = i.at[m].set(gi, mode="drop")
            off += gs.shape[0]
        return s, i

    return gather


def make_group_gather_sound():
    """Group gather variant that also scatters per-row soundness flags
    (term-split groups; plain groups pass all-True). Unmapped rows
    default to sound=True (they don't exist — pads are dropped by the
    posmap, and rows outside every group never reach the caller)."""
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("bl",))
    def gather(group_s, group_i, group_f, posmaps, *, bl: int):
        k = group_s[0].shape[1]
        s = jnp.full((bl, k), -jnp.inf, dtype=group_s[0].dtype)
        i = jnp.zeros((bl, k), dtype=group_i[0].dtype)
        f = jnp.ones((bl,), dtype=bool)
        off = 0
        for gs, gi, gf in zip(group_s, group_i, group_f):
            m = posmaps[off:off + gs.shape[0]]
            s = s.at[m].set(gs, mode="drop")
            i = i.at[m].set(gi, mode="drop")
            f = f.at[m].set(gf, mode="drop")
            off += gs.shape[0]
        return s, i, f

    return gather


def make_row_combiner():
    """Scatter two row-groups' (scores, ids) back into original batch
    order on device (pad rows carry an out-of-range map entry and are
    dropped)."""
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("n_rows",))
    def combine(light_s, light_i, heavy_s, heavy_i, maps,
                *, n_rows: int):
        """maps [Bl + Bh] int32 — the two row maps in one upload,
        split at the (static) light row count."""
        light_map = maps[: light_s.shape[0]]
        heavy_map = maps[light_s.shape[0]:]
        k = light_s.shape[1]
        s = jnp.full((n_rows + 1, k), -jnp.inf, dtype=light_s.dtype)
        i = jnp.zeros((n_rows + 1, k), dtype=light_i.dtype)
        s = s.at[light_map].set(light_s, mode="drop")
        i = i.at[light_map].set(light_i, mode="drop")
        s = s.at[heavy_map].set(heavy_s.astype(light_s.dtype),
                                mode="drop")
        i = i.at[heavy_map].set(heavy_i.astype(light_i.dtype),
                                mode="drop")
        return s[:n_rows], i[:n_rows]

    return combine


def tier_bounds(max_blocks: int) -> list:
    """Ladder of light-row tiers up to ``max_blocks``: pow-4 to 512
    (e.g. 512 → [8, 32, 128, 512]), pow-2 beyond (8192 →
    [8, 32, 128, 512, 1024, ..., 8192]). The candidate scorer pads
    every row's strip to the GROUP's max block count, so mixing a
    480-block query into a batch of 4-block queries makes every row
    sort a 61k-candidate strip; tiering keeps each row's padding
    bounded (4x low tiers, 2x above 512 — where the strip sort is the
    dominant cost and pad columns are pure waste) at the cost of one
    launch per occupied tier."""
    bounds = []
    b = 8
    while b < max_blocks:
        bounds.append(b)
        b *= 4 if b < 512 else 2
    bounds.append(max_blocks)
    return bounds


# per-launch candidate-strip element cap (docs+impacts i32/f32 pairs):
# a group whose rows x padded strip width exceed it is emitted as
# multiple row chunks so one wide tier can't blow the HBM budget
# (16 rows x 2M-candidate strips = 256M elements = 2 GB already).
STRIP_CHUNK_ELEMS = int(os.environ.get(
    "SEARCHLITE_STRIP_CHUNK_ELEMS", str(128 * 1024 * 1024)))


def _chunk_rows(n_rows: int, nblk: int) -> int:
    """Rows per launch for a tier whose padded strips hold
    ``nblk`` * 128 candidates, bounded by STRIP_CHUNK_ELEMS."""
    per = max(16, STRIP_CHUNK_ELEMS // max(nblk * 128, 1))
    return min(n_rows, per)


def _split_light(qb, max_blocks: int):
    """Shared light/heavy split of a build_impact_batch() output by
    per-query gathered-block count: queries at or under ``max_blocks``
    go to the candidate scorer, the rest (head-term queries, whose
    candidate strips would stretch every row of the batch) stay on the
    dense path. Returns None when no query qualifies, else the light
    rows' CSR entry gather + bucketed static shapes."""
    from searchlite.ops.impact import csr_row_lengths, csr_take_rows

    nblk_q = qb["q_nblk"]
    light = nblk_q <= max_blocks
    if not light.any():
        return None
    light_idx = np.flatnonzero(light)
    heavy_idx = np.flatnonzero(~light)
    counts = csr_row_lengths(qb)
    idx, sc, pos = csr_take_rows(qb["qs_start"], counts, light_idx)
    t_max = int(sc.max()) if len(sc) else 1
    t_pad = next_pow2(max(t_max, 2))
    return {
        "idx": idx,
        "pos": pos,
        "rows_rep": np.repeat(
            np.arange(len(light_idx), dtype=np.int64), sc),
        "light_idx": light_idx,
        "heavy_idx": heavy_idx,
        "t_pad": t_pad,
        "nblk": pow15_bucket(int(nblk_q[light_idx].max()), minimum=16),
        "bl": pow15_bucket(len(light_idx), minimum=64),
        "log2_run": max((t_pad - 1).bit_length(), 1),
    }


def partition_sparse_batch(qb, max_blocks: int):
    """Explicit-table emission of the light/heavy split: the light
    rows' [3, Bl, t_pad] (bstart, bcnt, weight) upload for
    make_sparse_candidate_scorer(). Returns None when no query
    qualifies."""
    sp = _split_light(qb, max_blocks)
    if sp is None:
        return None
    idx, pos, rows_rep = sp["idx"], sp["pos"], sp["rows_rep"]
    t_pad, bl = sp["t_pad"], sp["bl"]
    bstart = np.zeros((bl, t_pad), dtype=np.int32)
    bcnt = np.zeros((bl, t_pad), dtype=np.int32)
    w = np.zeros((bl, t_pad), dtype=np.float32)
    slots = qb["qs_slot"][idx]
    bstart[rows_rep, pos] = qb["slot_bstart"][slots]
    bcnt[rows_rep, pos] = qb["slot_bcnt"][slots]
    w[rows_rep, pos] = qb["qs_w"][idx]
    sp["tbl"] = np.stack([bstart, bcnt, w.view(np.int32)])
    return sp


def _packed_applies(qb) -> bool:
    """Batch-global guards for the packed upload format: per-entry
    occurrence counts present, term ids under 2^26, occurrence counts
    at most 31."""
    qs_cnt = qb.get("qs_cnt")
    if qs_cnt is None:
        return False
    slot_tids = qb["slot_tids"]
    if len(slot_tids) and int(slot_tids.max()) >= TID_LIMIT:
        return False
    if len(qs_cnt) and int(qs_cnt.max()) > OCC_MAX:
        return False
    return True


def _take_kept(qb, row_idx, entry_keep):
    """Row-major CSR expansion of the given rows' entries restricted
    to ``entry_keep`` (bool over the global qs_* entry axis). Returns
    (idx, rows_rep, pos, sc): kept global entry indices, their row
    ordinal within ``row_idx``, within-row rank, and per-row kept
    counts."""
    from searchlite.ops.impact import csr_row_lengths, csr_take_rows

    counts = csr_row_lengths(qb)
    idx, sc, _pos = csr_take_rows(qb["qs_start"], counts, row_idx)
    rows_rep = np.repeat(np.arange(len(row_idx), dtype=np.int64), sc)
    keep = entry_keep[idx]
    idx = idx[keep]
    rows_rep = rows_rep[keep]
    sc2 = np.bincount(rows_rep, minlength=len(row_idx)).astype(np.int64)
    starts2 = np.concatenate([[0], np.cumsum(sc2)[:-1]])
    pos = np.arange(len(idx), dtype=np.int64) - starts2[rows_rep]
    return idx, rows_rep, pos, sc2


def _emit_packed_rows(qb, row_idx, idf32, bl_min: int = 64):
    """Packed [bl, t_pad] int32 of (tid | occ << 26) for the given
    query rows, plus the (usually empty) weight-override COO: entries
    where the device's f32(occ)*f32(idf) double-rounds away from the
    host's f32(occ * f64(idf)) ship their exact weight. ``idf32`` is
    the segment's f64 idf table pre-rounded to f32 — the values the
    device recomputes weights from (DeviceSegment.idf32 must match
    sparse_tid_tbl's row 2)."""
    from searchlite.ops.impact import csr_row_lengths, csr_take_rows

    counts = csr_row_lengths(qb)
    idx, sc, pos = csr_take_rows(qb["qs_start"], counts, row_idx)
    t_max = int(sc.max()) if len(sc) else 1
    rows_rep = np.repeat(np.arange(len(row_idx), dtype=np.int64), sc)
    return _pack_entries(qb, idx, rows_rep, pos, len(row_idx), t_max,
                         idf32, bl_min)


def _pack_entries(qb, idx, rows_rep, pos, n_rows, t_max, idf32,
                  bl_min):
    """Shared packed-table emission from a row-major entry selection
    (see _emit_packed_rows for the format)."""
    t_pad = next_pow2(max(t_max, 2))
    bl = pow15_bucket(n_rows, minimum=bl_min)
    occ = qb["qs_cnt"][idx]
    slots = qb["qs_slot"][idx]
    tids_e = qb["slot_tids"][slots].astype(np.int64)
    packed = np.zeros((bl, t_pad), dtype=np.int32)
    packed[rows_rep, pos] = (
        tids_e | (occ.astype(np.int64) << TID_BITS)).astype(np.int32)
    qs_w = qb["qs_w"][idx]
    w_dev = occ.astype(np.float32) * idf32[tids_e]
    bad = w_dev.view(np.int32) != qs_w.view(np.int32)
    n_ovr = int(bad.sum())
    if n_ovr:
        ov_pad = next_pow2(max(n_ovr, 8))
        ovr = np.full((2, ov_pad), bl * t_pad, dtype=np.int32)
        ovr[0, :n_ovr] = (rows_rep[bad] * t_pad + pos[bad]).astype(
            np.int32)
        ovr[1, :n_ovr] = qs_w[bad].view(np.int32)
    else:
        ovr = np.zeros((2, 1), dtype=np.int32)
    return {
        "packed": packed,
        "ovr": ovr,
        "n_ovr": next_pow2(max(n_ovr, 8)) if n_ovr else 0,
        "t_pad": t_pad,
        "log2_run": max((t_pad - 1).bit_length(), 1),
    }


def partition_sparse_batch_packed(qb, max_blocks: int,
                                  idf32: np.ndarray):
    """Packed emission of the light/heavy split for
    make_sparse_candidate_scorer_packed(): ONE [Bl, t_pad] int32 of
    (tid | occ << 26) plus the (usually empty) weight-override COO.
    Returns None when the batch can't use the packed format (see
    _packed_applies) — the caller falls back to
    partition_sparse_batch."""
    if not _packed_applies(qb):
        return None
    sp = _split_light(qb, max_blocks)
    if sp is None:
        return None
    sp.update(_emit_packed_rows(qb, sp["light_idx"], idf32))
    return sp


def partition_sparse_batch_split(qb, max_blocks: int,
                                 idf32: np.ndarray, k: int,
                                 term_cap: int, h_max: int,
                                 maximp: np.ndarray | None = None,
                                 ub_ratio: float = 0.5):
    """TERM-level split partition (device-side batched WAND): an entry
    is heavy when ITS term exceeds ``term_cap`` blocks; a row is
    eligible when its LIGHT entries total ≤ ``max_blocks`` blocks, it
    has ≤ ``h_max`` heavy entries, and ≥ 1 light entry. Eligible rows
    ride the candidate strips on their light terms (pow-4 tiers, as
    partition_sparse_batch_tiered) with per-group heavy tables
    [2, Bg, h_pad] (term id, exact f32 weight bit-cast) consumed by
    make_sparse_candidate_scorer_split; the rest fall back dense.

    Against the row-level tiered partition this turns head-term
    queries — previously ALL dense — into strip rows with a 2-block
    point lookup per heavy term, at the price of a per-row soundness
    certificate (rows whose certificate fails must be re-scored dense;
    the scorer returns the flags). Groups without heavy entries carry
    ``hvy=None`` and should run the plain packed scorer."""
    if not _packed_applies(qb):
        return None
    nq = qb["n_queries"]
    from searchlite.ops.impact import csr_row_lengths

    counts = csr_row_lengths(qb)
    row_of = np.repeat(np.arange(nq, dtype=np.int64), counts)
    ent_bcnt = qb["slot_bcnt"][qb["qs_slot"]].astype(np.int64)
    heavy_e = ent_bcnt > term_cap
    n_heavy = np.bincount(row_of[heavy_e], minlength=nq)
    light_blocks = np.bincount(
        row_of[~heavy_e], weights=ent_bcnt[~heavy_e],
        minlength=nq).astype(np.int64)
    n_light = np.bincount(row_of[~heavy_e], minlength=nq)
    eligible = ((light_blocks <= max_blocks) & (n_heavy <= h_max)
                & ((n_light > 0) | (n_heavy == 0)))
    if maximp is not None and ub_ratio > 0:
        # host routing predictor: a split row's certificate needs its
        # k-th candidate score to strictly beat HUB = Σ_heavy w·maximp.
        # θ is unknowable before scoring, but rows where HUB rivals
        # even the best light term's ceiling (max_light w·maximp)
        # almost always fail it — send those straight to the dense
        # path instead of scoring them twice. Pure routing: mispredicts
        # are caught by the certificate (→ fallback wave) or merely
        # dense-score a row that would have been sound.
        ent_ub = qb["qs_w"] * maximp[
            qb["slot_tids"][qb["qs_slot"]]].astype(np.float32)
        hub = np.bincount(row_of[heavy_e], weights=ent_ub[heavy_e],
                          minlength=nq)
        lmax = np.zeros(nq, dtype=np.float64)
        np.maximum.at(lmax, row_of[~heavy_e], ent_ub[~heavy_e])
        eligible &= (n_heavy == 0) | (hub < ub_ratio * lmax)
    if not eligible.any():
        return None
    light_idx = np.flatnonzero(eligible)
    heavy_idx = np.flatnonzero(~eligible)
    nblk_min = -(-k // 128)  # strips must hold at least k candidates
    groups = []
    prev = -1  # first tier includes 0-block strips (all-df-0 rows)
    for bound in tier_bounds(max_blocks):
        lb = light_blocks[light_idx]
        sel = (lb > prev) & (lb <= bound)
        prev = bound
        if not sel.any():
            continue
        pos_sel = np.flatnonzero(sel)
        nblk_tier = pow15_bucket(
            max(int(lb[pos_sel].max()), nblk_min), minimum=16)
        step = _chunk_rows(len(pos_sel), nblk_tier)
        if step < len(pos_sel):
            # width-ascending order within the tier: row chunks then
            # get chunk-local nblk buckets (early chunks pad less)
            pos_sel = pos_sel[np.argsort(lb[pos_sel], kind="stable")]
        for c0 in range(0, len(pos_sel), step):
            pos_c = pos_sel[c0:c0 + step]
            rows = light_idx[pos_c]
            lidx, lrows, lpos, lsc = _take_kept(qb, rows, ~heavy_e)
            g = _pack_entries(qb, lidx, lrows, lpos, len(rows),
                              int(lsc.max()) if len(lsc) else 1,
                              idf32, bl_min=16)
            g["pos_in_light"] = pos_c
            g["nblk"] = pow15_bucket(
                max(int(lb[pos_c].max()), nblk_min), minimum=16)
            nh = n_heavy[rows]
            if nh.any():
                bl = g["packed"].shape[0]
                h_pad = next_pow2(max(int(nh.max()), 1))
                hidx, hrows, hpos, _hsc = _take_kept(qb, rows, heavy_e)
                hvy = np.zeros((2, bl, h_pad), dtype=np.int32)
                htids = qb["slot_tids"][qb["qs_slot"][hidx]]
                hvy[0, hrows, hpos] = htids.astype(np.int32)
                hvy[1, hrows, hpos] = qb["qs_w"][hidx].view(np.int32)
                g["hvy"] = hvy
                g["h_pad"] = h_pad
            else:
                g["hvy"] = None
            groups.append(g)
    return {
        "groups": groups,
        "light_idx": light_idx,
        "heavy_idx": heavy_idx,
        "bl": pow15_bucket(len(light_idx), minimum=64),
        "term_split": True,
    }


def partition_sparse_batch_tiered(qb, max_blocks: int,
                                  idf32: np.ndarray, k: int):
    """Tiered packed emission: light rows are grouped into pow-4
    block-count tiers (tier_bounds), one packed table per occupied
    tier, so a single wide query can't inflate every other row's
    candidate strip. Each group's strip is still wide enough for
    top-k (nblk >= ceil(k/128)). Returns None when the packed format
    doesn't apply or no query is light."""
    if not _packed_applies(qb):
        return None
    nblk_q = qb["q_nblk"]
    light = nblk_q <= max_blocks
    if not light.any():
        return None
    light_idx = np.flatnonzero(light)
    heavy_idx = np.flatnonzero(~light)
    nblk_min = -(-k // 128)  # strips must hold at least k candidates
    groups = []
    # first tier includes 0-block rows (every query term absent from
    # this segment): they MUST land in a group — an ungrouped light
    # row would shift every later row in a single-group fast path
    prev = -1
    for bound in tier_bounds(max_blocks):
        sel = (nblk_q[light_idx] > prev) & (nblk_q[light_idx] <= bound)
        prev = bound
        if not sel.any():
            continue
        pos_sel = np.flatnonzero(sel)
        nblk_tier = pow15_bucket(
            max(int(nblk_q[light_idx[pos_sel]].max()), nblk_min),
            minimum=16)
        step = _chunk_rows(len(pos_sel), nblk_tier)
        if step < len(pos_sel):
            pos_sel = pos_sel[np.argsort(
                nblk_q[light_idx[pos_sel]], kind="stable")]
        for c0 in range(0, len(pos_sel), step):
            pos_c = pos_sel[c0:c0 + step]
            rows = light_idx[pos_c]
            g = _emit_packed_rows(qb, rows, idf32, bl_min=16)
            g["pos_in_light"] = pos_c
            g["nblk"] = pow15_bucket(
                max(int(nblk_q[rows].max()), nblk_min), minimum=16)
            groups.append(g)
    return {
        "groups": groups,
        "light_idx": light_idx,
        "heavy_idx": heavy_idx,
        "bl": pow15_bucket(len(light_idx), minimum=64),
    }
