"""DeviceSegment: one segment's postings resident in device memory.

The device-side mirror of a ``SegmentReader``. Each array uploads at most
once, lazily on first use by a scoring path (segments are immutable, so
commits only ever add new segments — the incremental-write story
mirrors the reference's segment model; laziness keeps paths that never
read an array — e.g. doc-sharded/pruned execution vs the whole-segment
block arrays — from paying its HBM footprint):

- ``block_docs [B+1,128] int32`` — doc ordinals; padding remapped from
  -1 to the sentinel ordinal ``n_docs`` (dead slot of the
  ``n_docs+1``-wide score arrays); trailing all-sentinel row pads the
  scorer's block gathers.
- ``block_impacts [B+1,128]`` — precomputed BM25 impacts
  (tf-saturation × length norm; query-independent), pads 0. Host copy
  is f32; the device copy stores the precision policy's impact dtype
  (bf16 on accelerators in fast modes — halves upload/HBM/gather
  traffic; ops/precision.py::impacts_store_dtype, divergence D8) and
  scorers upcast to f32 right after their gathers.
- ``block_tfs [B,128] float32`` (raw tfs, block-scatter path + mesh).
- ``doc_len [n_len_fields, n_docs+1] float32`` — per-field BM25 doc
  lengths (from the ``_len:{field}`` fast columns).
- ``avgdl [n_len_fields]``, ``deleted [n_docs+1] bool``.

Scoring row-gathers query-term block ranges out of these arrays,
densifies them into the impact matrix M with one unique-index scatter,
and runs ``W @ M`` as a matmul (see ``ops/impact.py``/``ops/score.py``).
Scoring uses segment-local df / live-doc count / avgdl, matching the
reference's per-segment semantics (`api/reader.rs:2985-3002`).
"""

from __future__ import annotations

import os

import numpy as np

from searchlite.index.segment import SegmentReader


class DeviceSegment:
    def __init__(self, reader: SegmentReader, segment_ord: int, jnp=None,
                 k1: float = 0.9, b: float = 0.4, device=None):
        if jnp is None:
            import jax.numpy as jnp  # noqa: PLC0415
        # host-tier placement: when ``device`` is a (cpu) jax.Device,
        # every segment-resident array commits there instead of the
        # default accelerator (the opt-in host tier, api/reader.py::
        # _host_tier_device); jit executors follow the committed
        # operands onto that backend. None = default-device residency,
        # the normal tier.
        self.device = device
        self._jnp = jnp
        self.reader = reader
        self.ord = segment_ord
        self.n_docs = reader.doc_count
        self.n1 = self.n_docs + 1  # +1 sentinel slot
        # Bucket the doc-axis width for small segments: executors
        # trace per exact shape, so the realtime fold stream (every
        # fold a slightly different doc count) compiled a fresh
        # executor per fold, a search stall each time. Padding n1 to
        # the pow-2 ladder
        # makes folds of similar size land in the SAME compiled
        # bucket; slots n_docs..n1-2 are pure pads (no postings ever
        # reference them, `deleted` masks them) and the dead/sentinel
        # slot stays n1-1 as every op assumes. Big corpora keep exact
        # shapes (one compile per immutable segment is the right
        # trade there, and the doc axis costs FLOPs on dense paths).
        pad_max = int(os.environ.get("SEARCHLITE_PAD_DOCS_MAX",
                                     "262144"))
        if 0 < self.n1 <= pad_max:
            # pow-2 (not pow-1.5): one bucket per octave on BOTH the
            # doc and block axes keeps the (doc-bucket x block-bucket)
            # combo count — each combo is one first-crossing compile —
            # half the pow-1.5 ladder's; the worst-case 2x FLOPs pad
            # is cheap at these segment sizes
            from searchlite.ops.impact import pow2_bucket

            self.n1 = pow2_bucket(self.n1, minimum=256)
        self.k1 = float(k1)
        self.b = float(b)

        postings = reader.postings
        bd = postings.block_docs
        if bd.shape[0] == 0:
            bd = np.full((1, 128), -1, dtype=np.int32)
            bt = np.zeros((1, 128), dtype=np.float32)
        else:
            bt = postings.block_tfs
        # trailing all-sentinel row: pads blk_idx gathers (every entry
        # routes to the scatter dump zone — see build_m_from_blocks)
        self.n_block_rows = bd.shape[0]
        # block arrays upload lazily on first use: the doc-sharded and
        # pruned paths (the ones giant corpora route through) never read
        # them, and eagerly uploading ~4 GB at 5M docs would take
        # device memory the pruned waves need
        self._block_docs = None
        # raw tfs stay host-side (nothing on the scoring path reads them
        # from HBM; 1.2 GB at 5M docs) — upload lazily if ever needed
        self.block_tfs_np = bt
        self._block_tfs = None

        # doc-length matrix over fields that have _len columns, plus one
        # zero row (avgdl 0 → norm 1) for length-less fields (keywords)
        len_fields = sorted(
            name[len("_len:"):] for name in reader.fast.columns
            if name.startswith("_len:"))
        self.len_field_ids = {f: i for i, f in enumerate(len_fields)}
        n_fields = len(len_fields) + 1
        doc_len = np.zeros((n_fields, self.n1), dtype=np.float32)
        avgdl = np.zeros(n_fields, dtype=np.float32)
        for field, fid in self.len_field_ids.items():
            col = reader.fast.column(f"_len:{field}")
            if col is not None and len(col.values):
                doc_len[fid, col.row_ids] = col.values.astype(np.float32)
            avgdl[fid] = np.float32(reader.avg_field_length(field))
        self._no_len_field = n_fields - 1
        self.doc_len = self._put(doc_len)
        self.avgdl = self._put(avgdl)

        deleted = np.zeros(self.n1, dtype=bool)
        deleted[self.n_docs:] = True  # sentinel + doc-axis pad slots
        for d in reader.deleted:
            if 0 <= d < self.n_docs:
                deleted[d] = True
        self.deleted = self._put(deleted)
        self.deleted_np = deleted
        self.live_docs = int(self.n_docs - len(reader.deleted))

        # ---- impact-ordered flat postings (for the matmul scorer) ----
        # tf-saturation is query-independent, so per-posting impacts are
        # precomputed here; query time only multiplies by idf·boost
        # (see ops/impact.py).
        term_df = postings.term_df.astype(np.int64)
        self.posting_base = np.concatenate(
            [[0], np.cumsum(term_df)]).astype(np.int64)
        if len(postings.terms):
            term_fields = np.asarray(
                [self.len_field_ids.get(t.split(":", 1)[0],
                                        n_fields - 1)
                 for t in postings.terms], dtype=np.int32)
        else:
            term_fields = np.zeros(0, dtype=np.int32)
        docs_flat = impacts = None
        if postings.block_docs.size:
            out = self._impacts_native(postings, term_fields, term_df,
                                       doc_len, avgdl)
            if out is None:
                out = self._impacts_numpy(postings, term_fields,
                                          term_df, doc_len, avgdl)
            (self.block_docs_np, self.block_impacts_np,
             self.block_max_impact, docs_flat, impacts) = out
        else:
            self.block_docs_np = np.concatenate([
                np.where(bd < 0, self.n1 - 1, bd).astype(np.int32),
                np.full((1, 128), self.n1 - 1, dtype=np.int32)])
            self.block_impacts_np = np.zeros((bd.shape[0] + 1, 128),
                                             dtype=np.float32)
            self.block_max_impact = np.zeros(0, dtype=np.float32)
        # Bucket the block-row axis for small segments (same compile-
        # shape motivation as the doc-axis pad above): pad rows are
        # all-sentinel/zero — the existing sentinel-row convention,
        # just more of them; consumers index rows <= n_block_rows
        # only. block_tfs pads to the same row count so shared row
        # indexing (block-scatter/mesh paths) stays in range.
        if self.n1 != self.n_docs + 1:
            from searchlite.ops.impact import pow2_bucket

            rows = self.block_docs_np.shape[0]
            p_rows = pow2_bucket(rows, minimum=16)
            if p_rows > rows:
                self.block_docs_np = np.concatenate([
                    self.block_docs_np,
                    np.full((p_rows - rows, 128), self.n1 - 1,
                            dtype=np.int32)])
                self.block_impacts_np = np.concatenate([
                    self.block_impacts_np,
                    np.zeros((p_rows - rows, 128), dtype=np.float32)])
            t_rows = self.block_tfs_np.shape[0]
            if p_rows > t_rows:
                self.block_tfs_np = np.concatenate([
                    self.block_tfs_np,
                    np.zeros((p_rows - t_rows, 128),
                             dtype=np.float32)])
        self._block_impacts = None
        self._block_impacts_live = None
        self._sparse_sentinels = None
        self._sparse_tid_tbl = None
        if docs_flat is None or len(docs_flat) == 0:
            docs_flat = np.zeros(1, dtype=np.int32)
            impacts = np.zeros(1, dtype=np.float32)
        # host flat CSR (doc-shard builder); device copies are lazy —
        # only the doc-sharded and multi-chip paths use them
        self.docs_flat_np = docs_flat.astype(np.int32, copy=False)
        self.impacts_flat_np = impacts
        self._docs_flat = None
        self._impacts_flat = None

    def _put(self, x):
        """Upload one segment-resident array: committed to the host
        tier's device when placed, otherwise an uncommitted transfer
        to the default accelerator (the normal HBM upload)."""
        if self.device is None:
            return self._jnp.asarray(x)
        import jax  # noqa: PLC0415

        return jax.device_put(x, self.device)

    def exec_scope(self):
        """Context manager for this segment's compute launches: pins
        eager ops and uncommitted ``jnp.asarray`` placements (query
        tables, masks, tile indexes) to the host tier's device so a
        placed segment's entire execution — uploads included — stays
        local. No-op (and free) for HBM-resident segments; jit
        executors already follow the committed operands, this keeps
        the per-query operand uploads off the accelerator link too."""
        if self.device is None:
            import contextlib  # noqa: PLC0415

            return contextlib.nullcontext()
        import jax  # noqa: PLC0415

        return jax.default_device(self.device)

    def clone_with_tombstones(self, reader, ordinal: int):
        """Shallow copy for a tombstone-delta of the SAME segment uuid:
        the expensive immutable state — precomputed impact blocks, flat
        CSR, dense rows, doc shards, heavy lookups, tile tables, agg
        bucket codes, and every HBM upload of them — is shared; only
        the deletion-DERIVED state rebuilds (lazily where possible):

        - ``deleted``/``deleted_np``/``live_docs``
        - idf tables (idf uses the live doc count) and the packed
          sparse term table that embeds f32 idf
        - ``block_impacts_live`` (tombstones folded into impacts — the
          sparse scorer's deletion contract) and the mesh sparse
          tables (same folding per shard)
        - the per-tid live-df cache, and the tile index's device
          deleted mask (``TileIndex.clone_for``)

        Everything else masks deletions at query time from the fresh
        ``deleted`` array (ops/impact.py::_score_m and friends), so a
        commit that merely tombstones docs in an existing segment
        no longer re-parses it on host or re-uploads it to HBM."""
        import copy

        d = copy.copy(self)
        d.reader = reader
        d.ord = ordinal
        deleted = np.zeros(self.n1, dtype=bool)
        deleted[self.n_docs:] = True  # sentinel + doc-axis pad slots
        for x in reader.deleted:
            if 0 <= x < self.n_docs:
                deleted[x] = True
        d.deleted_np = deleted
        d.deleted = d._put(deleted)
        d.live_docs = int(self.n_docs - len(reader.deleted))
        d._block_impacts_live = None
        d._idf_table = None
        d._idf32 = None
        d._sparse_tid_tbl = None
        d._live_df_cache = None
        d._mesh_sparse = None
        # significant_terms background counts are LIVE-doc statics
        # (ops/device_aggs.py::_sig_bg_structure) — deletion-derived,
        # unlike the shared _agg_structs bucket codes
        d._sig_bg_cache = None
        tl = getattr(self, "_tile_index", None)
        if tl is not None:
            d._tile_index = tl.clone_for(d)
        return d

    def _impacts_native(self, postings, term_fields, term_df, doc_len,
                        avgdl):
        """One C pass (native/slt_ingest.cpp::slt_impacts) computing
        the padded block-doc/impact arrays, per-block max impacts, and
        the pad-stripped flat CSR — bit-identical to _impacts_numpy
        (equivalence-fuzzed in tests/test_native.py) and ~20x faster:
        the numpy pipeline was 89 s of the 121 s reader open at 1M
        docs. Returns None when the native library is unavailable."""
        try:
            from searchlite.native import get_lib

            lib = get_lib()
        except Exception:  # noqa: BLE001
            lib = None
        if lib is None or not hasattr(lib, "slt_impacts"):
            return None
        bd = np.ascontiguousarray(postings.block_docs, dtype=np.int32)
        bt = np.ascontiguousarray(postings.block_tfs, dtype=np.float32)
        n_rows = bd.shape[0]
        row_field = np.repeat(
            term_fields, postings.term_block_count.astype(np.int64))
        row_field = np.ascontiguousarray(row_field, dtype=np.int32)
        n_post = int(term_df.sum())
        bd_out = np.empty((n_rows + 1, 128), dtype=np.int32)
        bi_out = np.empty((n_rows + 1, 128), dtype=np.float32)
        block_max = np.empty(n_rows, dtype=np.float32)
        docs_flat = np.empty(max(n_post, 1), dtype=np.int32)
        impacts = np.empty(max(n_post, 1), dtype=np.float32)
        n_flat = lib.slt_impacts(
            bd, n_rows, row_field, bt,
            np.ascontiguousarray(doc_len), doc_len.shape[1],
            np.ascontiguousarray(avgdl), self.k1, self.b,
            np.int32(self.n1 - 1), bd_out, bi_out, block_max,
            docs_flat, impacts)
        if n_flat != n_post:  # pads vs term_df disagree — fall back
            return None
        return (bd_out, bi_out, block_max, docs_flat[:n_post],
                impacts[:n_post])

    def _impacts_numpy(self, postings, term_fields, term_df, doc_len,
                       avgdl):
        """Pure-numpy fallback; the behavioral spec for slt_impacts."""
        bd = postings.block_docs
        flat_mask = bd.reshape(-1) >= 0
        docs_flat = bd.reshape(-1)[flat_mask]
        tfs_flat = postings.block_tfs.reshape(-1)[flat_mask]
        pf = np.repeat(term_fields, term_df)
        dl = doc_len[pf, docs_flat] if len(docs_flat) else \
            np.zeros(0, dtype=np.float32)
        avg = avgdl[pf] if len(docs_flat) else \
            np.zeros(0, dtype=np.float32)
        norm = np.where(avg > 0, dl / np.where(avg > 0, avg, 1.0), 1.0)
        denom = np.maximum(
            tfs_flat + self.k1 * (1.0 - self.b + self.b * norm), 1e-6)
        impacts = (tfs_flat * (self.k1 + 1.0) / denom).astype(np.float32)
        # per-block max impact (the sound BMW upper bound: impacts fold
        # tf AND length norm, so block_max_impact * idf bounds any
        # posting's contribution)
        blocked = np.zeros(bd.size, dtype=np.float32)
        blocked[flat_mask] = impacts
        block_max = blocked.reshape(-1, bd.shape[1]).max(axis=1)
        # 2D impact blocks (pads 0) + sentinel row, mirroring
        # block_docs: the batch scorer's M build row-gathers these
        # (128-wide row gathers read contiguous memory; element
        # gathers over flat CSR do not)
        bi_out = np.concatenate(
            [blocked.reshape(-1, 128),
             np.zeros((1, 128), dtype=np.float32)])
        bd_out = np.concatenate(
            [np.where(bd < 0, self.n1 - 1, bd).astype(np.int32),
             np.full((1, 128), self.n1 - 1, dtype=np.int32)])
        return (bd_out, bi_out, block_max, docs_flat,
                impacts)

    @property
    def block_tfs(self):
        if self._block_tfs is None:
            self._block_tfs = self._put(self.block_tfs_np)
        return self._block_tfs

    @property
    def block_docs(self):
        if self._block_docs is None:
            self._block_docs = self._put(self.block_docs_np)
        return self._block_docs

    @property
    def block_impacts(self):
        """Device copy of the posting impact blocks, stored in the
        precision policy's impact dtype (bf16 on accelerators in the
        fast modes — halves upload/HBM/gather traffic, D8; f32 under
        f32_strict and on CPU). Scorers upcast to f32 right after
        their gathers. Host conversion happens before upload so the
        link carries the small form."""
        if self._block_impacts is None:
            from searchlite.ops.precision import (  # noqa: PLC0415
                impacts_store_dtype,
            )

            dtype = impacts_store_dtype(
                self.device.platform if self.device else None)
            self._block_impacts = self._put(
                self.block_impacts_np.astype(np.dtype(dtype)))
        return self._block_impacts

    @property
    def block_impacts_live(self):
        """Block impacts with tombstoned docs zeroed — the sparse
        candidate scorer (ops/sparse.py) never materializes a doc-axis
        score array to mask, so deletions fold into the impacts
        instead (score 0 → non-match, same contract as the dense
        scorers' ``~deleted`` mask). Alias of ``block_impacts`` when
        the segment has no tombstones; otherwise computed once on
        device (segments are immutable, so this never invalidates)."""
        if self.live_docs == self.n_docs:
            return self.block_impacts
        if self._block_impacts_live is None:
            live = (~self.deleted)[self.block_docs]
            self._block_impacts_live = self.block_impacts * live
        return self._block_impacts_live

    @property
    def idf_table(self) -> np.ndarray:
        """f64 [n_terms] BM25 idf per term id (models/bm25.py::idf,
        vectorized). The batch builders (Python and native) read term
        idf from here so their weights are bit-identical."""
        tbl = getattr(self, "_idf_table", None)
        if tbl is None:
            df = self.reader.postings.term_df.astype(np.float64)
            live = float(max(self.live_docs, 0))
            ratio = (live - df + 0.5) / (df + 0.5)
            with np.errstate(divide="ignore", invalid="ignore"):
                tbl = np.where(
                    ratio <= 0.0, 1.0,
                    np.maximum(np.log(np.maximum(ratio, 1e-300)), 0.0)
                    + 1.0)
            self._idf_table = tbl
        return tbl

    @property
    def idf32(self) -> np.ndarray:
        """idf_table pre-rounded to f32 — the values the packed sparse
        scorer's device weight recomputation (f32(occ) * f32(idf))
        reads from sparse_tid_tbl; the host partition uses this same
        array to detect double-rounding overrides
        (ops/sparse.py::partition_sparse_batch_packed)."""
        tbl = getattr(self, "_idf32", None)
        if tbl is None:
            tbl = self._idf32 = self.idf_table.astype(np.float32)
        return tbl

    @property
    def sparse_tid_tbl(self):
        """[3, n_terms_pad] int32 device table for the packed sparse
        candidate scorer: per term id the posting block start, block
        count, and f32 idf bitcast — segment-static, uploaded once and
        cached, so per-batch query uploads carry only packed term ids
        (ops/sparse.py::make_sparse_candidate_scorer_packed). The term
        axis pads to a pow1.5 bucket to keep compile shapes in a small
        family across segments."""
        if self._sparse_tid_tbl is None:
            from searchlite.ops.impact import pow15_bucket

            p = self.reader.postings
            n = len(p.term_df)
            n_pad = pow15_bucket(max(n, 1), minimum=1024)
            tbl = np.zeros((3, n_pad), dtype=np.int32)
            tbl[0, :n] = p.term_block_start.astype(np.int32)
            tbl[1, :n] = p.term_block_count.astype(np.int32)
            tbl[2, :n] = self.idf32.view(np.int32)
            self._sparse_tid_tbl = self._put(tbl)
        return self._sparse_tid_tbl

    def heavy_lookup_host(self, term_cap: int):
        """Host arrays of the heavy-term doc→block lookup
        (ops/sparse.py::build_heavy_lookup_host), built once per
        (segment, term_cap) and cached. ``maximp`` (f32 [n_terms],
        covering EVERY term) also feeds the term-split partition's
        host routing predictor."""
        cached = getattr(self, "_heavy_lookup_host", None)
        if cached is not None and cached[0] == term_cap:
            return cached[1]
        from searchlite.ops.sparse import build_heavy_lookup_host

        host = build_heavy_lookup_host(
            self.reader.postings, self.block_docs_np,
            self.block_impacts_np, self.n1, term_cap)
        self._heavy_lookup_host = (term_cap, host)
        return host

    def live_term_df(self, tid: int) -> int:
        """Exact live (non-tombstoned) document frequency of one term
        — the single-query term-split route's count arithmetic
        (|light ∪ heavy| = n_strip + live_df − overlap) needs it.
        Free when the segment has no deletions; otherwise one host
        pass over the term's postings, cached per tid."""
        p = self.reader.postings
        if self.live_docs == self.n_docs:
            return int(p.term_df[tid])
        cache = getattr(self, "_live_df_cache", None)
        if cache is None:
            cache = self._live_df_cache = {}
        got = cache.get(tid)
        if got is None:
            base = int(p.df_base(tid))
            docs = self.docs_flat_np[base: base + int(p.term_df[tid])]
            got = int(np.count_nonzero(~self.deleted_np[docs]))
            cache[tid] = got
        return got

    def heavy_lookup(self, term_cap: int):
        """Device copies of the heavy-term doc→block lookup for the
        term-split candidate scorer — segment-static and cached: keys
        ``tbl``/``base``/``log2g`` int32 and ``maximp`` f32
        [n_terms]. ~1-2 int32 entries per heavy-term block, so a few
        MB even at 5M docs."""
        cached = getattr(self, "_heavy_lookup", None)
        if cached is not None and cached[0] == term_cap:
            return cached[1]
        host = self.heavy_lookup_host(term_cap)
        dev = {k: self._put(v) for k, v in host.items()}
        self._heavy_lookup = (term_cap, dev)
        return dev

    @property
    def sparse_sentinels(self):
        """[2] int32 device array (sentinel block row, dead doc slot)
        for the sparse candidate scorer — cached so the per-batch
        dispatch path transfers nothing segment-invariant."""
        if self._sparse_sentinels is None:
            self._sparse_sentinels = self._put(
                np.array([self.n_block_rows, self.n1 - 1],
                         dtype=np.int32))
        return self._sparse_sentinels

    def evict_device_caches(self) -> None:
        """Drop rebuildable HBM residents (the host copies stay). Called
        when a pruned wave launch hits RESOURCE_EXHAUSTED: the doc-shard
        re-block, dense rows, and whole-segment block arrays are pure
        caches the next dense query can re-upload."""
        self._doc_shards = None
        self._mesh_sparse = None
        self._dense_rows = None
        self._block_tfs = None
        self._block_docs = None
        self._block_impacts = None
        self._block_impacts_live = None
        self._sparse_sentinels = None
        self._sparse_tid_tbl = None
        self._heavy_lookup = None
        self._docs_flat = None
        self._impacts_flat = None

    @property
    def docs_flat(self):
        if self._docs_flat is None:
            self._docs_flat = self._put(self.docs_flat_np)
        return self._docs_flat

    @property
    def impacts_flat(self):
        if self._impacts_flat is None:
            from searchlite.ops.precision import (  # noqa: PLC0415
                impacts_store_dtype,
            )

            dtype = impacts_store_dtype(
                self.device.platform if self.device else None)
            self._impacts_flat = self._put(
                self.impacts_flat_np.astype(np.dtype(dtype)))
        return self._impacts_flat

    def field_id(self, field: str) -> int:
        return self.len_field_ids.get(field, self._no_len_field)

    def dense_rows(self, budget_bytes: int):
        """Precomputed dense impact rows for the highest-df terms
        (df >= n1/512, highest first) within ``budget_bytes`` of HBM.
        Zipf head terms carry most postings, so batch M builds can
        row-gather these instead of scattering their postings (the
        scatter's cost grows with the update count). Rows are stored in
        the precision policy's dense dtype
        (ops/precision.py::dense_store_dtype): bf16 on accelerators
        doubles row coverage per byte, at bf16 rounding of the stored
        impacts (D8). Returns None
        when nothing qualifies, else {"row_of_tid": dict,
        "m_dense": [n_rows+1, n1] jnp (last row zeros, the gather
        pad)}."""
        import os  # noqa: PLC0415

        from searchlite.ops.precision import (  # noqa: PLC0415
            dense_store_dtype,
        )

        dtype = dense_store_dtype(os.environ.get("SEARCHLITE_PRECISION",
                                                 "f32"))
        itemsize = np.dtype(dtype).itemsize
        key = (budget_bytes, np.dtype(dtype).name)
        cached = getattr(self, "_dense_rows", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        import jax.numpy as jnp  # noqa: PLC0415

        postings = self.reader.postings
        term_df = postings.term_df.astype(np.int64)
        max_rows = budget_bytes // (self.n1 * itemsize)
        order = np.argsort(-term_df, kind="stable")
        out = None
        # breakeven: a resident dense row pays 2·Q·n1 matmul FLOPs per
        # batch whether used or not; a scattered term pays per posting
        # — the high-df terms are the ones worth a dense row
        sel = order[:max_rows]
        rows = sel[term_df[sel] * 512 >= self.n1]
        if len(rows):
            # one vectorized scatter over all selected rows (a python
            # per-row loop costs seconds at thousands of rows)
            n_rows = len(rows)
            m = np.zeros((n_rows + 1) * self.n1, dtype=np.float32)
            starts = self.posting_base[rows]
            dfs = term_df[rows]
            total = int(dfs.sum())
            if total:
                row_of = np.repeat(np.arange(n_rows, dtype=np.int64),
                                   dfs)
                p_idx = (np.repeat(starts - np.concatenate(
                    [[0], np.cumsum(dfs)[:-1]]), dfs)
                    + np.arange(total, dtype=np.int64))
                docs = self.docs_flat_np[p_idx].astype(np.int64)
                m[row_of * self.n1 + docs] = \
                    self.impacts_flat_np[p_idx]
            # host-side dtype conversion BEFORE upload: bf16 halves the
            # transfer
            m = m.reshape(n_rows + 1, self.n1).astype(np.dtype(dtype))
            out = {
                "row_of_tid": {int(t): i for i, t in enumerate(rows)},
                "m_dense": jnp.asarray(m),
            }
        self._dense_rows = (key, out)
        return out

    def mesh_sparse_tables(self, n_shards: int):
        """Doc-sharded BLOCK layout + per-shard term tables for the
        multi-chip batched sparse candidate scorer
        (parallel/query.py::make_sharded_batch_scorer): the round-3
        single-chip headline path, laid out so every chip gathers its
        strips from purely local blocks (no collective until the final
        [B, k] top-k merge over collectives).

        Built from ``doc_shards(n_shards)``'s reordered postings:
        per-shard 128-wide blocks stacked to a uniform pow-1.5 pad
        ``bp`` (``block_docs``/``block_impacts`` [D·bp, 128], pad rows
        hold the per-shard dead doc = ``width`` and zero impacts —
        tombstoned docs' impacts are ALSO zeroed here, the sparse
        core's deletion contract), plus a per-shard term table
        ``tid_tbl`` [D, 3, n_terms_pad] (local block start, block
        count, f32 idf bit-cast — the shard-local analogue of
        ``sparse_tid_tbl``). ``blocks`` ([D·n_terms] host int64) feeds
        the reader's light/heavy partition (a row must be light on its
        WORST shard so the shard_map stays uniform SPMD)."""
        cached = getattr(self, "_mesh_sparse", None)
        if cached is not None and cached["n_shards"] == n_shards:
            return cached
        from searchlite.ops.impact import pow15_bucket  # noqa: PLC0415
        from searchlite.ops.precision import (  # noqa: PLC0415
            impacts_store_dtype,
        )

        sh = self.doc_shards(n_shards)
        n_terms = sh["n_terms"]
        width = sh["shard_width"]
        counts = sh["counts"]                      # [D*n_terms]
        base = sh["posting_base"]                  # [D*n_terms + 1]
        blocks = -(-counts // 128)
        block_base = np.concatenate([[0], np.cumsum(blocks)])
        sb_lo = block_base[np.arange(n_shards) * n_terms]
        sb_hi = block_base[(np.arange(n_shards) + 1) * n_terms]
        bp = pow15_bucket(int((sb_hi - sb_lo).max()) + 1, minimum=16)
        bdocs = np.full((n_shards * bp, 128), width, dtype=np.int32)
        bimps = np.zeros((n_shards * bp, 128), dtype=np.float32)
        total = int(counts.sum())
        if total:
            run_of = np.repeat(np.arange(len(counts), dtype=np.int64),
                               counts)
            shard_of = run_of // n_terms
            offset = np.arange(total, dtype=np.int64) \
                - base[:-1][run_of]
            dest = (shard_of * bp
                    + (block_base[:-1][run_of] - sb_lo[shard_of])) \
                * 128 + offset
            docs_sh = sh["docs_sh_np"][:total]
            imps_sh = sh["imps_sh_np"][:total]
            if self.live_docs != self.n_docs:
                glob = shard_of * width + docs_sh.astype(np.int64)
                imps_sh = np.where(self.deleted_np[glob], np.float32(0),
                                   imps_sh)
            bdocs.reshape(-1)[dest] = docs_sh
            bimps.reshape(-1)[dest] = imps_sh
        n_pad = pow15_bucket(max(n_terms, 1), minimum=1024)
        tid_tbl = np.zeros((n_shards, 3, n_pad), dtype=np.int32)
        local_start = (block_base[:-1].reshape(n_shards, n_terms)
                       - sb_lo[:, None])
        tid_tbl[:, 0, :n_terms] = local_start.astype(np.int32)
        tid_tbl[:, 1, :n_terms] = blocks.reshape(
            n_shards, n_terms).astype(np.int32)
        tid_tbl[:, 2, :n_terms] = self.idf32.view(np.int32)[None, :]
        jnp = self._jnp
        cached = {
            "n_shards": n_shards,
            "width": int(width),
            "bp": int(bp),
            "n_terms": n_terms,
            "blocks": blocks,
            # host copy of the per-shard local block starts (the
            # device tid_tbl's row 0) — the dense-remainder path
            # expands per-shard block tables from it
            "local_start_np": local_start.astype(np.int64),
            "block_docs": jnp.asarray(bdocs),
            "block_impacts": jnp.asarray(
                bimps.astype(np.dtype(impacts_store_dtype()))),
            "tid_tbl": jnp.asarray(tid_tbl),
            # (sentinel block row, per-shard width) as a traced device
            # pair so one strip-scorer compile serves every segment of
            # the same bucket shape
            "sent": jnp.asarray(
                np.array([bp - 1, width], dtype=np.int32)),
        }
        self._mesh_sparse = cached
        return cached

    # -- doc-sharded layout (large corpora) --------------------------------
    # Postings re-sorted by (doc_shard, term, doc): each shard's slice is
    # still term-major/doc-ascending, so the sorted-unique M build works
    # per shard with host-computed per-(term, shard) ranges. Lets one chip
    # loop shards sequentially (bounded memory) and maps 1:1 onto chips
    # for multi-device doc sharding (no M collective needed — every shard
    # owns complete doc columns).

    def doc_shards(self, n_shards: int):
        import jax.numpy as jnp  # noqa: PLC0415

        cached = getattr(self, "_doc_shards", None)
        if cached is not None and cached["n_shards"] == n_shards:
            return cached
        docs_flat = self.docs_flat_np
        impacts_flat = self.impacts_flat_np
        n_terms = len(self.reader.postings.terms)
        term_df = self.reader.postings.term_df.astype(np.int64)
        term_of_posting = np.repeat(
            np.arange(n_terms, dtype=np.int32), term_df)
        shard_width = -(-self.n1 // n_shards)
        shard_of = (docs_flat // shard_width).astype(np.int32)
        order = np.lexsort((docs_flat, term_of_posting, shard_of))
        docs_sh = (docs_flat[order] - shard_of[order].astype(np.int64)
                   * shard_width).astype(np.int32)
        imps_sh = impacts_flat[order]
        # per-(term, shard) posting counts: group key sorted by
        # (shard, term), so offsets come from a bincount over key ids
        key = shard_of[order].astype(np.int64) * n_terms + \
            term_of_posting[order]
        counts = np.bincount(key, minlength=n_shards * n_terms)
        base = np.concatenate([[0], np.cumsum(counts)])
        # re-blocked 128-wide layout per (term, shard) run, so shards
        # score through the same block-gather M build as whole segments;
        # local sentinel doc = shard_width (per-shard n1 = width+1)
        blocks = -(-counts // 128)
        block_base = np.concatenate([[0], np.cumsum(blocks)])
        total_blocks = int(block_base[-1])
        bdocs = np.full((total_blocks + 1, 128), shard_width,
                        dtype=np.int32)
        bimps = np.zeros((total_blocks + 1, 128), dtype=np.float32)
        if len(docs_sh):
            run_of = np.repeat(np.arange(len(counts), dtype=np.int64),
                               counts)
            offset = np.arange(len(docs_sh), dtype=np.int64) \
                - base[:-1][run_of]
            dest = block_base[:-1][run_of] * 128 + offset
            bdocs.reshape(-1)[dest] = docs_sh
            bimps.reshape(-1)[dest] = imps_sh
        from searchlite.ops.precision import (  # noqa: PLC0415
            impacts_store_dtype,
        )

        cached = {
            "n_shards": n_shards,
            "shard_width": int(shard_width),
            "block_docs": jnp.asarray(bdocs),
            "block_impacts": jnp.asarray(
                bimps.astype(np.dtype(impacts_store_dtype()))),
            # block range of key = shard*n_terms + term (host numpy)
            "block_base": block_base,
            "blocks": blocks,
            "sentinel_row": total_blocks,
            "counts": counts,
            "n_terms": n_terms,
            # flat reordered postings (host): sorted by (shard, term,
            # doc), LOCAL doc coords — the multi-chip doc-sharded
            # executor slices these per chip (parallel/query.py)
            "docs_sh_np": docs_sh,
            "imps_sh_np": imps_sh,
            "posting_base": base,
        }
        self._doc_shards = cached
        return cached
