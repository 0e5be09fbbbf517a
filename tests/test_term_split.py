"""Term-split batched scoring (device-side batched WAND) vs the dense
path.

ops/sparse.py::_candidate_core_split lets head-term queries ride the
candidate strips: light terms are gathered/sorted/summed as usual,
heavy terms are added by point lookup over the segment's heavy lookup
table, and a per-row soundness certificate (the WAND upper-bound
argument) marks rows whose result provably equals the dense scorer's.
Unsound rows are re-scored dense by the reader's fallback wave
(api/reader.py::_apply_split_fallbacks).

These tests pin: (a) agreement with the dense path across randomized
workloads including head terms, deletions, duplicates, multi-segment
indexes, and per-query limits (tolerance = f32 association-order ulps,
divergence D10); (b) the fallback wave fires and still yields exact
results when the certificate cannot hold (candidates fewer than k);
(c) the lookup-table invariant that any doc group spans at most two
blocks.

Reference behavior contract: WAND/BMW return identical top-k to brute
BM25 (`searchlite-core/tests/pruning.rs:44-105`)."""

import random

import numpy as np
import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema

VOCAB = [f"w{i}" for i in range(150)]
HEADS = ["head0", "head1", "head2"]


def build_index(seed=11, n_docs=3000, segments=2, delete_every=17,
                head_p=(0.8, 0.5, 0.25)):
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, len(VOCAB) + 1)
    probs /= probs.sum()
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}]}))
    writer = idx.writer()
    for i in range(n_docs):
        n = int(rng.integers(4, 40))
        toks = list(rng.choice(VOCAB, size=n, p=probs))
        for h, p in zip(HEADS, head_p):
            if rng.random() < p:
                toks.append(h)
        writer.add_document({"_id": str(i), "body": " ".join(toks)})
        if segments > 1 and i == n_docs // segments:
            writer.commit()
    writer.commit()
    if delete_every:
        w2 = idx.writer()
        for i in range(0, n_docs, delete_every):
            w2.delete_document(str(i))
        w2.commit()
    return idx


def make_queries(rng, n, max_terms=4, head_p=0.6, dup_p=0.15):
    out = []
    for _ in range(n):
        t = rng.randint(1, max_terms)
        terms = [rng.choice(VOCAB) for _ in range(t)]
        if rng.random() < head_p:
            terms.append(rng.choice(HEADS))
        if rng.random() < head_p / 2:
            terms.append(rng.choice(HEADS))
        if rng.random() < dup_p and terms:
            terms.append(terms[0])  # occ > 1
        random.shuffle(terms)
        out.append(" ".join(terms))
    return out


def assert_same(dense, split, rtol=1e-5, atol=1e-5):
    assert len(dense) == len(split)
    for qi, (dr, sr) in enumerate(zip(dense, split)):
        assert len(dr) == len(sr), f"q{qi} lengths {len(dr)}/{len(sr)}"
        if not dr:
            continue
        # the sorted score vectors must agree elementwise...
        ds = np.array(sorted(s for _d, s in dr), dtype=np.float64)
        ss = np.array(sorted(s for _d, s in sr), dtype=np.float64)
        assert np.allclose(ds, ss, rtol=rtol, atol=atol), \
            f"q{qi} score vectors {ds} vs {ss}"
        # ...every doc returned by both must score identically (tol),
        # and any doc returned by only one side must be a genuine
        # near-tie with some doc on the other side (D10 ulp noise can
        # legitimately swap exact ties at the top-k boundary)
        dd = {d: s for d, s in dr}
        sd = {d: s for d, s in sr}
        for d in set(dd) & set(sd):
            assert abs(dd[d] - sd[d]) <= atol + rtol * abs(dd[d]), \
                f"q{qi} doc {d}: {dd[d]} vs {sd[d]}"
        for only_d, here, there in (
                (set(dd) - set(sd), dd, sd),
                (set(sd) - set(dd), sd, dd)):
            for d in only_d:
                s = here[d]
                near = min(abs(s - v) for v in there.values())
                assert near <= atol + rtol * abs(s), \
                    f"q{qi} boundary doc {d} ({s}) not a tie"


def run_both(reader, queries, limit, monkeypatch, max_blocks=8,
             **kw):
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS",
                       str(max_blocks))
    monkeypatch.setenv("SEARCHLITE_HEAVY_TERM_BLOCKS",
                       str(max_blocks))
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "0")
    dense = reader.search_batch(queries, limit=limit, **kw)
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "1")
    split = reader.search_batch(queries, limit=limit, **kw)
    return dense, split


@pytest.fixture(scope="module")
def index():
    return build_index()


def test_head_term_queries_match_dense(index, monkeypatch):
    rng = random.Random(7)
    reader = index.reader()
    queries = make_queries(rng, 64)
    dense, split = run_both(reader, queries, 10, monkeypatch)
    assert_same(dense, split)


def test_split_actually_engages(index, monkeypatch):
    """Head-term rows must ride the split scorer, not fall back: with
    all-head queries sharing one rare discriminating term, soundness
    holds and no dense wave runs."""
    reader = index.reader()
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_HEAVY_TERM_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "1")
    # w100+ are rare (zipf tail): strong tail evidence, tiny head UB
    queries = [f"w14{i} head0" for i in range(5)] * 4
    before = getattr(reader, "_split_fallback_rows", 0)
    split = reader.search_batch(queries, limit=3)
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "0")
    dense = reader.search_batch(queries, limit=3)
    assert_same(dense, split)
    assert getattr(reader, "_split_fallback_rows", 0) == before, \
        "expected zero fallbacks on rare-tail + head queries"


def test_fallback_wave_exactness(index, monkeypatch):
    """Queries whose certificate cannot hold (fewer candidates than k,
    heavy terms present) must flow through the dense fallback wave and
    still match the dense path exactly."""
    reader = index.reader()
    # w149 is the rarest vocab term; limit larger than its df forces
    # theta = -inf with hub > 0 → unsound → fallback
    queries = ["w149 head0", "w148 head1 head2", "head0 w147"] * 3
    dense, split = run_both(reader, queries, 200, monkeypatch)
    assert_same(dense, split)
    assert getattr(reader, "_split_fallback_rows", 0) > 0


def test_all_heavy_and_oov_rows(index, monkeypatch):
    """Rows with no light terms (all-head) or nothing at all keep
    dense routing / empty results."""
    reader = index.reader()
    queries = ["head0", "head0 head1", "zzz-not-a-term", "head2"]
    dense, split = run_both(reader, queries, 10, monkeypatch)
    assert_same(dense, split)


def test_per_query_limits(index, monkeypatch):
    rng = random.Random(13)
    reader = index.reader()
    queries = make_queries(rng, 16)
    limits = [rng.randint(1, 20) for _ in queries]
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_HEAVY_TERM_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "0")
    dense = reader.search_batch(queries, limit=20, limits=limits)
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "1")
    split = reader.search_batch(queries, limit=20, limits=limits)
    assert_same(dense, split)
    for lim, row in zip(limits, split):
        assert len(row) <= lim


def test_fuzz_random_workloads(monkeypatch):
    rng = random.Random(29)
    for trial in range(3):
        idx = build_index(seed=100 + trial,
                          n_docs=rng.randint(800, 2500),
                          segments=rng.randint(1, 3),
                          delete_every=rng.choice([0, 11]))
        reader = idx.reader()
        queries = make_queries(rng, 32, max_terms=5)
        dense, split = run_both(
            reader, queries, rng.choice([1, 5, 10, 50]), monkeypatch,
            max_blocks=rng.choice([4, 8, 16]))
        assert_same(dense, split)


def test_oversized_corpus_split_route(index, monkeypatch):
    """The sharded (oversized-corpus) branch also admits term-split
    rows and patches unsound ones through the sharded dense scan."""
    rng = random.Random(31)
    reader = index.reader()
    queries = make_queries(rng, 24)
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_HEAVY_TERM_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "0")
    dense = reader.search_batch(queries, limit=10)
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "1")
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "200000")
    split = reader.search_batch(queries, limit=10)
    assert_same(dense, split)


def _single(reader, q, limit=10, execution="bm25"):
    res = reader.search({"query": q, "limit": limit,
                         "execution": execution})
    return ([(h.doc_id, h.score) for h in res.hits],
            res.total_hits_estimate)


def test_single_query_split_route(index, monkeypatch):
    """The single-query term-split route (head term via full-strip
    lookup) returns the dense path's hits AND its exact match count —
    counts come from |light ∪ heavy| = n_strip + live_df − overlap,
    with tombstones excluded on both sides."""
    reader = index.reader()
    monkeypatch.setenv("SEARCHLITE_SINGLE_SPARSE_MIN_DOCS", "0")
    monkeypatch.setenv("SEARCHLITE_SINGLE_SPARSE_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_HEAVY_TERM_BLOCKS", "8")
    queries = ["w120 head0", "w50 w90 head1", "w30 head2 w77",
               "w140 w141 head0"]
    for q in queries:
        monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "0")
        dense_hits, dense_cnt = _single(reader, q)
        monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "1")
        split_hits, split_cnt = _single(reader, q)
        assert split_cnt == dense_cnt, f"{q}: count"
        assert_same([dense_hits], [split_hits])


def test_single_query_split_two_head_terms(index, monkeypatch):
    """Two over-cap terms in one query: only the LARGEST takes the
    point-lookup role; the second head term rides the strip with the
    light terms (its blocks count toward the light budget). Results
    and counts still match the dense path exactly."""
    reader = index.reader()
    monkeypatch.setenv("SEARCHLITE_SINGLE_SPARSE_MIN_DOCS", "0")
    monkeypatch.setenv("SEARCHLITE_SINGLE_SPARSE_BLOCKS", "16")
    monkeypatch.setenv("SEARCHLITE_HEAVY_TERM_BLOCKS", "4")
    monkeypatch.setenv("SEARCHLITE_SPLIT_UB_RATIO", "0")  # force try
    queries = ["head0 head1 w40", "head1 head2 w10 w11",
               "head0 head2 w3"]
    for q in queries:
        monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "0")
        dense_hits, dense_cnt = _single(reader, q)
        monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "1")
        split_hits, split_cnt = _single(reader, q)
        assert split_cnt == dense_cnt, f"{q}: count"
        assert_same([dense_hits], [split_hits])


def test_single_query_split_unsound_falls_through(index, monkeypatch):
    """When the certificate can't hold (limit above the light df), the
    route returns None and the dense path answers — results must be
    the dense results trivially, and still correct."""
    reader = index.reader()
    monkeypatch.setenv("SEARCHLITE_SINGLE_SPARSE_MIN_DOCS", "0")
    monkeypatch.setenv("SEARCHLITE_SINGLE_SPARSE_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_HEAVY_TERM_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_SPLIT_UB_RATIO", "0")  # no predictor
    q = "w149 head0"
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "0")
    dense_hits, dense_cnt = _single(reader, q, limit=300)
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "1")
    split_hits, split_cnt = _single(reader, q, limit=300)
    assert split_cnt == dense_cnt
    assert_same([dense_hits], [split_hits])


def test_single_query_split_multi_heavy(index, monkeypatch):
    """When several over-cap terms can't all fit the strip, the route
    peels them into point-lookup slots (up to SEARCHLITE_HEAVY_SLOTS)
    instead of bailing to the dense path. Top-k must still match the
    dense path exactly (certificate θ > Σ HUBᵢ); the count becomes a
    LOWER-BOUND estimate — the `total_hits_estimate` contract the
    pruned tile path already uses (pruned ≤ dense, > 0)."""
    reader = index.reader()
    monkeypatch.setenv("SEARCHLITE_SINGLE_SPARSE_MIN_DOCS", "0")
    # strip cap small enough that the over-cap terms cannot all
    # ride the strip — multi-heavy is forced, not elective (cap 2
    # makes every head AND mid term heavy-eligible, so the greedy
    # peel can always reach a fitting light set)
    monkeypatch.setenv("SEARCHLITE_SINGLE_SPARSE_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_HEAVY_TERM_BLOCKS", "2")
    monkeypatch.setenv("SEARCHLITE_SPLIT_UB_RATIO", "0")  # force try
    queries = ["head0 head1 w40", "head0 head1 head2 w10 w11",
               "head1 head2 w3 w120"]
    for q in queries:
        monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "0")
        dense_hits, dense_cnt = _single(reader, q)
        monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "1")
        split_hits, split_cnt = _single(reader, q)
        assert 0 < split_cnt <= dense_cnt, \
            f"{q}: estimate {split_cnt} vs dense {dense_cnt}"
        assert_same([dense_hits], [split_hits])


def test_single_query_split_multi_heavy_engages(index, monkeypatch):
    """The multi-heavy branch actually runs (≥2 heavy slots) on the
    forced-small caps — guards against a silent fall-through to the
    dense path masking the previous test."""
    reader = index.reader()
    monkeypatch.setenv("SEARCHLITE_SINGLE_SPARSE_MIN_DOCS", "0")
    monkeypatch.setenv("SEARCHLITE_SINGLE_SPARSE_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_HEAVY_TERM_BLOCKS", "2")
    monkeypatch.setenv("SEARCHLITE_SPLIT_UB_RATIO", "0")
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "1")
    seen_h = []
    orig = type(reader)._sparse_single_split_scorer

    def spy(self):
        real = orig(self)

        def wrapped(*args, **kw):
            seen_h.append(int(args[8].shape[1]))  # hvy [2, h_pad]
            return real(*args, **kw)

        return wrapped

    monkeypatch.setattr(type(reader),
                        "_sparse_single_split_scorer", spy)
    _single(reader, "head0 head1 head2 w10 w11")
    assert seen_h and max(seen_h) >= 2, seen_h


def test_heavy_lookup_invariant():
    """Every doc group names a block window of ≤ 2 blocks that covers
    all of the term's postings in the group (the G=128 guarantee and
    its widenings — build_heavy_lookup_host)."""
    idx = build_index(seed=77, n_docs=1500, segments=1,
                      delete_every=0)
    reader = idx.reader()
    dseg = reader.device_segments[0]
    from searchlite.ops.sparse import build_heavy_lookup_host

    p = dseg.reader.postings
    hl = build_heavy_lookup_host(p, dseg.block_docs_np,
                                 dseg.block_impacts_np, dseg.n1, 2)
    heavy = np.flatnonzero(hl["base"] >= 0)
    assert len(heavy) > 0
    for t in heavy:
        docs, _tfs = p.term_postings(int(t))
        g = docs >> hl["log2g"][t]
        ent = hl["tbl"][hl["base"][t] + g]
        # block containing posting j is blk0 + j // 128
        blk0 = int(p.term_block_start[t])
        blk_of_doc = blk0 + np.arange(len(docs)) // 128
        assert ((blk_of_doc == ent) | (blk_of_doc == ent + 1)).all()
        # maximp is a sound upper bound on the term's impacts
        flat = dseg.impacts_flat_np
        base = int(p.df_base(int(t)))
        assert hl["maximp"][t] >= flat[
            base: base + len(docs)].max() - 1e-6


def test_full_strip_fallback_replaces_dense_at_scale(index,
                                                     monkeypatch):
    """At oversized corpora (shard budget set), ineligible head-term
    rows and unsound split rows are re-scored on FULL candidate strips
    (every term on the strip — exact by construction,
    reader._full_strip_launch) instead of the doc-sharded dense scan,
    and the results still match the dense path."""
    rng = random.Random(41)
    reader = index.reader()
    queries = make_queries(rng, 24) + ["w149 head0", "head0 w147"]
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "0")
    dense = reader.search_batch(queries, limit=50)
    # oversized branch + certificate-hostile shape (limit > rare df)
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "1")
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_HEAVY_TERM_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "200000")
    calls = []
    orig = type(reader)._full_strip_launch

    def spy(self, dseg, qb, k):
        out = orig(self, dseg, qb, k)
        calls.append((int(qb["n_queries"]), out is not None))
        return out

    monkeypatch.setattr(type(reader), "_full_strip_launch", spy)
    split = reader.search_batch(queries, limit=50)
    assert_same(dense, split)
    assert calls, "full-strip launch never fired on oversized branch"
    assert any(ok for _n, ok in calls), \
        "full-strip launch never handled a subset"


def test_full_strip_handles_all_heavy_rows(index, monkeypatch):
    """SEARCHLITE_HEAVY_SLOTS=0 makes every head-term row ineligible:
    the whole remainder must ride the full-strip pass (oversized
    branch) and stay exact."""
    reader = index.reader()
    queries = [f"head0 w{i}" for i in range(8)] + ["head1 head2"]
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "0")
    dense = reader.search_batch(queries, limit=10)
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "1")
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_HEAVY_TERM_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_HEAVY_SLOTS", "0")
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "200000")
    split = reader.search_batch(queries, limit=10)
    assert_same(dense, split)


def test_chunked_tier_launches_exact(index, monkeypatch):
    """A tiny STRIP_CHUNK_ELEMS forces every tier into multiple
    row-chunked launches (width-sorted row order): results must be
    identical to the unchunked run."""
    import searchlite.ops.sparse as sparse_mod

    rng = random.Random(43)
    reader = index.reader()
    queries = make_queries(rng, 32, max_terms=5)
    dense, split = run_both(reader, queries, 10, monkeypatch,
                            max_blocks=16)
    assert_same(dense, split)
    monkeypatch.setattr(sparse_mod, "STRIP_CHUNK_ELEMS", 4096)
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "1")
    chunked = reader.search_batch(queries, limit=10)
    assert_same(dense, chunked)
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "0")
    chunked_plain = reader.search_batch(queries, limit=10)
    assert_same(dense, chunked_plain)


def test_wand_bmw_strip_route_at_scale(index, monkeypatch):
    """SEARCHLITE_BATCH_PRUNE=auto at corpora over the strip-min-docs
    threshold routes batched wand/bmw through the candidate-strip
    scorer (execution is a hint; top-k identical), and =pq pins the
    tile path."""
    rng = random.Random(47)
    reader = index.reader()
    queries = make_queries(rng, 16)
    monkeypatch.setenv("SEARCHLITE_BATCH_STRIP_MIN_DOCS", "1")
    bm25 = reader.search_batch(queries, limit=10, execution="bm25")
    wand = reader.search_batch(queries, limit=10, execution="wand")
    bmw = reader.search_batch(queries, limit=10, execution="bmw")
    assert_same(bm25, wand)
    assert_same(bm25, bmw)
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", "pq")
    pq = reader.search_batch(queries, limit=10, execution="bmw")
    assert_same(bm25, pq)


def test_subset_qb_stays_packed_eligible(index, monkeypatch):
    """subset_impact_batch must carry qs_cnt through: without it the
    oversized-corpus full-strip fallback loses packed/tiered/chunked
    eligibility and compiles ONE un-chunked [bl, nblk*128] strip sort
    (192 rows x 6.29M lanes = 18 GB HBM at 5M docs — the round-4
    bench_scale OOM)."""
    from searchlite.ops.impact import subset_impact_batch
    from searchlite.ops.sparse import _packed_applies

    reader = index.reader()
    qbs = []
    orig = subset_impact_batch

    def spy(qb, q_idx, **kw):
        out = orig(qb, q_idx, **kw)
        qbs.append((qb, np.asarray(q_idx), out))
        return out

    # the reader imports it function-locally from ops.impact — patch
    # the source module so the call-time lookup resolves to the spy
    import searchlite.ops.impact as impact_mod
    monkeypatch.setattr(impact_mod, "subset_impact_batch", spy)
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "1")
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_HEAVY_TERM_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "200000")
    rng = random.Random(41)
    queries = make_queries(rng, 24) + ["w149 head0", "head0 w147"]
    reader.search_batch(queries, limit=50)
    assert qbs, "no heavy remainder was re-packed"
    for parent, q_idx, sub in qbs:
        assert _packed_applies(parent)
        assert _packed_applies(sub), \
            "subset qb lost packed eligibility (qs_cnt dropped)"
        # per-row entry counts and occ values must match the parent's
        pc = np.diff(parent["qs_start"])[q_idx]
        sc = np.diff(sub["qs_start"])[: len(q_idx)]
        assert np.array_equal(pc, sc)


def test_full_strip_launch_chunks_rows(index, monkeypatch):
    """The full-strip fallback must honor STRIP_CHUNK_ELEMS: with a
    tiny cap it emits many row-chunked launches and stays exact."""
    import searchlite.ops.sparse as sparse_mod

    reader = index.reader()
    queries = [f"head0 w{i}" for i in range(8)] + ["head1 head2"]
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "0")
    monkeypatch.delenv("SEARCHLITE_SPARSE_MAX_BLOCKS", raising=False)
    dense = reader.search_batch(queries, limit=10)
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "1")
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "8")
    monkeypatch.setenv("SEARCHLITE_HEAVY_SLOTS", "0")
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "200000")
    monkeypatch.setattr(sparse_mod, "STRIP_CHUNK_ELEMS", 4096)
    split = reader.search_batch(queries, limit=10)
    assert_same(dense, split)


def test_legacy_table_refuses_oversized_launch(index, monkeypatch):
    """When the packed format doesn't apply, the legacy explicit-table
    path must refuse launches past the element cap (the caller falls
    back dense) instead of compiling an HBM-sized sort."""
    import searchlite.ops.sparse as sparse_mod

    reader = index.reader()
    queries = [f"w{i} w{i+1} head0" for i in range(0, 12, 2)]
    monkeypatch.setenv("SEARCHLITE_TERM_SPLIT", "0")
    monkeypatch.delenv("SEARCHLITE_SPARSE_MAX_BLOCKS", raising=False)
    dense = reader.search_batch(queries, limit=10)
    monkeypatch.setattr(sparse_mod, "_packed_applies",
                        lambda qb: False)
    monkeypatch.setattr(sparse_mod, "STRIP_CHUNK_ELEMS", 64)
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "8")
    out = reader.search_batch(queries, limit=10)
    assert_same(dense, out)
