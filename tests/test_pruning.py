"""Pruned (doc-tile WAND/BMW) execution exactness vs the dense oracle.

Port of the reference's pruning contract
(`/root/reference/searchlite-core/tests/pruning.rs:44-105`): on seeded
random corpora, `wand` and `bmw` must return top-k sets identical to the
brute-force `bm25` strategy — same docs, same scores, same
(score desc, doc_id asc) order. Here the contract covers both the
batched API and the single-query request surface, under multi-segment
indexes, score ties (duplicate docs), and tombstones.
"""

import random

import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema


def _build_index(seed: int, segments: int = 3, docs_per_segment: int = 400,
                 vocab_size: int = 80, delete: int = 50):
    rng = random.Random(seed)
    vocab = [f"w{i}" for i in range(vocab_size)]
    weights = [1.0 / (j + 1) for j in range(vocab_size)]  # zipf-ish
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({"text_fields": [
            {"name": "body", "analyzer": "default", "stored": False,
             "indexed": True}]}))
    n = 0
    for _seg in range(segments):
        writer = idx.writer()
        for _i in range(docs_per_segment):
            body = " ".join(rng.choices(vocab, weights=weights,
                                        k=rng.randint(2, 30)))
            writer.add_document({"_id": str(n), "body": body})
            n += 1
            if rng.random() < 0.08:  # duplicate → exact score ties
                writer.add_document({"_id": str(n), "body": body})
                n += 1
        writer.commit()
    if delete:
        writer = idx.writer()
        writer.delete_documents(
            [str(rng.randrange(n)) for _ in range(delete)])
        writer.commit()
    return idx, vocab, rng


@pytest.mark.parametrize("mode", ["per_query", "union"])
@pytest.mark.parametrize("seed", [7, 21])
def test_batch_wand_bmw_match_bm25_on_random_corpora(seed, mode,
                                                     monkeypatch):
    # tiny tiles force real multi-tile pruning even on a small corpus;
    # both batched pruned formulations (per-query waves and union
    # waves) must be exact
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", mode)
    idx, vocab, rng = _build_index(seed)
    reader = idx.reader()
    queries = [" ".join(rng.sample(vocab, k=rng.randint(1, 5)))
               for _ in range(40)]
    queries += ["missing-term", vocab[0],
                " ".join(vocab[:8])]  # head-heavy disjunction
    for limit in (1, 10, 37):
        dense = reader.search_batch(queries, limit=limit)
        for strategy in ("wand", "bmw"):
            pruned = reader.search_batch(queries, limit=limit,
                                         execution=strategy)
            for query, a, b in zip(queries, dense, pruned):
                assert [d for d, _ in a] == [d for d, _ in b], \
                    (strategy, limit, query)
                for (_, sa), (_, sb) in zip(a, b):
                    assert sa == pytest.approx(sb, abs=1e-5), \
                        (strategy, limit, query)


def test_batch_pruned_seed_extremes(monkeypatch):
    """Seed-size extremes exercise wave 3: seeding a single tile forces
    the survivor wave to do the real work; a huge seed skips it."""
    idx, vocab, rng = _build_index(33, segments=1, docs_per_segment=600)
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", "union")  # union knob
    reader = idx.reader()
    queries = [" ".join(rng.sample(vocab, k=3)) for _ in range(12)]
    dense = reader.search_batch(queries, limit=10)
    for seeds in ("1", "1000"):
        monkeypatch.setenv("SEARCHLITE_SEED_TILES", seeds)
        pruned = reader.search_batch(queries, limit=10, execution="bmw")
        assert pruned == dense or all(
            [d for d, _ in a] == [d for d, _ in b]
            and all(sa == pytest.approx(sb, abs=1e-5)
                    for (_, sa), (_, sb) in zip(a, b))
            for a, b in zip(dense, pruned))


def test_pruned_waves_chunked_by_memory_budget(monkeypatch):
    """A tiny M budget splits every exact-scoring wave into multiple
    chunk launches; results must stay identical to dense. Regression:
    the wave-3 survivor set is unbounded and a single launch OOMed the
    device at 5M docs (RESOURCE_EXHAUSTED, 2026-08-16)."""
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", "union")  # M budget
    idx, vocab, rng = _build_index(13, segments=2, docs_per_segment=500)
    reader = idx.reader()
    queries = [" ".join(rng.sample(vocab, k=rng.randint(1, 4)))
               for _ in range(16)]
    dense = reader.search_batch(queries, limit=10)
    single_dense = [reader.search({"query": q, "limit": 10})
                    for q in queries[:6]]
    # ~64KB budget => a handful of tiles per launch at s_pad 64, T 128
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "131072")
    reader2 = idx.reader()
    pruned = reader2.search_batch(queries, limit=10, execution="bmw")
    for query, a, b in zip(queries, dense, pruned):
        assert [d for d, _ in a] == [d for d, _ in b], query
        for (_, sa), (_, sb) in zip(a, b):
            assert sa == pytest.approx(sb, abs=1e-5), query
    for q, exp in zip(queries[:6], single_dense):
        got = reader2.search({"query": q, "limit": 10,
                              "execution": "bmw"})
        assert [h.doc_id for h in got.hits] == \
            [h.doc_id for h in exp.hits], q
        for ha, hb in zip(exp.hits, got.hits):
            assert hb.score == pytest.approx(ha.score, abs=1e-5)


def test_batch_pruned_rejects_unknown_execution():
    idx, _vocab, _rng = _build_index(5, segments=1, docs_per_segment=50,
                                     delete=0)
    reader = idx.reader()
    from searchlite.errors import QueryError
    with pytest.raises(QueryError):
        reader.search_batch(["w1"], limit=5, execution="turbo")


def test_single_query_wand_bmw_match_bm25(monkeypatch):
    """`execution: wand|bmw` on the request surface returns results
    identical to the dense default (reference `tests/pruning.rs`)."""
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    monkeypatch.setenv("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")
    idx, vocab, rng = _build_index(11)
    reader = idx.reader()
    queries = [" ".join(rng.sample(vocab, k=rng.randint(1, 4)))
               for _ in range(12)]
    queries.append(" ".join(vocab[:6]))
    for query in queries:
        base = reader.search({"query": query, "limit": 10})
        for strategy in ("wand", "bmw"):
            res = reader.search({"query": query, "limit": 10,
                                 "execution": strategy})
            assert [h.doc_id for h in res.hits] == \
                [h.doc_id for h in base.hits], (strategy, query)
            for ha, hb in zip(base.hits, res.hits):
                assert ha.score == pytest.approx(hb.score, abs=1e-5)
            assert res.total_hits_estimate <= base.total_hits_estimate


def test_single_query_pruned_with_filters_and_msm(monkeypatch):
    """Pruning must stay exact under filters / minimum_should_match /
    must_not — the matcher evaluates exactly inside scored tiles and the
    bound argument is mask-independent."""
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    monkeypatch.setenv("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")
    rng = random.Random(19)
    vocab = [f"w{i}" for i in range(50)]
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "keyword_fields": [{"name": "cat", "stored": False,
                                "indexed": True, "fast": True}],
            "numeric_fields": [{"name": "rank", "type": "i64",
                                "stored": False, "fast": True}],
        }))
    writer = idx.writer()
    for i in range(900):
        writer.add_document({
            "_id": str(i),
            "body": " ".join(rng.choices(
                vocab, weights=[1 / (j + 1) for j in range(50)],
                k=rng.randint(2, 20))),
            "cat": rng.choice(["a", "b", "c"]),
            "rank": rng.randint(0, 100),
        })
    writer.commit()
    reader = idx.reader()
    requests = [
        {"query": {"type": "bool",
                   "should": [{"type": "term", "field": "body",
                               "value": v} for v in vocab[:5]],
                   "minimum_should_match": 2},
         "limit": 10},
        {"query": {"type": "bool",
                   "must": [{"type": "term", "field": "body",
                             "value": "w3"}],
                   "must_not": [{"type": "term", "field": "body",
                                 "value": "w0"}]},
         "limit": 10},
        {"query": "w1 w2 w3",
         "filter": {"KeywordEq": {"field": "cat", "value": "b"}},
         "limit": 10},
        {"query": "w4 w5",
         "filter": {"I64Range": {"field": "rank", "min": 20, "max": 70}},
         "limit": 10},
    ]
    for req in requests:
        base = reader.search(dict(req))
        for strategy in ("wand", "bmw"):
            res = reader.search({**req, "execution": strategy})
            assert [h.doc_id for h in res.hits] == \
                [h.doc_id for h in base.hits], (strategy, req)
            for ha, hb in zip(base.hits, res.hits):
                assert ha.score == pytest.approx(hb.score, abs=1e-5)


def test_pruned_profile_reports_real_counts(monkeypatch):
    """With real pruning engaged, the profile reports actually-touched
    postings (`pruning_simulated: false`) and they are <= the dense
    posting volume."""
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    monkeypatch.setenv("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")
    idx, vocab, rng = _build_index(17, segments=1, docs_per_segment=800,
                                   delete=0)
    reader = idx.reader()
    dense = reader.search({"query": " ".join(vocab[:4]), "limit": 5,
                           "profile": True})
    pruned = reader.search({"query": " ".join(vocab[:4]), "limit": 5,
                            "execution": "bmw", "profile": True})
    dprof = dense.profile["execution"]
    pprof = pruned.profile["execution"]
    assert pprof.get("pruning_simulated") is False
    assert pprof["postings_advanced"] <= dprof["postings_advanced"]


def test_bmw_block_size_knob(monkeypatch):
    """The reference's bmw_block_size request knob maps to the doc-tile
    width; any width returns identical exact results."""
    monkeypatch.setenv("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")
    idx, vocab, rng = _build_index(3, segments=1, docs_per_segment=500,
                                   delete=0)
    reader = idx.reader()
    query = " ".join(vocab[:4])
    base = reader.search({"query": query, "limit": 10})
    for size in (64, 128, 300, 4096):
        res = reader.search({"query": query, "limit": 10,
                             "execution": "bmw",
                             "bmw_block_size": size})
        assert [h.doc_id for h in res.hits] == \
            [h.doc_id for h in base.hits], size


def test_tile_index_tables_match_bruteforce():
    """TileIndex entry runs / tile maxes / run tables vs a brute-force
    recomputation from the flat postings."""
    import numpy as np

    from searchlite.ops.tiles import TileIndex

    idx, vocab, rng = _build_index(57, segments=1, docs_per_segment=700,
                                   delete=0)
    reader = idx.reader()
    seg = reader.segments[0]
    dseg = reader.device_segments[0]
    tl = TileIndex(dseg, tile_width=128)

    docs = dseg.docs_flat_np
    imps = dseg.impacts_flat_np
    term_df = seg.postings.term_df.astype(np.int64)
    base = dseg.posting_base

    for tid in rng.sample(range(len(term_df)), k=min(25, len(term_df))):
        lo, hi = int(base[tid]), int(base[tid + 1])
        tdocs, timps = docs[lo:hi], imps[lo:hi]
        # brute per-tile groups
        tiles = tdocs // 128
        e_lo, e_hi = int(tl.entry_base[tid]), int(tl.entry_base[tid + 1])
        got_tiles = tl.entry_tile[e_lo:e_hi]
        want_tiles = np.unique(tiles)
        np.testing.assert_array_equal(got_tiles, want_tiles)
        for e in range(e_lo, e_hi):
            t = tl.entry_tile[e]
            sel = tiles == t
            assert tl.entry_len[e] == sel.sum()
            assert tl.entry_max[e] == pytest.approx(timps[sel].max())
            run = slice(int(tl.entry_start[e]),
                        int(tl.entry_start[e]) + int(tl.entry_len[e]))
            np.testing.assert_array_equal(docs[run], tdocs[sel])

    # run_tables over a random tile selection: runs cover exactly the
    # slots' postings within the selected tiles
    tids = np.asarray(rng.sample(range(len(term_df)),
                                 k=min(6, len(term_df))), dtype=np.int64)
    sel_tiles = np.unique(np.asarray(
        rng.sample(range(tl.n_tiles), k=max(1, tl.n_tiles // 3))))
    runs = tl.run_tables(tids, sel_tiles)
    from searchlite.ops.tiles import unpack_runs_np

    run_start, run_len, run_slot, run_off = unpack_runs_np(
        runs["packed"], runs["packed_fmt"])
    covered = 0
    for i in range(len(run_start)):
        ln = int(run_len[i])
        if ln == 0:
            continue
        start = int(run_start[i])
        s = int(run_slot[i])
        off = int(run_off[i])
        rdocs = docs[start:start + ln]
        tile = rdocs[0] // 128
        assert tile in sel_tiles
        # destination columns land in the tile's rank slice
        rank = int(np.searchsorted(sel_tiles, tile))
        dest = rdocs + off
        assert dest.min() >= rank * 128 and dest.max() < (rank + 1) * 128
        covered += ln
    want = 0
    for tid in tids:
        lo, hi = int(base[tid]), int(base[tid + 1])
        want += int(np.isin(docs[lo:hi] // 128, sel_tiles).sum())
    assert covered == want == runs["postings"]

    # tile_postings: per-tile posting sums over the same selection
    per_tile = tl.tile_postings(tids, sel_tiles)
    assert per_tile.sum() == want
    for rank, tile in enumerate(sel_tiles):
        brute = 0
        for tid in tids:
            lo, hi = int(base[tid]), int(base[tid + 1])
            brute += int((docs[lo:hi] // 128 == tile).sum())
        assert per_tile[rank] == brute


def test_wave_launch_oom_evicts_and_retries(monkeypatch):
    """A RESOURCE_EXHAUSTED wave launch evicts rebuildable device
    caches and retries; results stay exact (regression: 5M-doc bmw run,
    2026-08-16, OOMed after the bm25 doc-shard pass filled HBM)."""
    import searchlite.api.reader as reader_mod

    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    # the eviction machinery under test lives in the union wave path
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", "union")
    idx, vocab, rng = _build_index(29, segments=1, docs_per_segment=600,
                                   delete=0)
    reader = idx.reader()
    queries = [" ".join(rng.sample(vocab, k=3)) for _ in range(8)]
    dense = reader.search_batch(queries, limit=10)

    reader2 = idx.reader()
    # warm the doc-shard + dense-row caches so eviction has targets
    dseg = reader2.device_segments[0]
    dseg.doc_shards(2)
    assert getattr(dseg, "_doc_shards", None) is not None

    fails = {"left": 2}
    orig = reader_mod.IndexReader._launch_tile_runs_one

    def flaky(self, *args, **kwargs):
        if fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("RESOURCE_EXHAUSTED: device backend error")
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(reader_mod.IndexReader,
                        "_launch_tile_runs_one", flaky)
    pruned = reader2.search_batch(queries, limit=10, execution="bmw")
    assert fails["left"] == 0
    assert getattr(dseg, "_doc_shards", None) is None  # evicted
    for query, a, b in zip(queries, dense, pruned):
        assert [d for d, _ in a] == [d for d, _ in b], query
        for (_, sa), (_, sb) in zip(a, b):
            assert sa == pytest.approx(sb, abs=1e-5), query


def test_per_query_pruned_rounds_and_limits(monkeypatch):
    """The per-query path's survivor rounds (tiny seed forces many)
    and per-query limits must stay exact vs dense."""
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", "per_query")
    # pin the tile-wave machinery: without this every small-corpus
    # query is "light" and routes to the sparse candidate scorer
    monkeypatch.setenv("SEARCHLITE_WAND_SPARSE_BLOCKS", "0")
    monkeypatch.setenv("SEARCHLITE_SEED_TILES_PER_QUERY", "1")
    idx, vocab, rng = _build_index(41, segments=2, docs_per_segment=500)
    reader = idx.reader()
    queries = [" ".join(rng.sample(vocab, k=rng.randint(1, 5)))
               for _ in range(12)] + [vocab[0], "missing-term"]
    limits = [rng.randint(1, 25) for _ in queries]
    dense = reader.search_batch(queries, limit=30, limits=limits)
    pruned = reader.search_batch(queries, limit=30, limits=limits,
                                 execution="bmw")
    for query, a, b in zip(queries, dense, pruned):
        assert [d for d, _ in a] == [d for d, _ in b], query
        for (_, sa), (_, sb) in zip(a, b):
            assert sa == pytest.approx(sb, abs=1e-5), query


def test_per_query_pruned_memory_capped_rounds(monkeypatch):
    """A tiny M budget caps the per-round tile width; exactness must
    survive the extra rounds."""
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", "per_query")
    # pin the tile-wave machinery: without this every small-corpus
    # query is "light" and routes to the sparse candidate scorer
    monkeypatch.setenv("SEARCHLITE_WAND_SPARSE_BLOCKS", "0")
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "2000000")
    idx, vocab, rng = _build_index(43, segments=1, docs_per_segment=700)
    reader = idx.reader()
    queries = [" ".join(rng.sample(vocab, k=3)) for _ in range(10)]
    dense = reader.search_batch(queries, limit=10)
    pruned = reader.search_batch(queries, limit=10, execution="wand")
    for query, a, b in zip(queries, dense, pruned):
        assert [d for d, _ in a] == [d for d, _ in b], query


def test_filtered_batches_route_to_union_path(monkeypatch):
    """Per-query filters aren't implemented in the per-query pruned
    path; filtered pruned batches must still be exact (union route)."""
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    rng = random.Random(47)
    vocab = [f"w{i}" for i in range(60)]
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "keyword_fields": [{"name": "cat", "stored": False,
                                "indexed": True, "fast": True}]}))
    writer = idx.writer()
    for i in range(400):
        writer.add_document({
            "_id": str(i),
            "body": " ".join(rng.choices(vocab, k=rng.randint(3, 20))),
            "cat": rng.choice(["a", "b"])})
    writer.commit()
    reader = idx.reader()
    queries = [" ".join(rng.sample(vocab, k=3)) for _ in range(6)]
    flt = {"KeywordEq": {"field": "cat", "value": "a"}}
    filters = [flt if i % 2 == 0 else None
               for i in range(len(queries))]
    dense = reader.search_batch(queries, limit=10, filters=filters)
    pruned = reader.search_batch(queries, limit=10, filters=filters,
                                 execution="bmw")
    for query, a, b in zip(queries, dense, pruned):
        assert [d for d, _ in a] == [d for d, _ in b], query


def test_per_query_light_heavy_split(monkeypatch):
    """Light queries ride the sparse candidate scorer, heavy ones the
    tile waves; results stay exact vs dense with both routes live in
    one batch (the row-recombination contract)."""
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", "per_query")
    for cap in ("1", "2", "512"):
        monkeypatch.setenv("SEARCHLITE_WAND_SPARSE_BLOCKS", cap)
        idx, vocab, rng = _build_index(53, segments=2,
                                       docs_per_segment=500)
        reader = idx.reader()
        queries = [" ".join(rng.sample(vocab, k=rng.randint(1, 5)))
                   for _ in range(12)] + [vocab[0], "missing-term", ""]
        limits = [rng.randint(1, 20) for _ in queries]
        dense = reader.search_batch(queries, limit=20, limits=limits)
        pruned = reader.search_batch(queries, limit=20, limits=limits,
                                     execution="wand")
        for query, a, b in zip(queries, dense, pruned):
            assert [d for d, _ in a] == [d for d, _ in b], (cap, query)
            for (_, sa), (_, sb) in zip(a, b):
                assert sa == pytest.approx(sb, abs=1e-5), (cap, query)


def test_pack_runs_roundtrip():
    """pack_runs/unpack_runs_np: exact roundtrip in both formats; the
    [3, r_pad] packing engages iff len fits 16 bits and slot 15."""
    import numpy as np

    from searchlite.ops.tiles import pack_runs, unpack_runs_np

    rng = np.random.default_rng(3)
    n = 37
    start = rng.integers(0, 2**30, size=n)
    off = rng.integers(-(2**25), 2**25, size=n)
    ln = rng.integers(0, 2**16, size=n)
    slot = rng.integers(0, 2**15, size=n)
    packed, fmt = pack_runs(start, off, ln, slot, 64)
    assert fmt == 3 and packed.shape == (3, 64)
    s2, l2, sl2, o2 = unpack_runs_np(packed, fmt)
    np.testing.assert_array_equal(s2[:n], start)
    np.testing.assert_array_equal(l2[:n], ln)
    np.testing.assert_array_equal(sl2[:n], slot)
    np.testing.assert_array_equal(o2[:n], off)

    # oversized slot forces the explicit fallback
    slot_big = slot.copy()
    slot_big[5] = 2**15
    packed4, fmt4 = pack_runs(start, off, ln, slot_big, 64)
    assert fmt4 == 4 and packed4.shape == (4, 64)
    s2, l2, sl2, o2 = unpack_runs_np(packed4, fmt4)
    np.testing.assert_array_equal(sl2[:n], slot_big)
    np.testing.assert_array_equal(l2[:n], ln)

    # empty
    z = np.zeros(0, dtype=np.int64)
    packed0, fmt0 = pack_runs(z, z, z, z, 64)
    assert fmt0 == 3 and packed0.shape == (3, 64)
    assert not packed0.any()


def test_pruned_execution_with_explicit_runs_format(monkeypatch):
    """SEARCHLITE_RUNS_FMT=4 forces the explicit [4, r_pad] run upload
    through every pruned path; results must match the packed default
    and the dense oracle (the fallback only engages naturally at
    >=2^15-row waves, so this is its end-to-end coverage)."""
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    idx, vocab, rng = _build_index(17, segments=2, docs_per_segment=300)
    reader = idx.reader()
    queries = [" ".join(rng.sample(vocab, k=rng.randint(1, 4)))
               for _ in range(12)]
    dense = reader.search_batch(queries, limit=10)
    monkeypatch.setenv("SEARCHLITE_RUNS_FMT", "4")
    for strategy in ("wand", "bmw"):
        pruned = reader.search_batch(queries, limit=10,
                                     execution=strategy)
        for query, a, b in zip(queries, dense, pruned):
            assert [d for d, _ in a] == [d for d, _ in b], \
                (strategy, query)
            for (_, sa), (_, sb) in zip(a, b):
                assert sa == pytest.approx(sb, abs=1e-5)
    single = reader.search({"query": queries[0], "limit": 10,
                            "execution": "bmw"})
    base = reader.search({"query": queries[0], "limit": 10})
    assert [h.doc_id for h in single.hits] == \
        [h.doc_id for h in base.hits]
