"""Batched search API parity with the single-query path."""

import random

import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema


@pytest.fixture(scope="module")
def index():
    rng = random.Random(9)
    vocab = [f"w{i}" for i in range(60)]
    schema = Schema.from_json({
        "text_fields": [
            {"name": "title", "analyzer": "default", "stored": True,
             "indexed": True},
            {"name": "body", "analyzer": "default", "stored": True,
             "indexed": True},
        ],
    })
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY), schema)
    writer = idx.writer()
    for i in range(300):
        writer.add_document({
            "_id": str(i),
            "title": " ".join(rng.choices(vocab, k=3)),
            "body": " ".join(rng.choices(vocab, k=rng.randint(5, 40))),
        })
        if i == 150:
            writer.commit()  # two segments
    writer.commit()
    return idx


def test_batch_matches_single_query_path(index):
    rng = random.Random(10)
    reader = index.reader()
    queries = [" ".join(rng.sample([f"w{i}" for i in range(60)],
                                   k=rng.randint(1, 4)))
               for _ in range(16)]
    batch = reader.search_batch(queries, limit=10)
    for query, batch_hits in zip(queries, batch):
        single = reader.search({"query": query, "limit": 10})
        expected = [(h.doc_id, round(h.score, 4)) for h in single.hits]
        got = [(doc_id, round(score, 4)) for doc_id, score in batch_hits]
        assert got == expected, f"mismatch for {query!r}"


def test_sharded_batch_matches_unsharded(index, monkeypatch):
    """Forcing a tiny memory budget routes through the doc-sharded path,
    which must return identical results."""
    reader = index.reader()
    queries = ["w1 w2", "w3", "w10 w20 w30"]
    expected = reader.search_batch(queries, limit=10)
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "20000")
    reader2 = index.reader()
    sharded = reader2.search_batch(queries, limit=10)
    for exp, got in zip(expected, sharded):
        assert [(d, round(s, 4)) for d, s in got] == \
            [(d, round(s, 4)) for d, s in exp]


def test_int32_overflow_routes_to_sharded(index, monkeypatch):
    """A batch whose dense M would exceed int32 flat indexing must route
    through the doc-sharded path instead of raising. Regression: 1M-doc
    corpora raised OverflowError from inside build_impact_batch before
    search_batch_many's budget check could route (caught by
    tools/bench_1m.py on hardware, 2026-08-16)."""
    from searchlite.api import reader as reader_mod

    rd = index.reader()
    queries = ["w1 w2", "w3", "w10 w20 w30"]
    expected = rd.search_batch(queries, limit=10)
    # lower the wall so this corpus is "past" it; the dense launch guard
    # raises QueryError on the same constant, so a routing failure fails
    # loudly rather than silently passing through the dense path
    monkeypatch.setattr(reader_mod, "FLAT_INDEX_LIMIT", 1)
    rd2 = index.reader()
    got = rd2.search_batch(queries, limit=10)
    for exp, g in zip(expected, got):
        assert [(d, round(s, 4)) for d, s in g] == \
            [(d, round(s, 4)) for d, s in exp]
    # the pruned tile path never builds the full-width M: it must keep
    # working (not raise) past the wall too
    pruned = rd2.search_batch(queries, limit=10, execution="bmw")
    for exp, g in zip(expected, pruned):
        assert [(d, round(s, 4)) for d, s in g] == \
            [(d, round(s, 4)) for d, s in exp]


def test_bf16_fast_mode_close_to_exact(index, monkeypatch):
    reader = index.reader()
    queries = ["w1 w2", "w5 w9 w12"]
    exact = reader.search_batch(queries, limit=10)
    monkeypatch.setenv("SEARCHLITE_PRECISION", "bf16")
    reader2 = index.reader()
    fast = reader2.search_batch(queries, limit=10)
    for e, f in zip(exact, fast):
        exact_ids = {d for d, _ in e}
        fast_ids = {d for d, _ in f}
        # near-ties may swap order; the sets must agree almost entirely
        assert len(exact_ids & fast_ids) >= len(exact_ids) - 1
        for (de, se), (df_, sf) in zip(e, f):
            assert sf == pytest.approx(se, rel=2e-2, abs=1e-2)


def test_batch_field_qualified(index):
    reader = index.reader()
    batch = reader.search_batch(["title:w5"], limit=5)
    single = reader.search({"query": "title:w5", "limit": 5})
    assert [d for d, _ in batch[0]] == [h.doc_id for h in single.hits]


def test_search_batch_many_matches_sequential(index):
    rng = random.Random(12)
    reader = index.reader()
    batches = [[" ".join(rng.sample([f"w{i}" for i in range(60)],
                                    k=rng.randint(1, 4)))
                for _ in range(8)] for _ in range(3)]
    pipelined = reader.search_batch_many(batches, limit=10)
    sequential = [reader.search_batch(batch, limit=10)
                  for batch in batches]
    # micro-batch coalescing re-chunks the stream into wider launches,
    # whose padded shapes reassociate f32 sums (divergence D10) —
    # compare like the sharded-path test: same docs, scores to 4dp
    for p_batch, s_batch in zip(pipelined, sequential):
        for p, s in zip(p_batch, s_batch):
            assert [(d, round(sc, 4)) for d, sc in p] == \
                [(d, round(sc, 4)) for d, sc in s]


def test_batch_coalescing_matches_uncoalesced(index, monkeypatch):
    """Micro-batch coalescing (narrow filterless batches re-chunked
    into wider launches) must return identical results, for both
    output forms, including multi-group splits and per-query limits."""
    import numpy as np

    rng = random.Random(31)
    reader = index.reader()
    batches = [[" ".join(rng.sample([f"w{i}" for i in range(60)],
                                    k=rng.randint(1, 4)))
                for _ in range(6)] for _ in range(5)]
    monkeypatch.setenv("SEARCHLITE_BATCH_COALESCE", "0")
    plain_pairs = reader.search_batch_many(batches, limit=10)
    plain_arr = reader.search_batch_many(batches, limit=10,
                                         output="arrays")
    # coalesce=14 with 6-query batches -> groups of 2 (multi-group)
    monkeypatch.setenv("SEARCHLITE_BATCH_COALESCE", "14")
    co_pairs = reader.search_batch_many(batches, limit=10)
    co_arr = reader.search_batch_many(batches, limit=10,
                                      output="arrays")
    # wider padded shapes reassociate f32 sums (divergence D10):
    # same docs and order, scores to 4dp
    for c_batch, p_batch in zip(co_pairs, plain_pairs):
        for c, p in zip(c_batch, p_batch):
            assert [(d, round(s, 4)) for d, s in c] == \
                [(d, round(s, 4)) for d, s in p]
    for (ps, pd, pg), (cs, cd, cg) in zip(plain_arr, co_arr):
        np.testing.assert_array_equal(pd, cd)
        np.testing.assert_array_equal(pg, cg)
        np.testing.assert_allclose(ps, cs, rtol=1e-4, atol=1e-4)
    # per-query limits concatenate losslessly; a batch with a smaller
    # max limit keeps its own (narrower) column count in arrays form
    limits = [[3] * 6, [10] * 6, [5] * 6, [10] * 6, [2] * 6]
    monkeypatch.setenv("SEARCHLITE_BATCH_COALESCE", "0")
    plain_l = reader.search_batch_many(batches, limit=10,
                                       limits=limits, output="arrays")
    monkeypatch.setenv("SEARCHLITE_BATCH_COALESCE", "14")
    co_l = reader.search_batch_many(batches, limit=10, limits=limits,
                                    output="arrays")
    for (ps, pd, pg), (cs, cd, cg) in zip(plain_l, co_l):
        assert ps.shape == cs.shape
        np.testing.assert_array_equal(pd, cd)
        np.testing.assert_allclose(ps, cs, rtol=1e-6)


def test_dense_split_path_matches_plain(index, monkeypatch):
    """SEARCHLITE_DENSE_M_BYTES routes high-df slots through precomputed
    dense impact rows; results must match the plain block-scatter path
    (scores to f32 summation-order tolerance)."""
    rng = random.Random(21)
    queries = [" ".join(rng.sample([f"w{i}" for i in range(60)],
                                   k=rng.randint(1, 4)))
               for _ in range(12)]
    monkeypatch.setenv("SEARCHLITE_DENSE_M_BYTES", "0")  # split OFF
    plain = index.reader().search_batch(queries, limit=10)
    monkeypatch.setenv("SEARCHLITE_DENSE_M_BYTES", str(64 * 1024 * 1024))
    # fresh reader: dense rows are cached per DeviceSegment
    split = index.reader().search_batch(queries, limit=10)
    for p_row, s_row in zip(plain, split):
        assert [d for d, _ in p_row] == [d for d, _ in s_row]
        for (pd, ps), (sd, ss) in zip(p_row, s_row):
            assert abs(ps - ss) < 1e-4 * max(1.0, abs(ps))


def test_dense_rows_selection(index):
    """dense_rows picks only terms with df >= n1/512 within budget."""
    dseg = index.reader().device_segments[0]
    dense = dseg.dense_rows(64 * 1024 * 1024)
    assert dense is not None
    postings = dseg.reader.postings
    for tid in dense["row_of_tid"]:
        assert int(postings.term_df[tid]) * 512 >= dseg.n1
    # the pad row is zeros
    import numpy as np
    m = np.asarray(dense["m_dense"])
    assert (m[-1] == 0).all()
    # and a representative batch actually routes slots to dense rows
    from searchlite.ops.impact import (
        build_impact_batch,
        split_impact_batch,
    )
    qb = build_impact_batch(dseg.reader, dseg,
                            [[("body", "w1")], [("body", "w2")]])
    split = split_impact_batch(qb, dense["row_of_tid"],
                               n_rows=len(dense["row_of_tid"]),
                               n1=dseg.n1)
    # dense weight entries exist and point inside [Q, R+1]
    r1 = len(dense["row_of_tid"]) + 1
    assert split is not None
    assert (split["wd_idx"][:1] < 2 * r1).all()


@pytest.fixture(scope="module")
def filtered_index():
    rng = random.Random(23)
    vocab = [f"w{i}" for i in range(40)]
    from searchlite.index.manifest import Schema as _S
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        _S.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "keyword_fields": [{"name": "cat", "stored": False,
                                "indexed": True, "fast": True}],
            "numeric_fields": [{"name": "rank", "type": "i64",
                                "stored": False, "fast": True}],
        }))
    writer = idx.writer()
    for i in range(500):
        writer.add_document({
            "_id": str(i),
            "body": " ".join(rng.choices(vocab, k=rng.randint(3, 20))),
            "cat": rng.choice(["a", "b", "c"]),
            "rank": rng.randint(0, 30),
        })
        if i == 250:
            writer.commit()
    writer.commit()
    return idx


def test_batch_per_query_filters_match_single_path(filtered_index):
    """Structured batched queries: per-query filters in
    search_batch must match the single-query path with the same
    `filter` (reference surface api/types.rs:395-520)."""
    reader = filtered_index.reader()
    rng = random.Random(4)
    vocab = [f"w{i}" for i in range(40)]
    queries, filters = [], []
    filter_pool = [
        None,
        {"KeywordEq": {"field": "cat", "value": "a"}},
        {"KeywordEq": {"field": "cat", "value": "b"}},
        {"I64Range": {"field": "rank", "min": 5, "max": 20}},
        {"And": [{"KeywordEq": {"field": "cat", "value": "c"}},
                 {"I64Range": {"field": "rank", "min": 0, "max": 15}}]},
    ]
    for _ in range(24):
        queries.append(" ".join(rng.sample(vocab, k=rng.randint(1, 3))))
        filters.append(rng.choice(filter_pool))
    for execution in ("bm25", "bmw"):
        batch = reader.search_batch(queries, limit=10, filters=filters,
                                    execution=execution)
        for query, f, row in zip(queries, filters, batch):
            req = {"query": query, "limit": 10}
            if f is not None:
                req["filter"] = f
            single = reader.search(req)
            expected = [(h.doc_id, round(h.score, 4))
                        for h in single.hits]
            got = [(d, round(s, 4)) for d, s in row]
            assert got == expected, (execution, query, f)


def test_batch_per_query_limits(filtered_index):
    reader = filtered_index.reader()
    queries = ["w1 w2", "w3 w4", "w5"]
    limits = [3, 7, 1]
    rows = reader.search_batch(queries, limit=10, limits=limits)
    full = reader.search_batch(queries, limit=10)
    for row, fr, lim in zip(rows, full, limits):
        assert row == fr[:lim]


def test_batch_sharded_with_filters(filtered_index, monkeypatch):
    """Filters survive the doc-sharded big-corpus path."""
    reader = filtered_index.reader()
    queries = ["w1 w2", "w3"]
    filters = [{"KeywordEq": {"field": "cat", "value": "a"}}, None]
    expected = reader.search_batch(queries, limit=10, filters=filters)
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "20000")
    got = reader.search_batch(queries, limit=10, filters=filters)
    # ids exact; scores to f32 tolerance (matmul summation order
    # differs between the split and flat-sharded kernels)
    for g_row, e_row in zip(got, expected):
        assert [d for d, _ in g_row] == [d for d, _ in e_row]
        for (_, gs), (_, es) in zip(g_row, e_row):
            assert gs == pytest.approx(es, rel=1e-5, abs=1e-5)


def test_batch_filter_validation(filtered_index):
    reader = filtered_index.reader()
    from searchlite.errors import QueryError
    with pytest.raises(QueryError):
        reader.search_batch(["w1"], limit=5, filters=[
            {"KeywordEq": {"field": "rank", "value": "x"}}])
    with pytest.raises(QueryError):
        reader.search_batch(["w1", "w2"], limit=5, filters=[None])
    with pytest.raises(QueryError):
        reader.search_batch(["w1"], limit=5, limits=[0])


def test_bf16_m_storage_machinery(index, monkeypatch):
    """With SEARCHLITE_PRECISION=bf16 the M matrices are BUILT in bf16
    (scatter stores bf16, dense rows stored bf16) — results must stay
    within bf16 tolerance of the exact path on every route (plain,
    split, sharded)."""
    import numpy as np

    rng = random.Random(31)
    queries = [" ".join(rng.sample([f"w{i}" for i in range(60)],
                                   k=rng.randint(1, 4)))
               for _ in range(12)]
    exact = index.reader().search_batch(queries, limit=10)
    monkeypatch.setenv("SEARCHLITE_PRECISION", "bf16")
    reader = index.reader()
    # dense rows come out bf16 under the policy
    dseg = reader.device_segments[0]
    dense = dseg.dense_rows(64 * 1024 * 1024)
    assert np.asarray(dense["m_dense"]).dtype == np.dtype("bfloat16") \
        or str(np.asarray(dense["m_dense"]).dtype) == "bfloat16"
    fast = reader.search_batch(queries, limit=10)
    for e, f in zip(exact, fast):
        exact_ids = {d for d, _ in e}
        fast_ids = {d for d, _ in f}
        assert len(exact_ids & fast_ids) >= len(exact_ids) - 1
        for (de, se), (df_, sf) in zip(e, f):
            assert sf == pytest.approx(se, rel=2e-2, abs=1e-2)


def test_fine_bucketing_block_tables():
    """build_block_tables pads to the {pow2, 0.75·pow2} ladder by
    default (every pad block = 128 wasted scatter updates); coarse
    keeps the pow-4 ladder for compile-sensitive callers."""
    from searchlite.ops.impact import build_block_tables

    # 40 blocks → pow2 64, then 48 (= 0.75*64) still fits
    blk, row, nb = build_block_tables([0], [40], sentinel_row=99)
    assert nb == 48
    blk, row, nb = build_block_tables([0], [40], sentinel_row=99,
                                      coarse=True)
    assert nb == 128
    # pads carry the sentinel row
    assert (blk[40:] == 99).all()
    # ladder shape: 0.75*pow2 chosen only when it fits
    from searchlite.ops.impact import pow15_bucket

    assert pow15_bucket(40, minimum=32) == 48
    assert pow15_bucket(50, minimum=32) == 64
    assert pow15_bucket(3000) == 3072
    assert pow15_bucket(3100) == 4096


def test_output_arrays_matches_pairs(index):
    """output='arrays' carries the same merged ranking as the default
    pairs output (multi-segment merge, per-query limits)."""
    import numpy as np

    rng = random.Random(21)
    reader = index.reader()
    queries = [" ".join(rng.sample([f"w{i}" for i in range(60)],
                                   k=rng.randint(1, 4)))
               for _ in range(24)]
    limits = [rng.randint(1, 10) for _ in queries]
    pairs = reader.search_batch_many(
        [queries], limit=10, limits=[limits])[0]
    scores, ids, segs = reader.search_batch_many(
        [queries], limit=10, limits=[limits], output="arrays")[0]
    assert scores.shape == ids.shape == segs.shape
    for qi, expected in enumerate(pairs):
        n = int((scores[qi] != -np.inf).sum())
        got = [(reader.segments[int(segs[qi, j])].doc_id(
                    int(ids[qi, j])), scores[qi, j])
               for j in range(n)]
        exp = [(d, float(np.float32(s))) for d, s in expected]
        assert [(d, float(s)) for d, s in got] == exp, queries[qi]


def test_output_arrays_rejections(index):
    from searchlite.errors import QueryError

    reader = index.reader()
    with pytest.raises(QueryError):
        reader.search_batch_many([["w1"]], output="bogus")


def test_output_arrays_pruned_matches_dense(index):
    """The pruned batched executions return the arrays surface too,
    identical to the dense path's (both per-query pruning and — via
    SEARCHLITE_BATCH_PRUNE=union — the union-wave path)."""
    import numpy as np

    rng = random.Random(33)
    reader = index.reader()
    queries = [" ".join(rng.sample([f"w{i}" for i in range(60)],
                                   k=rng.randint(1, 4)))
               for _ in range(24)]
    want = reader.search_batch_many([queries], limit=10,
                                    output="arrays")[0]
    for execution in ("wand", "bmw"):
        got = reader.search_batch_many([queries], limit=10,
                                       execution=execution,
                                       output="arrays")[0]
        for w, g, name in zip(want, got, ("scores", "ids", "segs")):
            np.testing.assert_allclose(
                np.asarray(w, dtype=np.float64),
                np.asarray(g, dtype=np.float64),
                rtol=1e-5, atol=1e-5,
                err_msg=f"{execution}/{name}")


def test_output_arrays_union_pruned_matches_dense(index, monkeypatch):
    import numpy as np

    monkeypatch.setenv("SEARCHLITE_BATCH_PRUNE", "union")
    rng = random.Random(34)
    reader = index.reader()
    queries = [" ".join(rng.sample([f"w{i}" for i in range(60)],
                                   k=rng.randint(1, 3)))
               for _ in range(12)]
    want = reader.search_batch_many([queries], limit=5,
                                    output="arrays")[0]
    got = reader.search_batch_many([queries], limit=5,
                                   execution="bmw",
                                   output="arrays")[0]
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(w, dtype=np.float64),
                                   np.asarray(g, dtype=np.float64),
                                   rtol=1e-5, atol=1e-5)


def test_output_arrays_empty_index():
    import numpy as np

    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": True, "indexed": True}]}))
    reader = idx.reader()
    for execution in ("bm25", "wand"):
        scores, ids, segs = reader.search_batch_many(
            [["w1 w2", "w3"]], limit=4, execution=execution,
            output="arrays")[0]
        assert scores.shape == (2, 4)
        assert np.all(scores == -np.inf)
        pairs = reader.search_batch_many(
            [["w1 w2", "w3"]], limit=4, execution=execution)[0]
        assert pairs == [[], []]
