"""Structural segment merge (index/merge.py, Index.merge_segments).

The merge concatenates postings/positions/fast columns/docstore/vector
rows with doc ordinals remapped and tombstones expunged — no
re-ingestion, so unlike compact() it needs no stored fields (the
reference refuses that case outright, `index/mod.rs:202-212`; merge is
a capability beyond the reference). Equivalence contract: the merged
segment's structures equal what re-ingesting the same live docs in the
same order produces.
"""

import numpy as np
import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.errors import SchemaError
from searchlite.index import Index
from searchlite.index.manifest import Schema

SCHEMA = {
    "text_fields": [{"name": "body", "analyzer": "default",
                     "stored": True, "indexed": True}],
    "keyword_fields": [{"name": "tag", "stored": True,
                        "indexed": True, "fast": True}],
    "numeric_fields": [{"name": "price", "i64": False,
                        "stored": True, "fast": True}],
}

VOCAB = [f"w{i}" for i in range(60)]


def make_docs(n, seed=7):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        docs.append({
            "_id": str(i),
            "body": " ".join(rng.choice(
                VOCAB, size=int(rng.integers(3, 20)))),
            "tag": f"g{i % 4}",
            "price": float(i % 97),
        })
    return docs


def build(docs, chunks, schema=None, **opt_kw):
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY, **opt_kw),
        Schema.from_json(schema or SCHEMA))
    it = iter(docs)
    for chunk in chunks:
        w = idx.writer()
        for _ in range(chunk):
            w.add_document(next(it))
        w.commit()
    return idx


def delete_every(idx, n, step):
    w = idx.writer()
    for i in range(0, n, step):
        w.delete_document(str(i))
    w.commit()


REQUESTS = [
    {"query": "w3 w7", "limit": 10},
    {"query": '"w3 w5"', "limit": 10},
    {"query": "w2", "limit": 8,
     "filter": {"F64Range": {"field": "price", "min": 5.0,
                             "max": 60.0}},
     "aggs": {"t": {"type": "terms", "field": "tag"},
              "p": {"type": "stats", "field": "price"}}},
    {"query": "w4 w9", "limit": 6,
     "sort": [{"field": "price", "order": "asc"}]},
]


def strip_cursor(out):
    out = dict(out)
    out.pop("next_cursor", None)
    return out


def assert_same_results(ra, rb):
    for q in REQUESTS:
        a = strip_cursor(ra.search(dict(q)).to_json())
        b = strip_cursor(rb.search(dict(q)).to_json())
        assert a == b, q


def assert_segments_structurally_equal(sa, sb):
    assert sa.doc_ids == sb.doc_ids
    assert sa.avg_field_lengths == pytest.approx(sb.avg_field_lengths)
    pa, pb = sa.postings, sb.postings
    assert pa.terms == pb.terms
    np.testing.assert_array_equal(pa.block_docs, pb.block_docs)
    np.testing.assert_array_equal(pa.block_tfs, pb.block_tfs)
    np.testing.assert_array_equal(pa.term_df, pb.term_df)
    np.testing.assert_array_equal(pa.term_max_tf, pb.term_max_tf)
    np.testing.assert_array_equal(pa.block_max_tf, pb.block_max_tf)
    np.testing.assert_array_equal(pa.block_last_doc, pb.block_last_doc)
    assert pa.has_positions == pb.has_positions
    if pa.has_positions:
        np.testing.assert_array_equal(pa.pos_values, pb.pos_values)
        np.testing.assert_array_equal(pa.pos_offsets, pb.pos_offsets)
    assert set(sa.fast.columns) == set(sb.fast.columns)
    for name, ca in sa.fast.columns.items():
        cb = sb.fast.columns[name]
        np.testing.assert_array_equal(ca.offsets, cb.offsets, err_msg=name)
        np.testing.assert_array_equal(ca.row_ids, cb.row_ids, err_msg=name)
        if ca.kind == "str":
            da = np.asarray(ca.dictionary, dtype=object)[ca.values] \
                if len(ca.values) else np.zeros(0, object)
            db = np.asarray(cb.dictionary, dtype=object)[cb.values] \
                if len(cb.values) else np.zeros(0, object)
            np.testing.assert_array_equal(da, db, err_msg=name)
        else:
            np.testing.assert_array_equal(ca.values, cb.values,
                                          err_msg=name)
        if ca.nested:
            np.testing.assert_array_equal(ca.objects, cb.objects,
                                          err_msg=name)


def test_merge_equals_compact_rebuild():
    """Merged(3 segments + tombstones) == compact()'s re-ingested
    segment, structure for structure."""
    docs = make_docs(250)
    idx_m = build(docs, [120, 80, 50])
    idx_c = build(docs, [120, 80, 50])
    for idx in (idx_m, idx_c):
        delete_every(idx, 250, 11)
    assert idx_m.merge_segments() == 3
    idx_c.compact()
    ra, rb = idx_m.reader(), idx_c.reader()
    assert len(ra.segments) == len(rb.segments) == 1
    assert_segments_structurally_equal(ra.segments[0], rb.segments[0])
    assert_same_results(ra, rb)
    sa = ra.segments[0]
    assert not sa.deleted
    assert sa.get_doc(0) == rb.segments[0].get_doc(0)


def test_merge_without_stored_fields():
    """The headline capability: schemas compact() must refuse
    (indexed/fast but not stored) merge cleanly; results equal a
    single-commit rebuild of the same live docs."""
    schema = {
        "text_fields": [{"name": "body", "analyzer": "default",
                         "stored": False, "indexed": True}],
        "keyword_fields": [{"name": "tag", "stored": False,
                            "indexed": True, "fast": True}],
        "numeric_fields": [{"name": "price", "i64": False,
                            "stored": False, "fast": True}],
    }
    docs = make_docs(200, seed=3)
    idx = build(docs, [90, 60, 50], schema=schema)
    delete_every(idx, 200, 9)
    with pytest.raises(SchemaError):
        idx.compact()
    assert idx.merge_segments() == 3
    live = [d for i, d in enumerate(docs) if i % 9 != 0]
    idx_ref = build(live, [len(live)], schema=schema)
    ra, rb = idx.reader(), idx_ref.reader()
    assert_segments_structurally_equal(ra.segments[0], rb.segments[0])
    assert_same_results(ra, rb)


def test_merge_positions_disabled():
    docs = make_docs(120, seed=5)
    idx = build(docs, [60, 60], enable_positions=False)
    idx_ref = build(docs, [120], enable_positions=False)
    idx_ref.compact()  # single segment already; fold for parity anyway
    assert idx.merge_segments() == 2
    ra, rb = idx.reader(), idx_ref.reader()
    sa = ra.segments[0]
    assert not sa.enable_positions
    assert_segments_structurally_equal(sa, rb.segments[0])
    out = ra.search({"query": "w3", "limit": 5}).to_json()
    assert out["hits"]


def test_merge_max_docs_selection():
    """max_docs folds only the small segments; the big one keeps its
    identity and relative order; results unchanged (scores too: BM25
    is per-segment, and the merged smalls see the same df/avgdl as a
    re-commit of their docs would)."""
    docs = make_docs(300, seed=11)
    idx = build(docs, [200, 40, 30, 30])
    metas = list(idx.manifest.segments)
    big_id = metas[0].id
    assert idx.merge_segments(max_docs=100) == 3
    segs = idx.manifest.segments
    assert len(segs) == 2
    assert segs[0].id == big_id  # untouched, still first
    assert segs[1].doc_count == 100
    # doc ids preserved in order across the fold
    r = idx.reader()
    assert [r.segments[1].doc_ids[0], r.segments[1].doc_ids[-1]] == \
        ["200", "299"]
    out = r.search({"query": "w2 w5", "limit": 10}).to_json()
    idx_ref = build(docs, [200, 100])
    ref = idx_ref.reader().search(
        {"query": "w2 w5", "limit": 10}).to_json()
    assert strip_cursor(out) == strip_cursor(ref)


def test_merge_fully_deleted_segment_drops():
    docs = make_docs(100, seed=13)
    idx = build(docs, [50, 50])
    w = idx.writer()
    for i in range(50):
        w.delete_document(str(i))
    w.commit()
    assert idx.merge_segments() == 2
    segs = idx.manifest.segments
    assert len(segs) == 1 and segs[0].doc_count == 50
    r = idx.reader()
    assert r.segments[0].doc_ids[0] == "50"
    assert not r.search({"query": "w3", "limit": 100}).to_json()[
        "hits"] or all(
        int(h["doc_id"]) >= 50 for h in
        r.search({"query": "w3", "limit": 100}).to_json()["hits"])


def test_merge_nested_and_vectors():
    """Nested object columns (same-object semantics) and vector rows
    survive the fold byte-for-byte."""
    schema = {
        "text_fields": [{"name": "body", "analyzer": "default",
                         "stored": True, "indexed": True}],
        "nested_fields": [{
            "name": "items",
            "fields": [
                {"type": "keyword", "name": "kind", "stored": True,
                 "indexed": True, "fast": True},
                {"type": "numeric", "name": "qty", "i64": True,
                 "stored": True, "fast": True},
            ],
        }],
        "vector_fields": [{"name": "emb", "dim": 4,
                           "metric": "cosine"}],
    }
    rng = np.random.default_rng(19)
    docs = []
    for i in range(90):
        docs.append({
            "_id": str(i),
            "body": " ".join(rng.choice(VOCAB, size=6)),
            "items": [{"kind": f"k{j % 3}", "qty": int(j + i)}
                      for j in range(int(rng.integers(1, 4)))],
            "emb": [float(x) for x in rng.normal(size=4)],
        })
    idx_m = build(docs, [40, 30, 20], schema=schema)
    delete_every(idx_m, 90, 7)
    # compact is no oracle here: vector values aren't stored, so a
    # re-ingest would drop them — it must refuse (divergence D11)...
    with pytest.raises(SchemaError):
        idx_m.compact()
    assert idx_m.merge_segments() == 3
    # ...while the structural merge equals a single-commit rebuild of
    # the same live docs, vectors included
    live = [d for i, d in enumerate(docs) if i % 7 != 0]
    idx_c = build(live, [len(live)], schema=schema)
    ra, rb = idx_m.reader(), idx_c.reader()
    assert_segments_structurally_equal(ra.segments[0], rb.segments[0])
    va = ra.segments[0].vectors["emb"]
    vb = rb.segments[0].vectors["emb"]
    np.testing.assert_array_equal(va.present, vb.present)
    np.testing.assert_allclose(va.vectors, vb.vectors, rtol=1e-6)
    req = {"query": {"type": "vector", "field": "emb",
                     "vector": [0.1, -0.2, 0.3, 0.4], "k": 5},
           "limit": 5}
    a = strip_cursor(ra.search(dict(req)).to_json())
    b = strip_cursor(rb.search(dict(req)).to_json())
    assert a == b
    nested_req = {
        "query": "w1 w2 w3 w4 w5 w6 w7 w8 w9", "limit": 10,
        "filter": {"Nested": {"path": "items", "filter": {
            "And": [{"KeywordEq": {"field": "items.kind",
                                   "value": "k1"}},
                    {"I64Range": {"field": "items.qty",
                                  "min": 1, "max": 50}}]}}}}
    a = strip_cursor(ra.search(dict(nested_req)).to_json())
    b = strip_cursor(rb.search(dict(nested_req)).to_json())
    assert a == b


def test_auto_merge_policy(monkeypatch):
    """SEARCHLITE_AUTO_MERGE=N folds small segments once more than N
    accumulate; results keep matching an unmerged twin."""
    monkeypatch.setenv("SEARCHLITE_AUTO_MERGE", "3")
    monkeypatch.setenv("SEARCHLITE_AUTO_MERGE_DOCS", "1000")
    docs = make_docs(150, seed=23)
    idx = build(docs, [25, 25, 25, 25, 25, 25])
    assert len(idx.manifest.segments) <= 3
    monkeypatch.delenv("SEARCHLITE_AUTO_MERGE")
    idx_ref = build(docs, [25, 25, 25, 25, 25, 25])
    assert len(idx_ref.manifest.segments) == 6
    ra, rb = idx.reader(), idx_ref.reader()
    for q in ({"query": "w2 w5", "limit": 10},
              {"query": "w3", "limit": 10,
               "aggs": {"t": {"type": "terms", "field": "tag"}}}):
        a = ra.search(dict(q)).to_json()
        b = rb.search(dict(q)).to_json()
        # scores are segment-local (df/avgdl) so only membership and
        # aggregations must agree when segment folds differ
        assert a["total_hits_estimate"] == b["total_hits_estimate"]
        assert a.get("aggregations") == b.get("aggregations")


def test_auto_merge_via_index_options():
    """The IndexOptions form of the tiered policy (no env vars)."""
    docs = make_docs(100, seed=31)
    idx = build(docs, [20, 20, 20, 20, 20],
                auto_merge_segments=2, auto_merge_docs=1000)
    assert len(idx.manifest.segments) <= 2
    r = idx.reader()
    out = r.search({"query": "w2", "limit": 5}).to_json()
    assert out["total_hits_estimate"] > 0


def test_reader_retries_when_merge_swaps_segments(monkeypatch):
    """A concurrent merge can delete a manifest snapshot's segment
    files between reader() snapshotting and the per-segment opens
    (found live by tools/bench_realtime.py). The reader must
    re-snapshot and retry, not raise."""
    import searchlite.api.reader as reader_mod

    docs = make_docs(120, seed=37)
    idx = build(docs, [60, 60])
    stale = idx.manifest  # snapshot referencing both segments
    orig = reader_mod._cached_segment
    calls = {"n": 0}

    def racy(storage, meta, ordinal, k1, b):
        calls["n"] += 1
        if calls["n"] == 1:
            # simulate: files of the snapshot's segment were deleted
            # by a merge that already swapped the live manifest
            idx.merge_segments()
            from searchlite.errors import StorageError

            raise StorageError(f"file not found: seg_{meta.id}.terms")
        return orig(storage, meta, ordinal, k1, b)

    monkeypatch.setattr(reader_mod, "_cached_segment", racy)
    idx._manifest = stale  # make reader() start from the stale snapshot
    r = idx.reader()
    assert len(r.segments) == 1  # the merged segment
    out = r.search({"query": "w3", "limit": 5}).to_json()
    assert out["total_hits_estimate"] > 0


def test_auto_merge_async():
    """Background folds: commits return without paying the merge;
    wait_for_background_merges() drains, results match the sync policy
    (segment count collapses, all docs searchable)."""
    from searchlite.api.writer import wait_for_background_merges

    docs = make_docs(120, seed=41)
    idx = build(docs, [20, 20, 20, 20, 20, 20],
                auto_merge_segments=2, auto_merge_docs=1000,
                auto_merge_async=True)
    wait_for_background_merges()
    assert len(idx.reload_manifest().segments) <= 3
    r = idx.reader()
    out = r.search({"query": "w1 w2 w3 w4 w5 w6 w7", "limit": 120})
    seen = {h.doc_id for h in out.hits}
    # every doc with any of those terms is present exactly once
    assert len(seen) == len(out.hits)


def test_merge_noop_cases():
    docs = make_docs(50, seed=29)
    idx = build(docs, [50])
    assert idx.merge_segments() == 0  # single clean segment
    assert idx.merge_segments(max_docs=10) == 0  # nothing qualifies
    # single segment WITH tombstones: merge expunges in place
    delete_every(idx, 50, 5)
    assert idx.manifest.segments[0].deleted_docs
    assert idx.merge_segments() == 1
    seg = idx.manifest.segments[0]
    assert not seg.deleted_docs and seg.doc_count == 40


def test_tombstone_clone_shares_structures():
    """A delete-only commit must CLONE the cached segment (shared
    immutable arrays + uploads, fresh deletion-derived state), not
    rebuild it — and results must equal a cold-cache rebuild."""
    import searchlite.api.reader as reader_mod

    docs = make_docs(300, seed=43)
    idx = build(docs, [300])
    r1 = idx.reader()
    d1 = r1.device_segments[0]
    _ = d1.block_impacts  # force the upload
    _ = d1.sparse_tid_tbl
    idf1 = d1.idf_table

    delete_every(idx, 300, 7)
    r2 = idx.reader()
    d2 = r2.device_segments[0]
    # shared immutable structures — same objects, no re-parse/upload
    assert d2.reader.postings is d1.reader.postings
    assert d2.reader.fast is d1.reader.fast
    assert d2.block_docs_np is d1.block_docs_np
    assert d2.block_impacts is d1.block_impacts
    # deletion-derived state rebuilt
    assert d2.deleted is not d1.deleted
    assert d2.live_docs == 300 - len(range(0, 300, 7))
    assert d2.idf_table is not idf1  # idf uses the live doc count
    assert d2.sparse_tid_tbl is not d1.sparse_tid_tbl

    got = [r2.search({"query": q, "limit": 10}).to_json()
           for q in ("w2 w5", "w3", "w7 w11 w2")]
    # cold cache: full rebuild must agree exactly
    reader_mod._GLOBAL_SEGMENTS.clear()
    reader_mod._GLOBAL_BASE.clear()
    r3 = idx.reader()
    assert r3.device_segments[0].reader.postings is not \
        d1.reader.postings  # really rebuilt
    want = [r3.search({"query": q, "limit": 10}).to_json()
            for q in ("w2 w5", "w3", "w7 w11 w2")]
    assert got == want
    # no deleted doc in any result
    dead = {str(i) for i in range(0, 300, 7)}
    for out in got:
        assert not dead & {h["doc_id"] for h in out["hits"]}
