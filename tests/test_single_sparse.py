"""Single-query sparse candidate route (reader._try_sparse_single):
plain OR requests at large corpora ride the candidate gather instead of
the dense [S, n1] executor. Scores may differ from the dense path at
f32-ulp level (different summation association — see docs/precision.md
D8), so the comparison here is bench.py-style: every returned doc's
score matches the dense path's score for that doc to tight tolerance,
the returned set is a top-k under that tolerance, and the exact match
count (total_hits_estimate) is identical."""

from __future__ import annotations

import random

import numpy as np
import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema


@pytest.fixture(scope="module")
def index():
    rng = random.Random(17)
    vocab = [f"w{i}" for i in range(80)]
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [
                {"name": "body", "analyzer": "default", "stored": False,
                 "indexed": True},
                {"name": "title", "analyzer": "default", "stored": False,
                 "indexed": True},
            ]}))
    writer = idx.writer()
    for i in range(600):
        writer.add_document({
            "_id": str(i),
            "body": " ".join(rng.choices(vocab, k=rng.randint(3, 25))),
            "title": " ".join(rng.choices(vocab, k=2)),
        })
        if i == 300:
            writer.commit()  # second segment
    writer.commit()
    # tombstones exercise the live-impact masking
    writer.delete_document("42")
    writer.delete_document("310")
    writer.commit()
    return idx


def assert_topk_equiv(fast, dense, rtol=2e-6, atol=1e-5):
    """fast's hits are a valid top-k of dense's ranking under f32-ulp
    tolerance; exact same match count."""
    assert fast.total_hits_estimate == dense.total_hits_estimate
    dscore = {h.doc_id: h.score for h in dense.hits}
    assert len(fast.hits) == len(dense.hits)
    if not dense.hits:
        return
    floor = min(h.score for h in dense.hits)
    for h in fast.hits:
        if h.doc_id in dscore:
            ref = dscore[h.doc_id]
            assert abs(h.score - ref) <= atol + rtol * abs(ref), \
                (h.doc_id, h.score, ref)
        else:
            # near-tie swap: must not be materially below the dense
            # path's weakest returned score
            assert h.score >= floor - (atol + rtol * abs(floor)), \
                (h.doc_id, h.score, floor)


def test_sparse_single_matches_dense(index, monkeypatch):
    rng = random.Random(23)
    monkeypatch.setenv("SEARCHLITE_SINGLE_SPARSE_MIN_DOCS", "0")
    reader = index.reader()
    queries = []
    for _ in range(60):
        n = rng.randint(1, 5)
        queries.append(" ".join(
            f"w{rng.randint(0, 90)}" for _ in range(n)))
    queries += ["w1 w1 w1", "missing0 missing1", "w2"]
    for q in queries:
        req = {"query": q, "limit": rng.choice([3, 10, 25])}
        monkeypatch.setenv("SEARCHLITE_SINGLE_SPARSE", "1")
        fast = reader.search(dict(req))
        monkeypatch.setenv("SEARCHLITE_SINGLE_SPARSE", "0")
        dense = reader.search(dict(req))
        assert_topk_equiv(fast, dense)


def test_sparse_single_route_taken(index, monkeypatch):
    monkeypatch.setenv("SEARCHLITE_SINGLE_SPARSE_MIN_DOCS", "0")
    reader = index.reader()
    calls = []
    orig = reader._try_sparse_single

    def spy(dseg, qargs, k):
        out = orig(dseg, qargs, k)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(reader, "_try_sparse_single", spy)
    reader.search({"query": "w1 w2", "limit": 5})
    assert calls and all(calls)
    # feature-bearing requests must NOT take the route
    calls.clear()
    reader.search({"query": "w1 w2", "limit": 5, "explain": True})
    reader.search({"query": '"w1 w2"', "limit": 5})
    reader.search({"query": "w1 -w2", "limit": 5})
    assert not any(calls)


def test_sparse_single_default_gate(index):
    """With the default 1M-doc gate, small corpora keep the dense
    executor (bit-stable historical scoring)."""
    reader = index.reader()
    calls = []
    orig = reader._try_sparse_single
    reader._try_sparse_single = lambda d, q, k: calls.append(1) or \
        orig(d, q, k)
    try:
        res = reader.search({"query": "w1 w2", "limit": 5})
        assert res.hits
        # route consulted but declined (n1 < min_docs)
        out = orig(reader.device_segments[0],
                   {"n_slots": 0, "slot_tids": np.zeros(0, np.int64),
                    "slot_weight": {}, "postings_touched": 0}, 5)
        assert out is None
    finally:
        reader._try_sparse_single = orig
