"""Chunked tile execution: the oversized-corpus path (no S·n1 wall).

Forcing a tiny SEARCHLITE_M_BUDGET_BYTES routes single-query execution
through `_run_segment_chunked` — every tile scored in column-bounded
chunks, stitched back on the host. Results must be identical to the
one-shot dense executor for the full request surface (scores, sort,
filters, cursors, aggregations)."""

import random

import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema


@pytest.fixture(scope="module")
def index():
    rng = random.Random(77)
    vocab = [f"w{i}" for i in range(60)]
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
    for i in range(1200):
        writer.add_document({
            "_id": str(i),
            "body": " ".join(rng.choices(
                vocab, weights=[1 / (j + 1) for j in range(60)],
                k=rng.randint(2, 25))),
            "cat": rng.choice(["a", "b", "c"]),
            "rank": rng.randint(0, 50),
        })
    writer.commit()
    return idx


def _result_key(res):
    return ([(h.doc_id, round(h.score, 4)) for h in res.hits],
            res.total_hits_estimate, res.aggregations)


REQUESTS = [
    {"query": "w1 w5 w9", "limit": 10},
    {"query": "w2", "limit": 10,
     "filter": {"KeywordEq": {"field": "cat", "value": "b"}}},
    {"query": "w0 w3", "limit": 10,
     "sort": [{"field": "rank", "order": "asc"},
              {"field": "_score", "order": "desc"}]},
    {"query": "w1 w4", "limit": 10,
     "aggs": {"cats": {"type": "terms", "field": "cat"}}},
    {"query": {"type": "bool",
               "must": [{"type": "term", "field": "body", "value": "w2"}],
               "must_not": [{"type": "term", "field": "body",
                             "value": "w0"}]},
     "limit": 10},
]


@pytest.mark.parametrize("req_i", range(len(REQUESTS)))
def test_chunked_matches_dense(index, monkeypatch, req_i):
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    req = dict(REQUESTS[req_i], execution="bm25")
    reader = index.reader()
    base = _result_key(reader.search(dict(req)))
    # budget below one slot row forces max chunking (1 tile per chunk
    # would be extreme; this yields a handful of chunks)
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "40000")
    chunked = _result_key(reader.search(dict(req)))
    assert chunked == base


def test_chunked_cursor_pagination(index, monkeypatch):
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    reader = index.reader()
    req = {"query": "w1 w3 w8", "limit": 7, "execution": "bm25"}
    pages_dense = []
    cursor = None
    for _ in range(4):
        r = reader.search(dict(req, **({"cursor": cursor} if cursor
                                       else {})))
        pages_dense.append([h.doc_id for h in r.hits])
        cursor = r.next_cursor
        if cursor is None:
            break
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "40000")
    pages_chunked = []
    cursor = None
    for _ in range(4):
        r = reader.search(dict(req, **({"cursor": cursor} if cursor
                                       else {})))
        pages_chunked.append([h.doc_id for h in r.hits])
        cursor = r.next_cursor
        if cursor is None:
            break
    assert pages_chunked == pages_dense


def test_chunked_with_pruning_preference(index, monkeypatch):
    """Oversized + execution=bmw prefers the pruned path (exact), falls
    back to chunked when pruning returns nothing usable."""
    monkeypatch.setenv("SEARCHLITE_TILE_WIDTH", "128")
    reader = index.reader()
    req = {"query": "w1 w5 w9", "limit": 10}
    base = _result_key(reader.search(dict(req, execution="bm25")))
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "40000")
    got = _result_key(reader.search(dict(req, execution="bmw")))
    assert got[0] == base[0]  # hits identical; totals may undercount
