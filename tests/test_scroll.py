"""search_scroll block-drain parity with the sequential cursor loop
(the reference's pagination drain pattern, end_to_end.rs:236-313)."""

import random

import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema


@pytest.fixture(scope="module")
def index():
    rng = random.Random(5)
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "numeric_fields": [{"name": "rank", "type": "i64",
                                "stored": False, "fast": True}],
        }))
    writer = idx.writer()
    for i in range(437):
        writer.add_document({
            "_id": str(i),
            "body": "common " + " ".join(
                rng.choices([f"w{j}" for j in range(30)], k=8)),
            "rank": rng.randint(0, 100),
        })
        if i == 200:
            writer.commit()  # two segments
    writer.commit()
    return idx


def drain_sequential(reader, req):
    pages = []
    cursor = None
    while True:
        r = dict(req)
        if cursor:
            r["cursor"] = cursor
        res = reader.search(r)
        pages.append(res)
        cursor = res.next_cursor
        if cursor is None:
            break
    return pages


@pytest.mark.parametrize("block", [40, 100, 2000])
def test_scroll_matches_sequential_drain(index, block):
    reader = index.reader()
    req = {"query": "common", "limit": 20}
    seq = drain_sequential(reader, req)
    scroll = reader.search_scroll(dict(req), block_docs=block)
    assert len(scroll) == len(seq)
    for sp, qp in zip(scroll, seq):
        assert [h.doc_id for h in sp.hits] == [h.doc_id for h in qp.hits]
        assert [round(h.score, 5) for h in sp.hits] == \
            [round(h.score, 5) for h in qp.hits]


def test_scroll_interior_cursor_resumes(index):
    """A cursor minted for a block-interior page must resume the plain
    search() loop at exactly the next page."""
    reader = index.reader()
    req = {"query": "common", "limit": 20}
    scroll = reader.search_scroll(dict(req), block_docs=2000)
    # every page except the last carries a cursor; resuming from page p
    # must reproduce page p+1
    for p in (0, 3, 7):
        cur = scroll[p].next_cursor
        assert cur is not None
        res = reader.search({**req, "cursor": cur})
        assert [h.doc_id for h in res.hits] == \
            [h.doc_id for h in scroll[p + 1].hits]


def test_scroll_field_sort(index):
    reader = index.reader()
    req = {"query": "common", "limit": 15,
           "sort": [{"field": "rank", "order": "asc"},
                    {"field": "_score", "order": "desc"}]}
    seq = drain_sequential(reader, req)
    scroll = reader.search_scroll(dict(req), block_docs=64)
    assert len(scroll) == len(seq)
    for sp, qp in zip(scroll, seq):
        assert [h.doc_id for h in sp.hits] == [h.doc_id for h in qp.hits]


def test_scroll_max_pages(index):
    reader = index.reader()
    pages = reader.search_scroll({"query": "common", "limit": 20},
                                 max_pages=3, block_docs=2000)
    assert len(pages) == 3
    assert all(len(p.hits) == 20 for p in pages)
