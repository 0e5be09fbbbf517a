"""Warm-before-swap on structural merge (Index._warm_fold).

The realtime finding it fixes (tools/bench_realtime.py --device): a
fold graduating past the host tier paid its
device upload + XLA bucket compile inside whichever SEARCH touched it
first (multi-second stalls). The merge thread now opens, places, and
searches the fold BEFORE the manifest swap, while readers still serve
the pre-merge snapshot — exact, because a fold is content-neutral.

These tests drive the warm on the cpu backend: the observable contract
is (a) the post-merge segment is already in the process-wide segment
cache when the first real reader opens, (b) the warm never changes
results or breaks merges on term-free / analyzer-mangling schemas.
"""

import numpy as np
import pytest

from searchlite.api import reader as reader_mod
from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema

SCHEMA = {
    "text_fields": [{"name": "body", "analyzer": "default",
                     "stored": True, "indexed": True}],
}

VOCAB = [f"w{i}" for i in range(40)]


def build(chunks, monkeypatch=None, warm="1"):
    if monkeypatch is not None:
        monkeypatch.setenv("SEARCHLITE_MERGE_WARM", warm)
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json(SCHEMA))
    rng = np.random.default_rng(3)
    it = 0
    for chunk in chunks:
        w = idx.writer()
        for _ in range(chunk):
            w.add_document({
                "_id": str(it),
                "body": " ".join(rng.choice(VOCAB, size=8))})
            it += 1
        w.commit()
    return idx


def test_warm_populates_segment_cache(monkeypatch):
    idx = build([30, 30, 30], monkeypatch)
    assert idx.merge_segments() == 3
    meta = idx.manifest.segments[-1]
    with reader_mod._GLOBAL_LOCK:
        cached_ids = {k[0] for k in reader_mod._GLOBAL_SEGMENTS}
    assert meta.id in cached_ids, \
        "warm-before-swap must leave the fold in the segment cache"


def test_warm_off_is_equivalent(monkeypatch):
    out = {}
    for warm in ("1", "0"):
        idx = build([25, 25], monkeypatch, warm=warm)
        assert idx.merge_segments() == 2
        r = idx.reader()
        res = r.search({"query": "w3 w7", "limit": 10})
        out[warm] = [(h.doc_id, round(h.score, 6)) for h in res.hits]
    assert out["1"] == out["0"]


def test_warm_survives_termless_segments(monkeypatch):
    # empty-body docs: the fold has no terms to warm with — the warm
    # must silently no-op, not fail the merge
    monkeypatch.setenv("SEARCHLITE_MERGE_WARM", "1")
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json(SCHEMA))
    for chunk in (5, 5):
        w = idx.writer()
        for i in range(chunk):
            w.add_document({"_id": f"{chunk}-{i}", "body": ""})
        w.commit()
    assert idx.merge_segments() == 2
    assert idx.reader().search(
        {"query": "w1", "limit": 5}).total_hits_estimate == 0


def test_warm_search_runs_pre_swap_snapshot(monkeypatch):
    # while the warm runs, the LIVE manifest must still be pre-merge:
    # a reader opened mid-warm (simulated via the search hook) sees
    # the old segments and exact results
    idx = build([20, 20], monkeypatch)
    seen = {}
    orig = reader_mod.IndexReader.search

    def spy(self, req, mesh=None):
        if "live_segments" not in seen:
            seen["live_segments"] = len(idx.manifest.segments)
        return orig(self, req, mesh=mesh)

    monkeypatch.setattr(reader_mod.IndexReader, "search", spy)
    assert idx.merge_segments() == 2
    # the warm search observed the pre-swap manifest (2 segments)
    assert seen["live_segments"] == 2
    assert len(idx.manifest.segments) == 1
