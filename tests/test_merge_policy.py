"""Tiered auto-merge policy + stall backpressure (round 5).

The round-4 policy folded ALL small segments every pass, re-merging
the previous fold output until it graduated past the small threshold
(~40x write amplification at 200-doc commit batches); on the 1-CPU
device A/B the async drain fell behind the commit rate and the live
segment count hit 305 mid-run. The tiered policy (Lucene
TieredMergePolicy-flavored: fold only the most crowded pow-4
doc-count tier) bounds re-merging at O(log4) per doc, and the stall
loop (Lucene merge-stall-flavored) blocks the WRITER when the small
backlog exceeds its cap so search cost stays bounded.

Reference behavior preserved: segment fold results are array-equal
to a compact() re-ingest (tests/test_merge.py); this file tests only
the SELECTION policy and backpressure.
"""

import numpy as np

from searchlite.api.types import IndexOptions, StorageType
from searchlite.api.writer import (
    _select_merge_tier,
    wait_for_background_merges,
)
from searchlite.index import Index
from searchlite.index.manifest import Schema

SCHEMA = {
    "text_fields": [{"name": "body", "analyzer": "default",
                     "stored": True, "indexed": True}],
}

VOCAB = [f"w{i}" for i in range(40)]


class _Seg:
    def __init__(self, sid, docs):
        self.id = sid
        self.doc_count = docs


def test_select_prefers_smallest_crowded_tier():
    segs = [_Seg(f"a{i}", 200) for i in range(5)]
    segs += [_Seg(f"b{i}", 800) for i in range(6)]
    sel = _select_merge_tier(segs, small_docs=16384, auto=4)
    # both tiers are over threshold; the smallest folds first
    assert sel == [f"a{i}" for i in range(5)]


def test_select_ignores_balanced_tiers_and_big_segments():
    segs = [_Seg(f"a{i}", 200) for i in range(4)]       # == auto: ok
    segs += [_Seg(f"b{i}", 3000) for i in range(4)]      # == auto: ok
    segs += [_Seg(f"c{i}", 100_000) for i in range(9)]   # not small
    assert _select_merge_tier(segs, small_docs=16384, auto=4) is None


def test_select_excludes_in_progress_inputs():
    segs = [_Seg(f"a{i}", 200) for i in range(6)]
    sel = _select_merge_tier(segs, small_docs=16384, auto=4,
                             merging_ids={"a0", "a1"})
    assert sel is None  # only 4 remain in the tier — balanced


def _mk_index(auto=2, path=""):
    return Index.create(
        IndexOptions(path=path, create_if_missing=True,
                     storage=StorageType.IN_MEMORY,
                     auto_merge_segments=auto),
        Schema.from_json(SCHEMA))


def _commit_batch(idx, start, n):
    rng = np.random.default_rng(start)
    w = idx.writer()
    for i in range(n):
        w.add_document({"_id": str(start + i),
                        "body": " ".join(rng.choice(VOCAB, size=6))})
    w.commit()


def test_sync_tiered_merge_cascades_and_results_exact(monkeypatch):
    monkeypatch.delenv("SEARCHLITE_AUTO_MERGE_ASYNC", raising=False)
    idx = _mk_index(auto=2)
    for c in range(12):
        _commit_batch(idx, c * 10, 10)
    # after every commit the policy drains: no tier may stay over
    small = [s for s in idx.manifest.segments if s.doc_count <= 16384]
    tiers = {}
    for s in small:
        t = int(np.log(max(s.doc_count, 1)) / np.log(4))
        tiers.setdefault(t, []).append(s)
    assert all(len(v) <= 2 for v in tiers.values()), \
        [(t, len(v)) for t, v in tiers.items()]
    # every doc is still live exactly once
    res = idx.reader().search({"query": "w1 w2 w3", "limit": 200})
    assert idx.stats()["documents"] == 120
    assert len({h.doc_id for h in res.hits}) == len(res.hits)


def test_async_stall_bounds_small_segment_backlog(monkeypatch):
    monkeypatch.setenv("SEARCHLITE_AUTO_MERGE_ASYNC", "1")
    monkeypatch.setenv("SEARCHLITE_AUTO_MERGE_STALL", "6")
    idx = _mk_index(auto=2)
    for c in range(16):
        _commit_batch(idx, 1000 + c * 10, 10)
        # the stall loop runs after each commit's lock release: the
        # small backlog must never exceed the cap once it returns
        # (modulo the fold the drain thread is mid-way through, which
        # appears only after its swap)
        small_n = sum(1 for s in idx.manifest.segments
                      if s.doc_count <= 16384)
        assert small_n <= 6 + 1, small_n
    wait_for_background_merges(timeout=60.0)
    assert idx.stats()["documents"] == 160


def test_async_drain_loop_folds_cascades(monkeypatch):
    monkeypatch.setenv("SEARCHLITE_AUTO_MERGE_ASYNC", "1")
    monkeypatch.delenv("SEARCHLITE_AUTO_MERGE_STALL", raising=False)
    idx = _mk_index(auto=2)
    for c in range(12):
        _commit_batch(idx, 2000 + c * 10, 10)
    wait_for_background_merges(timeout=60.0)
    # drained: no tier over threshold (same invariant as sync mode)
    small = [s for s in idx.manifest.segments if s.doc_count <= 16384]
    tiers = {}
    for s in small:
        t = int(np.log(max(s.doc_count, 1)) / np.log(4))
        tiers.setdefault(t, []).append(s)
    assert all(len(v) <= 2 for v in tiers.values())
    assert idx.stats()["documents"] == 120


def test_stall_exits_when_policy_is_drained(monkeypatch):
    """Balanced tiers can hold more than the stall cap with nothing
    foldable — the stall loop must return immediately, not spin its
    deadline."""
    import time

    monkeypatch.setenv("SEARCHLITE_AUTO_MERGE_ASYNC", "1")
    monkeypatch.setenv("SEARCHLITE_AUTO_MERGE_STALL", "1")
    idx = _mk_index(auto=50)  # policy never selects anything
    t0 = time.time()
    for c in range(4):
        _commit_batch(idx, 3000 + c * 10, 10)
    assert time.time() - t0 < 60.0  # far under 4x300s deadlines
    assert len(idx.manifest.segments) == 4
