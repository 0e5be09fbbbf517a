"""De-locked structural merge (round 5): the fold + warm run outside
the writer lock so commits never wait on a background merge, with a
late-tombstone carryover at swap time for correctness.

Contracts tested:
- tombstones (deletes / LWW upserts) landing on a merge INPUT while
  the fold runs unlocked are carried onto the fold at swap — the old
  doc version is never resurrected;
- a concurrent compact() that swallows the inputs makes the merge a
  no-op (fold discarded, results exact);
- segment generations stay strictly increasing across a swap that
  raced a commit (the cursor epoch contract);
- _carry_late_tombstones maps ordinals through the live-rank remap
  exactly (unit).
"""

import numpy as np

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index, _carry_late_tombstones
from searchlite.index.manifest import Schema

SCHEMA = {
    "text_fields": [{"name": "body", "analyzer": "default",
                     "stored": True, "indexed": True}],
}

VOCAB = [f"w{i}" for i in range(40)]


def build(chunks):
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json(SCHEMA))
    rng = np.random.default_rng(5)
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


def _hits(idx, q, limit=50):
    res = idx.reader().search({"query": q, "limit": limit})
    return {h.doc_id for h in res.hits}


def test_mid_merge_upsert_is_not_resurrected(monkeypatch):
    idx = build([20, 20])
    # find a doc matching w3 so the upsert is observable via search
    victim = sorted(_hits(idx, "w3"))[0]

    # during the unlocked window (the warm), race a commit that
    # upserts the victim with a body that no longer matches w3
    orig_warm = Index._warm_fold

    def racing_warm(self, manifest, segments):
        w = idx.writer()
        w.add_document({"_id": victim, "body": "zzz_replaced"})
        w.commit()
        orig_warm(self, manifest, segments)

    monkeypatch.setattr(Index, "_warm_fold", racing_warm)
    assert idx.merge_segments() == 2
    # the fold must NOT serve the old version
    assert victim not in _hits(idx, "w3")
    assert victim in _hits(idx, "zzz_replaced")
    # exactly one live copy
    stats = idx.stats()
    assert stats["documents"] == 40


def test_mid_merge_delete_carries_over(monkeypatch):
    idx = build([15, 15])
    victim = sorted(_hits(idx, "w1"))[0]
    orig_warm = Index._warm_fold

    def racing_warm(self, manifest, segments):
        w = idx.writer()
        w.delete_document(victim)
        w.commit()
        orig_warm(self, manifest, segments)

    monkeypatch.setattr(Index, "_warm_fold", racing_warm)
    pre_gen = max(s.generation for s in idx.manifest.segments)
    assert idx.merge_segments() == 2
    assert victim not in _hits(idx, "w1")
    assert idx.stats()["documents"] == 29
    # cursor epoch: max segment generation strictly increased
    assert max(s.generation for s in idx.manifest.segments) > pre_gen


def test_concurrent_compact_discards_fold(monkeypatch):
    idx = build([12, 12])
    before = _hits(idx, "w2")

    def compacting_warm(self, manifest, segments):
        idx.compact()

    monkeypatch.setattr(Index, "_warm_fold", compacting_warm)
    assert idx.merge_segments() == 0
    assert len(idx.manifest.segments) == 1
    assert _hits(idx, "w2") == before
    # the discarded fold's files must not linger
    live_ids = {s.id for s in idx.manifest.segments}
    for f in idx.storage.list_files():
        if f.startswith("seg_"):
            assert any(sid in f for sid in live_ids), f


def test_merging_ids_guard_blocks_overlapping_selection(monkeypatch):
    idx = build([10, 10, 10])
    inner = {}
    orig_warm = Index._warm_fold

    def reentrant_warm(self, manifest, segments):
        # while the first merge holds its inputs, a second merge over
        # the same inputs must select nothing
        inner["result"] = idx.merge_segments()
        orig_warm(self, manifest, segments)

    monkeypatch.setattr(Index, "_warm_fold", reentrant_warm)
    assert idx.merge_segments() == 3
    assert inner["result"] == 0
    assert idx.stats()["documents"] == 30


def test_carry_late_tombstones_unit():
    class Meta:
        def __init__(self, id, n, dead):
            self.id = id
            self.doc_count = n
            self.deleted_docs = list(dead)

    # seg A: 5 docs, ord 1 dead at snapshot -> live [0,2,3,4]
    # seg B: 4 docs, none dead              -> live [0,1,2,3]
    snapA = Meta("a", 5, [1])
    snapB = Meta("b", 4, [])
    fold = Meta("f", 8, [])
    # after snapshot: A gains ord 3 (fold ord 2), B gains ord 0
    # (fold ord 4 + 0) and ord 3 (fold ord 4 + 3)
    nowA = Meta("a", 5, [1, 3])
    nowB = Meta("b", 4, [0, 3])
    _carry_late_tombstones([snapA, snapB],
                           {"a": nowA, "b": nowB}, fold)
    assert fold.deleted_docs == [2, 4, 7]
