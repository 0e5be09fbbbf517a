"""Regression tests mirroring `searchlite-core/tests/regressions.rs` and
`file_format.rs`: format stability, atomicity, concurrent writers."""

import json

import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.errors import SchemaError, SearchliteError
from searchlite.index import Index
from searchlite.index.manifest import Manifest, Schema
from searchlite.index.wal import Wal
from searchlite.storage import InMemoryStorage
from searchlite.utils import varint


def mem_options(**kw):
    return IndexOptions(path="", create_if_missing=True,
                        storage=StorageType.IN_MEMORY, **kw)


SCHEMA = {
    "text_fields": [{"name": "body", "analyzer": "default", "stored": True,
                     "indexed": True}],
    "keyword_fields": [{"name": "tag", "stored": True, "indexed": True,
                        "fast": True}],
    "numeric_fields": [],
}


class TestFileFormatStability:
    """WAL/varint byte-format goldens (parity: tests/file_format.rs)."""

    def test_wal_entry_bytes(self):
        storage = InMemoryStorage()
        wal = Wal(storage)
        wal.append_delete_doc_id("abc")
        data = storage.read_to_end("wal.log")
        # varint len(3) + type byte 3 + b"abc" + crc32 LE
        assert data[0] == 3        # payload length varint
        assert data[1] == 3        # DeleteDocId type
        assert data[2:5] == b"abc"
        assert len(data) == 9      # 1 + 1 + 3 + 4

    def test_commit_marker_bytes(self):
        storage = InMemoryStorage()
        wal = Wal(storage)
        wal.append_commit()
        data = storage.read_to_end("wal.log")
        assert data[0] == 0 and data[1] == 2 and len(data) == 6

    def test_varint_format(self):
        assert varint.encode_u64(300) == b"\xac\x02"

    def test_wal_raw_passthrough_replays_identically(self):
        """NDJSON surfaces splice the client's raw line bytes into the
        WAL payload (no re-serialization); replay must decode the same
        documents as the dumps path, and framing/crc must hold."""
        docs = [
            {"_id": "a", "body": "alpha été", "tag": "t",
             "n": 1.5},
            {"_id": "b", "body": "beta", "tag": "u", "n": -3},
        ]
        raws = [json.dumps(d).encode() for d in docs]

        s_raw, s_dump = InMemoryStorage(), InMemoryStorage()
        Wal(s_raw).append_add_docs(docs, raws=raws)
        Wal(s_dump).append_add_docs(docs)
        assert Wal.replay(s_raw) == Wal.replay(s_dump)
        assert [d for _t, d in Wal.replay(s_raw)] == docs

        # mixed raws (None falls back to dumps per entry)
        s_mix = InMemoryStorage()
        Wal(s_mix).append_add_docs(docs, raws=[raws[0], None])
        assert [d for _t, d in Wal.replay(s_mix)] == docs

    def test_wal_raw_passthrough_fuzz_client_formatting(self):
        """Raw WAL splice must replay exactly json.loads(raw) no matter
        how the client formatted the line: odd spacing, unicode
        escapes vs literals, floats, nested values, duplicate keys
        (last wins at parse time, both at add and at replay)."""
        import random

        rng = random.Random(1234)
        lines = [
            '{"_id":"a","body":"caf\\u00e9 crème","n":1e-3}',
            '{ "_id" : "b" ,\t"body" : "tabs\\tand\\nnewlines" }',
            '{"_id":"c","n":123456789012345678,"f":0.1,"l":[1,2.5,"x"]}',
            '{"_id":"d","dup":1,"dup":2}',
            '{"_id":"e","deep":{"a":[{"b":"\\ud83d\\ude00"}]},"s":"😀"}',
            '{"_id":"f","neg":-0.0,"big":1e308,"tiny":5e-324}',
        ]
        for _ in range(40):
            doc = {"_id": f"r{rng.randrange(10**6)}",
                   "body": "".join(chr(rng.randrange(32, 0x2FA0))
                                   for _ in range(rng.randrange(0, 40))),
                   "n": rng.choice([rng.random() * 10**rng.randrange(-9, 9),
                                    rng.randrange(-2**53, 2**53)])}
            sep = rng.choice([(", ", ": "), (",", ":"), (" , ", " : ")])
            lines.append(json.dumps(doc, separators=sep,
                                    ensure_ascii=rng.random() < 0.5))
        docs = [json.loads(ln) for ln in lines]
        storage = InMemoryStorage()
        Wal(storage).append_add_docs(docs, raws=[ln.encode()
                                                 for ln in lines])
        replayed = [d for _t, d in Wal.replay(storage)]
        assert replayed == docs

    def test_wal_raw_passthrough_truncation_stops_replay(self):
        """A torn raw-spliced entry is detected exactly like a dumps
        entry: replay returns only the intact prefix."""
        docs = [{"_id": "a", "body": "x", "tag": "t"},
                {"_id": "b", "body": "y", "tag": "t"}]
        raws = [json.dumps(d).encode() for d in docs]
        storage = InMemoryStorage()
        Wal(storage).append_add_docs(docs, raws=raws)
        data = storage.read_to_end("wal.log")
        storage.write_all("wal.log", data[:-3])  # tear the second crc
        replayed = Wal.replay(storage)
        assert [d for _t, d in replayed] == docs[:1]


def test_in_memory_storage_keeps_disk_clean(tmp_path):
    """StorageType.IN_MEMORY with a path configured must never touch
    the filesystem (reference tests/smoke.rs::
    in_memory_storage_keeps_disk_clean)."""
    import os

    idx_path = str(tmp_path / "idx")
    index = Index.create(
        IndexOptions(path=idx_path, create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json(SCHEMA))
    writer = index.writer()
    writer.add_document({"_id": "mem-1", "body": "in memory wal",
                         "tag": "a"})
    writer.commit()
    hits = index.reader().search({"query": "memory", "limit": 10}).hits
    assert len(hits) == 1
    assert not os.path.exists(idx_path)


class TestConcurrentWriters:
    def test_stale_writer_refreshes_manifest_before_commit(self):
        """A writer created before another writer's commit must fold
        its upsert over the NEWEST manifest: the old version gets
        tombstoned, the new one is visible (reference
        tests/regressions.rs::concurrent_writers_refresh_manifest_
        before_commit)."""
        index = Index.create(mem_options(), Schema.from_json(SCHEMA))
        w1 = index.writer()
        w2 = index.writer()  # stale snapshot: pre-dates w1's commit
        w1.add_document({"_id": "1", "body": "first body", "tag": "a"})
        w1.commit()
        w2.add_document({"_id": "1", "body": "updated body", "tag": "a"})
        w2.commit()
        reader = index.reader()
        assert len(reader.search({"query": "first",
                                  "limit": 10}).hits) == 0
        assert len(reader.search({"query": "updated",
                                  "limit": 10}).hits) == 1


class TestAtomicity:
    def test_failed_manifest_persistence_rolls_back(self):
        class FailingManifestStorage(InMemoryStorage):
            def __init__(self):
                super().__init__()
                self.fail_manifest = False

            def atomic_write(self, path, data):
                if self.fail_manifest and path == "MANIFEST.json":
                    raise OSError("injected manifest failure")
                super().atomic_write(path, data)

        storage = FailingManifestStorage()
        index = Index.create_with_storage(storage, mem_options(),
                                          Schema.from_json(SCHEMA))
        writer = index.writer()
        writer.add_document({"_id": "1", "body": "first", "tag": "a"})
        writer.commit()
        before = Manifest.load(storage).to_json()

        writer.add_document({"_id": "2", "body": "second", "tag": "a"})
        storage.fail_manifest = True
        with pytest.raises(SearchliteError):
            writer.commit()
        storage.fail_manifest = False

        # manifest unchanged on disk; WAL retains the pending op so a new
        # writer replays it (parity: api/writer.rs:341-461)
        after = Manifest.load(storage).to_json()
        assert after["segments"] == before["segments"]
        writer2 = index.writer()
        assert writer2.pending_ops >= 1
        writer2.commit()
        reader = Index.open_with_storage(storage, mem_options()).reader()
        res = reader.search({"query": "second", "limit": 5})
        assert res.total_hits_estimate == 1

    def test_concurrent_writers_refresh_manifest(self):
        """Two writers on the same index: the second commit must see the
        first's segment (parity: regressions.rs:296+)."""
        index = Index.create(mem_options(), Schema.from_json(SCHEMA))
        w1 = index.writer()
        w2 = index.writer()
        w1.add_document({"_id": "1", "body": "one", "tag": "a"})
        w1.commit()
        # w2 was opened before w1 committed and replays the shared WAL —
        # its pending ops include w1's (shared single-writer WAL), so
        # fold-and-commit must not duplicate doc 1
        w2.add_document({"_id": "2", "body": "two", "tag": "a"})
        w2.commit()
        reader = index.reader()
        res = reader.search({"query": {"type": "match_all"}, "limit": 10})
        assert res.total_hits_estimate == 2
        ids = sorted(h.doc_id for h in res.hits)
        assert ids == ["1", "2"]


class TestCompactionSafety:
    def test_compaction_refuses_unstored_indexed_fields(self):
        schema = {
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
        }
        index = Index.create(mem_options(), Schema.from_json(schema))
        writer = index.writer()
        writer.add_document({"_id": "1", "body": "hello"})
        writer.commit()
        writer.add_document({"_id": "2", "body": "world"})
        writer.commit()
        with pytest.raises(SchemaError):
            index.compact()

    def test_readers_stay_live_across_commits(self):
        index = Index.create(mem_options(), Schema.from_json(SCHEMA))
        writer = index.writer()
        writer.add_document({"_id": "1", "body": "first", "tag": "a"})
        writer.commit()
        reader = index.reader()  # snapshot
        writer.add_document({"_id": "2", "body": "second", "tag": "a"})
        writer.commit()
        # old snapshot still serves the old view
        res = reader.search({"query": {"type": "match_all"}, "limit": 10})
        assert res.total_hits_estimate == 1
        # a fresh reader sees both
        res2 = index.reader().search(
            {"query": {"type": "match_all"}, "limit": 10})
        assert res2.total_hits_estimate == 2


class TestCrashWindow:
    def test_manifest_durable_but_wal_not_truncated_reapplies_batch(self):
        """The documented crash window (reference README.md:22-24): a
        crash after the manifest is durable but before the WAL is
        truncated makes the next writer replay the batch into a
        duplicate generation — no data loss, no duplicate results
        (upserts tombstone the earlier copies), compaction cleans up."""
        index = Index.create(mem_options(), Schema.from_json(SCHEMA))
        writer = index.writer()
        writer.add_document({"_id": "a", "body": "alpha text", "tag": "t"})
        writer.add_document({"_id": "b", "body": "beta text", "tag": "t"})
        writer.commit()
        gen_before = index.manifest.generation
        segs_before = len(index.manifest.segments)

        # simulate the window: the committed batch's ops are back in the
        # WAL with no Commit marker (as if the crash hit between
        # manifest.store() and wal.truncate())
        wal = Wal(index.storage)
        wal.append_add_doc({"_id": "a", "body": "alpha text", "tag": "t"})
        wal.append_add_doc({"_id": "b", "body": "beta text", "tag": "t"})

        writer2 = index.writer()  # replays pending ops
        writer2.commit()

        manifest = index.manifest
        assert manifest.generation > gen_before
        assert len(manifest.segments) == segs_before + 1  # duplicate gen
        reader = index.reader()
        res = reader.search({"query": "alpha", "limit": 10,
                             "return_stored": True})
        assert [h.doc_id for h in res.hits] == ["a"]  # no duplicates
        res = reader.search({"query": "text", "limit": 10})
        assert sorted(h.doc_id for h in res.hits) == ["a", "b"]
        # WAL is clean again: a fresh writer has nothing to replay
        assert Wal.replay(index.storage) == []

        index.compact()
        assert len(index.manifest.segments) == 1
        res = index.reader().search({"query": "text", "limit": 10})
        assert sorted(h.doc_id for h in res.hits) == ["a", "b"]


class TestConcurrentReadWrite:
    def test_searches_during_commits(self):
        """Readers (and the process-global segment cache) stay
        consistent while a writer commits new segments concurrently:
        every search sees a complete manifest snapshot and never
        errors."""
        import threading

        index = Index.create(mem_options(), Schema.from_json(SCHEMA))
        w = index.writer()
        w.add_document({"_id": "seed", "body": "common seed doc",
                        "tag": "t"})
        w.commit()

        errors: list[Exception] = []
        stop = threading.Event()

        def searcher():
            try:
                while not stop.is_set():
                    reader = index.reader()
                    res = reader.search({"query": "common", "limit": 50})
                    # every committed doc contains "common": the count
                    # must equal that reader's snapshot doc count
                    expect = sum(s.doc_count for s in reader.segments) \
                        - sum(len(s.deleted) for s in reader.segments)
                    assert res.total_hits_estimate == expect
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=searcher) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            for i in range(15):
                w2 = index.writer()
                w2.add_document({"_id": f"d{i}", "body": "common doc",
                                 "tag": "t"})
                w2.commit()
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
        assert not errors, errors[:1]
        final = index.reader().search({"query": "common", "limit": 50})
        assert final.total_hits_estimate == 16


def test_bulk_delete_wal_bytes_match_per_doc():
    """append_delete_doc_ids writes byte-identical entries to the
    per-doc form, in one storage append."""
    ids = ["a", "doc-β", "z" * 100]
    s_bulk, s_one = InMemoryStorage(), InMemoryStorage()
    Wal(s_bulk).append_delete_doc_ids(ids)
    w = Wal(s_one)
    for i in ids:
        w.append_delete_doc_id(i)
    assert s_bulk.read_to_end("wal.log") == s_one.read_to_end("wal.log")
    assert [d for _t, d in Wal.replay(s_bulk)] == ids
