"""WAL / manifest / segment / writer tests.

Mirrors the reference's unit+integration coverage for the persistence
layer (searchlite-core `index/wal.rs:174-278`, `index/segment.rs:1397+`,
`api/writer.rs:341-461`).
"""

import json

import numpy as np
import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.api.writer import IndexWriter
from searchlite.errors import SchemaError, StorageError
from searchlite.index import Index
from searchlite.index.manifest import Manifest, Schema, SegmentMeta
from searchlite.index.postings import BLOCK, InvertedIndexBuilder
from searchlite.index.segment import SegmentReader, SegmentWriter
from searchlite.index.wal import ADD_DOC, COMMIT, DELETE_DOC_ID, Wal
from searchlite.storage import InMemoryStorage


def mem_options(**kw):
    return IndexOptions(path="", create_if_missing=True,
                        storage=StorageType.IN_MEMORY, **kw)


def make_schema():
    return Schema.from_json({
        "text_fields": [
            {"name": "title", "analyzer": "default", "stored": True,
             "indexed": True},
            {"name": "body", "analyzer": "default", "stored": True,
             "indexed": True},
        ],
        "keyword_fields": [
            {"name": "tag", "stored": True, "indexed": True, "fast": True},
        ],
        "numeric_fields": [
            {"name": "year", "i64": True, "fast": True, "stored": True},
        ],
    })


class TestWal:
    def test_replay_roundtrip(self):
        storage = InMemoryStorage()
        wal = Wal(storage)
        wal.append_add_doc({"_id": "1", "body": "hello"})
        wal.append_delete_doc_id("2")
        wal.append_commit()
        entries = Wal.replay(storage)
        assert [e[0] for e in entries] == [ADD_DOC, DELETE_DOC_ID, COMMIT]
        assert entries[0][1]["_id"] == "1"
        assert entries[1][1] == "2"

    def test_pending_ops_cleared_by_commit(self):
        storage = InMemoryStorage()
        wal = Wal(storage)
        wal.append_add_doc({"_id": "1"})
        wal.append_commit()
        wal.append_add_doc({"_id": "2"})
        pending = Wal.last_pending_ops(storage)
        assert len(pending) == 1
        assert pending[0][1]["_id"] == "2"

    def test_replay_stops_at_corruption(self):
        storage = InMemoryStorage()
        wal = Wal(storage)
        wal.append_add_doc({"_id": "1"})
        wal.append_add_doc({"_id": "2"})
        data = bytearray(storage.read_to_end("wal.log"))
        # flip a byte in the middle of the second entry
        data[len(data) - 3] ^= 0xFF
        storage.write_all("wal.log", bytes(data))
        entries = Wal.replay(storage)
        assert len(entries) == 1

    def test_replay_handles_truncation(self):
        storage = InMemoryStorage()
        wal = Wal(storage)
        wal.append_add_doc({"_id": "1"})
        wal.append_add_doc({"_id": "2"})
        data = storage.read_to_end("wal.log")
        storage.write_all("wal.log", data[:-5])
        entries = Wal.replay(storage)
        assert len(entries) == 1


class TestPostingsBuilder:
    def test_merges_same_doc_adds(self):
        b = InvertedIndexBuilder()
        b.add_term("body:x", 0, 0)
        b.add_term("body:x", 0, 3)
        b.add_term("body:x", 2, 1)
        data = b.build()
        docs, tfs = data.term_postings(0)
        assert docs.tolist() == [0, 2]
        assert tfs.tolist() == [2.0, 1.0]
        assert data.positions(0, 0).tolist() == [0, 3]
        assert data.positions(0, 1).tolist() == [1]

    def test_blocks_padded(self):
        b = InvertedIndexBuilder()
        for d in range(BLOCK + 10):
            b.add_term("body:x", d, 0)
        data = b.build()
        assert data.block_docs.shape == (2, BLOCK)
        assert data.term_df[0] == BLOCK + 10
        assert (data.block_docs[1, 10:] == -1).all()

    def test_roundtrip_bytes(self):
        b = InvertedIndexBuilder()
        b.add_term("a:x", 0, 0)
        b.add_term("b:y", 1, 2)
        data = b.build()
        restored = type(data).from_bytes(data.to_bytes(), data.terms)
        assert restored.terms == ["a:x", "b:y"]
        np.testing.assert_array_equal(restored.block_docs, data.block_docs)


class TestSegment:
    def docs(self):
        return [
            {"_id": "1", "title": "Rust Systems", "body": "fast and safe",
             "tag": "Lang", "year": 2015},
            {"_id": "2", "title": "Python", "body": "slow but fun fun fun",
             "tag": ["lang", "Scripting"], "year": 1991},
        ]

    def write(self, storage=None):
        storage = storage or InMemoryStorage()
        writer = SegmentWriter(make_schema(), storage)
        meta = writer.write_segment(self.docs(), generation=1)
        return storage, meta

    def test_roundtrip(self):
        storage, meta = self.write()
        assert meta.doc_count == 2
        reader = SegmentReader(meta, storage)
        assert reader.doc_ids == ["1", "2"]
        assert reader.doc_freq("body:fun") == 1
        docs, tfs = reader.postings_for("body:fun")
        assert docs.tolist() == [1]
        assert tfs.tolist() == [3.0]
        doc = reader.get_doc(0)
        assert doc["title"] == "Rust Systems"
        assert doc["_id"] == "1"

    def test_keywords_lowercased_for_index_original_in_fast(self):
        storage, meta = self.write()
        reader = SegmentReader(meta, storage)
        assert reader.doc_freq("tag:lang") == 2
        assert reader.doc_freq("tag:scripting") == 1
        assert reader.doc_freq("tag:Lang") == 0
        # fast column keeps original case, matching is case-insensitive
        assert reader.fast.str_values("tag", 0) == ["Lang"]
        mask = reader.fast.matches_keyword("tag", "LANG")
        assert mask.tolist() == [True, True]

    def test_doc_lengths_and_avg(self):
        storage, meta = self.write()
        reader = SegmentReader(meta, storage)
        assert reader.fast.doc_length("body", 0) == 3.0
        assert reader.fast.doc_length("body", 1) == 5.0
        assert meta.avg_field_lengths["body"] == pytest.approx(4.0)

    def test_checksum_validation(self):
        storage, meta = self.write()
        data = bytearray(storage.read_to_end(f"seg_{meta.id}.terms"))
        data[10] ^= 0xFF
        storage.write_all(f"seg_{meta.id}.terms", bytes(data))
        with pytest.raises(StorageError):
            SegmentReader(meta, storage)

    def test_unknown_field_rejected(self):
        storage = InMemoryStorage()
        writer = SegmentWriter(make_schema(), storage)
        with pytest.raises(SchemaError):
            writer.write_segment(
                [{"_id": "1", "bogus": "x"}], generation=1)

    def test_positions_across_multi_values(self):
        storage = InMemoryStorage()
        writer = SegmentWriter(make_schema(), storage)
        meta = writer.write_segment(
            [{"_id": "1", "body": ["alpha beta", "gamma alpha"]}],
            generation=1)
        reader = SegmentReader(meta, storage)
        tid = reader.term_id("body:alpha")
        pos = reader.postings.positions_for_doc(tid, 0)
        assert pos.tolist() == [0, 3]


class TestIndexWriter:
    def make_index(self):
        return Index.create(mem_options(), make_schema())

    def test_add_commit_search_lifecycle(self):
        index = self.make_index()
        writer = index.writer()
        writer.add_document({"_id": "1", "title": "hello world",
                             "body": "first doc", "tag": "a", "year": 1})
        writer.add_document({"_id": "2", "title": "goodbye",
                             "body": "second doc", "tag": "b", "year": 2})
        writer.commit()
        m = index.manifest
        assert len(m.segments) == 1
        assert m.segments[0].doc_count == 2
        # WAL truncated after commit
        assert Wal.last_pending_ops(index.storage) == []

    def test_upsert_tombstones_old_version(self):
        index = self.make_index()
        writer = index.writer()
        writer.add_document({"_id": "1", "title": "v1", "body": "one",
                             "tag": "a", "year": 1})
        writer.commit()
        writer.add_document({"_id": "1", "title": "v2", "body": "two",
                             "tag": "a", "year": 1})
        writer.commit()
        m = index.manifest
        assert len(m.segments) == 2
        assert m.segments[0].deleted_docs == [0]
        assert m.segments[1].deleted_docs == []

    def test_delete(self):
        index = self.make_index()
        writer = index.writer()
        writer.add_document({"_id": "1", "title": "x", "body": "y",
                             "tag": "a", "year": 1})
        writer.commit()
        writer.delete_document("1")
        writer.commit()
        m = index.manifest
        assert m.segments[0].deleted_docs == [0]
        assert index.stats()["documents"] == 0

    def test_last_write_wins_within_batch(self):
        index = self.make_index()
        writer = index.writer()
        writer.add_document({"_id": "1", "title": "a", "body": "a",
                             "tag": "a", "year": 1})
        writer.add_document({"_id": "1", "title": "b", "body": "b",
                             "tag": "b", "year": 2})
        writer.commit()
        m = index.manifest
        assert m.segments[0].doc_count == 1
        reader = SegmentReader(m.segments[0], index.storage)
        assert reader.get_doc(0)["title"] == "b"

    def test_rollback_clears_pending(self):
        index = self.make_index()
        writer = index.writer()
        writer.add_document({"_id": "1", "title": "x", "body": "y",
                             "tag": "a", "year": 1})
        writer.rollback()
        writer.commit()
        assert index.manifest.segments == []

    def test_crash_replay_restores_pending_batch(self):
        index = self.make_index()
        writer = index.writer()
        writer.add_document({"_id": "1", "title": "x", "body": "y",
                             "tag": "a", "year": 1})
        # simulate crash: new writer on same storage
        writer2 = IndexWriter(index)
        assert writer2.pending_ops == 1
        writer2.commit()
        assert index.manifest.total_docs() == 1

    def test_validation_rejects_missing_id(self):
        index = self.make_index()
        writer = index.writer()
        with pytest.raises(SchemaError):
            writer.add_document({"title": "no id", "body": "x",
                                 "tag": "a", "year": 1})

    def test_compact_merges_segments(self):
        index = self.make_index()
        writer = index.writer()
        for i in range(3):
            writer.add_document({"_id": str(i), "title": f"t{i}",
                                 "body": f"doc {i}", "tag": "a", "year": i})
            writer.commit()
        writer.delete_document("1")
        writer.commit()
        assert len(index.manifest.segments) == 3
        index.compact()
        m = index.manifest
        assert len(m.segments) == 1
        assert m.segments[0].doc_count == 2
        reader = SegmentReader(m.segments[0], index.storage)
        assert sorted(reader.doc_ids) == ["0", "2"]

    def test_compact_removes_old_files(self, tmp_path):
        opts = IndexOptions(path=str(tmp_path / "idx"),
                            create_if_missing=True)
        index = Index.create(opts, make_schema())
        writer = index.writer()
        for i in range(2):
            writer.add_document({"_id": str(i), "title": "t", "body": "b",
                                 "tag": "a", "year": i})
            writer.commit()
        old_ids = [s.id for s in index.manifest.segments]
        index.compact()
        files = index.storage.list_files()
        for seg_id in old_ids:
            assert not any(seg_id in f for f in files)


class TestManifest:
    def test_store_load_roundtrip(self):
        storage = InMemoryStorage()
        m = Manifest(schema=make_schema())
        m.segments.append(SegmentMeta(
            id="abc", generation=1, doc_count=5, max_doc_id=4,
            deleted_docs=[2], avg_field_lengths={"body": 3.5},
            checksums={"terms": 123}))
        m.store(storage)
        loaded = Manifest.load(storage)
        assert loaded.uuid == m.uuid
        assert loaded.segments[0].deleted_docs == [2]
        assert loaded.schema.text_fields[0].name == "title"

    def test_schema_validate_config_rejects_doc_id_overlap(self):
        schema = Schema.from_json({
            "doc_id_field": "title",
            "text_fields": [{"name": "title", "analyzer": "default",
                             "stored": True, "indexed": True}],
        })
        with pytest.raises(SchemaError):
            schema.validate_config()

    def test_saty_generates_edge_ngram_analyzer(self):
        schema = Schema.from_json({
            "text_fields": [{"name": "title", "stored": True, "indexed": True,
                             "search_as_you_type": {"min_gram": 2,
                                                    "max_gram": 4}}],
        })
        analyzers = schema.build_analyzers()
        idx = analyzers.index_analyzer("title")
        search = analyzers.search_analyzer("title")
        assert [t.text for t in idx.analyze("rust")] == ["ru", "rus", "rust"]
        assert [t.text for t in search.analyze("rust")] == ["rust"]

    def test_nested_schema_resolves_dotted_paths(self):
        schema = Schema.from_json({
            "text_fields": [],
            "nested_fields": [{
                "name": "cast",
                "fields": [
                    {"type": "keyword", "name": "role", "stored": True,
                     "indexed": True, "fast": True},
                    {"type": "numeric", "name": "age", "i64": True,
                     "fast": True},
                ],
            }],
        })
        paths = [f.path for f in schema.resolved_fields()]
        assert "cast.role" in paths and "cast.age" in paths

    def test_document_validation(self):
        schema = make_schema()
        with pytest.raises(SchemaError):
            schema.validate_document({"_id": "1", "year": "not a number"})
        with pytest.raises(SchemaError):
            schema.validate_document({"_id": "  "})
        schema.validate_document({"_id": "1", "year": [1, 2]})
