"""Engine option modes: return_hits=false, docstore compression,
positions disabled, custom BM25 params, search-as-you-type, custom
analyzers end-to-end."""

import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema
from searchlite.models.bm25 import bm25


def make_index(schema_json, docs, **opts):
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY, **opts),
        Schema.from_json(schema_json))
    writer = index.writer()
    writer.add_documents(docs)
    writer.commit()
    return index


BASIC_SCHEMA = {
    "text_fields": [{"name": "body", "analyzer": "default",
                     "stored": True, "indexed": True}],
}

BASIC_DOCS = [
    {"_id": "1", "body": "alpha beta gamma"},
    {"_id": "2", "body": "alpha alpha delta"},
]


class TestReturnHits:
    def test_return_hits_false_counts_only(self):
        index = make_index(BASIC_SCHEMA, BASIC_DOCS)
        res = index.reader().search({"query": "alpha", "limit": 5,
                                     "return_hits": False})
        assert res.total_hits_estimate == 2
        assert res.hits == []
        assert res.next_cursor is None

    def test_return_hits_false_with_aggs(self):
        schema = dict(BASIC_SCHEMA)
        schema["numeric_fields"] = [
            {"name": "n", "i64": True, "fast": True, "stored": True}]
        docs = [dict(d, n=i) for i, d in enumerate(BASIC_DOCS)]
        index = make_index(schema, docs)
        res = index.reader().search({
            "query": "alpha", "limit": 5, "return_hits": False,
            "aggs": {"s": {"type": "stats", "field": "n"}}})
        assert res.aggregations["s"]["count"] == 2

    def test_cursor_with_return_hits_false_rejected(self):
        from searchlite.errors import QueryError

        index = make_index(BASIC_SCHEMA, BASIC_DOCS)
        with pytest.raises(QueryError):
            index.reader().search({"query": "alpha", "limit": 5,
                                   "return_hits": False, "cursor": "00"})


class TestDocstoreCompression:
    def test_compressed_roundtrip(self):
        index = make_index(BASIC_SCHEMA, BASIC_DOCS,
                           compress_docstore=True)
        res = index.reader().search({"query": "alpha", "limit": 5,
                                     "return_stored": True})
        bodies = {h.doc_id: h.fields["body"] for h in res.hits}
        assert bodies["1"] == "alpha beta gamma"

    def test_default_true_prefers_zstd(self):
        """compress_docstore=True now means zstd (the reference's
        codec, `index/docstore.rs`); segment meta records the codec."""
        index = make_index(BASIC_SCHEMA, BASIC_DOCS,
                           compress_docstore=True)
        reader = index.reader()
        assert reader.segments[0].compress == "zstd"

    def test_explicit_zlib_codec(self):
        index = make_index(BASIC_SCHEMA, BASIC_DOCS,
                           compress_docstore="zlib")
        reader = index.reader()
        assert reader.segments[0].compress == "zlib"
        res = reader.search({"query": "alpha", "limit": 5,
                             "return_stored": True})
        assert res.hits[0].fields["body"].startswith("alpha")

    def test_legacy_bool_meta_reads_as_zlib(self):
        """Segments written by earlier builds recorded compress: true
        and used zlib — they must keep decoding."""
        import json as _json
        import zlib as _zlib

        from searchlite.index.docstore import DocStoreReader

        payload = _json.dumps({"body": "legacy"}).encode()
        data = _zlib.compress(payload)
        blob = len(data).to_bytes(4, "little") + data
        reader = DocStoreReader(blob, [0], compress=True)
        assert reader.get(0) == {"body": "legacy"}

    def test_compaction_preserves_compression(self):
        index = make_index(BASIC_SCHEMA, BASIC_DOCS,
                           compress_docstore=True)
        writer = index.writer()
        writer.add_document({"_id": "3", "body": "alpha epsilon"})
        writer.commit()
        index.compact()
        res = index.reader().search({"query": "epsilon", "limit": 5,
                                     "return_stored": True})
        assert res.hits[0].fields["body"] == "alpha epsilon"


class TestPositionsDisabled:
    def test_phrase_never_matches_without_positions(self):
        index = make_index(BASIC_SCHEMA, BASIC_DOCS,
                           enable_positions=False)
        res = index.reader().search({
            "query": {"type": "phrase", "field": "body",
                      "terms": ["alpha", "beta"]},
            "limit": 5})
        assert res.hits == []
        # term search still works
        res2 = index.reader().search({"query": "alpha", "limit": 5})
        assert res2.total_hits_estimate == 2


class TestBm25Params:
    def test_custom_k1_b(self):
        index = make_index(BASIC_SCHEMA, BASIC_DOCS,
                           bm25_k1=1.2, bm25_b=0.75)
        reader = index.reader()
        res = reader.search({"query": "alpha", "limit": 5})
        seg = reader.segments[0]
        docs, tfs = seg.postings_for("body:alpha")
        avgdl = seg.avg_field_length("body")
        expected = {
            seg.doc_id(d): bm25(tf, 2.0, seg.fast.doc_length("body", d),
                                avgdl, 2.0, 1.2, 0.75)
            for d, tf in zip(docs.tolist(), tfs.tolist())
        }
        for h in res.hits:
            assert h.score == pytest.approx(expected[h.doc_id], rel=1e-5)


class TestSearchAsYouType:
    def test_prefix_matches_via_edge_ngrams(self):
        schema = {
            "text_fields": [{"name": "title", "stored": True,
                             "indexed": True,
                             "search_as_you_type": {"min_gram": 2,
                                                    "max_gram": 10}}],
        }
        docs = [{"_id": "1", "title": "chocolate cake"},
                {"_id": "2", "title": "chicken soup"}]
        index = make_index(schema, docs)
        reader = index.reader()
        # plain term query hits the edge-ngram index terms
        res = reader.search({"query": "choc", "limit": 5,
                             "fields": ["title"]})
        assert [h.doc_id for h in res.hits] == ["1"]
        res2 = reader.search({"query": "ch", "limit": 5,
                              "fields": ["title"]})
        assert sorted(h.doc_id for h in res2.hits) == ["1", "2"]
        # full word still matches (max_gram covers it)
        res3 = reader.search({"query": "chocolate", "limit": 5,
                              "fields": ["title"]})
        assert [h.doc_id for h in res3.hits] == ["1"]


class TestCustomAnalyzers:
    def test_stemmer_stopwords_pipeline_end_to_end(self):
        schema = {
            "analyzers": [{
                "name": "english",
                "tokenizer": "default",
                "filters": [
                    {"type": "stopwords", "stopwords": "en"},
                    {"type": "stemmer", "stemmer": "english"},
                ],
            }],
            "text_fields": [{"name": "body", "analyzer": "english",
                             "stored": True, "indexed": True}],
        }
        docs = [{"_id": "1", "body": "the running dogs were jumping"},
                {"_id": "2", "body": "a cat sleeps"}]
        index = make_index(schema, docs)
        reader = index.reader()
        # query analyzed with the same pipeline: "runs" → "run"
        res = reader.search({"query": "runs", "limit": 5})
        assert [h.doc_id for h in res.hits] == ["1"]
        # stopwords dropped at both index and query time
        res2 = reader.search({"query": "the", "limit": 5})
        assert res2.hits == []

    def test_unicode_tokenizer_end_to_end(self):
        schema = {
            "analyzers": [{"name": "uni", "tokenizer": "unicode"}],
            "text_fields": [{"name": "body", "analyzer": "uni",
                             "stored": True, "indexed": True}],
        }
        docs = [{"_id": "1", "body": "CAFÉ ﬂavor town"}]
        index = make_index(schema, docs)
        res = index.reader().search({"query": "café", "limit": 5})
        assert [h.doc_id for h in res.hits] == ["1"]
        res2 = index.reader().search({"query": "flavor", "limit": 5})
        assert [h.doc_id for h in res2.hits] == ["1"]

    def test_phrase_matches_through_synonym_variants(self):
        """Phrase postings merge synonym variants at the same position
        (parity: merge_postings_lists, `api/reader.rs:1748-1771`)."""
        schema = {
            "analyzers": [{
                "name": "syn", "tokenizer": "default",
                "filters": [{"type": "synonyms", "synonyms": [
                    {"from": ["nyc"], "to": ["new", "york"]}]}],
            }],
            "text_fields": [{"name": "body", "analyzer": "syn",
                             "stored": True, "indexed": True}],
        }
        docs = [{"_id": "1", "body": "nyc subway map"},
                {"_id": "2", "body": "newark subway map"}]
        index = make_index(schema, docs)
        res = index.reader().search({
            "query": {"type": "phrase", "field": "body",
                      "terms": ["new", "subway"]},
            "limit": 5})
        assert [h.doc_id for h in res.hits] == ["1"]

    def test_suggest_with_fuzzy_prefix(self):
        docs = [{"_id": "1", "body": "chocolate chip cookies"},
                {"_id": "2", "body": "chocolate cake"}]
        index = make_index(BASIC_SCHEMA, docs)
        res = index.reader().search({
            "query": {"type": "match_all"}, "limit": 1,
            "suggest": {"s": {"type": "completion", "field": "body",
                              "prefix": "chok",
                              "fuzzy": {"max_edits": 1,
                                        "prefix_length": 3}}}})
        texts = [o["text"] for o in res.suggest["s"]["options"]]
        assert "chocolate" in texts

    def test_synonym_search(self):
        schema = {
            "analyzers": [{
                "name": "syn", "tokenizer": "default",
                "filters": [{"type": "synonyms", "synonyms": [
                    {"from": ["nyc"], "to": ["york"]}]}],
            }],
            "text_fields": [{"name": "body", "analyzer": "syn",
                             "stored": True, "indexed": True}],
        }
        docs = [{"_id": "1", "body": "i love nyc"},
                {"_id": "2", "body": "new york pizza"}]
        index = make_index(schema, docs)
        res = index.reader().search({"query": "york", "limit": 5})
        assert sorted(h.doc_id for h in res.hits) == ["1", "2"]
