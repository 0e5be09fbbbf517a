"""Vector + hybrid search tests (parity targets:
`searchlite-core/tests/vector_search.rs`)."""

import math

import numpy as np
import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.errors import QueryError
from searchlite.index import Index
from searchlite.index.manifest import Schema


def make_vector_index(metric="Cosine", docs=None):
    schema = Schema.from_json({
        "text_fields": [{"name": "body", "analyzer": "default",
                         "stored": True, "indexed": True}],
        "keyword_fields": [{"name": "tag", "stored": True, "indexed": True,
                            "fast": True}],
        "numeric_fields": [],
        "vector_fields": [{"name": "embedding", "dim": 4,
                           "metric": metric}],
    })
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY), schema)
    writer = index.writer()
    default_docs = [
        {"_id": "a", "body": "alpha document", "tag": "x",
         "embedding": [1.0, 0.0, 0.0, 0.0]},
        {"_id": "b", "body": "beta document", "tag": "x",
         "embedding": [0.9, 0.1, 0.0, 0.0]},
        {"_id": "c", "body": "gamma document", "tag": "y",
         "embedding": [0.0, 1.0, 0.0, 0.0]},
        {"_id": "d", "body": "delta document without vector", "tag": "y"},
    ]
    for doc in (docs if docs is not None else default_docs):
        writer.add_document(doc)
    writer.commit()
    return index


class TestVectorOnly:
    def test_cosine_ranking(self):
        index = make_vector_index()
        res = index.reader().search({
            "query": {"type": "vector", "field": "embedding",
                      "vector": [1.0, 0.0, 0.0, 0.0], "alpha": 0.0},
            "limit": 3})
        ids = [h.doc_id for h in res.hits]
        assert ids[0] == "a"
        assert ids[1] == "b"
        assert res.hits[0].score == pytest.approx(1.0, rel=1e-5)
        assert res.hits[0].vector_score is not None

    def test_l2_ranking(self):
        index = make_vector_index(metric="L2")
        res = index.reader().search({
            "query": {"type": "vector", "field": "embedding",
                      "vector": [0.9, 0.1, 0.0, 0.0], "alpha": 0.0},
            "limit": 3})
        assert [h.doc_id for h in res.hits][0] == "b"
        # L2 similarity is negated distance
        assert res.hits[0].score == pytest.approx(0.0, abs=1e-5)

    def test_missing_vector_doc_excluded(self):
        index = make_vector_index()
        res = index.reader().search({
            "query": {"type": "vector", "field": "embedding",
                      "vector": [1.0, 0.0, 0.0, 0.0], "alpha": 0.0},
            "limit": 10})
        assert "d" not in [h.doc_id for h in res.hits]

    def test_vector_filter(self):
        index = make_vector_index()
        res = index.reader().search({
            "query": {"type": "vector", "field": "embedding",
                      "vector": [1.0, 0.0, 0.0, 0.0], "alpha": 0.0},
            "limit": 10,
            "vector_filter": {"KeywordEq": {"field": "tag", "value": "y"}}})
        assert [h.doc_id for h in res.hits] == ["c"]

    def test_legacy_tuple_form(self):
        index = make_vector_index()
        res = index.reader().search({
            "query": "alpha",
            "vector_query": ["embedding", [1.0, 0.0, 0.0, 0.0], 0.5],
            "limit": 5})
        assert res.hits[0].doc_id == "a"

    def test_unknown_field_rejected(self):
        index = make_vector_index()
        with pytest.raises(QueryError):
            index.reader().search({
                "query": {"type": "vector", "field": "nope",
                          "vector": [1, 0, 0, 0]},
                "limit": 5})

    def test_wrong_dim_rejected(self):
        index = make_vector_index()
        with pytest.raises(QueryError):
            index.reader().search({
                "query": {"type": "vector", "field": "embedding",
                          "vector": [1, 0]},
                "limit": 5})

    def test_bad_alpha_rejected(self):
        index = make_vector_index()
        with pytest.raises(QueryError):
            index.reader().search({
                "query": {"type": "vector", "field": "embedding",
                          "vector": [1, 0, 0, 0], "alpha": 1.5},
                "limit": 5})


class TestHybrid:
    def test_blend(self):
        index = make_vector_index()
        reader = index.reader()
        text_only = reader.search({"query": "document", "limit": 5})
        hybrid = reader.search({
            "query": "document",
            "vector_query": {"field": "embedding",
                             "vector": [0.0, 1.0, 0.0, 0.0], "alpha": 0.5},
            "limit": 5})
        ids = [h.doc_id for h in hybrid.hits]
        assert "c" in ids and "a" in ids
        t = {h.doc_id: h.score for h in text_only.hits}
        hy = {h.doc_id: h.score for h in hybrid.hits}
        # blended: alpha*bm25 + (1-alpha)*cosine
        assert hy["c"] == pytest.approx(0.5 * t["c"] + 0.5 * 1.0, rel=1e-4)
        assert hy["a"] == pytest.approx(0.5 * t["a"] + 0.5 * 0.0, abs=1e-4)

    def test_hybrid_requires_text_match(self):
        """Vector candidates that don't match the text query are excluded
        (parity: collect_vector_maps require_text_match,
        `api/reader.rs:2387-2443`)."""
        index = make_vector_index()
        hybrid = index.reader().search({
            "query": "alpha",
            "vector_query": {"field": "embedding",
                             "vector": [0.0, 1.0, 0.0, 0.0], "alpha": 0.5},
            "limit": 5})
        assert [h.doc_id for h in hybrid.hits] == ["a"]

    def test_missing_vector_penalty(self):
        index = make_vector_index()
        res = index.reader().search({
            "query": "document",
            "vector_query": {"field": "embedding",
                             "vector": [1.0, 0.0, 0.0, 0.0], "alpha": 0.5},
            "limit": 10})
        scores = {h.doc_id: h.score for h in res.hits}
        # doc d matched the text but has no vector → cosine penalty -1
        assert "d" in scores
        assert scores["d"] < scores["a"]
        assert res.hits[-1].doc_id == "d" or scores["d"] <= min(
            v for k, v in scores.items() if k != "d")

    def test_alpha_one_is_text_only_scores(self):
        index = make_vector_index()
        reader = index.reader()
        text_only = reader.search({"query": "alpha", "limit": 5})
        hybrid = reader.search({
            "query": "alpha",
            "vector_query": {"field": "embedding",
                             "vector": [0.0, 1.0, 0.0, 0.0], "alpha": 1.0},
            "limit": 5})
        assert [h.doc_id for h in hybrid.hits] == \
            [h.doc_id for h in text_only.hits]
        for a, b in zip(hybrid.hits, text_only.hits):
            assert a.score == pytest.approx(b.score, rel=1e-5)

    def test_bool_with_vector_clause(self):
        index = make_vector_index()
        res = index.reader().search({
            "query": {"type": "bool",
                      "should": [
                          {"type": "term", "field": "body",
                           "value": "alpha"},
                          {"type": "vector", "field": "embedding",
                           "vector": [0.0, 1.0, 0.0, 0.0], "alpha": 0.0},
                      ]},
            "limit": 10})
        ids = [h.doc_id for h in res.hits]
        assert "c" in ids

    def test_multiple_vector_clauses_merge_candidates(self):
        """Two vector clauses over DIFFERENT vector fields merge their
        candidate sets (reference tests/vector_search.rs::
        multiple_vector_clauses_merge_candidates: doc-1 tops on vec_a,
        doc-2 matches both, doc-3 only vec_a's query direction)."""
        schema = Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": True, "indexed": True}],
            "vector_fields": [
                {"name": "vec_a", "dim": 2, "metric": "Cosine"},
                {"name": "vec_b", "dim": 2, "metric": "Cosine"},
            ],
        })
        index = Index.create(
            IndexOptions(path="", create_if_missing=True,
                         storage=StorageType.IN_MEMORY), schema)
        writer = index.writer()
        writer.add_document({"_id": "doc-1", "body": "first",
                             "vec_a": [1.0, 0.0], "vec_b": [0.0, 1.0]})
        writer.add_document({"_id": "doc-2", "body": "second",
                             "vec_a": [0.0, 1.0], "vec_b": [0.0, 1.0]})
        writer.add_document({"_id": "doc-3", "body": "third",
                             "vec_a": [0.0, 1.0], "vec_b": [1.0, 0.0]})
        writer.commit()
        res = index.reader().search({
            "query": {"type": "bool", "should": [
                {"type": "vector", "field": "vec_a",
                 "vector": [1.0, 0.0], "k": 3, "alpha": 0.0,
                 "candidate_size": 3, "boost": 1.0},
                {"type": "vector", "field": "vec_b",
                 "vector": [0.0, 1.0], "k": 3, "alpha": 0.0,
                 "candidate_size": 3, "boost": 1.0},
            ]},
            "limit": 3})
        assert [h.doc_id for h in res.hits] == ["doc-1", "doc-2", "doc-3"]

    def test_conflicting_vector_specs_rejected(self):
        index = make_vector_index()
        with pytest.raises(QueryError):
            index.reader().search({
                "query": {"type": "vector", "field": "embedding",
                          "vector": [1, 0, 0, 0]},
                "vector_query": {"field": "embedding",
                                 "vector": [1, 0, 0, 0]},
                "limit": 5})


class TestVectorMultiSegment:
    def test_results_across_segments(self):
        index = make_vector_index()
        writer = index.writer()
        writer.add_document({"_id": "e", "body": "epsilon",
                             "tag": "z",
                             "embedding": [0.95, 0.05, 0.0, 0.0]})
        writer.commit()
        res = index.reader().search({
            "query": {"type": "vector", "field": "embedding",
                      "vector": [1.0, 0.0, 0.0, 0.0], "alpha": 0.0},
            "limit": 3})
        assert [h.doc_id for h in res.hits][:2] == ["a", "e"]


class TestQuantization:
    def make_index(self, quantization, metric="Cosine", dim=8, n=40):
        rng = np.random.default_rng(3)
        schema = Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "vector_fields": [{"name": "embedding", "dim": dim,
                               "metric": metric,
                               "quantization": quantization}],
        })
        index = Index.create(
            IndexOptions(path="", create_if_missing=True,
                         storage=StorageType.IN_MEMORY), schema)
        writer = index.writer()
        vecs = rng.normal(size=(n, dim)).astype(np.float32)
        for i in range(n):
            writer.add_document({"_id": str(i), "body": "doc",
                                 "embedding": vecs[i].tolist()})
        writer.commit()
        return index, vecs

    @pytest.mark.parametrize("metric", ["Cosine", "L2"])
    @pytest.mark.parametrize("quant", ["bf16", "int8"])
    def test_quantized_recall(self, metric, quant):
        index, vecs = self.make_index(quant, metric=metric)
        exact, _ = self.make_index(None, metric=metric)
        q = vecs[7] + 0.01
        req = {"query": {"type": "vector", "field": "embedding",
                         "vector": q.tolist(), "alpha": 0.0},
               "limit": 10}
        got = [h.doc_id for h in index.reader().search(req).hits]
        want = [h.doc_id for h in exact.reader().search(req).hits]
        # approximate: require >= 8/10 overlap and the true top-1
        assert got[0] == want[0]
        assert len(set(got) & set(want)) >= 8

    def test_int8_matches_numpy_quantized_oracle(self):
        from searchlite.ops.vector import quantize_int8, vector_topk
        from searchlite.index.segment import VectorData

        rng = np.random.default_rng(5)
        vecs = rng.normal(size=(30, 8)).astype(np.float32)
        vdata = VectorData(dim=8, metric="cosine", vectors=vecs,
                           present=np.ones(30, dtype=bool))
        query = rng.normal(size=(1, 8)).astype(np.float32)
        scores, ids = vector_topk(vdata, np.ones(30, dtype=bool), query,
                                  5, "cosine", quantization="int8")
        qv, vs = quantize_int8(vecs)
        qq, qs = quantize_int8(query)
        sims = (qq.astype(np.int32) @ qv.astype(np.int32).T
                ).astype(np.float32) * (qs[:, None] * vs[None, :])
        order = np.argsort(-sims[0], kind="stable")[:5]
        np.testing.assert_array_equal(ids[0], order)
        np.testing.assert_allclose(scores[0], sims[0][order], rtol=1e-6)

    def test_bad_quantization_rejected(self):
        from searchlite.errors import SchemaError
        with pytest.raises(SchemaError):
            Schema.from_json({"vector_fields": [
                {"name": "v", "dim": 4, "quantization": "fp4"}]})

    def test_quantization_roundtrips_in_manifest(self):
        schema = Schema.from_json({"vector_fields": [
            {"name": "v", "dim": 4, "quantization": "INT8"}]})
        out = schema.to_json()
        assert out["vector_fields"][0]["quantization"] == "int8"
