"""Reader behavioral details: expansion caps, pattern normalization,
profile/explain shapes, candidate_size (parity: reader unit tests,
`api/reader.rs:3989-4542`)."""

import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.errors import QueryError
from searchlite.index import Index
from searchlite.index.manifest import Schema


def make_index(docs):
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": True, "indexed": True}],
            "keyword_fields": [{"name": "tag", "stored": True,
                                "indexed": True, "fast": True}],
        }))
    writer = index.writer()
    writer.add_documents(docs)
    writer.commit()
    return index


class TestExpansionCaps:
    def docs(self):
        return [{"_id": str(i), "body": f"prefix{i:03d} other", "tag": "a"}
                for i in range(20)]

    def test_prefix_max_expansions_caps_matches(self):
        index = make_index(self.docs())
        res = index.reader().search({
            "query": {"type": "prefix", "field": "body", "value": "prefix",
                      "max_expansions": 5},
            "limit": 50})
        assert res.total_hits_estimate == 5

    def test_prefix_default_expansions(self):
        index = make_index(self.docs())
        res = index.reader().search({
            "query": {"type": "prefix", "field": "body", "value": "prefix"},
            "limit": 50})
        assert res.total_hits_estimate == 20  # under the default 50 cap

    def test_wildcard_zero_expansions_matches_nothing(self):
        index = make_index(self.docs())
        res = index.reader().search({
            "query": {"type": "wildcard", "field": "body",
                      "value": "prefix*", "max_expansions": 0},
            "limit": 10})
        assert res.total_hits_estimate == 0

    def test_wildcard_pattern_lowercased(self):
        # uppercase pattern with an inner wildcard: the analyzer splits
        # it, so the reference falls back to normalize_pattern
        # (lowercase, structure preserved) — `api/reader.rs:1093-1107`
        index = make_index(self.docs())
        res = index.reader().search({
            "query": {"type": "wildcard", "field": "body",
                      "value": "PREFIX0?0"},
            "limit": 50})
        assert res.total_hits_estimate == 2  # prefix000, prefix010

    def test_fuzzy_min_length_skips_short_terms(self):
        index = make_index([{"_id": "1", "body": "cat dog", "tag": "a"}])
        res = index.reader().search({
            "query": "cot", "limit": 10,
            "fuzzy": {"max_edits": 1, "prefix_length": 0, "min_length": 5}})
        # "cot" is shorter than min_length → exact only → no match
        assert res.total_hits_estimate == 0

    def test_fuzzy_prefix_length_locks_prefix(self):
        index = make_index([{"_id": "1", "body": "systems", "tag": "a"}])
        res = index.reader().search({
            "query": "zystems", "limit": 10,
            "fuzzy": {"max_edits": 1, "prefix_length": 1}})
        # first char differs but the prefix is locked → no expansion
        assert res.total_hits_estimate == 0


class TestRequestKnobs:
    def test_candidate_size_bounds_results(self):
        docs = [{"_id": str(i), "body": "match " * (1 + i % 5), "tag": "a"}
                for i in range(100)]
        index = make_index(docs)
        res = index.reader().search({
            "query": "match", "limit": 10, "candidate_size": 15})
        assert len(res.hits) == 10
        assert res.total_hits_estimate == 100

    def test_profile_shape(self):
        index = make_index([{"_id": "1", "body": "hello", "tag": "a"}])
        res = index.reader().search({
            "query": "hello", "limit": 5, "profile": True,
            "rescore": {"window_size": 5,
                        "query": {"type": "term", "field": "body",
                                  "value": "hello"}}})
        prof = res.profile
        assert set(prof) == {"execution", "rescore", "timings"}
        assert set(prof["execution"]) == {"scored_docs",
                                          "candidates_examined",
                                          "postings_advanced",
                                          "pruning_simulated"}
        # 1-doc segment is below the pruning floor → counterfactual
        assert prof["execution"]["pruning_simulated"] is True
        assert "search_ms" in prof["timings"]
        assert "rescore_ms" in prof["timings"]

    def test_explain_function_breakdown(self):
        index = make_index([{"_id": "1", "body": "hello", "tag": "a"}])
        res = index.reader().search({
            "query": {"type": "function_score",
                      "query": {"type": "term", "field": "body",
                                "value": "hello"},
                      "functions": [{"type": "weight", "weight": 2.0}]},
            "limit": 5, "explain": True})
        expl = res.hits[0].explanation
        assert expl["final_score"] == res.hits[0].score
        assert any(f["type"] == "weight" and f["value"] == 2.0
                   for f in expl["functions"])

    def test_explain_respects_matcher_gating(self):
        """A function_score node whose MATCHER doesn't match the hit
        contributes no function explanations — gating is the matcher
        tree, not just per-function filters."""
        index = make_index([
            {"_id": "1", "body": "hello world", "tag": "a"},
            {"_id": "2", "body": "hello there", "tag": "a"},
        ])
        # sum of: plain term(hello) + function_score gated on
        # term(world) — doc 2 never matches the function_score branch
        res = index.reader().search({
            "query": {"type": "bool", "should": [
                {"type": "term", "field": "body", "value": "hello"},
                {"type": "function_score",
                 "query": {"type": "term", "field": "body",
                           "value": "world"},
                 "functions": [{"type": "weight", "weight": 5.0}]},
            ]},
            "limit": 5, "explain": True})
        by_id = {h.doc_id: h for h in res.hits}
        assert set(by_id) == {"1", "2"}
        fns_1 = by_id["1"].explanation["functions"]
        fns_2 = by_id["2"].explanation["functions"]
        assert any(f["type"] == "weight" and f["value"] == 5.0
                   for f in fns_1)
        assert fns_2 == []  # matcher-gated: no contribution for doc 2

    def test_compiled_plan_cache_survives_commits(self):
        from searchlite.api import reader as reader_mod

        index = make_index([{"_id": "1", "body": "hello", "tag": "a"}])
        index.reader().search({"query": "hello world", "limit": 5})
        before = len(reader_mod._GLOBAL_COMPILED)
        writer = index.writer()
        writer.add_document({"_id": "2", "body": "hello again", "tag": "b"})
        writer.commit()
        res = index.reader().search({"query": "hello world", "limit": 5})
        assert res.total_hits_estimate == 2
        # same plan structure + schema → no new compiled entry
        assert len(reader_mod._GLOBAL_COMPILED) == before

    def test_unknown_execution_strategy_rejected(self):
        index = make_index([{"_id": "1", "body": "x", "tag": "a"}])
        with pytest.raises(QueryError):
            index.reader().search({"query": "x", "limit": 1,
                                   "execution": "warp"})


def test_segment_upload_cache_shared_across_readers():
    """Immutable segments are uploaded once: reopening a reader after an
    add-only commit reuses the old segment's objects; merging a
    tombstone into a segment invalidates just that segment."""
    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({"text_fields": [
            {"name": "body", "analyzer": "default", "stored": True,
             "indexed": True}]}))
    w = index.writer()
    w.add_document({"_id": "1", "body": "first segment doc"})
    w.commit()
    r1 = index.reader()

    w2 = index.writer()
    w2.add_document({"_id": "2", "body": "second segment doc"})
    w2.commit()
    r2 = index.reader()
    assert r2.device_segments[0] is r1.device_segments[0]
    assert r2.segments[0] is r1.segments[0]
    assert len(r2.segments) == 2

    # tombstone merged into segment 1 -> that segment rebuilds
    w3 = index.writer()
    w3.delete_document("1")
    w3.commit()
    r3 = index.reader()
    assert r3.device_segments[0] is not r2.device_segments[0]
    assert r3.device_segments[1] is r2.device_segments[1]
    res = r3.search({"query": "doc", "limit": 10})
    assert [h.doc_id for h in res.hits] == ["2"]
