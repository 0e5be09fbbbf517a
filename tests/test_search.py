"""End-to-end search tests.

Mirrors the reference's integration coverage (`searchlite-core/tests/`:
smoke.rs, pruning.rs, sorting.rs, query_ast.rs, multi_field.rs,
function_score.rs, prefix_and_suggest.rs).
"""

import math
import random

import numpy as np
import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.errors import CursorError, QueryError
from searchlite.index import Index
from searchlite.index.manifest import Schema
from searchlite.models.bm25 import bm25


def mem_options(**kw):
    return IndexOptions(path="", create_if_missing=True,
                        storage=StorageType.IN_MEMORY, **kw)


def make_index(schema_json=None, docs=(), commits_per_doc=False, **opts):
    schema = Schema.from_json(schema_json or {
        "text_fields": [
            {"name": "title", "analyzer": "default", "stored": True,
             "indexed": True},
            {"name": "body", "analyzer": "default", "stored": True,
             "indexed": True},
        ],
        "keyword_fields": [
            {"name": "tag", "stored": True, "indexed": True, "fast": True}],
        "numeric_fields": [
            {"name": "year", "i64": True, "fast": True, "stored": True},
            {"name": "rating", "i64": False, "fast": True, "stored": True},
        ],
    })
    index = Index.create(mem_options(**opts), schema)
    writer = index.writer()
    for doc in docs:
        writer.add_document(doc)
        if commits_per_doc:
            writer.commit()
    if not commits_per_doc:
        writer.commit()
    return index


DOCS = [
    {"_id": "1", "title": "Rust systems language",
     "body": "memory safe systems programming with zero cost",
     "tag": "lang", "year": 2015, "rating": 4.8},
    {"_id": "2", "title": "Python scripting",
     "body": "dynamic scripting language that is fun and productive",
     "tag": "lang", "year": 1991, "rating": 4.5},
    {"_id": "3", "title": "Cooking systems",
     "body": "fun recipes and flavor systems for weeknight dinner",
     "tag": "food", "year": 2020, "rating": 4.1},
    {"_id": "4", "title": "Go concurrency",
     "body": "goroutines channels and simple concurrent systems",
     "tag": ["lang", "google"], "year": 2009, "rating": 4.0},
]


class TestBasicSearch:
    def test_ranking_and_total(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({"query": "systems", "limit": 10})
        assert res.total_hits_estimate == 3
        # doc 3 has the shortest title containing "systems" (length norm)
        assert [h.doc_id for h in res.hits] == ["3", "1", "4"]
        scores = [h.score for h in res.hits]
        assert scores == sorted(scores, reverse=True)

    def test_score_matches_scalar_oracle(self):
        """Device-computed scores equal the scalar BM25 oracle."""
        index = make_index(docs=DOCS)
        reader = index.reader()
        res = reader.search({"query": "systems", "limit": 10,
                             "fields": ["body"]})
        seg = reader.segments[0]
        docs, tfs = seg.postings_for("body:systems")
        n = float(seg.doc_count)
        df = float(len(docs))
        avgdl = seg.avg_field_length("body")
        expected = {}
        for doc, tf in zip(docs.tolist(), tfs.tolist()):
            dl = seg.fast.doc_length("body", doc)
            expected[seg.doc_id(doc)] = bm25(
                tf, df, dl, avgdl, n, 0.9, 0.4)
        for h in res.hits:
            assert h.score == pytest.approx(expected[h.doc_id], rel=1e-5)

    def test_multi_field_sums(self):
        index = make_index(docs=DOCS)
        res_both = index.reader().search({"query": "systems", "limit": 10})
        res_body = index.reader().search(
            {"query": "systems", "limit": 10, "fields": ["body"]})
        both = {h.doc_id: h.score for h in res_both.hits}
        body = {h.doc_id: h.score for h in res_body.hits}
        # doc 1 has "systems" in both title and body: summed leaf score
        assert both["1"] > body["1"]

    def test_field_qualified_term(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({"query": "title:cooking", "limit": 10})
        assert [h.doc_id for h in res.hits] == ["3"]

    def test_negated_term(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({"query": "systems -cooking",
                                     "limit": 10})
        assert "3" not in [h.doc_id for h in res.hits]

    def test_keyword_search_case_insensitive_query(self):
        index = make_index(docs=DOCS)
        res = index.reader().search(
            {"query": {"type": "term", "field": "tag", "value": "LANG"},
             "limit": 10})
        assert sorted(h.doc_id for h in res.hits) == ["1", "2", "4"]

    def test_return_stored_and_snippet(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": "recipes", "limit": 10, "return_stored": True,
            "highlight_field": "body"})
        assert res.hits[0].fields["title"] == "Cooking systems"
        assert "**recipes**" in res.hits[0].snippet

    def test_limit_zero_rejected(self):
        index = make_index(docs=DOCS)
        with pytest.raises(QueryError):
            index.reader().search({"query": "x", "limit": 0})

    def test_match_all(self):
        index = make_index(docs=DOCS)
        res = index.reader().search(
            {"query": {"type": "match_all"}, "limit": 10})
        assert res.total_hits_estimate == 4

    def test_empty_query_matches_nothing(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({"query": "zzzzz", "limit": 10})
        assert res.total_hits_estimate == 0
        assert res.hits == []


class TestStrategies:
    def test_execution_strategies_agree(self):
        """Port of the reference's pruning exactness oracle
        (`tests/pruning.rs:44-105`)."""
        rng = random.Random(42)
        vocab = [f"w{i}" for i in range(50)]
        docs = []
        for i in range(200):
            words = rng.choices(vocab, k=rng.randint(3, 30))
            docs.append({"_id": str(i), "title": "t", "body": " ".join(words),
                         "tag": "a", "year": i, "rating": 1.0})
        index = make_index(docs=docs)
        reader = index.reader()
        for _ in range(25):
            terms = rng.sample(vocab, k=rng.randint(1, 4))
            query = " ".join(terms)
            results = {}
            for strategy in ("bm25", "wand", "bmw"):
                res = reader.search({"query": query, "limit": 10,
                                     "execution": strategy})
                results[strategy] = [(h.doc_id, round(h.score, 5))
                                     for h in res.hits]
            assert results["bm25"] == results["wand"] == results["bmw"], \
                f"strategy mismatch for query {query!r}"

    def test_pruning_telemetry(self):
        """wand/bmw report the postings a block-max pruned traversal
        would advance — never more than the dense oracle's count, with
        identical results."""
        rng = random.Random(7)
        docs = []
        for i in range(2000):
            words = ["common"] * 3 + rng.choices(
                [f"w{j}" for j in range(40)], k=20)
            if i % 200 == 0:
                words += ["rare"] * 5
            docs.append({"_id": str(i), "title": "t",
                         "body": " ".join(words), "tag": "a",
                         "year": i, "rating": 1.0})
        index = make_index(docs=docs)
        reader = index.reader()
        counters = {}
        results = {}
        for strategy in ("bm25", "wand", "bmw"):
            res = reader.search({"query": "rare common w1", "limit": 5,
                                 "execution": strategy, "profile": True})
            counters[strategy] = res.profile["execution"][
                "postings_advanced"]
            results[strategy] = [(h.doc_id, round(h.score, 5))
                                 for h in res.hits]
        assert results["bm25"] == results["wand"] == results["bmw"]
        assert counters["wand"] <= counters["bm25"]
        assert counters["bmw"] <= counters["wand"]

    def test_tie_break_by_doc_order(self):
        docs = [{"_id": str(i), "title": "same", "body": "same words here",
                 "tag": "a", "year": i, "rating": 1.0} for i in range(5)]
        index = make_index(docs=docs)
        res = index.reader().search({"query": "same", "limit": 5})
        assert [h.doc_id for h in res.hits] == ["0", "1", "2", "3", "4"]


class TestFilters:
    def test_keyword_filter(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": "systems", "limit": 10,
            "filter": {"KeywordEq": {"field": "tag", "value": "food"}}})
        assert [h.doc_id for h in res.hits] == ["3"]

    def test_keyword_in(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "match_all"}, "limit": 10,
            "filter": {"KeywordIn": {"field": "tag",
                                     "values": ["food", "google"]}}})
        assert sorted(h.doc_id for h in res.hits) == ["3", "4"]

    def test_i64_range(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "match_all"}, "limit": 10,
            "filter": {"I64Range": {"field": "year", "min": 2000,
                                    "max": 2016}}})
        assert sorted(h.doc_id for h in res.hits) == ["1", "4"]

    def test_f64_range(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "match_all"}, "limit": 10,
            "filter": {"F64Range": {"field": "rating", "min": 4.4,
                                    "max": 5.0}}})
        assert sorted(h.doc_id for h in res.hits) == ["1", "2"]

    def test_and_or_not(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "match_all"}, "limit": 10,
            "filter": {"And": [
                {"KeywordEq": {"field": "tag", "value": "lang"}},
                {"Not": {"I64Range": {"field": "year", "min": 2010,
                                      "max": 2030}}},
            ]}})
        assert sorted(h.doc_id for h in res.hits) == ["2", "4"]


class TestNestedFilters:
    def schema(self):
        return {
            "text_fields": [{"name": "name", "analyzer": "default",
                             "stored": True, "indexed": True}],
            "nested_fields": [{
                "name": "cast",
                "fields": [
                    {"type": "keyword", "name": "role", "stored": True,
                     "indexed": False, "fast": True},
                    {"type": "numeric", "name": "age", "i64": True,
                     "fast": True, "stored": True},
                ],
            }],
        }

    def docs(self):
        return [
            {"_id": "m1", "name": "movie one", "cast": [
                {"role": "hero", "age": 30}, {"role": "villain", "age": 50}]},
            {"_id": "m2", "name": "movie two", "cast": [
                {"role": "hero", "age": 50}, {"role": "villain", "age": 30}]},
        ]

    def test_same_object_semantics(self):
        index = make_index(self.schema(), self.docs())
        # hero AND age 50 within the SAME cast object → only m2
        res = index.reader().search({
            "query": {"type": "match_all"}, "limit": 10,
            "filter": {"And": [
                {"Nested": {"path": "cast", "filter": {
                    "KeywordEq": {"field": "role", "value": "hero"}}}},
                {"Nested": {"path": "cast", "filter": {
                    "I64Range": {"field": "age", "min": 50, "max": 50}}}},
            ]}})
        assert [h.doc_id for h in res.hits] == ["m2"]

    def test_nested_or_matches_any_object(self):
        index = make_index(self.schema(), self.docs())
        res = index.reader().search({
            "query": {"type": "match_all"}, "limit": 10,
            "filter": {"Nested": {"path": "cast", "filter": {
                "KeywordEq": {"field": "role", "value": "villain"}}}}})
        assert sorted(h.doc_id for h in res.hits) == ["m1", "m2"]


class TestSortingAndCursors:
    def test_sort_by_numeric_asc(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "match_all"}, "limit": 10,
            "sort": [{"field": "year", "order": "asc"}]})
        assert [h.doc_id for h in res.hits] == ["2", "4", "1", "3"]

    def test_sort_by_keyword_desc(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "match_all"}, "limit": 10,
            "sort": [{"field": "tag", "order": "desc"}]})
        # multi-valued picks max for desc: doc4 has [lang, google] → lang
        assert res.hits[0].doc_id in ("1", "2", "4")

    def test_missing_sorts_last(self):
        docs = list(DOCS) + [{"_id": "5", "title": "No year",
                              "body": "missing year", "tag": "x"}]
        index = make_index(docs=docs)
        res = index.reader().search({
            "query": {"type": "match_all"}, "limit": 10,
            "sort": [{"field": "year", "order": "asc"}]})
        assert res.hits[-1].doc_id == "5"
        res_desc = index.reader().search({
            "query": {"type": "match_all"}, "limit": 10,
            "sort": [{"field": "year", "order": "desc"}]})
        assert res_desc.hits[-1].doc_id == "5"

    def test_sort_field_requires_fast(self):
        index = make_index(docs=DOCS)
        with pytest.raises(QueryError):
            index.reader().search({
                "query": {"type": "match_all"}, "limit": 10,
                "sort": [{"field": "title"}]})

    def test_cursor_pagination_drains_score_order(self):
        docs = [{"_id": str(i), "title": "t",
                 "body": " ".join(["match"] * (1 + i % 7)),
                 "tag": "a", "year": i, "rating": 1.0} for i in range(55)]
        index = make_index(docs=docs)
        reader = index.reader()
        seen = []
        cursor = None
        pages = 0
        while True:
            req = {"query": "match", "limit": 10}
            if cursor:
                req["cursor"] = cursor
            res = reader.search(req)
            seen.extend(h.doc_id for h in res.hits)
            pages += 1
            cursor = res.next_cursor
            if cursor is None:
                break
            assert pages < 20
        assert len(seen) == 55
        assert len(set(seen)) == 55
        # compare against one big page
        full = reader.search({"query": "match", "limit": 100})
        assert seen == [h.doc_id for h in full.hits]

    def test_cursor_pagination_sorted_field(self):
        docs = [{"_id": str(i), "title": "t", "body": "match",
                 "tag": "a", "year": 100 - i, "rating": 1.0}
                for i in range(25)]
        index = make_index(docs=docs)
        reader = index.reader()
        seen = []
        cursor = None
        while True:
            req = {"query": "match", "limit": 7,
                   "sort": [{"field": "year", "order": "asc"}]}
            if cursor:
                req["cursor"] = cursor
            res = reader.search(req)
            seen.extend(h.doc_id for h in res.hits)
            cursor = res.next_cursor
            if cursor is None:
                break
        assert seen == [str(i) for i in reversed(range(25))]

    def test_multi_field_sort_cursor_pagination(self):
        """Mixed-type multi-field sort (keyword asc, numeric desc) with
        cursor pagination must drain every doc exactly once in order."""
        docs = []
        for i in range(60):
            docs.append({"_id": str(i), "title": "t", "body": "match",
                         "tag": f"g{i % 4}", "year": i % 7,
                         "rating": 1.0})
        # some docs missing the sort fields → must sort last
        docs.append({"_id": "nx", "title": "t", "body": "match"})
        index = make_index(docs=docs)
        reader = index.reader()
        sort = [{"field": "tag", "order": "asc"},
                {"field": "year", "order": "desc"}]
        full = reader.search({"query": "match", "limit": 100,
                              "sort": sort})
        expected = [h.doc_id for h in full.hits]
        assert expected[-1] == "nx"
        seen = []
        cursor = None
        while True:
            req = {"query": "match", "limit": 7, "sort": sort}
            if cursor:
                req["cursor"] = cursor
            res = reader.search(req)
            seen.extend(h.doc_id for h in res.hits)
            cursor = res.next_cursor
            if cursor is None:
                break
        assert seen == expected

    def test_cursor_stability_across_segments(self):
        docs = [{"_id": str(i), "title": "t", "body": "match word",
                 "tag": "a", "year": i, "rating": 1.0} for i in range(12)]
        index = make_index(docs=docs, commits_per_doc=True)
        reader = index.reader()
        assert len(reader.segments) == 12
        seen = []
        cursor = None
        while True:
            req = {"query": "match", "limit": 5}
            if cursor:
                req["cursor"] = cursor
            res = reader.search(req)
            seen.extend(h.doc_id for h in res.hits)
            cursor = res.next_cursor
            if cursor is None:
                break
        assert sorted(seen, key=int) == [str(i) for i in range(12)]
        assert len(set(seen)) == 12

    def test_tampered_cursor_rejected(self):
        index = make_index(docs=DOCS)
        reader = index.reader()
        res = reader.search({"query": "systems", "limit": 1})
        cursor = res.next_cursor
        assert cursor is not None
        with pytest.raises(CursorError):
            reader.search({"query": "systems", "limit": 1,
                           "cursor": cursor[:-4] + "beef"})

    def test_cursor_sort_mismatch_rejected(self):
        index = make_index(docs=DOCS)
        reader = index.reader()
        res = reader.search({"query": "systems", "limit": 1})
        with pytest.raises(CursorError):
            reader.search({"query": "systems", "limit": 1,
                           "cursor": res.next_cursor,
                           "sort": [{"field": "year"}]})

    def test_stale_cursor_rejected_after_commit(self):
        index = make_index(docs=DOCS)
        reader = index.reader()
        res = reader.search({"query": "systems", "limit": 1})
        writer = index.writer()
        writer.add_document({"_id": "9", "title": "new", "body": "systems",
                             "tag": "a", "year": 1, "rating": 1.0})
        writer.commit()
        reader2 = index.reader()
        with pytest.raises(CursorError):
            reader2.search({"query": "systems", "limit": 1,
                            "cursor": res.next_cursor})


class TestQueryAst:
    def test_multi_match_best_fields(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "multi_match", "query": "systems",
                      "fields": [{"field": "title", "boost": 2.0}, "body"]},
            "limit": 10})
        assert res.hits[0].doc_id in ("1", "3")

    def test_multi_match_operator_and(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "multi_match", "query": "fun recipes",
                      "fields": ["body"], "operator": "and"},
            "limit": 10})
        assert [h.doc_id for h in res.hits] == ["3"]

    def test_multi_match_cross_fields_operator_and(self):
        """cross_fields + operator=and: each term must appear in SOME
        queried field, not necessarily the same one (reference
        tests/multi_field.rs::cross_fields_operator_and_matches_split_terms)."""
        index = make_index(docs=[
            {"_id": "1", "title": "rust search", "body": "fast",
             "tag": "a", "year": 1, "rating": 1.0},
            {"_id": "2", "title": "rust", "body": "search",
             "tag": "a", "year": 1, "rating": 1.0},
            {"_id": "4", "title": "boring", "body": "rust",
             "tag": "a", "year": 1, "rating": 1.0},
        ])
        res = index.reader().search({
            "query": {"type": "multi_match", "query": "rust search",
                      "fields": ["title", "body"],
                      "match_type": "cross_fields", "operator": "and"},
            "limit": 10})
        hit_ids = {h.doc_id for h in res.hits}
        assert "2" in hit_ids      # terms split across fields
        assert "4" not in hit_ids  # "search" appears nowhere

    def test_multi_match_minimum_should_match_percentage(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "multi_match",
                      "query": "fun recipes zebra",
                      "fields": ["body"],
                      "minimum_should_match": "66%"},
            "limit": 10})
        assert [h.doc_id for h in res.hits] == ["3"]

    def test_dis_max(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "dis_max", "queries": [
                {"type": "term", "field": "body", "value": "recipes"},
                {"type": "term", "field": "body", "value": "goroutines"},
            ]},
            "limit": 10})
        assert sorted(h.doc_id for h in res.hits) == ["3", "4"]

    def test_prefix(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "prefix", "field": "body", "value": "gorou"},
            "limit": 10})
        assert [h.doc_id for h in res.hits] == ["4"]

    def test_wildcard(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "wildcard", "field": "body",
                      "value": "s*stems"},
            "limit": 10})
        assert sorted(h.doc_id for h in res.hits) == ["1", "3", "4"]

    def test_regex(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "regex", "field": "body",
                      "value": "recip[aeiou]s"},
            "limit": 10})
        assert [h.doc_id for h in res.hits] == ["3"]

    def test_phrase_with_slop(self):
        index = make_index(docs=DOCS)
        no_slop = index.reader().search({
            "query": {"type": "phrase", "field": "body",
                      "terms": ["memory", "systems"]},
            "limit": 10})
        assert no_slop.hits == []
        with_slop = index.reader().search({
            "query": {"type": "phrase", "field": "body",
                      "terms": ["memory", "systems"], "slop": 1},
            "limit": 10})
        assert [h.doc_id for h in with_slop.hits] == ["1"]

    def test_bool_minimum_should_match(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "bool", "should": [
                {"type": "term", "field": "body", "value": "fun"},
                {"type": "term", "field": "body", "value": "systems"},
            ], "minimum_should_match": 2},
            "limit": 10})
        assert [h.doc_id for h in res.hits] == ["3"]

    def test_bool_filter_clause(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "bool",
                      "must": [{"type": "term", "field": "body",
                                "value": "systems"}],
                      "filter": [{"KeywordEq": {"field": "tag",
                                                "value": "lang"}}]},
            "limit": 10})
        assert sorted(h.doc_id for h in res.hits) == ["1", "4"]

    def test_constant_score(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "constant_score",
                      "filter": {"KeywordEq": {"field": "tag",
                                               "value": "food"}},
                      "boost": 3.5},
            "limit": 10})
        assert [h.doc_id for h in res.hits] == ["3"]
        assert res.hits[0].score == pytest.approx(3.5)

    def test_fuzzy(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": "sistems", "limit": 10,
            "fuzzy": {"max_edits": 1, "prefix_length": 0}})
        assert sorted(h.doc_id for h in res.hits) == ["1", "3", "4"]

    def test_fuzzy_distance_weighting(self):
        index = make_index(docs=DOCS)
        exact = index.reader().search({"query": "systems", "limit": 10,
                                       "fields": ["body"]})
        fuzzy = index.reader().search({
            "query": "sistems", "limit": 10, "fields": ["body"],
            "fuzzy": {"max_edits": 1, "prefix_length": 0}})
        e = {h.doc_id: h.score for h in exact.hits}
        f = {h.doc_id: h.score for h in fuzzy.hits}
        for doc_id in f:
            assert f[doc_id] == pytest.approx(e[doc_id] * 0.5, rel=1e-5)

    def test_boost_zero_matches_without_scoring(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "term", "field": "body", "value": "recipes",
                      "boost": 0.0},
            "limit": 10})
        assert [h.doc_id for h in res.hits] == ["3"]
        assert res.hits[0].score == pytest.approx(0.0)

    def test_negative_boost_rejected(self):
        index = make_index(docs=DOCS)
        with pytest.raises(QueryError):
            index.reader().search({
                "query": {"type": "term", "field": "body", "value": "x",
                          "boost": -1.0},
                "limit": 10})


class TestCustomScoring:
    def test_function_score_weight(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "function_score",
                      "query": {"type": "term", "field": "body",
                                "value": "recipes"},
                      "functions": [{"type": "weight", "weight": 2.0}]},
            "limit": 10})
        base = index.reader().search({
            "query": {"type": "term", "field": "body", "value": "recipes"},
            "limit": 10})
        assert res.hits[0].score == pytest.approx(
            base.hits[0].score * 2.0, rel=1e-5)

    def test_function_score_field_value_factor(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "function_score",
                      "query": {"type": "match_all"},
                      "functions": [{"type": "field_value_factor",
                                     "field": "year", "factor": 1.0}],
                      "boost_mode": "replace"},
            "limit": 10})
        assert [h.doc_id for h in res.hits] == ["3", "1", "4", "2"]
        assert res.hits[0].score == pytest.approx(2020.0)

    def test_function_score_filtered_weight(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "function_score",
                      "query": {"type": "match_all"},
                      "functions": [
                          {"type": "weight", "weight": 5.0,
                           "filter": {"KeywordEq": {"field": "tag",
                                                    "value": "food"}}}],
                      "boost_mode": "replace"},
            "limit": 10})
        by_id = {h.doc_id: h.score for h in res.hits}
        assert by_id["3"] == pytest.approx(5.0)

    def test_function_score_decay(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "function_score",
                      "query": {"type": "match_all"},
                      "functions": [{"type": "decay", "field": "year",
                                     "origin": 2020, "scale": 10}],
                      "boost_mode": "replace"},
            "limit": 10})
        by_id = {h.doc_id: h.score for h in res.hits}
        assert by_id["3"] == pytest.approx(1.0)
        assert by_id["1"] == pytest.approx(0.5 ** 0.5, rel=1e-4)

    def test_function_score_min_score_drops(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "function_score",
                      "query": {"type": "match_all"},
                      "functions": [{"type": "field_value_factor",
                                     "field": "year", "factor": 1.0}],
                      "boost_mode": "replace", "min_score": 2010.0},
            "limit": 10})
        assert sorted(h.doc_id for h in res.hits) == ["1", "3"]

    def test_min_score_branch_does_not_drop_other_clauses(self):
        """A function_score with min_score inside a `should` only gates
        its own branch; docs matching a sibling clause survive
        (reference tests/function_score.rs::
        min_score_branch_does_not_drop_other_clauses)."""
        index = make_index(docs=[
            {"_id": "doc-1", "title": "t", "body": "rust fast",
             "tag": "a", "year": 1, "rating": 1.0},
            {"_id": "doc-2", "title": "t", "body": "rust slow",
             "tag": "a", "year": 1, "rating": 1.0},
        ])
        res = index.reader().search({
            "query": {"type": "bool", "should": [
                {"type": "term", "field": "body", "value": "fast"},
                {"type": "function_score", "query": {"type": "match_all"},
                 "functions": [{"type": "weight", "weight": 1.0}],
                 "score_mode": "sum", "boost_mode": "multiply",
                 "min_score": 10.0},
            ], "minimum_should_match": 1},
            "limit": 10})
        assert [h.doc_id for h in res.hits] == ["doc-1"]
        assert res.hits[0].score > 0.0

    def test_rank_feature(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "rank_feature", "field": "rating",
                      "modifier": "log1p"},
            "limit": 10})
        assert res.hits[0].doc_id == "1"
        assert res.hits[0].score == pytest.approx(math.log1p(4.8), rel=1e-5)

    def test_script_score(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "script_score",
                      "query": {"type": "term", "field": "body",
                                "value": "systems"},
                      "script": "_score * 0 + year / 1000",
                      "params": {}},
            "limit": 10})
        by_id = {h.doc_id: h.score for h in res.hits}
        assert by_id["3"] == pytest.approx(2.020, rel=1e-4)

    def test_script_score_div_zero_drops(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "script_score",
                      "query": {"type": "match_all"},
                      "script": "1 / (year - 2020)"},
            "limit": 10})
        assert "3" not in [h.doc_id for h in res.hits]

    def test_explain(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({"query": "systems", "limit": 3,
                                     "explain": True})
        for h in res.hits:
            assert h.explanation is not None
            assert h.explanation["final_score"] == h.score


class TestHighlightCollapseRescore:
    def test_highlight_fields(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": "systems", "limit": 10,
            "highlight": {"fields": {"body": {}}}})
        top = res.hits[0]
        assert top.highlights is not None
        assert any("<em>systems</em>" in f for f in top.highlights["body"])

    def test_collapse(self):
        docs = [{"_id": str(i), "title": "t", "body": "match",
                 "tag": "g" + str(i % 3), "year": i, "rating": 1.0}
                for i in range(9)]
        index = make_index(docs=docs)
        res = index.reader().search({
            "query": "match", "limit": 10, "collapse": {"field": "tag"}})
        assert res.total_groups == 3
        assert len(res.hits) == 3

    def test_collapse_rejects_multi_valued_field(self):
        index = make_index(docs=DOCS)  # doc 4 has tag list
        with pytest.raises(QueryError):
            index.reader().search({
                "query": "systems", "limit": 10,
                "collapse": {"field": "tag"}})

    def test_collapse_with_inner_hits(self):
        docs = [{"_id": str(i), "title": "t", "body": "match",
                 "tag": "g" + str(i % 2), "year": i, "rating": 1.0}
                for i in range(6)]
        index = make_index(docs=docs)
        res = index.reader().search({
            "query": "match", "limit": 10,
            "collapse": {"field": "tag",
                         "inner_hits": {"size": 2}}})
        assert len(res.hits) == 2
        for h in res.hits:
            assert h.inner_hits is not None
            assert len(h.inner_hits) == 2

    def test_highlight_multiple_fragments(self):
        docs = [{"_id": "1", "title": "t", "tag": "a", "year": 1,
                 "rating": 1.0,
                 "body": ("alpha start " + "filler word " * 30
                          + "alpha middle " + "filler word " * 30
                          + "alpha end")}]
        index = make_index(docs=docs)
        res = index.reader().search({
            "query": "alpha", "limit": 1,
            "highlight": {"fields": {"body": {
                "fragment_size": 40, "number_of_fragments": 3,
                "pre_tag": "[", "post_tag": "]"}}}})
        frags = res.hits[0].highlights["body"]
        assert len(frags) == 3
        assert all("[alpha]" in f for f in frags)

    def test_collapse_missing_value_groups_together(self):
        docs = [
            {"_id": "1", "title": "t", "body": "match", "tag": "g1",
             "year": 1, "rating": 1.0},
            {"_id": "2", "title": "t", "body": "match",
             "year": 2, "rating": 1.0},
            {"_id": "3", "title": "t", "body": "match",
             "year": 3, "rating": 1.0},
        ]
        index = make_index(docs=docs)
        res = index.reader().search({
            "query": "match", "limit": 10, "collapse": {"field": "tag"}})
        assert res.total_groups == 2  # g1 + the missing-value group

    def test_rescore_total(self):
        index = make_index(docs=DOCS)
        base = index.reader().search({"query": "systems", "limit": 10})
        res = index.reader().search({
            "query": "systems", "limit": 10,
            "rescore": {"window_size": 10,
                        "query": {"type": "term", "field": "body",
                                  "value": "recipes"}}})
        base_scores = {h.doc_id: h.score for h in base.hits}
        rescored = {h.doc_id: h.score for h in res.hits}
        assert rescored["3"] > base_scores["3"]
        assert rescored["1"] == pytest.approx(base_scores["1"])

    def test_profile(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({"query": "systems", "limit": 10,
                                     "profile": True})
        assert res.profile is not None
        assert "search_ms" in res.profile["timings"]
        assert res.profile["execution"]["postings_advanced"] > 0


class TestSuggest:
    def test_completion_suggest(self):
        index = make_index(docs=DOCS)
        res = index.reader().search({
            "query": {"type": "match_all"}, "limit": 1,
            "suggest": {"s1": {"type": "completion", "field": "body",
                               "prefix": "sys"}}})
        options = res.suggest["s1"]["options"]
        assert options[0]["text"] == "systems"
        assert options[0]["doc_freq"] == 3

    def test_suggest_ordering_by_tf(self):
        docs = [
            {"_id": "1", "title": "t", "body": "app apple apple apple",
             "tag": "a", "year": 1, "rating": 1.0},
            {"_id": "2", "title": "t", "body": "app apricot",
             "tag": "a", "year": 2, "rating": 1.0},
        ]
        index = make_index(docs=docs)
        res = index.reader().search({
            "query": {"type": "match_all"}, "limit": 1,
            "suggest": {"s": {"type": "completion", "field": "body",
                              "prefix": "ap"}}})
        texts = [o["text"] for o in res.suggest["s"]["options"]]
        assert texts[0] == "apple"


class TestDeletesAndUpserts:
    def test_deleted_doc_not_returned(self):
        index = make_index(docs=DOCS)
        writer = index.writer()
        writer.delete_document("1")
        writer.commit()
        res = index.reader().search({"query": "systems", "limit": 10})
        assert "1" not in [h.doc_id for h in res.hits]
        assert res.total_hits_estimate == 2

    def test_upsert_visible_after_commit(self):
        index = make_index(docs=DOCS)
        writer = index.writer()
        writer.add_document({"_id": "1", "title": "Rust rewritten",
                             "body": "totally different text",
                             "tag": "lang", "year": 2024, "rating": 5.0})
        writer.commit()
        res = index.reader().search({"query": "systems", "limit": 10})
        assert "1" not in [h.doc_id for h in res.hits]
        res2 = index.reader().search({"query": "rewritten", "limit": 10,
                                      "fields": ["title"]})
        assert [h.doc_id for h in res2.hits] == ["1"]


class TestMultiSegment:
    def test_results_merge_across_segments(self):
        index = make_index(docs=DOCS, commits_per_doc=True)
        reader = index.reader()
        assert len(reader.segments) == 4
        res = reader.search({"query": "systems", "limit": 10})
        assert res.total_hits_estimate == 3
        assert res.hits[0].doc_id == "1"

    def test_compaction_preserves_results(self):
        index = make_index(docs=DOCS, commits_per_doc=True)
        before = index.reader().search({"query": "systems", "limit": 10})
        index.compact()
        after = index.reader().search({"query": "systems", "limit": 10})
        # BM25 stats (df, N, avgdl) are per-segment — as in the reference —
        # so compaction changes scores; the matched set must be identical.
        assert sorted(h.doc_id for h in before.hits) == \
            sorted(h.doc_id for h in after.hits)
        assert before.total_hits_estimate == after.total_hits_estimate
