"""Aggregation tests (parity targets: `searchlite-core/tests/
aggregations.rs` + `aggregation_bounds.rs`)."""

import math

import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.errors import QueryError
from searchlite.index import Index
from searchlite.index.manifest import Schema


def make_index(docs, commits_per_doc=False):
    schema = Schema.from_json({
        "text_fields": [{"name": "body", "analyzer": "default",
                         "stored": True, "indexed": True}],
        "keyword_fields": [
            {"name": "tag", "stored": True, "indexed": True, "fast": True},
            {"name": "day", "stored": True, "indexed": True, "fast": True},
        ],
        "numeric_fields": [
            {"name": "price", "i64": True, "fast": True, "stored": True},
            {"name": "score", "i64": False, "fast": True, "stored": True},
            {"name": "ts", "i64": True, "fast": True, "stored": True},
        ],
    })
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY), schema)
    writer = index.writer()
    for doc in docs:
        writer.add_document(doc)
        if commits_per_doc:
            writer.commit()
    if not commits_per_doc:
        writer.commit()
    return index


DAY = 86_400_000

DOCS = [
    {"_id": "1", "body": "match one", "tag": "a", "price": 10,
     "score": 1.0, "ts": 0 * DAY, "day": "2024-01-01"},
    {"_id": "2", "body": "match two", "tag": "a", "price": 20,
     "score": 2.0, "ts": 0 * DAY + 1000, "day": "2024-01-01"},
    {"_id": "3", "body": "match three", "tag": "b", "price": 30,
     "score": 3.0, "ts": 1 * DAY, "day": "2024-01-02"},
    {"_id": "4", "body": "match four", "tag": "b", "price": 40,
     "score": 4.0, "ts": 2 * DAY, "day": "2024-01-03"},
    {"_id": "5", "body": "match five", "tag": "c", "price": 50,
     "score": 5.0, "ts": 2 * DAY + 1, "day": "2024-01-03"},
    {"_id": "6", "body": "other text", "tag": "c", "price": 60,
     "score": 6.0, "ts": 3 * DAY, "day": "2024-01-04"},
]


def run_aggs(index, aggs, query="match"):
    return index.reader().search(
        {"query": query, "limit": 1, "aggs": aggs}).aggregations


class TestBucketAggs:
    def test_terms_ordering_and_counts(self):
        index = make_index(DOCS)
        out = run_aggs(index, {"tags": {"type": "terms", "field": "tag"}})
        buckets = out["tags"]["buckets"]
        assert [(b["key"], b["doc_count"]) for b in buckets] == [
            ("a", 2), ("b", 2), ("c", 1)]

    def test_terms_size_and_min_doc_count(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "tags": {"type": "terms", "field": "tag", "size": 1,
                     "min_doc_count": 2}})
        buckets = out["tags"]["buckets"]
        assert len(buckets) == 1
        assert buckets[0]["doc_count"] == 2

    def test_terms_missing_bucket(self):
        docs = DOCS + [{"_id": "7", "body": "match seven", "price": 70,
                        "score": 7.0, "ts": 0}]
        index = make_index(docs)
        out = run_aggs(index, {
            "tags": {"type": "terms", "field": "tag", "missing": "none"}})
        keys = {b["key"]: b["doc_count"] for b in out["tags"]["buckets"]}
        assert keys["none"] == 1

    def test_terms_numeric_field(self):
        index = make_index(DOCS)
        out = run_aggs(index, {"p": {"type": "terms", "field": "price"}})
        assert len(out["p"]["buckets"]) == 5

    def test_terms_with_sub_stats(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "tags": {"type": "terms", "field": "tag",
                     "aggs": {"prices": {"type": "stats",
                                         "field": "price"}}}})
        first = out["tags"]["buckets"][0]
        assert first["key"] == "a"
        stats = first["aggregations"]["prices"]
        assert stats["count"] == 2
        assert stats["sum"] == 30.0
        assert stats["avg"] == 15.0

    def test_histogram(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "h": {"type": "histogram", "field": "price", "interval": 20}})
        buckets = {b["key"]: b["doc_count"] for b in out["h"]["buckets"]}
        assert buckets == {0.0: 1, 20.0: 2, 40.0: 2}

    def test_histogram_offset_and_extended_bounds(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "h": {"type": "histogram", "field": "price", "interval": 20,
                  "min_doc_count": 0,
                  "extended_bounds": {"min": 0, "max": 100}}})
        keys = [b["key"] for b in out["h"]["buckets"]]
        assert keys == [0.0, 20.0, 40.0, 60.0, 80.0, 100.0]

    def test_range(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "r": {"type": "range", "field": "price", "keyed": False,
                  "ranges": [{"to": 25}, {"from": 25, "to": 45},
                             {"from": 45, "key": "big"}]}})
        buckets = out["r"]["buckets"]
        assert buckets[0]["doc_count"] == 2
        assert buckets[1]["doc_count"] == 2
        assert buckets[2]["key"] == "big"
        assert buckets[2]["doc_count"] == 1

    def test_filter_agg(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "cheap": {"type": "filter",
                      "filter": {"I64Range": {"field": "price", "min": 0,
                                              "max": 25}},
                      "aggs": {"cnt": {"type": "value_count",
                                       "field": "price"}}}})
        assert out["cheap"]["doc_count"] == 2
        assert out["cheap"]["aggregations"]["cnt"]["value"] == 2

    def test_date_histogram_calendar_day(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "days": {"type": "date_histogram", "field": "ts",
                     "calendar_interval": "day"}})
        buckets = out["days"]["buckets"]
        assert [b["doc_count"] for b in buckets] == [2, 1, 2]
        assert buckets[0]["key"].startswith("1970-01-01")

    def test_date_histogram_calendar_month(self):
        docs = [
            {"_id": "1", "body": "match", "tag": "a", "price": 1,
             "score": 0.0, "ts": 0, "day": "2024-01-05"},
            {"_id": "2", "body": "match", "tag": "a", "price": 1,
             "score": 0.0,
             "ts": 1706918400000, "day": "2024-02-03"},  # 2024-02-03
            {"_id": "3", "body": "match", "tag": "a", "price": 1,
             "score": 0.0,
             "ts": 1708732800000, "day": "2024-02-24"},  # 2024-02-24
        ]
        index = make_index(docs)
        out = run_aggs(index, {
            "m": {"type": "date_histogram", "field": "ts",
                  "calendar_interval": "month",
                  "format": "strict_date"}})
        buckets = out["m"]["buckets"]
        assert [(b["key"], b["doc_count"]) for b in buckets] == [
            ("1970-01-01", 1), ("2024-02-01", 2)]

    def test_date_histogram_fixed_interval_with_offset(self):
        docs = [{"_id": str(i), "body": "match", "tag": "a", "price": 1,
                 "score": 0.0, "ts": i * 3_600_000} for i in range(5)]
        index = make_index(docs)
        out = run_aggs(index, {
            "h": {"type": "date_histogram", "field": "ts",
                  "fixed_interval": "2h", "offset": "1h",
                  "format": "epoch_millis"}})
        buckets = {b["key"]: b["doc_count"] for b in out["h"]["buckets"]}
        # buckets anchored at -1h, 1h, 3h
        assert buckets == {str(-3_600_000): 1, str(3_600_000): 2,
                           str(3 * 3_600_000): 2}

    def test_date_histogram_hard_bounds_filter_and_fill(self):
        """Values outside hard_bounds are dropped AND empty buckets are
        generated across the bounds (reference tests/aggregations.rs::
        date_histogram_hard_bounds_filter_out_of_range: ts 0 is
        filtered, keys become [1000, 2000] with counts [1, 0])."""
        docs = [
            {"_id": "1", "body": "match", "tag": "a", "price": 1,
             "score": 0.0, "ts": 1_000},
            {"_id": "0", "body": "match", "tag": "a", "price": 1,
             "score": 0.0, "ts": 0},
        ]
        index = make_index(docs)
        out = run_aggs(index, {
            "h": {"type": "date_histogram", "field": "ts",
                  "fixed_interval": "1s", "min_doc_count": 0,
                  "hard_bounds": {"min": "1970-01-01T00:00:01Z",
                                  "max": "1970-01-01T00:00:02Z"}}})
        buckets = out["h"]["buckets"]
        assert [b["key_as_millis"] for b in buckets] == [1_000, 2_000]
        assert [b["doc_count"] for b in buckets] == [1, 0]

    def test_histogram_hard_bounds_filter_and_fill(self):
        index = make_index(DOCS)  # prices 10..60
        out = run_aggs(index, {
            "h": {"type": "histogram", "field": "price", "interval": 20,
                  "hard_bounds": {"min": 40, "max": 100}}})
        # min_doc_count defaults to 0 because bounds are present
        # (parity: aggs/mod.rs:1145-1150); 40-bucket holds prices 40+50
        buckets = {b["key"]: b["doc_count"] for b in out["h"]["buckets"]}
        assert buckets == {40.0: 2, 60.0: 0, 80.0: 0, 100.0: 0}

    def test_pipeline_gap_policy_inserts_zeros(self):
        """A buckets_path that resolves to nothing yields zeros under
        gap_policy=insert_zeros, so the derivative is 0.0 (reference
        tests/aggregations.rs::pipeline_missing_metric_path_with_
        gap_policy_inserts_zeros)."""
        index = make_index(DOCS)
        out = run_aggs(index, {
            "h": {"type": "histogram", "field": "price", "interval": 20},
            "d": {"type": "derivative", "buckets_path": "h>missing.metric",
                  "gap_policy": "insert_zeros", "unit": 1.0},
        })
        buckets = out["h"]["buckets"]
        assert len(buckets) >= 2
        assert buckets[1]["aggregations"]["derivative"]["value"] == 0.0

    def test_date_histogram_month_interval_spellings(self):
        """'1M' (and lowercase '1m') mean calendar month, matching the
        reference's parse_calendar_interval (aggs/mod.rs:3384) —
        regression: the lowercased name was compared against '1M' and
        both spellings raised."""
        for spelling in ("1M", "1m", "month"):
            index = make_index(DOCS)
            out = run_aggs(index, {
                "m": {"type": "date_histogram", "field": "ts",
                      "calendar_interval": spelling}})
            assert len(out["m"]["buckets"]) == 1  # all ts in Jan 1970
            assert out["m"]["buckets"][0]["doc_count"] == 5

    def test_histogram_bounds_densify_capped(self):
        index = make_index(DOCS)
        with pytest.raises(QueryError):
            run_aggs(index, {
                "h": {"type": "histogram", "field": "price",
                      "interval": 0.001,
                      "extended_bounds": {"min": 0, "max": 1e6}}})
        with pytest.raises(QueryError):
            run_aggs(index, {
                "h": {"type": "date_histogram", "field": "ts",
                      "fixed_interval": "1s",
                      "hard_bounds": {"min": "1970-01-01T00:00:00Z",
                                      "max": "2100-01-01T00:00:00Z"}}})

    def test_composite_histogram_source(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "c": {"type": "composite", "size": 10,
                  "sources": [
                      {"type": "histogram", "name": "p", "field": "price",
                       "interval": 20},
                      {"type": "terms", "name": "t", "field": "tag"},
                  ]}})
        buckets = out["c"]["buckets"]
        assert buckets[0]["key"] == {"p": 0.0, "t": "a"}
        assert all("p" in b["key"] and "t" in b["key"] for b in buckets)

    def test_date_range(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "dr": {"type": "date_range", "field": "ts", "keyed": False,
                   "ranges": [
                       {"key": "early", "to": 1 * DAY},
                       {"key": "late", "from": 1 * DAY},
                   ]}})
        buckets = out["dr"]["buckets"]
        assert buckets[0]["doc_count"] == 2
        assert buckets[1]["doc_count"] == 3

    def test_composite_pagination(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "c": {"type": "composite", "size": 2,
                  "sources": [{"type": "terms", "name": "tag",
                               "field": "tag"}]}})
        buckets = out["c"]["buckets"]
        assert [b["key"]["tag"] for b in buckets] == ["a", "b"]
        after = out["c"]["after_key"]
        out2 = run_aggs(index, {
            "c": {"type": "composite", "size": 2, "after": after,
                  "sources": [{"type": "terms", "name": "tag",
                               "field": "tag"}]}})
        assert [b["key"]["tag"] for b in out2["c"]["buckets"]] == ["c"]

    def test_significant_terms(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "sig": {"type": "significant_terms", "field": "tag"}},
            query="match five")
        # "match five" matches all 'match' docs? no — default OR: matches
        # docs with match OR five → docs 1-5
        assert out["sig"]["doc_count"] == 5

    def test_significant_terms_respects_deletions(self):
        """Deleted docs contribute to neither foreground nor background
        counts (reference tests/aggregations.rs::
        significant_terms_respects_deletions)."""
        index = make_index([
            {"_id": "1", "body": "keep me", "tag": "foo", "price": 1,
             "score": 0.0, "ts": 0},
            {"_id": "2", "body": "delete me", "tag": "foo", "price": 1,
             "score": 0.0, "ts": 0},
        ])
        writer = index.writer()
        writer.delete_document("2")
        writer.commit()
        out = run_aggs(index, {
            "sig": {"type": "significant_terms", "field": "tag",
                    "size": 5}}, query="keep")
        buckets = out["sig"]["buckets"]
        assert len(buckets) == 1
        assert buckets[0]["key"] == "foo"
        assert buckets[0]["doc_count"] == 1

    def test_rare_terms(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "rare": {"type": "rare_terms", "field": "tag",
                     "max_doc_count": 1}})
        assert [b["key"] for b in out["rare"]["buckets"]] == ["c"]


class TestMetricAggs:
    def test_stats_and_extended(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "s": {"type": "stats", "field": "price"},
            "e": {"type": "extended_stats", "field": "score"}})
        s = out["s"]
        assert (s["count"], s["min"], s["max"], s["sum"]) == (5, 10, 50, 150)
        e = out["e"]
        assert e["avg"] == pytest.approx(3.0)
        assert e["variance"] == pytest.approx(2.0)
        assert e["std_deviation"] == pytest.approx(math.sqrt(2.0))

    def test_value_count_multivalued(self):
        docs = [
            {"_id": "1", "body": "match", "tag": "a", "price": [1, 2, 3],
             "score": 0.0, "ts": 0},
            {"_id": "2", "body": "match", "tag": "a", "price": 4,
             "score": 0.0, "ts": 0},
        ]
        index = make_index(docs)
        out = run_aggs(index, {
            "vc": {"type": "value_count", "field": "price"}})
        assert out["vc"]["value"] == 4

    def test_cardinality(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "card": {"type": "cardinality", "field": "tag"}})
        assert out["card"]["value"] == 3

    def test_percentiles(self):
        docs = [{"_id": str(i), "body": "match", "tag": "a",
                 "price": i, "score": 0.0, "ts": 0} for i in range(101)]
        index = make_index(docs)
        out = run_aggs(index, {
            "p": {"type": "percentiles", "field": "price",
                  "percents": [50, 95]}})
        assert out["p"]["values"]["50"] == pytest.approx(50.0)
        assert out["p"]["values"]["95"] == pytest.approx(95.0)

    def test_percentile_ranks(self):
        docs = [{"_id": str(i), "body": "match", "tag": "a",
                 "price": i, "score": 0.0, "ts": 0} for i in range(1, 11)]
        index = make_index(docs)
        out = run_aggs(index, {
            "pr": {"type": "percentile_ranks", "field": "price",
                   "values": [5]}})
        assert out["pr"]["values"]["5"] == pytest.approx(50.0)

    def test_top_hits(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "tags": {"type": "terms", "field": "tag",
                     "aggs": {"top": {"type": "top_hits", "size": 1,
                                      "fields": ["body"]}}}})
        first = out["tags"]["buckets"][0]
        top = first["aggregations"]["top"]
        assert top["total"] == 2
        assert len(top["hits"]) == 1
        assert top["hits"][0]["fields"]["body"].startswith("match")


class TestPipelines:
    def test_avg_and_sum_bucket(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "tags": {"type": "terms", "field": "tag",
                     "aggs": {"p": {"type": "stats", "field": "price"}}},
            "avg_price": {"type": "avg_bucket",
                          "buckets_path": "tags>p.avg"},
            "sum_count": {"type": "sum_bucket", "buckets_path": "tags"},
        })
        assert out["sum_count"]["value"] == 5.0
        # per-tag avgs: a=15, b=35, c=50 → mean = 100/3
        assert out["avg_price"]["value"] == pytest.approx(100.0 / 3)

    def test_derivative_and_moving_avg(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "h": {"type": "histogram", "field": "price", "interval": 20,
                  "aggs": {"s": {"type": "stats", "field": "price"}}},
            "d": {"type": "derivative", "buckets_path": "h"},
            "m": {"type": "moving_avg", "buckets_path": "h", "window": 2},
        })
        # bucket counts 1, 2, 2 → derivative last = 0
        assert out["d"]["value"] == 0.0
        assert out["m"]["value"] == pytest.approx(2.0)

    def test_bucket_script(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "tags": {"type": "terms", "field": "tag",
                     "aggs": {"p": {"type": "stats", "field": "price"}}},
            "ratio": {"type": "bucket_script",
                      "buckets_path": {"total": "tags>p.sum",
                                       "n": "tags"},
                      "script": "total / n"},
        })
        # annotated on buckets: a: 30/2=15, b: 70/2=35, c: 50/1=50
        assert out["ratio"]["value"] == pytest.approx(50.0)

    def test_bucket_sort(self):
        index = make_index(DOCS)
        out = run_aggs(index, {
            "tags": {"type": "terms", "field": "tag"},
            "sorter": {"type": "bucket_sort",
                       "sort": [{"_count": "asc"}], "size": 2},
        })
        buckets = out["tags"]["buckets"]
        assert len(buckets) == 2
        assert buckets[0]["doc_count"] <= buckets[1]["doc_count"]


class TestValidationAndMerge:
    def test_unknown_agg_type(self):
        index = make_index(DOCS)
        with pytest.raises(QueryError):
            run_aggs(index, {"x": {"type": "bogus", "field": "tag"}})

    def test_stats_requires_numeric_fast(self):
        index = make_index(DOCS)
        with pytest.raises(QueryError):
            run_aggs(index, {"x": {"type": "stats", "field": "tag"}})
        with pytest.raises(QueryError):
            run_aggs(index, {"x": {"type": "stats", "field": "body"}})

    def test_cross_segment_merge(self):
        index = make_index(DOCS, commits_per_doc=True)
        assert len(index.reader().segments) == 6
        out = run_aggs(index, {
            "tags": {"type": "terms", "field": "tag",
                     "aggs": {"s": {"type": "stats", "field": "price"}}},
            "st": {"type": "stats", "field": "price"},
            "card": {"type": "cardinality", "field": "tag"},
        })
        buckets = out["tags"]["buckets"]
        assert [(b["key"], b["doc_count"]) for b in buckets] == [
            ("a", 2), ("b", 2), ("c", 1)]
        assert buckets[0]["aggregations"]["s"]["sum"] == 30.0
        assert out["st"]["count"] == 5
        assert out["card"]["value"] == 3

    def test_top_hits_across_segments(self):
        index = make_index(DOCS, commits_per_doc=True)
        out = run_aggs(index, {
            "tags": {"type": "terms", "field": "tag",
                     "aggs": {"top": {"type": "top_hits", "size": 5,
                                      "fields": ["body"]}}}})
        buckets = {b["key"]: b for b in out["tags"]["buckets"]}
        tops = buckets["a"]["aggregations"]["top"]
        assert tops["total"] == 2
        bodies = {h["fields"]["body"] for h in tops["hits"]}
        assert bodies == {"match one", "match two"}

    def test_sampling_flag(self):
        docs = [{"_id": str(i), "body": "match", "tag": f"t{i % 3}",
                 "price": i, "score": 0.0, "ts": 0} for i in range(50)]
        index = make_index(docs)
        out = run_aggs(index, {
            "tags": {"type": "terms", "field": "tag",
                     "sampling": {"size": 10, "seed": 7}}})
        assert out["tags"].get("sampled") is True
        total = sum(b["doc_count"] for b in out["tags"]["buckets"])
        assert total <= 10

    def test_sampling_deterministic(self):
        docs = [{"_id": str(i), "body": "match", "tag": f"t{i % 5}",
                 "price": i, "score": 0.0, "ts": 0} for i in range(60)]
        index = make_index(docs)
        out1 = run_aggs(index, {
            "tags": {"type": "terms", "field": "tag",
                     "sampling": {"probability": 0.5, "seed": 3}}})
        out2 = run_aggs(index, {
            "tags": {"type": "terms", "field": "tag",
                     "sampling": {"probability": 0.5, "seed": 3}}})
        assert out1 == out2

    def test_aggs_respect_filters_and_query(self):
        index = make_index(DOCS)
        out = index.reader().search({
            "query": "match", "limit": 1,
            "filter": {"KeywordEq": {"field": "tag", "value": "a"}},
            "aggs": {"st": {"type": "stats", "field": "price"}},
        }).aggregations
        assert out["st"]["count"] == 2
        assert out["st"]["sum"] == 30.0
