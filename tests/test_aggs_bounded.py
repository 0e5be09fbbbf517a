"""Bounded-memory + vectorized aggregation collectors.

Covers the round-3 verdict items: t-digest percentiles above the exact
window, cardinality precision_threshold estimator, and the vectorized
(no per-doc Python loop) cardinality/date_histogram/composite/top_hits
collection paths (reference contracts: `query/aggs/mod.rs:466-596`,
`:1478-1561`, TopHitsState).
"""

import numpy as np
import pytest

from searchlite.index.fastfields import FastFieldsWriter
from searchlite.query import aggs as A
from searchlite.query import datetime_util as dtu
from searchlite.query import sketches


class FakeMeta:
    def __init__(self, seg_id):
        self.id = seg_id


class FakeSeg:
    """Just enough of SegmentReader for the collector functions."""

    def __init__(self, fast, seg_id="seg0"):
        self.fast = fast
        self.meta = FakeMeta(seg_id)

    def doc_id(self, doc):
        return str(doc)

    def get_doc(self, doc):
        return {}


def build_fast(n_docs, fill):
    w = FastFieldsWriter()
    fill(w)
    return w.build(n_docs)


def collect(kind, seg, matched, spec):
    fn = A._COLLECTORS[kind]
    return fn(seg, 0, np.asarray(matched, dtype=np.int64), spec)


# ---------------------------------------------------------------------------
# calendar_bucket_vec == calendar_bucket
# ---------------------------------------------------------------------------

def test_calendar_bucket_vec_matches_scalar():
    rng = np.random.default_rng(1)
    ms = np.concatenate([
        rng.integers(-2_145_916_800_000, 4_102_444_800_000, 500),
        np.array([0, -1, 1, 86_400_000, -86_400_000, 86_399_999]),
    ]).astype(np.int64)
    for iv in ("day", "week", "month", "quarter", "year"):
        vec = dtu.calendar_bucket_vec(ms, iv)
        for i, m in enumerate(ms.tolist()):
            assert dtu.calendar_bucket(m, iv) == int(vec[i]), (iv, m)


# ---------------------------------------------------------------------------
# percentiles: exact window then t-digest
# ---------------------------------------------------------------------------

def make_price_seg(values, n_docs=None):
    values = np.asarray(values, dtype=np.float64)
    n_docs = n_docs if n_docs is not None else len(values)

    def fill(w):
        w.extend_f64("price", np.arange(len(values)), values)

    return FakeSeg(build_fast(n_docs, fill))


def test_percentiles_exact_below_window():
    vals = np.arange(101, dtype=np.float64)
    seg = make_price_seg(vals)
    inter = collect("percentiles", seg, np.arange(101),
                    {"type": "percentiles", "field": "price"})
    assert inter.data["state"].is_exact
    out = A._finalize_percentiles(inter, {"percents": [50, 95]})
    assert out["values"]["50"] == pytest.approx(50.0)
    assert out["values"]["95"] == pytest.approx(95.0)


def test_percentiles_digest_above_window_is_bounded_and_close():
    rng = np.random.default_rng(7)
    vals = rng.normal(500, 100, 200_000)
    seg = make_price_seg(vals)
    inter = collect("percentiles", seg, np.arange(len(vals)),
                    {"type": "percentiles", "field": "price"})
    state = inter.data["state"]
    assert not state.is_exact
    # bounded: centroids, not values
    assert len(state.digest.means) <= sketches.TDIGEST_COMPRESSION + 2
    out = A._finalize_percentiles(inter, {"percents": [1, 50, 99]})
    for p in (1, 50, 99):
        true = float(np.percentile(vals, p))
        assert out["values"][f"{p:g}"] == pytest.approx(true, rel=0.01), p


def test_percentiles_merge_exact_plus_digest():
    a = make_price_seg(np.arange(100, dtype=np.float64))
    b = make_price_seg(np.arange(10_000, dtype=np.float64))
    ia = collect("percentiles", a, np.arange(100),
                 {"type": "percentiles", "field": "price"})
    ib = collect("percentiles", b, np.arange(10_000),
                 {"type": "percentiles", "field": "price"})
    A._merge_in_place(ia, ib)
    assert ia.data["state"].count == 10_100
    out = A._finalize_percentiles(ia, {"percents": [50]})
    combined = np.concatenate([np.arange(100), np.arange(10_000)])
    assert out["values"]["50"] == pytest.approx(
        float(np.percentile(combined, 50)), rel=0.02)


def test_percentile_ranks_digest():
    vals = np.arange(50_000, dtype=np.float64)
    seg = make_price_seg(vals)
    inter = collect("percentile_ranks", seg, np.arange(len(vals)),
                    {"type": "percentile_ranks", "field": "price",
                     "values": [25_000]})
    out = A._finalize_percentile_ranks(inter, {"values": [25_000]})
    assert out["values"]["25000"] == pytest.approx(50.0, abs=1.0)


# ---------------------------------------------------------------------------
# cardinality: exact set -> HLL above precision_threshold
# ---------------------------------------------------------------------------

def make_tag_seg(tags, n_docs=None):
    tags = list(tags)
    n_docs = n_docs if n_docs is not None else len(tags)

    def fill(w):
        w.extend_str("tag", np.arange(len(tags)), tags)

    return FakeSeg(build_fast(n_docs, fill))


def test_cardinality_exact_below_threshold():
    seg = make_tag_seg([f"t{i % 700}" for i in range(5000)])
    inter = collect("cardinality", seg, np.arange(5000),
                    {"type": "cardinality", "field": "tag"})
    assert inter.data["state"].sketch is None
    assert A._finalize(inter, {}, "cardinality")["value"] == 700


def test_cardinality_sketch_above_threshold():
    n = 30_000
    seg = make_tag_seg([f"u{i}" for i in range(n)])
    inter = collect("cardinality", seg, np.arange(n),
                    {"type": "cardinality", "field": "tag"})
    state = inter.data["state"]
    assert state.sketch is not None  # exceeded the default threshold
    est = A._finalize(inter, {}, "cardinality")["value"]
    assert abs(est - n) / n < 0.05


def test_cardinality_precision_threshold_knob():
    n = 8000
    seg = make_tag_seg([f"u{i}" for i in range(n)])
    inter = collect("cardinality", seg, np.arange(n),
                    {"type": "cardinality", "field": "tag",
                     "precision_threshold": 10_000})
    assert inter.data["state"].sketch is None  # stays exact up to 10k
    assert A._finalize(inter, {}, "cardinality")["value"] == n


def test_cardinality_merge_across_segments():
    a = make_tag_seg([f"v{i}" for i in range(0, 2000)])
    b = make_tag_seg([f"v{i}" for i in range(1000, 2500)])
    ia = collect("cardinality", a, np.arange(2000),
                 {"type": "cardinality", "field": "tag"})
    ib = collect("cardinality", b, np.arange(1500),
                 {"type": "cardinality", "field": "tag"})
    A._merge_in_place(ia, ib)
    assert A._finalize(ia, {}, "cardinality")["value"] == 2500


def test_cardinality_missing_and_numeric():
    def fill(w):
        w.extend_f64("price", np.arange(5), [1.0, 2.0, 2.0, 3.0, 1.0])

    seg = FakeSeg(build_fast(8, fill))  # docs 5..7 have no value
    inter = collect("cardinality", seg, np.arange(8),
                    {"type": "cardinality", "field": "price",
                     "missing": 99})
    assert A._finalize(inter, {}, "cardinality")["value"] == 4  # 1,2,3,99


# ---------------------------------------------------------------------------
# vectorized date_histogram / histogram / composite match loop semantics
# ---------------------------------------------------------------------------

def test_date_histogram_str_column_with_unparsable_and_missing():
    days = ["2024-01-01T05:00:00Z", "2024-01-01T23:59:59Z",
            "2024-01-02T00:00:00Z", "not-a-date", "2024-01-03T01:02:03Z"]

    def fill(w):
        w.extend_str("day", np.arange(5), days)

    seg = FakeSeg(build_fast(6, fill))  # doc 5 missing entirely
    inter = collect("date_histogram", seg, np.arange(6),
                    {"type": "date_histogram", "field": "day",
                     "calendar_interval": "day",
                     "missing": "2024-01-09T00:00:00Z"})
    buckets = inter.data["buckets"]
    key = lambda s: dtu.parse_datetime_millis(s)
    assert buckets[key("2024-01-01T00:00:00Z")].doc_count == 2
    assert buckets[key("2024-01-02T00:00:00Z")].doc_count == 1
    assert buckets[key("2024-01-03T00:00:00Z")].doc_count == 1
    # unparsable doc 3 AND absent doc 5 both take the missing date
    assert buckets[key("2024-01-09T00:00:00Z")].doc_count == 2


def test_date_histogram_multivalued_dedupe_and_hard_bounds():
    DAY = 86_400_000

    def fill(w):
        # doc 0 has two values in the SAME day -> counts once
        w.extend_i64("ts", np.array([0, 0, 1, 2]),
                     np.array([100, 200, DAY + 5, 3 * DAY]))

    seg = FakeSeg(build_fast(3, fill))
    inter = collect("date_histogram", seg, np.arange(3),
                    {"type": "date_histogram", "field": "ts",
                     "fixed_interval": "1d",
                     "hard_bounds": {"min": 0, "max": 2 * DAY - 1}})
    buckets = inter.data["buckets"]
    assert buckets[0].doc_count == 1
    assert buckets[DAY].doc_count == 1
    assert 3 * DAY not in buckets  # hard bounds dropped doc 2


def test_histogram_subaggs_vectorized():
    def fill(w):
        w.extend_f64("price", np.arange(6),
                     [5.0, 15.0, 15.5, 25.0, 5.5, 26.0])
        w.extend_str("tag", np.arange(6), ["a", "b", "b", "c", "a", "c"])

    seg = FakeSeg(build_fast(6, fill))
    inter = collect("histogram", seg, np.arange(6),
                    {"type": "histogram", "field": "price", "interval": 10,
                     "aggs": {"tags": {"type": "terms", "field": "tag"}}})
    buckets = inter.data["buckets"]
    assert buckets[0.0].doc_count == 2
    assert buckets[10.0].doc_count == 2
    assert buckets[20.0].doc_count == 2
    sub = buckets[0.0].sub["tags"]
    assert sub.data["buckets"]["a"].doc_count == 2


def test_composite_vectorized_matches_loop():
    tags = ["a", "b", "a", "c", "b", "a", None, "c"]
    prices = [1, 2, 1, 3, 2, 7, 4, None]

    def fill(w):
        for d, (t, p) in enumerate(zip(tags, prices)):
            if t is not None:
                w.set_str("tag", d, [t])
            if p is not None:
                w.set_i64("price", d, [p])

    seg = FakeSeg(build_fast(8, fill))
    spec = {"type": "composite", "sources": [
        {"name": "t", "type": "terms", "field": "tag"},
        {"name": "p", "type": "histogram", "field": "price",
         "interval": 2}]}
    inter = collect("composite", seg, np.arange(8), spec)
    buckets = {k: b.doc_count for k, b in inter.data["buckets"].items()}
    # docs 6 (no tag) and 7 (no price) are skipped entirely
    assert buckets == {("a", 0.0): 2, ("b", 2.0): 2, ("c", 2.0): 1,
                       ("a", 6.0): 1}


def test_composite_multivalued_fallback_cartesian():
    def fill(w):
        w.set_str("tag", 0, ["x", "y"])
        w.set_i64("price", 0, [1])

    seg = FakeSeg(build_fast(1, fill))
    spec = {"type": "composite", "sources": [
        {"name": "t", "type": "terms", "field": "tag"},
        {"name": "p", "type": "terms", "field": "price"}]}
    inter = collect("composite", seg, np.arange(1), spec)
    buckets = {k: b.doc_count for k, b in inter.data["buckets"].items()}
    assert buckets == {("x", 1): 1, ("y", 1): 1}


# ---------------------------------------------------------------------------
# top_hits: bounded per-segment collection
# ---------------------------------------------------------------------------

def test_top_hits_bounded_and_correct():
    n = 10_000
    rng = np.random.default_rng(3)
    prices = rng.permutation(n).astype(np.float64)

    def fill(w):
        w.extend_f64("price", np.arange(n), prices)

    seg = FakeSeg(build_fast(n, fill))
    spec = {"type": "top_hits", "size": 3, "from": 1,
            "sort": [{"field": "price", "order": "desc"}], "fields": []}
    inter = collect("top_hits", seg, np.arange(n), spec)
    assert len(inter.data["hits"]) == 4  # from + size, not n
    assert inter.data["total"] == n
    out = A._finalize_top_hits(inter, spec)
    assert out["total"] == n
    got = [int(h["doc_id"]) for h in out["hits"]]
    want = np.argsort(-prices, kind="stable")[1:4].tolist()
    assert got == want


def test_top_hits_merge_across_segments_keeps_global_page():
    specs = {"type": "top_hits", "size": 2, "sort": [{"field": "price", "order": "asc"}],
             "fields": []}
    inters = []
    for s, vals in enumerate([[50.0, 3.0, 60.0], [1.0, 70.0, 2.0]]):
        def fill(w, v=vals):
            w.extend_f64("price", np.arange(len(v)), v)

        seg = FakeSeg(build_fast(len(vals), fill), seg_id=f"s{s}")
        fn = A._COLLECTORS["top_hits"]
        inters.append(fn(seg, s, np.arange(len(vals)), specs))
    A._merge_in_place(inters[0], inters[1])
    out = A._finalize_top_hits(inters[0], specs)
    assert out["total"] == 6
    # global two smallest prices: 1.0 (seg1 doc0), 2.0 (seg1 doc2)
    assert [h["doc_id"] for h in out["hits"]] == ["0", "2"]
