"""Device-side aggregation partials (ops/device_aggs.py) must produce
responses identical to the host collectors — counts/min/max bit-exact,
stats sums within f32-sum tolerance (D8-class divergence, module doc).

Round 4 widened the device surface (static-structure insight: bucket
membership, `missing`, `hard_bounds` and per-doc moments are all
query-independent): multi-valued columns, terms/histogram `missing`,
date_histogram / date_range / filter, and ONE level of
stats/value_count sub-aggregations. Tests below assert BOTH parity and
that the device plan actually engages (so they never degrade into
host-vs-host comparisons)."""

import random

import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema

DAYS = ["2024-01-0%dT0%d:00:00Z" % (d, h)
        for d in range(1, 8) for h in range(0, 6)]


@pytest.fixture(scope="module")
def index():
    rng = random.Random(91)
    vocab = [f"w{i}" for i in range(50)]
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "keyword_fields": [
                {"name": "cat", "stored": False, "indexed": True,
                 "fast": True},
                {"name": "tags", "stored": False, "indexed": True,
                 "fast": True},
                {"name": "day", "stored": False, "indexed": False,
                 "fast": True}],
            "numeric_fields": [
                {"name": "price", "i64": False, "stored": False,
                 "fast": True},
                {"name": "qty", "i64": True, "stored": False,
                 "fast": True},
                {"name": "scores", "i64": True, "stored": False,
                 "fast": True}],
        }))
    writer = idx.writer()
    for i in range(900):
        doc = {
            "_id": str(i),
            "body": " ".join(rng.choices(vocab, k=rng.randint(3, 15))),
            "cat": rng.choice(["a", "b", "c", "d"]),
            # multi-valued keyword: exercises the [n1, V] distinct-code
            # table (was a host fallback before round 4)
            "tags": rng.sample(["x", "y", "z", "u"],
                               k=rng.randint(1, 3)),
        }
        if rng.random() < 0.9:  # some docs miss numeric values
            doc["price"] = round(rng.uniform(0, 100), 2)
        if rng.random() < 0.8:
            doc["qty"] = rng.randint(0, 50)
        if rng.random() < 0.85:
            doc["day"] = rng.choice(DAYS)
        if rng.random() < 0.7:  # multi-valued numeric
            doc["scores"] = rng.sample(range(100),
                                       k=rng.randint(1, 4))
        writer.add_document(doc)
        if i == 450:
            writer.commit()  # two segments
    writer.commit()
    return idx


AGGS = {
    "cats": {"type": "terms", "field": "cat", "size": 10},
    "price_hist": {"type": "histogram", "field": "price",
                   "interval": 7.5},
    "price_ranges": {"type": "range", "field": "price",
                     "ranges": [{"to": 25.0},
                                {"from": 20.0, "to": 60.0},
                                {"from": 60.0}]},
    "qty_stats": {"type": "stats", "field": "qty"},
    "qty_count": {"type": "value_count", "field": "qty"},
}

# round-4 widened device coverage — every one of these engages the
# device plan (asserted in test_widened_specs_engage_device_plan)
WIDE_AGGS = {
    "tags": {"type": "terms", "field": "tags"},
    "cats_missing": {"type": "terms", "field": "cat", "missing": "none"},
    "qty_terms": {"type": "terms", "field": "qty"},
    "qty_hist_missing": {"type": "histogram", "field": "qty",
                         "interval": 10.0, "missing": 0,
                         "hard_bounds": {"min": 0, "max": 45}},
    "by_day": {"type": "date_histogram", "field": "day",
               "calendar_interval": "day"},
    "by_12h": {"type": "date_histogram", "field": "day",
               "fixed_interval": "12h"},
    "day_ranges": {"type": "date_range", "field": "qty",
                   "ranges": [{"to": 20}, {"from": 20}]},
    "only_a": {"type": "filter",
               "filter": {"KeywordEq": {"field": "cat", "value": "a"}}},
    "scores_count": {"type": "value_count", "field": "scores"},
    "scores_stats": {"type": "stats", "field": "scores"},
    "tag_count_missing": {"type": "value_count", "field": "tags",
                          "missing": "?"},
    "sig": {"type": "significant_terms", "field": "tags"},
    "sig_bg": {"type": "significant_terms", "field": "cat",
               "background_filter": {"KeywordEq": {"field": "cat",
                                                   "value": "a"}}},
    "rare": {"type": "rare_terms", "field": "cat",
             "max_doc_count": 500},
}

SUB_AGGS = {
    "cats_sub": {"type": "terms", "field": "cat", "aggs": {
        "q": {"type": "stats", "field": "qty"},
        "n": {"type": "value_count", "field": "scores"}}},
    "hist_sub": {"type": "histogram", "field": "qty", "interval": 10.0,
                 "aggs": {"s": {"type": "stats", "field": "scores",
                                "missing": 3}}},
    "range_sub": {"type": "range", "field": "qty",
                  "ranges": [{"to": 25}, {"from": 25}],
                  "aggs": {"s": {"type": "stats", "field": "scores"}}},
    "filter_sub": {"type": "filter",
                   "filter": {"KeywordEq": {"field": "cat",
                                            "value": "b"}},
                   "aggs": {"q": {"type": "stats", "field": "qty"}}},
    "day_sub": {"type": "date_histogram", "field": "day",
                "calendar_interval": "week",
                "aggs": {"n": {"type": "value_count",
                               "field": "qty"}}},
}


def _approx_stats_eq(d, h):
    assert d["count"] == h["count"]
    assert d["min"] == h["min"]
    assert d["max"] == h["max"]
    assert d["sum"] == pytest.approx(h["sum"], rel=1e-5, abs=1e-6)
    assert d["avg"] == pytest.approx(h["avg"], rel=1e-5, abs=1e-6)


def _deep_parity(dev, host, path=""):
    """Counts/keys/min/max exact; any float sum/avg within f32-sum
    tolerance — applied recursively through buckets and sub-aggs."""
    if isinstance(host, dict):
        assert set(dev) == set(host), path
        for k in host:
            _deep_parity(dev[k], host[k], f"{path}.{k}")
    elif isinstance(host, list):
        assert len(dev) == len(host), path
        for i, (d, h) in enumerate(zip(dev, host)):
            _deep_parity(d, h, f"{path}[{i}]")
    elif isinstance(host, float):
        assert dev == pytest.approx(host, rel=1e-5, abs=1e-6), path
    else:
        assert dev == host, path


def _host_run(index, req, monkeypatch):
    monkeypatch.setenv("SEARCHLITE_DEVICE_AGGS", "0")
    host = index.reader().search(req).aggregations
    monkeypatch.delenv("SEARCHLITE_DEVICE_AGGS")
    return host


@pytest.mark.parametrize("query", ["w1", "w2 w9 w17", "w40"])
def test_device_aggs_match_host_collectors(index, query, monkeypatch):
    reader = index.reader()
    req = {"query": query, "limit": 5, "aggs": AGGS}
    dev = reader.search(req).aggregations
    host = _host_run(index, req, monkeypatch)
    assert set(dev) == set(host)
    for name in host:
        if name == "qty_stats":
            _approx_stats_eq(dev[name], host[name])
        else:
            assert dev[name] == host[name], name


@pytest.mark.parametrize("query", ["w1", "w3 w11 w24"])
def test_widened_device_kinds_match_host(index, query, monkeypatch):
    reader = index.reader()
    req = {"query": query, "limit": 5, "aggs": WIDE_AGGS}
    dev = reader.search(req).aggregations
    host = _host_run(index, req, monkeypatch)
    _deep_parity(dev, host)


@pytest.mark.parametrize("query", ["w1", "w5 w31"])
def test_device_subagg_metrics_match_host(index, query, monkeypatch):
    reader = index.reader()
    req = {"query": query, "limit": 5, "aggs": SUB_AGGS}
    dev = reader.search(req).aggregations
    host = _host_run(index, req, monkeypatch)
    _deep_parity(dev, host)


def test_widened_specs_engage_device_plan(index):
    """Every WIDE_AGGS/SUB_AGGS spec must actually plan device-side —
    otherwise the parity tests above silently compare host to host."""
    from searchlite.ops.device_aggs import plan_device_aggs

    reader = index.reader()
    dseg = reader.device_segments[0]
    for name, spec in {**AGGS, **WIDE_AGGS, **SUB_AGGS}.items():
        plan = plan_device_aggs(dseg, {name: spec}, strict=False)
        assert plan is not None and len(plan) == 1, name


def test_nonroundtrip_floats_fall_back(index):
    """price holds 2-decimal floats that don't round-trip f32 → stats
    device min/max would be inexact → the plan must refuse."""
    from searchlite.ops.device_aggs import plan_device_aggs

    reader = index.reader()
    dseg = reader.device_segments[0]
    assert plan_device_aggs(
        dseg, {"p": {"type": "stats", "field": "price"}},
        strict=False) is None
    # ... and the host path still serves it correctly
    req = {"query": "w2", "limit": 3,
           "aggs": {"p": {"type": "stats", "field": "price"}}}
    got = reader.search(req).aggregations
    assert got["p"]["count"] > 0


def test_strict_mode_keeps_stats_on_host(index):
    from searchlite.ops.device_aggs import plan_device_aggs

    reader = index.reader()
    dseg = reader.device_segments[0]
    assert plan_device_aggs(
        dseg, {"q": {"type": "stats", "field": "qty"}},
        strict=True) is None
    assert plan_device_aggs(
        dseg, {"c": {"type": "terms", "field": "cat", "aggs": {
            "q": {"type": "stats", "field": "qty"}}}},
        strict=True) is None
    # counts stay device-able under strict
    assert plan_device_aggs(
        dseg, {"c": {"type": "terms", "field": "cat"},
               "n": {"type": "value_count", "field": "qty"}},
        strict=True) is not None


def test_vcap_exceeded_falls_back(index, monkeypatch):
    """A doc with more distinct buckets than the V cap forces host."""
    from searchlite.ops.device_aggs import plan_device_aggs

    monkeypatch.setenv("SEARCHLITE_DEVICE_AGG_VCAP", "1")
    reader = index.reader()
    dseg = reader.device_segments[0]
    dseg._agg_structs = {}  # drop caches built with the default cap
    assert plan_device_aggs(
        dseg, {"t": {"type": "terms", "field": "tags"}},
        strict=False) is None
    req = {"query": "w3", "limit": 5,
           "aggs": {"t": {"type": "terms", "field": "tags"}}}
    got = reader.search(req).aggregations
    monkeypatch.delenv("SEARCHLITE_DEVICE_AGG_VCAP")
    dseg._agg_structs = {}
    host = _host_run(index, req, monkeypatch)
    assert got == host


def test_significant_terms_bg_refreshes_after_delete(monkeypatch):
    """significant_terms background counts are live-doc statics; a
    tombstone commit clones the DeviceSegment and must NOT reuse the
    stale background cache (clone_with_tombstones resets it)."""
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "keyword_fields": [{"name": "cat", "stored": False,
                                "indexed": True, "fast": True}]}))
    writer = idx.writer()
    for i in range(60):
        writer.add_document({"_id": str(i), "body": "hit",
                             "cat": "a" if i % 3 else "b"})
    writer.commit()
    req = {"query": "hit", "limit": 1, "aggs": {
        "sig": {"type": "significant_terms", "field": "cat"}}}
    before = idx.reader().search(req).aggregations
    assert before["sig"]["bg_count"] == 60
    for i in range(0, 60, 2):
        writer.delete_document(str(i))
    writer.commit()
    after = idx.reader().search(req).aggregations
    host = None
    monkeypatch.setenv("SEARCHLITE_DEVICE_AGGS", "0")
    host = idx.reader().search(req).aggregations
    assert after == host
    assert after["sig"]["bg_count"] == 30


def test_sampling_and_unsupported_kinds_fall_back(index, monkeypatch):
    reader = index.reader()
    req = {"query": "w5", "limit": 5, "aggs": {
        "sampled": {"type": "terms", "field": "cat",
                    "sampling": {"size": 50, "seed": 7}},
        "card": {"type": "cardinality", "field": "cat"},
    }}
    got = reader.search(req).aggregations
    host = _host_run(index, req, monkeypatch)
    assert got == host


def test_device_aggs_with_filter_and_pipeline(index, monkeypatch):
    """Root filter shrinks the mask before aggregation; sibling
    pipeline aggs consume device-built responses."""
    req = {"query": "w1 w2 w3", "limit": 3,
           "filter": {"KeywordEq": {"field": "cat", "value": "a"}},
           "aggs": {
               "hist": {"type": "histogram", "field": "price",
                        "interval": 20.0},
               "total": {"type": "sum_bucket",
                         "buckets_path": "hist>_count"},
           }}
    reader = index.reader()
    dev = reader.search(req).aggregations
    host = _host_run(index, req, monkeypatch)
    assert dev == host
