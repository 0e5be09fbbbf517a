"""Host tier: small fresh segments serve from the host cpu backend.

Segments under SEARCHLITE_HOST_TIER_DOCS docs commit their arrays to a
cpu device instead of the default accelerator (reader.py::
_host_tier_device, DeviceSegment(device=...)) — a live-ingest serving
feature with no reference counterpart (the reference is a CPU engine
throughout; here it removes the post-commit upload/remote-compile
cliff for realtime segments). Results must be identical to normal
placement on every surface: the tier changes WHERE a segment computes,
never what it returns.

These tests run on the 8-device virtual cpu mesh;
``SEARCHLITE_HOST_TIER=force`` places tier segments on the LAST cpu
device while the default backend stays device 0, driving the real
committed-placement + exec_scope + routing machinery without
accelerator hardware.
"""

import random

import numpy as np
import pytest

import searchlite.api.reader as reader_mod
from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema
from searchlite.parallel.mesh import make_mesh
from tests.test_sparse_batch import (
    assert_same,
    build_index,
    make_queries,
)


def build_rich_index(seed=31, n_docs=1200, split_at=None):
    """Two-segment index with text + keyword/numeric fast fields, so
    the filter/agg/sort/collapse surfaces have something to chew."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(120)]
    probs = 1.0 / np.arange(1, len(vocab) + 1)
    probs /= probs.sum()
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "keyword_fields": [{"name": "tag", "stored": False,
                                "indexed": True, "fast": True}],
            "numeric_fields": [{"name": "price", "i64": False,
                                "stored": False, "fast": True}],
        }))
    writer = idx.writer()
    for i in range(n_docs):
        n = int(rng.integers(4, 40))
        writer.add_document({
            "_id": str(i),
            "body": " ".join(rng.choice(vocab, size=n, p=probs)),
            "tag": f"g{i % 5}",
            "price": float(np.round(rng.uniform(0, 100), 2)),
        })
        if i == (split_at or n_docs // 2):
            writer.commit()
    writer.commit()
    w2 = idx.writer()
    for i in range(0, n_docs, 13):
        w2.delete_document(str(i))
    w2.commit()
    return idx


@pytest.fixture()
def tiered(monkeypatch):
    """Enable forced host-tier placement and give this test a clean
    process-wide segment cache (placement is part of the cache key,
    but the cache is capped — keep tests independent)."""
    monkeypatch.setenv("SEARCHLITE_HOST_TIER", "force")
    monkeypatch.setenv("SEARCHLITE_HOST_TIER_DOCS", "16384")
    saved = dict(reader_mod._GLOBAL_SEGMENTS)
    saved_base = dict(reader_mod._GLOBAL_BASE)
    reader_mod._GLOBAL_SEGMENTS.clear()
    reader_mod._GLOBAL_BASE.clear()
    yield
    reader_mod._GLOBAL_SEGMENTS.clear()
    reader_mod._GLOBAL_BASE.clear()
    reader_mod._GLOBAL_SEGMENTS.update(saved)
    reader_mod._GLOBAL_BASE.update(saved_base)


@pytest.fixture(scope="module")
def rich_index():
    return build_rich_index()


@pytest.fixture(scope="module")
def index():
    return build_index(seed=17, n_docs=1200, segments=2, delete_every=13)


def _tier_reader(index):
    r = index.reader()
    placed = [d for d in r.device_segments if d.device is not None]
    assert placed, "host tier did not place any segment"
    import jax

    last_cpu = jax.local_devices(backend="cpu")[-1]
    assert all(d.device == last_cpu for d in placed)
    return r


def _plain_reader(index, monkeypatch):
    monkeypatch.setenv("SEARCHLITE_HOST_TIER_DOCS", "0")
    reader_mod._GLOBAL_SEGMENTS.clear()
    reader_mod._GLOBAL_BASE.clear()
    r = index.reader()
    assert all(d.device is None for d in r.device_segments)
    monkeypatch.setenv("SEARCHLITE_HOST_TIER_DOCS", "16384")
    reader_mod._GLOBAL_SEGMENTS.clear()
    reader_mod._GLOBAL_BASE.clear()
    return r


def test_placement_and_residency(rich_index, tiered):
    """Tier segments' arrays are committed to the tier device — the
    whole per-segment execution stays off the default device."""
    r = _tier_reader(rich_index)
    dseg = r.device_segments[0]
    for arr in (dseg.deleted, dseg.doc_len, dseg.block_docs,
                dseg.block_impacts):
        assert arr.devices() == {dseg.device}
    # impacts stay f32 on the host tier even when accelerators would
    # quantize (no HBM/link bandwidth to save)
    assert dseg.block_impacts.dtype == np.float32
    # results of a tier search live on the tier device until fetched
    out = r.search({"query": "w3 w17", "limit": 5})
    assert out.to_json()["hits"]


def test_search_surfaces_identical(rich_index, tiered, monkeypatch):
    """Filters, aggs, phrases, sort, collapse: tier placement must not
    change a single byte of the response."""
    requests = [
        {"query": "w3 w17", "limit": 10},
        {"query": '"w3 w5"', "limit": 10},
        {"query": "w2 w9 w31", "limit": 8,
         "filter": {"F64Range": {"field": "price", "min": 10.0,
                                 "max": 90.0}},
         "aggs": {"tags": {"type": "terms", "field": "tag"},
                  "p": {"type": "stats", "field": "price"}}},
        {"query": "w4", "limit": 6,
         "sort": [{"field": "price", "order": "asc"}]},
        {"query": "w6 w2", "limit": 5,
         "collapse": {"field": "tag"}},
    ]
    r_tier = _tier_reader(rich_index)
    got = [r_tier.search(dict(q)).to_json() for q in requests]
    r_plain = _plain_reader(rich_index, monkeypatch)
    want = [r_plain.search(dict(q)).to_json() for q in requests]
    assert got == want


def test_cursor_drain_identical(rich_index, tiered, monkeypatch):
    def drain(r):
        pages, cursor = [], None
        for _ in range(5):
            req = {"query": "w2 w3 w5", "limit": 7}
            if cursor:
                req["cursor"] = cursor
            out = r.search(req).to_json()
            pages.append(out["hits"])
            cursor = out.get("cursor")
            if not cursor:
                break
        return pages

    got = drain(_tier_reader(rich_index))
    want = drain(_plain_reader(rich_index, monkeypatch))
    assert got == want


def test_batch_identical(index, tiered, monkeypatch):
    queries = make_queries(random.Random(5), 48)
    r_tier = _tier_reader(index)
    got = r_tier.search_batch(queries, limit=10)
    got_arrays = r_tier.search_batch_many(
        [queries], limit=10, output="arrays")[0]
    r_plain = _plain_reader(index, monkeypatch)
    want = r_plain.search_batch(queries, limit=10)
    want_arrays = r_plain.search_batch_many(
        [queries], limit=10, output="arrays")[0]
    assert_same(want, got)
    np.testing.assert_array_equal(got_arrays[1], want_arrays[1])
    np.testing.assert_array_equal(got_arrays[2], want_arrays[2])
    np.testing.assert_allclose(got_arrays[0], want_arrays[0],
                               rtol=1e-6)


def test_mesh_untouched_by_tier(index, tiered, monkeypatch):
    """Mesh execution reads host numpy copies and shards them itself —
    tier placement must not change sharded results (and must not break
    the mesh path with committed-device operands)."""
    mesh = make_mesh(8, query_axis=1)
    queries = make_queries(random.Random(6), 24)
    r_tier = _tier_reader(index)
    single = r_tier.search_batch(queries, limit=10)
    sharded = r_tier.search_batch(queries, limit=10, mesh=mesh)
    assert_same(single, sharded)
    out_single = r_tier.search({"query": "w2 w7", "limit": 10}).to_json()
    out_mesh = r_tier.search({"query": "w2 w7", "limit": 10},
                             mesh=mesh).to_json()
    assert out_single == out_mesh


def test_mixed_tiers_merge(tiered, monkeypatch):
    """A big (normal-tier) segment plus a small (host-tier) segment in
    one index: cross-tier result merging is exact."""
    monkeypatch.setenv("SEARCHLITE_HOST_TIER_DOCS", "400")
    reader_mod._GLOBAL_SEGMENTS.clear()
    reader_mod._GLOBAL_BASE.clear()
    idx = build_rich_index(seed=23, n_docs=900, split_at=300)
    r = idx.reader()
    tiers = {d.device is not None for d in r.device_segments}
    assert tiers == {True, False}, (
        "expected both tiers present: "
        f"{[(d.n_docs, d.device) for d in r.device_segments]}")
    queries = ("w2 w5", "w3", "w7 w11 w2")
    got = [r.search({"query": q, "limit": 10}).to_json()
           for q in queries]
    monkeypatch.setenv("SEARCHLITE_HOST_TIER_DOCS", "0")
    reader_mod._GLOBAL_SEGMENTS.clear()
    reader_mod._GLOBAL_BASE.clear()
    r_plain = idx.reader()
    want = [r_plain.search({"query": q, "limit": 10}).to_json()
            for q in queries]
    assert got == want
