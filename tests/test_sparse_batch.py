"""Sparse candidate batch scorer (ops/sparse.py) vs the dense path.

The sparse path scores each query over its own gathered posting strips
only — no [Q, n_docs] score matrix. These tests pin exact agreement
with the dense scorers (which tests/test_batch_search.py pins against
the single-query path) across routing splits, deletions, multi-segment
indexes, and randomized workloads.
"""

import random

import numpy as np
import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema

VOCAB = [f"w{i}" for i in range(150)]


def build_index(seed=5, n_docs=2000, segments=2, delete_every=13):
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, len(VOCAB) + 1)
    probs /= probs.sum()
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}]}))
    writer = idx.writer()
    for i in range(n_docs):
        n = int(rng.integers(4, 50))
        body = " ".join(rng.choice(VOCAB, size=n, p=probs))
        writer.add_document({"_id": str(i), "body": body})
        if segments > 1 and i == n_docs // segments:
            writer.commit()
    writer.commit()
    if delete_every:
        w2 = idx.writer()
        for i in range(0, n_docs, delete_every):
            w2.delete_document(str(i))
        w2.commit()
    return idx


def make_queries(rng, n, max_terms=5):
    out = []
    for _ in range(n):
        t = rng.randint(1, max_terms)
        out.append(" ".join(rng.choice(VOCAB) for _ in range(t)))
    return out


def run_both(reader, queries, limit, monkeypatch, max_blocks):
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "0")
    dense = reader.search_batch(queries, limit=limit)
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", str(max_blocks))
    sparse = reader.search_batch(queries, limit=limit)
    return dense, sparse


def assert_same(dense, sparse, rtol=1e-5, atol=1e-5):
    """Identical rankings up to float near-ties: the sparse path sums
    each doc's contributions as a balanced tree, the dense path as an
    f32 matmul — ~1-ulp differences can swap genuinely-tied docs at a
    rank boundary (divergence D8's tolerance model, like bench.py's
    oracle gate)."""
    for qi, (dr, sr) in enumerate(zip(dense, sparse)):
        assert len(dr) == len(sr), f"q{qi} lengths"
        ds = np.asarray([s for _, s in dr])
        ss = np.asarray([s for _, s in sr])
        assert np.allclose(ds, ss, rtol=rtol, atol=atol), f"q{qi} scores"
        for pos, ((di, dv), (si, sv)) in enumerate(zip(dr, sr)):
            if di != si:
                # a swap/substitution is only legal between near-ties
                assert abs(dv - sv) <= atol + rtol * abs(dv), \
                    f"q{qi} pos{pos}: {di}@{dv} vs {si}@{sv}"


@pytest.fixture(scope="module")
def index():
    return build_index()


def test_all_light_matches_dense(index, monkeypatch):
    reader = index.reader()
    rng = random.Random(1)
    queries = make_queries(rng, 40)
    dense, sparse = run_both(reader, queries, 10, monkeypatch, 10**6)
    assert_same(dense, sparse)


def test_light_heavy_mix_matches_dense(index, monkeypatch):
    """A tiny block cap forces most head-term queries through the
    heavy (dense) fallback while tail queries stay sparse — the
    combined rows must come back in batch order."""
    reader = index.reader()
    rng = random.Random(2)
    queries = make_queries(rng, 48)
    for cap in (1, 2, 4, 8):
        dense, sparse = run_both(reader, queries, 7, monkeypatch, cap)
        assert_same(dense, sparse)


def test_edge_queries(index, monkeypatch):
    reader = index.reader()
    queries = [
        "",                      # no terms
        "zzz_not_in_vocab",      # unknown term
        "w0",                    # head term (heavy at small caps)
        "w149 w149 w149",        # repeated term folds weights
        "w140 w141 w142 w143 w144 w145 w146 w147 w148",  # many terms
    ]
    dense, sparse = run_both(reader, queries, 10, monkeypatch, 4)
    assert_same(dense, sparse)


def test_limit_larger_than_matches(index, monkeypatch):
    reader = index.reader()
    dense, sparse = run_both(reader, ["w149"], 200, monkeypatch, 10**6)
    assert_same(dense, sparse)


def test_deletions_fold_into_sparse_path(monkeypatch):
    idx = build_index(seed=8, n_docs=600, segments=1, delete_every=3)
    reader = idx.reader()
    rng = random.Random(3)
    queries = make_queries(rng, 24)
    dense, sparse = run_both(reader, queries, 10, monkeypatch, 10**6)
    assert_same(dense, sparse)
    deleted = {str(i) for i in range(0, 600, 3)}
    for res in sparse:
        assert not deleted.intersection(d for d, _ in res)


def test_fuzz_random_workloads(monkeypatch):
    for seed in range(4):
        idx = build_index(seed=20 + seed, n_docs=900,
                          segments=1 + seed % 3,
                          delete_every=0 if seed % 2 else 11)
        reader = idx.reader()
        rng = random.Random(seed)
        queries = make_queries(rng, 32, max_terms=7)
        cap = rng.choice([2, 3, 6, 12, 10**6])
        limit = rng.choice([1, 5, 10, 37])
        dense, sparse = run_both(reader, queries, limit, monkeypatch,
                                 cap)
        assert_same(dense, sparse)


def test_oversized_corpus_routes_sparse(index, monkeypatch):
    """A tiny M budget forces the oversized-corpus branch; the sparse
    candidate scorer must route around the shard loop with identical
    results, including when its heavy remainder falls back to the
    doc-sharded scan (tiny cap)."""
    reader = index.reader()
    rng = random.Random(4)
    queries = make_queries(rng, 32)
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "0")
    dense = reader.search_batch(queries, limit=10)
    monkeypatch.setenv("SEARCHLITE_M_BUDGET_BYTES", "20000")
    for cap in ("1000000", "2"):
        monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", cap)
        sparse = reader.search_batch(queries, limit=10)
        assert_same(dense, sparse)


def test_partition_and_subset_shapes():
    """partition_sparse_batch buckets its static shape params and
    subset_impact_batch re-packs a coherent dense qb."""
    from searchlite.ops.impact import (
        build_impact_batch,
        subset_impact_batch,
    )
    from searchlite.ops.sparse import partition_sparse_batch

    idx = build_index(seed=30, n_docs=500, segments=1, delete_every=0)
    reader = idx.reader()
    dseg = reader.device_segments[0]
    seg = dseg.reader
    analyzed = [[("body", "w0"), ("body", "w1")],
                [("body", "w100")],
                [("body", "w3"), ("body", "w100"), ("body", "w50")]]
    qb = build_impact_batch(seg, dseg, analyzed)
    part = partition_sparse_batch(qb, max_blocks=2)
    assert part is not None
    assert set(part["light_idx"]) | set(part["heavy_idx"]) == {0, 1, 2}
    assert part["nblk"] >= 1 and part["t_pad"] >= 2
    bcnt = part["tbl"][1]
    assert (bcnt.sum(axis=1)[:len(part["light_idx"])] > 0).all()
    if len(part["heavy_idx"]):
        hqb = subset_impact_batch(qb, part["heavy_idx"])
        assert hqb["n_queries"] >= len(part["heavy_idx"])
        assert hqb["n_slots"] <= qb["n_slots"]
        assert hqb["n1"] == qb["n1"]


def test_strip_prune_core_certified_rows_exact():
    """The recorded sort-free combine experiment (_strip_prune_core,
    docs/architecture.md "Why the strip sort stays") must stay exact
    on every row its certificate accepts, across synthetic strips —
    the documented claim the probe measured."""
    import numpy as np

    from searchlite.ops.sparse import make_strip_prune_probe
    from tools.probe_strip_prune import build_strips, oracle_topk

    prune, sort_core = make_strip_prune_probe()
    k = 10
    for seed in (1, 9):
        d, v, t_of, sent = build_strips(24, 8, 4, 5001, seed)
        o_s, o_d = oracle_topk(d, v, sent, k)
        import jax
        import jax.numpy as jnp

        for c in (16, 64):
            ts, td, ok = jax.device_get(prune(
                jnp.asarray(d), jnp.asarray(v), jnp.asarray(t_of),
                sent, k=k, c=c, t_pad=4))
            for b in range(24):
                if not ok[b]:
                    continue
                assert list(td[b][: len(o_d[b])]) == o_d[b], (seed, c, b)
                np.testing.assert_allclose(
                    ts[b][: len(o_s[b])], o_s[b], rtol=2e-5, atol=1e-5)
        # the sort core must agree with the oracle on every row
        ts, td, _ = jax.device_get(sort_core(
            jnp.asarray(d), jnp.asarray(v), jnp.asarray(t_of),
            sent, k=k, c=16, t_pad=4))
        for b in range(24):
            assert list(td[b][: len(o_d[b])]) == o_d[b], (seed, b)
