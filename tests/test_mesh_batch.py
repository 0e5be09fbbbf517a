"""Batched search doc-sharded over a device mesh
(``search_batch_many(mesh=)``): the flagship batched workload must
return exactly the single-chip batch API's results. Light rows ride the
sharded packed candidate scorer (parallel/query.py::
make_sharded_batch_scorer, local strips + collective top-k merge); the heavy
remainder runs the single-chip dense scorers; rows stitch back into
batch order on host. Reference batched contract: one-query-at-a-time
loop over `query/wand.rs:459-566` with the (score desc, doc asc) merge.
"""

import random

import numpy as np
import pytest

from searchlite.parallel.mesh import make_mesh
from tests.test_sparse_batch import (
    VOCAB,
    assert_same,
    build_index,
    make_queries,
)


@pytest.fixture(scope="module")
def index():
    return build_index(seed=9, n_docs=1600, segments=2, delete_every=11)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, query_axis=1)


def run_mesh_vs_single(reader, queries, limit, mesh, monkeypatch,
                       cap=None, **kw):
    if cap is not None:
        monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", str(cap))
    single = reader.search_batch(queries, limit=limit, **kw)
    sharded = reader.search_batch(queries, limit=limit, mesh=mesh, **kw)
    return single, sharded


def test_mesh_matches_single_chip(index, mesh, monkeypatch):
    reader = index.reader()
    queries = make_queries(random.Random(3), 40)
    single, sharded = run_mesh_vs_single(reader, queries, 10, mesh,
                                         monkeypatch)
    assert_same(single, sharded)


def test_mesh_light_heavy_mix(index, mesh, monkeypatch):
    """Tiny per-shard caps force head-term rows through the dense
    remainder while tail rows stay on the sharded strips; the stitched
    batch must match the single-chip results at every cap."""
    reader = index.reader()
    queries = make_queries(random.Random(4), 32)
    for cap in (1, 2, 6):
        single, sharded = run_mesh_vs_single(reader, queries, 7, mesh,
                                             monkeypatch, cap=cap)
        assert_same(single, sharded)


def test_mesh_edge_queries(index, mesh, monkeypatch):
    reader = index.reader()
    queries = [
        "",                      # no terms
        "zzz_not_in_vocab",      # unknown term
        "w0",                    # head term
        "w149 w149 w149",        # repeated term: occ>1 packed weights
        " ".join(VOCAB[140:149]),  # many tail terms
    ]
    single, sharded = run_mesh_vs_single(reader, queries, 10, mesh,
                                         monkeypatch, cap=4)
    assert_same(single, sharded)


def test_mesh_per_query_limits_and_wand(index, mesh, monkeypatch):
    reader = index.reader()
    queries = make_queries(random.Random(5), 12)
    limits = [1 + (i % 7) for i in range(len(queries))]
    single = reader.search_batch(queries, limit=8, limits=limits)
    for execution in ("bm25", "wand", "bmw"):
        sharded = reader.search_batch(queries, limit=8, limits=limits,
                                      mesh=mesh, execution=execution)
        assert_same(single, sharded)


def _arrays_to_rows(reader, s, d, g):
    rows = []
    for qi in range(s.shape[0]):
        n = int((s[qi] != -np.inf).sum())
        rows.append([
            (reader.segments[int(g[qi, j])].doc_id(int(d[qi, j])),
             float(s[qi, j])) for j in range(n)])
    return rows


def test_mesh_arrays_output(index, mesh):
    reader = index.reader()
    queries = make_queries(random.Random(6), 16)
    (s1, d1, g1), = reader.search_batch_many([queries], limit=10,
                                             output="arrays")
    (s2, d2, g2), = reader.search_batch_many([queries], limit=10,
                                             output="arrays", mesh=mesh)
    assert s1.shape == s2.shape
    # per-position doc identity with the tie-aware comparator — a
    # different doc is only legal where the two scores genuinely tie
    assert_same(_arrays_to_rows(reader, s1, d1, g1),
                _arrays_to_rows(reader, s2, d2, g2))


def test_mesh_batch_stream(index, mesh, monkeypatch):
    """Multi-batch streams dispatch everything before one bulk fetch;
    results must still stitch back per batch."""
    reader = index.reader()
    rng = random.Random(7)
    batches = [make_queries(rng, 9) for _ in range(4)]
    single = reader.search_batch_many(batches, limit=6)
    sharded = reader.search_batch_many(batches, limit=6, mesh=mesh)
    for s_batch, m_batch in zip(single, sharded):
        assert_same(s_batch, m_batch)


def test_mesh_dense_remainder_matches_fallback(index, mesh,
                                               monkeypatch):
    """Heavy rows run doc-sharded dense scoring (per-chip M +
    all_gather merge); forcing the single-chip fallback
    (SEARCHLITE_MESH_DENSE=0) must give the same results."""
    reader = index.reader()
    queries = ["w0", "w0 w1", "w1 w2 w3"] + make_queries(
        random.Random(10), 13)
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "1")
    monkeypatch.setenv("SEARCHLITE_MESH_DENSE", "0")
    fallback = reader.search_batch(queries, limit=9, mesh=mesh)
    monkeypatch.setenv("SEARCHLITE_MESH_DENSE", "1")
    sharded = reader.search_batch(queries, limit=9, mesh=mesh)
    assert_same(fallback, sharded)


def test_mesh_smaller_than_eight(index, monkeypatch):
    reader = index.reader()
    queries = make_queries(random.Random(8), 10)
    for n in (2, 4):
        mesh_n = make_mesh(n, query_axis=1)
        single, sharded = run_mesh_vs_single(
            reader, queries, 10, mesh_n, monkeypatch)
        assert_same(single, sharded)


def test_mesh_empty_index(mesh):
    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}]}))
    reader = idx.reader()
    assert reader.search_batch(["a b"], limit=5, mesh=mesh) == [[]]
    (s, d, g), = reader.search_batch_many(
        [["a", "b c"]], limit=3, output="arrays", mesh=mesh)
    assert s.shape == (2, 3) and (s == -np.inf).all()
