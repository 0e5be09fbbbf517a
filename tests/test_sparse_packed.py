"""Packed sparse-candidate upload (ops/sparse.py packed path) vs the
explicit-table path.

The packed path uploads one [Bl, t_pad] int32 of (tid | occ << 26) per
batch and gathers block ranges + f32 idf from the segment-resident tid
table (DeviceSegment.sparse_tid_tbl); weights are recomputed on device
as f32(occ) * f32(idf), with double-rounding disagreements vs the host
definition f32(occ * f64(idf)) shipped as exact-weight overrides. These
tests pin BIT-IDENTICAL results between the two uploads, the override
machinery itself, and the fallback guards (wide tids / huge occurrence
counts)."""

import random

import numpy as np
import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema
from searchlite.ops.sparse import (
    OCC_MAX,
    TID_BITS,
    TID_LIMIT,
    make_sparse_candidate_scorer,
    make_sparse_candidate_scorer_packed,
    partition_sparse_batch,
    partition_sparse_batch_packed,
)

VOCAB = [f"w{i}" for i in range(120)]


def build_index(seed=9, n_docs=1500, segments=2, delete_every=17):
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
        n = int(rng.integers(4, 40))
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


def make_queries(rng, n, max_terms=5, dup_rate=0.3):
    """Random queries, a fraction with deliberately repeated terms
    (occ > 1 exercises the device weight recomputation)."""
    out = []
    for _ in range(n):
        t = rng.randint(1, max_terms)
        terms = [rng.choice(VOCAB) for _ in range(t)]
        if rng.random() < dup_rate and terms:
            terms += [terms[0]] * rng.randint(1, 3)
        out.append(" ".join(terms))
    return out


def run_both(reader, queries, limit, monkeypatch):
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "64")
    monkeypatch.setenv("SEARCHLITE_SPARSE_PACKED", "0")
    explicit = reader.search_batch(queries, limit=limit)
    monkeypatch.setenv("SEARCHLITE_SPARSE_PACKED", "1")
    packed = reader.search_batch(queries, limit=limit)
    return explicit, packed


def assert_identical(explicit, packed):
    assert len(explicit) == len(packed)
    for e_row, p_row in zip(explicit, packed):
        assert [d for d, _ in e_row] == [d for d, _ in p_row]
        es = np.asarray([s for _, s in e_row], dtype=np.float32)
        ps = np.asarray([s for _, s in p_row], dtype=np.float32)
        assert np.array_equal(es.view(np.int32), ps.view(np.int32))


@pytest.fixture(scope="module")
def index():
    return build_index()


def test_packed_matches_explicit(index, monkeypatch):
    rng = random.Random(3)
    reader = index.reader()
    queries = make_queries(rng, 64)
    explicit, packed = run_both(reader, queries, 10, monkeypatch)
    assert_identical(explicit, packed)


def test_packed_fuzz(monkeypatch):
    rng = random.Random(17)
    for seed in (1, 2):
        idx = build_index(seed=seed, n_docs=800,
                          segments=rng.choice((1, 2)),
                          delete_every=rng.choice((0, 11)))
        reader = idx.reader()
        for limit in (1, 7, 25):
            queries = make_queries(rng, 40)
            explicit, packed = run_both(reader, queries, limit,
                                        monkeypatch)
            assert_identical(explicit, packed)


def test_partition_emits_packed_tids():
    idx = build_index(n_docs=300, segments=1, delete_every=0)
    reader = idx.reader()
    from searchlite.ops.impact import build_impact_batch

    seg = reader.segments[0]
    dseg = reader.device_segments[0]
    queries = [[("body", "w1"), ("body", "w2"), ("body", "w1")],
               [("body", "w3")]]
    qb = build_impact_batch(seg, dseg, queries, lazy_tables=True)
    pp = partition_sparse_batch_packed(qb, 10_000, dseg.idf32)
    assert pp is not None
    packed = pp["packed"]
    # row 0: w1 carries occ=2, w2 occ=1 (slots are ascending by first
    # appearance order in the dict — decode and check the multiset)
    tids = packed & (TID_LIMIT - 1)
    occs = packed >> TID_BITS
    t_w1 = seg.terms.get("body:w1")
    t_w2 = seg.terms.get("body:w2")
    row0 = {int(t): int(o) for t, o in zip(tids[0], occs[0]) if o > 0}
    assert row0 == {t_w1: 2, t_w2: 1}
    # weight reconstruction: f32(occ)*f32(idf) + overrides == qs_w
    idf32 = dseg.idf32
    w_dev = occs.astype(np.float32) * idf32[tids]
    w_dev[occs == 0] = 0.0
    if pp["n_ovr"]:
        flat = w_dev.reshape(-1)
        ov_idx, ov_w = pp["ovr"][0], pp["ovr"][1].view(np.float32)
        ok = ov_idx < flat.shape[0]
        flat[ov_idx[ok]] = ov_w[ok]
        w_dev = flat.reshape(w_dev.shape)
    # compare against the explicit table's weights
    pe = partition_sparse_batch(qb, 10_000)
    w_exp = pe["tbl"][2].view(np.float32)
    assert np.array_equal(w_dev.view(np.int32), w_exp.view(np.int32))


def test_override_machinery_kernel_level():
    """Force a double-rounding disagreement and check the packed scorer
    reproduces the explicit scorer bit-for-bit through the override
    scatter."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    # find (occ, idf64) with f32(occ*idf) != f32(occ)*f32(idf)
    rng = np.random.default_rng(0)
    found = None
    for _ in range(200_000):
        idf = float(rng.uniform(1.0, 12.0))
        for occ in (3, 5, 7, 9, 11):
            a = np.float32(occ * idf)
            b = np.float32(occ) * np.float32(idf)
            if a.view(np.int32) != b.view(np.int32):
                found = (occ, idf)
                break
        if found:
            break
    assert found is not None, "no double-rounding example found"
    occ, idf = found

    # synthetic one-term segment: 1 posting block, 4 docs
    block_docs = np.full((2, 128), 4, dtype=np.int32)   # 4 = sentinel
    block_docs[0, :4] = np.arange(4)
    block_impacts = np.zeros((2, 128), dtype=np.float32)
    block_impacts[0, :4] = [0.5, 1.0, 0.25, 2.0]
    sent = np.array([1, 4], dtype=np.int32)  # sentinel row, dead doc

    qs_w = np.array([np.float32(occ * idf)], dtype=np.float32)
    qb = {
        "qs_start": np.array([0, 1], dtype=np.int64),
        "qs_slot": np.array([0], dtype=np.int32),
        "qs_w": qs_w,
        "qs_cnt": np.array([occ], dtype=np.int32),
        "slot_tids": np.array([0], dtype=np.int64),
        "slot_bstart": np.array([0], dtype=np.int64),
        "slot_bcnt": np.array([1], dtype=np.int64),
        "q_nblk": np.array([1], dtype=np.int64),
    }
    idf32 = np.array([idf], dtype=np.float32)
    pp = partition_sparse_batch_packed(qb, 8, idf32)
    assert pp is not None and pp["n_ovr"] > 0, \
        "disagreeing weight must emit an override"
    pe = partition_sparse_batch(qb, 8)

    tid_tbl = np.zeros((3, 1024), dtype=np.int32)
    tid_tbl[0, 0] = 0
    tid_tbl[1, 0] = 1
    tid_tbl[2, 0] = idf32.view(np.int32)[0]

    kw = dict(k=4, t_pad=pp["t_pad"], nblk=pp["nblk"],
              log2_run=pp["log2_run"])
    ts_p, td_p = make_sparse_candidate_scorer_packed()(
        jnp.asarray(block_docs), jnp.asarray(block_impacts),
        jnp.asarray(tid_tbl), jnp.asarray(pp["packed"]),
        jnp.asarray(pp["ovr"]), jnp.asarray(sent),
        n_ovr=pp["n_ovr"], **kw)
    ts_e, td_e = make_sparse_candidate_scorer()(
        jnp.asarray(block_docs), jnp.asarray(block_impacts),
        jnp.asarray(pe["tbl"]), jnp.asarray(sent), **kw)
    ts_p, td_p, ts_e, td_e = map(np.asarray, (ts_p, td_p, ts_e, td_e))
    assert np.array_equal(td_p, td_e)
    assert np.array_equal(ts_p.view(np.int32), ts_e.view(np.int32))
    # and the scores really reflect the HOST weight definition
    expect = np.float32(occ * idf) * block_impacts[0, :4]
    assert np.array_equal(
        np.sort(ts_p[0][:4]), np.sort(expect.astype(np.float32)))


def test_tiered_wide_narrow_mix(index, monkeypatch):
    """A head-term (many-block) query mixed into a batch of tiny
    queries lands in its own tier; results must stay identical to the
    explicit single-strip path."""
    reader = index.reader()
    # w0 is the most frequent token (widest posting range); w100+ tiny
    queries = ["w0 w1", "w110 w111", "w112", "w113 w114 w115",
               "w116", "w117 w118"] * 8
    explicit, packed = run_both(reader, queries, 10, monkeypatch)
    assert_identical(explicit, packed)
    # and the tiered partition really produced multiple groups
    from searchlite.ops.impact import build_impact_batch
    from searchlite.ops.sparse import partition_sparse_batch_tiered

    seg = reader.segments[0]
    dseg = reader.device_segments[0]
    analyzed = [[("body", t) for t in q.split()] for q in queries]
    qb = build_impact_batch(seg, dseg, analyzed, lazy_tables=True)
    tp = partition_sparse_batch_tiered(qb, 10_000, dseg.idf32, 10)
    assert tp is not None and len(tp["groups"]) >= 2
    covered = np.sort(np.concatenate(
        [g["pos_in_light"] for g in tp["groups"]]))
    assert np.array_equal(covered,
                          np.arange(len(tp["light_idx"])))


def test_tiered_k_exceeds_small_tier(index, monkeypatch):
    """k larger than a small tier's natural strip width: the tier's
    nblk must be bumped so top_k stays valid, results identical."""
    reader = index.reader()
    queries = ["w115", "w116 w117", "w0 w1 w2"] * 4
    explicit, packed = run_both(reader, queries, 200, monkeypatch)
    assert_identical(explicit, packed)


def test_fallback_guards():
    """Wide tids / huge occurrence counts refuse the packed format."""
    base = {
        "qs_start": np.array([0, 1], dtype=np.int64),
        "qs_slot": np.array([0], dtype=np.int32),
        "qs_w": np.array([1.0], dtype=np.float32),
        "slot_bstart": np.array([0], dtype=np.int64),
        "slot_bcnt": np.array([1], dtype=np.int64),
        "q_nblk": np.array([1], dtype=np.int64),
    }
    idf32 = np.ones(TID_LIMIT + 1, dtype=np.float32)

    qb = dict(base, qs_cnt=np.array([1], dtype=np.int32),
              slot_tids=np.array([TID_LIMIT], dtype=np.int64))
    assert partition_sparse_batch_packed(qb, 8, idf32) is None

    qb = dict(base, qs_cnt=np.array([OCC_MAX + 1], dtype=np.int32),
              slot_tids=np.array([0], dtype=np.int64))
    assert partition_sparse_batch_packed(qb, 8, idf32) is None

    qb = dict(base, slot_tids=np.array([0], dtype=np.int64))
    assert partition_sparse_batch_packed(qb, 8, idf32) is None  # no cnt


def test_zero_entry_rows_do_not_shift_results(index, monkeypatch):
    """Queries whose every term is ABSENT from a segment produce
    0-block light rows. Those rows must land in a tier (and the
    single-tier fast path must count covered ROWS, not compare padded
    shapes) — an ungrouped row used to shift every later row's result
    by one (found by tools/fuzz_matrix.py, seed 20260820)."""
    reader = index.reader()
    # 'zz*' terms exist in no segment; mix them between real queries
    queries = []
    rng = random.Random(5)
    for i in range(48):
        if i % 5 == 2:
            queries.append(f"zz{i} zz{i + 1}")
        else:
            queries.append(" ".join(
                rng.sample(VOCAB, k=rng.randint(1, 3))))
    explicit, packed = run_both(reader, queries, 5, monkeypatch)
    assert_identical(explicit, packed)
    for i in range(48):
        if i % 5 == 2:
            assert packed[i] == []  # absent terms match nothing


def test_all_zero_entry_batch(index, monkeypatch):
    """Every query absent from the index: all rows are 0-block."""
    reader = index.reader()
    queries = [f"zz{i}" for i in range(9)]
    explicit, packed = run_both(reader, queries, 5, monkeypatch)
    assert explicit == packed == [[] for _ in queries]
