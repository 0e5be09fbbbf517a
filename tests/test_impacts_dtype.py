"""Device impact-storage dtype (ops/precision.py::impacts_store_dtype).

On accelerators the device copies of posting impacts store bf16 in the
fast precision modes (divergence D8): upload, device memory and gather
traffic halve, at bf16 rounding of each stored impact. These tests force the bf16
layout on the CPU backend and pin (a) results within the D8 tolerance
of the f32 run across the dense, sparse, pruned, and sharded paths,
and (b) internal consistency between execution paths under the SAME
storage."""

import numpy as np
import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema

VOCAB = [f"w{i}" for i in range(100)]
RTOL = 2 ** -7  # bf16 mantissa step with headroom


def build_index(n_docs=1200):
    rng = np.random.default_rng(31)
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
        n = int(rng.integers(5, 40))
        writer.add_document(
            {"_id": str(i),
             "body": " ".join(rng.choice(VOCAB, size=n, p=probs))})
    writer.commit()
    return idx


QUERIES = ["w1 w7", "w3", "w20 w40 w60", "w2 w2 w5", "w90 w91"] * 6


def scores_close(a_rows, b_rows):
    assert len(a_rows) == len(b_rows)
    for ar, br in zip(a_rows, b_rows):
        a = {d: s for d, s in ar}
        b = {d: s for d, s in br}
        # top-k sets may swap true near-ties under quantization; every
        # common doc's score must agree to bf16 tolerance
        common = set(a) & set(b)
        assert len(common) >= max(len(a) - 2, 0)
        for d in common:
            assert abs(a[d] - b[d]) <= 1e-4 + RTOL * abs(b[d])


@pytest.fixture(scope="module")
def index():
    return build_index()


def _fresh_reader(index, monkeypatch, dtype):
    # new reader; the process-wide segment upload cache keys by
    # segment, so evict device copies to force re-upload in the new
    # dtype
    monkeypatch.setenv("SEARCHLITE_DEVICE_IMPACTS", dtype)
    reader = index.reader()
    for dseg in reader.device_segments:
        dseg.evict_device_caches()
    return reader


def test_batched_paths_match_f32_within_tolerance(index, monkeypatch):
    r32 = _fresh_reader(index, monkeypatch, "f32")
    base = r32.search_batch(QUERIES, limit=10)
    rbf = _fresh_reader(index, monkeypatch, "bf16")
    got = rbf.search_batch(QUERIES, limit=10)
    import jax.numpy as jnp

    assert rbf.device_segments[0].block_impacts.dtype == jnp.bfloat16
    scores_close(got, base)
    # sparse and dense paths under the SAME bf16 storage agree
    monkeypatch.setenv("SEARCHLITE_SPARSE_MAX_BLOCKS", "0")
    dense = rbf.search_batch(QUERIES, limit=10)
    monkeypatch.delenv("SEARCHLITE_SPARSE_MAX_BLOCKS")
    scores_close(got, dense)
    # restore f32 device copies for other tests
    _fresh_reader(index, monkeypatch, "f32")


def test_single_and_pruned_match_f32_within_tolerance(index,
                                                      monkeypatch):
    r32 = _fresh_reader(index, monkeypatch, "f32")
    base = [r32.search({"query": q, "limit": 10}) for q in QUERIES[:6]]
    base_rows = [[(h.doc_id, h.score) for h in r.hits] for r in base]
    rbf = _fresh_reader(index, monkeypatch, "bf16")
    for execution, label in (("bm25", "dense"), ("bmw", "pruned")):
        rows = []
        for q in QUERIES[:6]:
            res = rbf.search({"query": q, "limit": 10,
                              "execution": execution})
            rows.append([(h.doc_id, h.score) for h in res.hits])
        scores_close(rows, base_rows)
    _fresh_reader(index, monkeypatch, "f32")


def test_strict_mode_keeps_f32(monkeypatch):
    monkeypatch.setenv("SEARCHLITE_PRECISION", "f32_strict")
    monkeypatch.setenv("SEARCHLITE_DEVICE_IMPACTS", "bf16")
    import jax.numpy as jnp

    from searchlite.ops.precision import impacts_store_dtype

    assert impacts_store_dtype() == jnp.float32
