"""The C++ CPU baseline engine (native/slt_cpu_engine.cpp) must return
the exact top-k the device paths return, in all three modes — it is the
measured stand-in for the reference's CPU engine (BASELINE.md), so its
correctness is what makes the baseline comparison meaningful."""

import random

import numpy as np
import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema

pytestmark = pytest.mark.skipif(
    __import__("searchlite.native", fromlist=["build_cpu_engine_lib"]
               ).build_cpu_engine_lib() is None,
    reason="no C++ toolchain")


@pytest.fixture(scope="module")
def index():
    rng = random.Random(77)
    vocab = [f"w{i}" for i in range(80)]
    # zipf-ish skew so wand/bmw bounds actually bite
    weights = [1.0 / (i + 1) for i in range(80)]
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}]}))
    writer = idx.writer()
    for i in range(800):
        n = rng.randint(4, 30)
        writer.add_document({
            "_id": str(i),
            "body": " ".join(rng.choices(vocab, weights=weights, k=n)),
        })
    writer.commit()
    return idx


def test_cpu_engine_matches_reader_all_modes(index):
    from searchlite.native import CpuEngine

    rng = random.Random(78)
    reader = index.reader()
    seg = reader.segments[0]
    eng = CpuEngine(seg)
    queries = [" ".join(rng.sample([f"w{i}" for i in range(80)],
                                   k=rng.randint(1, 5)))
               for _ in range(40)]
    expected = reader.search_batch(queries, limit=10)
    qtids = np.full((len(queries), 5), -1, dtype=np.int32)
    for qi, q in enumerate(queries):
        for ti, tok in enumerate(q.split()):
            qtids[qi, ti] = eng.tid(f"body:{tok}")
    for mode in ("bm25", "wand", "bmw"):
        ids, scores = eng.search_batch(qtids, k=10, mode=mode)
        for qi, exp in enumerate(expected):
            got = [(seg.doc_id(int(d)), float(s))
                   for d, s in zip(ids[qi], scores[qi]) if d >= 0]
            assert [d for d, _ in got] == [d for d, _ in exp], \
                f"mode={mode} q={queries[qi]!r}"
            for (gd, gs), (ed, es) in zip(got, exp):
                assert gs == pytest.approx(es, rel=1e-5, abs=1e-5)


def test_cpu_engine_ties_resolve_doc_asc(index):
    """Duplicate docs produce exact score ties; order must be doc asc."""
    from searchlite.native import CpuEngine

    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}]}))
    writer = idx.writer()
    for i in range(30):
        writer.add_document({"_id": str(i), "body": "alpha beta"})
    writer.commit()
    reader = idx.reader()
    seg = reader.segments[0]
    eng = CpuEngine(seg)
    qt = np.asarray([[eng.tid("body:alpha"), -1]], dtype=np.int32)
    for mode in ("bm25", "wand", "bmw"):
        ids, scores = eng.search_batch(qt, k=10, mode=mode)
        kept = [int(d) for d in ids[0] if d >= 0]
        assert kept == sorted(kept) == list(range(10)), mode
