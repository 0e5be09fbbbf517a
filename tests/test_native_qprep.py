"""Native batched query prep (native/slt_ingest.cpp slt_qprep_*)
equivalence vs the Python analyze + build path.

The native path must produce a qb whose per-query (term-id, weight)
rows, q_nblk, and slot metadata are semantically identical to
build_impact_batch over _analyze_batches output (slot NUMBERING may
differ — it's an internal densification detail), and search_batch
results must be bit-identical with the fast path on or off.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema

pytestmark = pytest.mark.skipif(
    __import__("searchlite.native", fromlist=["get_lib"]).get_lib()
    is None, reason="native toolchain unavailable")


def make_index(schema_json, docs):
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json(schema_json))
    writer = idx.writer()
    for d in docs:
        writer.add_document(d)
    writer.commit()
    return idx


def qb_rows(qb):
    """Per-query {tid: weight} dicts (slot-numbering independent)."""
    tids = np.asarray(qb["slot_tids"])
    out = []
    for qi in range(qb["n_queries"]):
        lo, hi = int(qb["qs_start"][qi]), int(qb["qs_start"][qi + 1])
        out.append({int(tids[s]): float(w)
                    for s, w in zip(qb["qs_slot"][lo:hi],
                                    qb["qs_w"][lo:hi])})
    return out


def assert_qb_equiv(seg, dseg, reader, queries, fields):
    from searchlite.ops.impact import (
        build_impact_batch,
        build_impact_batch_native,
    )

    nat = build_impact_batch_native(
        seg, dseg, queries, fields, reader.analysis, reader.schema)
    assert nat is not None, "native path unexpectedly rejected batch"
    analyzed = reader._analyze_batches([queries], fields)[0]
    ref = build_impact_batch(seg, dseg, analyzed)
    assert nat["n_queries"] == ref["n_queries"]
    nat_rows = qb_rows(nat)
    ref_rows = qb_rows(ref)
    for qi, (a, b) in enumerate(zip(nat_rows, ref_rows)):
        assert a == b, f"query {qi}: {queries[qi]!r}: {a} != {b}"
    assert np.array_equal(nat["q_nblk"], ref["q_nblk"])
    # slot metadata agrees per tid
    for qb in (nat, ref):
        tids = np.asarray(qb["slot_tids"])
        pb = seg.postings
        assert np.array_equal(
            np.asarray(qb["slot_bcnt"]), pb.term_block_count[tids])
        assert np.array_equal(
            np.asarray(qb["slot_len_list"]), pb.term_df[tids])
    return nat


@pytest.fixture(scope="module")
def default_index():
    rng = random.Random(5)
    vocab = [f"w{i}" for i in range(150)]
    docs = [{"_id": str(i),
             "body": " ".join(rng.choices(vocab, k=rng.randint(2, 30))),
             "title": " ".join(rng.choices(vocab, k=3))}
            for i in range(800)]
    return make_index({
        "text_fields": [
            {"name": "body", "analyzer": "default", "stored": False,
             "indexed": True},
            {"name": "title", "analyzer": "default", "stored": False,
             "indexed": True},
        ]}, docs)


def test_equiv_default_analyzer(default_index):
    rng = random.Random(7)
    reader = default_index.reader()
    dseg = reader.device_segments[0]
    seg = dseg.reader
    queries = []
    for _ in range(300):
        n = rng.randint(1, 6)
        terms = []
        for _ in range(n):
            r = rng.random()
            if r < 0.75:
                terms.append(f"w{rng.randint(0, 160)}")  # some missing
            elif r < 0.85:
                terms.append(f"W{rng.randint(0, 150)}")  # uppercase
            elif r < 0.95:
                terms.append(f"w{rng.randint(0, 99)}.x")  # punctuation
            else:
                terms.append(terms[-1] if terms else "w1")  # repeats
        queries.append(" ".join(terms))
    queries.append("")          # empty query
    queries.append("   ")       # whitespace only
    queries.append("w1 w1 w1")  # triple repeat
    assert_qb_equiv(seg, dseg, reader, queries, ["body", "title"])
    assert_qb_equiv(seg, dseg, reader, queries, ["body"])


def test_native_rejects_special_syntax(default_index):
    from searchlite.ops.impact import build_impact_batch_native

    reader = default_index.reader()
    dseg = reader.device_segments[0]
    seg = dseg.reader
    for bad in ['body:w1', 'w1 -w2', 'a "b c"', "café"]:
        assert build_impact_batch_native(
            seg, dseg, ["w1", bad], ["body"], reader.analysis,
            reader.schema) is None


def test_equiv_english_chain():
    rng = random.Random(11)
    words = ["the", "and", "running", "jumps", "quickly", "searches",
             "engine", "connection", "flies", "happiness", "cats"]
    docs = [{"_id": str(i),
             "body": " ".join(rng.choices(words, k=rng.randint(3, 20)))}
            for i in range(400)]
    idx = make_index({
        "text_fields": [{"name": "body", "analyzer": "en_stem",
                         "stored": False, "indexed": True}],
        "analyzers": [{
            "name": "en_stem",
            "tokenizer": "default",
            "filters": ["lowercase",
                        {"stopwords": "english"},
                        {"stemmer": "english"}],
        }]}, docs)
    reader = idx.reader()
    dseg = reader.device_segments[0]
    seg = dseg.reader
    queries = [" ".join(rng.choices(words + ["Walking", "JUMPED"],
                                    k=rng.randint(1, 5)))
               for _ in range(200)]
    assert_qb_equiv(seg, dseg, reader, queries, ["body"])


def test_search_batch_results_identical(default_index, monkeypatch):
    rng = random.Random(13)
    reader = default_index.reader()
    queries = [" ".join(f"w{rng.randint(0, 160)}"
                        for _ in range(rng.randint(1, 5)))
               for _ in range(64)]
    fast = reader.search_batch(queries, limit=7)
    monkeypatch.setenv("SEARCHLITE_DISABLE_NATIVE_QPREP", "1")
    slow = reader.search_batch(queries, limit=7)
    assert fast == slow
