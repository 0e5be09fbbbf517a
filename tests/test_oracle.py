"""The numpy BM25 reference (searchlite/oracle.py) that gates the engine's
answers in chip_smoke.py and bench.py: its scores on hand-checked
postings, and what its top-k gate accepts and rejects."""

import math

import numpy as np
import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema
from searchlite.oracle import Bm25Oracle, Reference, tolerance

DOCS = ["t1 t2", "t1 t1 t3", "t2 t3 t4"]


@pytest.fixture(scope="module")
def oracle():
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({"text_fields": [
            {"name": "body", "analyzer": "default", "stored": False,
             "indexed": True}]}))
    writer = index.writer()
    writer.add_documents([{"_id": str(i), "body": b}
                          for i, b in enumerate(DOCS)])
    writer.commit()
    return Bm25Oracle(index.reader())


def _bm25(tf, df, dl, n=3, avg=8 / 3, k1=0.9, b=0.4):
    idf = max(math.log((n - df + 0.5) / (df + 0.5)), 0.0) + 1.0
    return idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avg))


# by hand: lengths 2, 3, 3; df t1=2, t2=2, t3=2, t4=1
HAND = {
    ("t1",): [_bm25(1, 2, 2), _bm25(2, 2, 3), 0.0],
    ("t4",): [0.0, 0.0, _bm25(1, 1, 3)],
    ("t1", "t3"): [_bm25(1, 2, 2), _bm25(2, 2, 3) + _bm25(1, 2, 3),
                   _bm25(1, 2, 3)],
    ("t2", "t2"): [2 * _bm25(1, 2, 2), 0.0, 2 * _bm25(1, 2, 3)],
    ("t9",): [0.0, 0.0, 0.0],
}


@pytest.mark.parametrize("tokens", list(HAND), ids=" ".join)
def test_scores_match_hand_computed_bm25(oracle, tokens):
    (got,) = oracle.scores(list(tokens))
    order = [oracle.locate(str(i))[1] for i in range(3)]
    np.testing.assert_allclose(got[order], HAND[tokens], rtol=1e-12)


SCORES = [np.array([5.0, 4.995, 3.0, 0.0, 1.0])]


@pytest.mark.parametrize("hits, mode, ok", [
    ([(0, 0, 5.0), (0, 1, 4.995)], "", True),
    # a near tie returned in the other order, with device rounding
    ([(0, 1, 4.99), (0, 0, 4.99)], "", True),
    # a near tie resolved the other way: doc 2 (3.0) is far below
    ([(0, 0, 5.0), (0, 2, 3.0)], "", False),
    ([(0, 0, 5.0), (0, 1, 4.9)], "", False),          # score off
    ([(0, 0, 5.0), (0, 3, 0.0)], "", False),          # not a match
    ([(0, 0, 5.0)], "", False),                       # too few hits
    ([(0, 0, 5.0), (0, 0, 5.0)], "", False),          # duplicate
    # strict f32 tolerates no rounding of the near tie's scores
    ([(0, 1, 4.99), (0, 0, 4.99)], "f32_strict", False),
    ([(0, 1, 4.995), (0, 0, 5.0)], "f32_strict", False),  # out of order
])
def test_gate_accepts_near_ties_and_rejects_misses(hits, mode, ok):
    why = Reference(SCORES, k=2).check(hits, tolerance(mode))
    assert (why is None) == ok, why


def test_gate_with_explicit_match_mask():
    """Cosine-style references: a score may be <= 0 and still match."""
    ref = Reference([np.array([-0.1, -0.3, 0.2])], k=2,
                    match=[np.array([True, False, True])])
    assert ref.check([(0, 2, 0.2), (0, 0, -0.1)], (1e-3, 1e-4)) is None
    assert ref.check([(0, 2, 0.2), (0, 1, -0.3)], (1e-3, 1e-4))
