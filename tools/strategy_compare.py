"""Execution-strategy comparison: bm25 (dense) vs wand vs bmw.

Device-side counterpart of the reference's strategy demo
(`searchlite-core/examples/pruning.rs:13-204`, surfaced at
README.md:1017): build a Zipf corpus, run the same query set under
every execution strategy, and print per-strategy ms/q, scored docs,
and postings advanced (real counters from the profile output — the
pruned strategies run the doc-tile waves of ops/tiles.py, so their
posting counts are actually-touched postings, not estimates).

Usage:
    python tools/strategy_compare.py [n_docs] [n_queries] [--cpu]
        [--vocab N]

A small vocab (default 2k) puts a head term in every doc tile — the
bound can't exclude tiles and dense wins. A large vocab (e.g. 50k,
the 5M scale run's shape) gives queries rare tail terms whose tiles
discipline the bound — where WAND-style pruning actually pays.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

VOCAB = 2_000
K = 10


def main():
    global VOCAB
    args = sys.argv[1:]
    if "--vocab" in args:
        i = args.index("--vocab")
        VOCAB = int(args[i + 1])
        del args[i:i + 2]
    nums = [a for a in args if not a.startswith("-")]
    n_docs = int(nums[0]) if nums else 20_000
    n_queries = int(nums[1]) if len(nums) > 1 else 100
    if "--cpu" in args:
        import jax

        jax.config.update("jax_platforms", "cpu")
    # make pruning eligible even for modest corpora
    os.environ.setdefault("SEARCHLITE_PRUNE_MIN_POSTINGS", "1")

    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    rng = np.random.default_rng(3)
    ranks = np.arange(1, VOCAB + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    vocab = [f"t{i}" for i in range(VOCAB)]

    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY,
                     enable_positions=False),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}]}))
    writer = index.writer()
    for i in range(n_docs):
        toks = rng.choice(VOCAB, size=int(rng.integers(20, 80)), p=probs)
        writer.add_document(
            {"_id": str(i), "body": " ".join(vocab[t] for t in toks)})
    writer.commit()
    reader = index.reader()

    # mixed-idf queries: one head term + mid/tail terms
    queries = []
    for _ in range(n_queries):
        terms = [vocab[int(rng.choice(VOCAB, p=probs))]]
        terms += [vocab[int(t)]
                  for t in rng.integers(50, VOCAB, size=3)]
        queries.append(" ".join(terms))

    print(f"{n_docs} docs, {n_queries} queries, top-{K}")
    results = {}
    for strategy in ("bm25", "wand", "bmw"):
        # warm with a full unmeasured pass: wave shapes are pow2-
        # bucketed but the first strategy otherwise pays every bucket's
        # compile for the ones that follow (the scorer caches are
        # shared), which skews per-strategy comparison
        for q in queries:
            reader.search({"query": q, "limit": K,
                           "execution": strategy})
        scored = advanced = 0
        all_hits = []
        t0 = time.perf_counter()
        for q in queries:
            res = reader.search({"query": q, "limit": K,
                                 "execution": strategy, "profile": True})
            prof = res.profile["execution"]
            scored += prof["scored_docs"]
            advanced += prof["postings_advanced"]
            all_hits.append([(h.doc_id, round(h.score, 4))
                             for h in res.hits])
        dt = time.perf_counter() - t0
        results[strategy] = all_hits
        print(f"{strategy:>4}: {dt * 1000 / n_queries:>7.2f} ms/q, "
              f"scored {scored:>9} docs, advances {advanced:>10}")
    # the reference's CI-enforced invariant: identical top-k, EVERY query
    assert results["wand"] == results["bm25"]
    assert results["bmw"] == results["bm25"]
    print(f"top-k identical across strategies for all {n_queries} "
          "queries (exactness invariant)")


if __name__ == "__main__":
    main()
