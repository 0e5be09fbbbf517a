"""Multi-chip sharded execution + batched kernel + driver entry tests.

The sharded path must reproduce the single-device results exactly —
the cross-chip reduce_scatter/all_gather merge preserves the
(score desc, doc id asc) contract of the reference's cross-segment merge.
"""

import numpy as np
import pytest

import __graft_entry__ as graft


class TestGraftEntry:
    def test_entry_compiles_and_runs(self):
        import jax

        fn, args = graft.entry()
        scores, ids = jax.jit(fn)(*args)
        assert scores.shape == (8, 10)
        s = np.asarray(scores)
        assert (np.diff(s, axis=1) <= 1e-6).all()  # descending per query

    def test_dryrun_multichip_8(self):
        graft.dryrun_multichip(8)

    @pytest.mark.parametrize("n", [2, 4])
    def test_dryrun_multichip_smaller(self, n):
        graft.dryrun_multichip(n)


class TestBatchedKernel:
    def test_batched_matches_scalar(self):
        import jax.numpy as jnp

        from searchlite.ops.batch import make_batched_scorer

        idx = graft._synthetic_index(n_docs=300, n_terms=20, seed=3)
        qs = graft._query_batch(idx, batch=4, terms_per_query=3, seed=5)
        scorer = make_batched_scorer()
        scores, ids = scorer(
            jnp.asarray(idx["block_docs"]), jnp.asarray(idx["block_tfs"]),
            jnp.asarray(idx["doc_len"]), jnp.asarray(idx["avgdl"]),
            jnp.asarray(idx["deleted"]),
            jnp.asarray(qs[0]), jnp.asarray(qs[1]), jnp.asarray(qs[2]),
            jnp.asarray(qs[3]),
            jnp.float32(0.9), jnp.float32(0.4), k=5)
        scores = np.asarray(scores)
        ids = np.asarray(ids)

        # numpy oracle over the same per-block slots
        k1, b = 0.9, 0.4
        n_docs = idx["doc_len"].shape[1] - 1
        dl = idx["doc_len"][0, :n_docs]
        avg = float(idx["avgdl"][0])
        for q in range(4):
            dense = np.zeros(n_docs + 1, dtype=np.float64)
            matched = np.zeros(n_docs + 1, dtype=bool)
            for s in range(qs[0].shape[1]):
                if not qs[3][q, s]:
                    continue
                blk = int(qs[0][q, s])
                w = float(qs[1][q, s])
                docs = idx["block_docs"][blk]
                tfs = idx["block_tfs"][blk]
                ok = docs < n_docs
                docs, tfs = docs[ok], tfs[ok]
                norm = dl[docs] / avg
                denom = np.maximum(tfs + k1 * (1 - b + b * norm), 1e-6)
                np.add.at(dense, docs, w * tfs * (k1 + 1) / denom)
                matched[docs] = True
            dense[~matched] = -np.inf
            order = np.argsort(-dense[:n_docs], kind="stable")[:5]
            np.testing.assert_array_equal(ids[q], order)
            np.testing.assert_allclose(scores[q], dense[order], rtol=1e-5)


class TestShardedFullQuery:
    """Multi-chip execution beyond plain BM25: the full
    request surface over a doc-sharded mesh must be identical to
    single-chip execution."""

    @pytest.fixture(scope="class")
    def setup(self):
        import random

        from searchlite.api.types import IndexOptions, StorageType
        from searchlite.index import Index
        from searchlite.index.manifest import Schema
        from searchlite.parallel.mesh import make_mesh

        rng = random.Random(31)
        vocab = [f"w{i}" for i in range(50)]
        idx = Index.create(
            IndexOptions(path="", create_if_missing=True,
                         storage=StorageType.IN_MEMORY),
            Schema.from_json({
                "text_fields": [{"name": "body", "analyzer": "default",
                                 "stored": False, "indexed": True}],
                "keyword_fields": [{"name": "cat", "stored": False,
                                    "indexed": True, "fast": True}],
                "numeric_fields": [{"name": "rank", "type": "i64",
                                    "stored": False, "fast": True}],
            }))
        writer = idx.writer()
        n = 0
        for _seg in range(2):  # two segments
            for _ in range(400):
                writer.add_document({
                    "_id": str(n),
                    "body": " ".join(rng.choices(
                        vocab, weights=[1 / (j + 1) for j in range(50)],
                        k=rng.randint(3, 20))),
                    "cat": rng.choice(["a", "b", "c"]),
                    "rank": rng.randint(0, 40),
                })
                n += 1
            writer.commit()
        writer = idx.writer()
        writer.delete_documents([str(i) for i in range(0, 50, 7)])
        writer.commit()
        mesh = make_mesh(8, query_axis=1)
        return idx.reader(), mesh

    REQUESTS = [
        # plain score top-k
        {"query": "w1 w4 w9", "limit": 10},
        # root filter
        {"query": "w2 w5", "limit": 10,
         "filter": {"KeywordEq": {"field": "cat", "value": "b"}}},
        # phrase
        {"query": '"w0 w1"', "limit": 10},
        # bool tree with msm + must_not
        {"query": {"type": "bool",
                   "should": [{"type": "term", "field": "body",
                               "value": v} for v in
                              ("w1", "w2", "w3", "w4")],
                   "minimum_should_match": 2,
                   "must_not": [{"type": "term", "field": "body",
                                 "value": "w0"}]},
         "limit": 10},
        # field sort (sort-key merge across chips)
        {"query": "w1 w3", "limit": 10,
         "sort": [{"field": "rank", "order": "asc"},
                  {"field": "_score", "order": "desc"}]},
        # terms + stats aggregations (intermediate merge across chips)
        {"query": "w2 w6", "limit": 5,
         "aggs": {"cats": {"type": "terms", "field": "cat"},
                  "ranks": {"type": "stats", "field": "rank"}}},
        # function_score custom scoring
        {"query": {"type": "function_score",
                   "query": {"type": "term", "field": "body",
                             "value": "w3"},
                   "functions": [{"type": "field_value_factor",
                                  "field": "rank", "factor": 0.5,
                                  "modifier": "log1p"}],
                   "boost_mode": "sum"},
         "limit": 10},
        # collapse
        {"query": "w1 w2 w3", "limit": 10,
         "collapse": {"field": "cat"}},
    ]

    @pytest.mark.parametrize("req_i", range(len(REQUESTS)))
    def test_mesh_matches_single_chip(self, setup, req_i):
        reader, mesh = setup
        req = dict(self.REQUESTS[req_i])
        base = reader.search(dict(req))
        got = reader.search(dict(req), mesh=mesh)
        assert [h.doc_id for h in got.hits] == \
            [h.doc_id for h in base.hits]
        for ha, hb in zip(base.hits, got.hits):
            assert hb.score == pytest.approx(ha.score, abs=1e-4)
        assert got.total_hits_estimate == base.total_hits_estimate
        assert got.aggregations == base.aggregations
        assert got.total_groups == base.total_groups

    def test_mesh_cursor_pagination(self, setup):
        reader, mesh = setup
        req = {"query": "w1 w2 w5", "limit": 7}
        pages_a, pages_b = [], []
        for pages, kw in ((pages_a, {}), (pages_b, {"mesh": mesh})):
            cursor = None
            for _ in range(4):
                r = reader.search(
                    dict(req, **({"cursor": cursor} if cursor else {})),
                    **kw)
                pages.append([h.doc_id for h in r.hits])
                cursor = r.next_cursor
                if cursor is None:
                    break
        assert pages_a == pages_b

    def test_device_side_terms_agg_partials(self, setup):
        """Mesh merge of terms-agg intermediates: per-chip bincount psum
        equals the host collector's counts."""
        import numpy as np

        from searchlite.parallel.query import (
            make_sharded_terms_counts,
            pad_doc_axis,
        )

        reader, mesh = setup
        seg = reader.segments[0]
        dseg = reader.device_segments[0]
        col = seg.fast.column("cat")
        n1 = dseg.n1
        # dict ids per doc (-1 = missing)
        ids = np.full(n1, -1, dtype=np.int32)
        present = np.diff(col.offsets) > 0
        first = col.offsets[:-1][present]
        ids[:seg.doc_count][present] = col.value_ids[first] \
            if hasattr(col, "value_ids") else col.values[first]
        # matched mask: docs containing w1
        res = reader.search({"query": "w1", "limit": 5,
                             "aggs": {"cats": {"type": "terms",
                                               "field": "cat"}}})
        import jax.numpy as jnp
        n_shards = mesh.shape["shard"]
        n1p = -(-n1 // n_shards) * n_shards
        mask = np.zeros(n1, dtype=bool)
        # reconstruct the matched mask from the aggregation path by
        # re-running filters host-side: simpler — use search_batch on
        # segment 0 docs is overkill; instead compare against counts
        # derived from the same mask we feed the kernel
        rng_mask = np.zeros(n1, dtype=bool)
        tid = seg.terms.get("body:w1")
        docs, _tfs = seg.postings.term_postings(tid)
        rng_mask[docs] = True
        rng_mask &= ~dseg.deleted_np
        kernel = make_sharded_terms_counts(mesh)
        n_buckets = int(ids.max()) + 1
        counts = kernel(
            jnp.asarray(pad_doc_axis(ids, n1p, -1)),
            jnp.asarray(pad_doc_axis(rng_mask, n1p, False)),
            n_buckets=n_buckets)
        counts = np.asarray(counts)
        expected = np.zeros(n_buckets, dtype=np.int64)
        for d in np.flatnonzero(rng_mask):
            if d < seg.doc_count and ids[d] >= 0:
                expected[ids[d]] += 1
        assert (counts == expected).all()


class TestShardedVectors:
    """Vector and hybrid search across the mesh — identical to
    single-chip."""

    @pytest.fixture(scope="class")
    def setup(self):
        import random

        from searchlite.api.types import IndexOptions, StorageType
        from searchlite.index import Index
        from searchlite.index.manifest import Schema
        from searchlite.parallel.mesh import make_mesh

        rng = random.Random(47)
        idx = Index.create(
            IndexOptions(path="", create_if_missing=True,
                         storage=StorageType.IN_MEMORY),
            Schema.from_json({
                "text_fields": [{"name": "body", "analyzer": "default",
                                 "stored": False, "indexed": True}],
                "vector_fields": [{"name": "emb", "dim": 8,
                                   "metric": "Cosine"}],
            }))
        writer = idx.writer()
        for i in range(300):
            vec = [rng.gauss(0, 1) for _ in range(8)]
            doc = {"_id": str(i),
                   "body": " ".join(rng.choices(
                       [f"w{j}" for j in range(30)], k=8))}
            if i % 7 != 0:  # some docs lack vectors
                doc["emb"] = vec
            writer.add_document(doc)
        writer.commit()
        return idx.reader(), make_mesh(8, query_axis=1)

    def test_vector_only_mesh_matches(self, setup):
        import random

        reader, mesh = setup
        rng = random.Random(3)
        for _ in range(4):
            q = [rng.gauss(0, 1) for _ in range(8)]
            req = {"query": {"type": "vector", "field": "emb",
                             "vector": q, "alpha": 0.0},
                   "limit": 10}
            base = reader.search(dict(req))
            got = reader.search(dict(req), mesh=mesh)
            assert [h.doc_id for h in got.hits] == \
                [h.doc_id for h in base.hits]
            for ha, hb in zip(base.hits, got.hits):
                assert hb.score == pytest.approx(ha.score, abs=1e-5)

    def test_hybrid_mesh_matches(self, setup):
        import random

        reader, mesh = setup
        rng = random.Random(5)
        q = [rng.gauss(0, 1) for _ in range(8)]
        req = {"query": {"type": "bool", "should": [
            {"type": "term", "field": "body", "value": "w3"},
            {"type": "vector", "field": "emb", "vector": q,
             "alpha": 0.5},
        ]}, "limit": 10}
        base = reader.search(dict(req))
        got = reader.search(dict(req), mesh=mesh)
        assert [h.doc_id for h in got.hits] == \
            [h.doc_id for h in base.hits]
        for ha, hb in zip(base.hits, got.hits):
            assert hb.score == pytest.approx(ha.score, abs=1e-5)


class TestShardedAggPartials:
    """Generalized device-side agg partials over the mesh: stats and
    range merge with psum/pmin/pmax; counts with the one-hot
    contraction (no colliding scatter)."""

    @pytest.fixture(scope="class")
    def setup(self):
        import random

        from searchlite.api.types import IndexOptions, StorageType
        from searchlite.index import Index
        from searchlite.index.manifest import Schema
        from searchlite.parallel.mesh import make_mesh

        rng = random.Random(61)
        idx = Index.create(
            IndexOptions(path="", create_if_missing=True,
                         storage=StorageType.IN_MEMORY),
            Schema.from_json({
                "text_fields": [{"name": "body", "analyzer": "default",
                                 "stored": False, "indexed": True}]}))
        writer = idx.writer()
        for i in range(300):
            writer.add_document({
                "_id": str(i),
                "body": " ".join(rng.choices(
                    [f"w{j}" for j in range(30)], k=8))})
        writer.commit()
        return idx.reader(), make_mesh(8, query_axis=1)

    def test_sharded_stats_and_range_partials(self, setup):
        import numpy as np

        from searchlite.parallel.query import (
            make_sharded_range_counts,
            make_sharded_stats_partial,
            pad_doc_axis,
        )

        reader, mesh = setup
        seg = reader.segments[0]
        dseg = reader.device_segments[0]
        n1 = dseg.n1
        rng = np.random.default_rng(3)
        vals = rng.uniform(0, 100, size=n1).astype(np.float32)
        has = rng.random(n1) < 0.8
        mask = rng.random(n1) < 0.5
        mask[n1 - 1] = False
        import jax.numpy as jnp
        n_shards = mesh.shape["shard"]
        n1p = -(-n1 // n_shards) * n_shards
        stats = make_sharded_stats_partial(mesh)
        count, total, total_sq, vmin, vmax = (
            np.asarray(x) for x in stats(
                jnp.asarray(pad_doc_axis(vals, n1p, 0.0)),
                jnp.asarray(pad_doc_axis(has, n1p, False)),
                jnp.asarray(pad_doc_axis(mask, n1p, False))))
        ok = has & mask
        assert int(count) == int(ok.sum())
        assert float(vmin) == float(vals[ok].min())
        assert float(vmax) == float(vals[ok].max())
        assert float(total) == pytest.approx(
            float(vals[ok].sum()), rel=1e-5)
        assert float(total_sq) == pytest.approx(
            float((vals[ok].astype(np.float64) ** 2).sum()), rel=1e-4)

        ranges = make_sharded_range_counts(mesh)
        rows = np.stack([(vals >= 0) & (vals < 30) & has,
                         (vals >= 20) & (vals < 80) & has,  # overlaps
                         (vals >= 80) & has])
        counts = np.asarray(ranges(
            jnp.asarray(pad_doc_axis(rows, n1p, False)),
            jnp.asarray(pad_doc_axis(mask, n1p, False))))
        for i in range(3):
            assert counts[i] == int((rows[i] & mask).sum())
