"""Randomized knob-matrix differential fuzz of the batched engine.

Every iteration builds a random corpus (size, vocabulary shape,
segments, deletes, positions), picks a random combination of the
engine's routing knobs (packed sparse uploads, term split, batch prune
mode, dense split budget, precision, memory budget, single-sparse
gate), and checks that EVERY execution strategy and output surface of
``search_batch_many`` agrees with the per-query ``search()`` path and
with an exact numpy BM25 oracle.

The per-path equivalence tests (tests/test_*.py) cover each knob in
isolation; this campaign hunts interactions between them. Run:

    python tools/fuzz_matrix.py [n_iters] [seed]

Prints one line per iteration; exits non-zero on the first mismatch
with a repro header (iteration seed + knob dict).
"""

from __future__ import annotations

import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def build_corpus(rng: random.Random, n_docs: int, vocab: int,
                 positions: bool, n_segments: int, delete_frac: float):
    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY,
                     enable_positions=positions),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "keyword_fields": [{"name": "cat", "stored": False,
                                "indexed": False, "fast": True}],
            "numeric_fields": [{"name": "price", "i64": True,
                                "stored": False, "fast": True}]}))
    writer = index.writer()
    alpha = rng.uniform(0.8, 1.6)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks ** alpha)
    probs /= probs.sum()
    nrng = np.random.default_rng(rng.randrange(2**31))
    per_seg = max(1, n_docs // n_segments)
    docs_written = 0
    for _s in range(n_segments):
        batch = []
        for _ in range(per_seg):
            n = nrng.integers(3, 80)
            toks = nrng.choice(vocab, size=n, p=probs)
            batch.append({"_id": str(docs_written),
                          "body": " ".join(f"t{t}" for t in toks),
                          "cat": f"c{docs_written % 5}",
                          "price": docs_written % 97})
            docs_written += 1
        writer.add_documents(batch)
        writer.commit()
    if delete_frac > 0:
        dels = [str(i) for i in range(docs_written)
                if rng.random() < delete_frac]
        if dels:
            writer.delete_documents(dels)
            writer.commit()
    return index


def oracle_scores(reader, raw_query: str) -> dict[str, float]:
    """Exact f64-accumulated BM25 per doc_id across all segments."""
    out: dict[str, float] = {}
    k1, b = 0.9, 0.4
    for seg, dseg in zip(reader.segments, reader.device_segments):
        postings = seg.postings
        n_docs = seg.doc_count
        col = seg.fast.column("_len:body")
        doc_len = np.zeros(n_docs, dtype=np.float64)
        doc_len[col.row_ids] = col.values.astype(np.float64)
        avg = seg.avg_field_length("body")
        live = float(dseg.live_docs)
        scores = np.zeros(n_docs, dtype=np.float64)
        touched = np.zeros(n_docs, dtype=bool)
        for token in raw_query.split():
            tid = seg.terms.get(f"body:{token}")
            if tid is None:
                continue
            df = float(postings.term_df[tid])
            # mirror device/index.py::idf_table — the ratio is clamped
            # before the log so df > live (tombstones) stays finite
            ratio = max((live - df + 0.5) / (df + 0.5), 1e-300)
            idf = max(np.log(ratio), 0.0) + 1.0
            docs, tfs = postings.term_postings(tid)
            tfs = tfs.astype(np.float64)
            norm = doc_len[docs] / avg
            denom = np.maximum(tfs + k1 * (1 - b + b * norm), 1e-6)
            # weight = count x idf per engine convention: a repeated
            # query term multiplies the idf; oracle handles repeats by
            # just accumulating again, same total
            scores[docs] += idf * tfs * (k1 + 1) / denom
            touched[docs] = True
        deleted = np.asarray(dseg.deleted_np[:n_docs])
        for d in np.flatnonzero(touched & ~deleted):
            out[seg.doc_id(int(d))] = out.get(
                seg.doc_id(int(d)), 0.0) + float(scores[d])
    return out


def mode_tols(precision: str) -> tuple:
    """Score tolerance per precision mode. f32_strict is bit-exact
    (1e-5 covers f32 summation-order ulps between paths, D10);
    fast-f32 rounds matmul INPUTS to bf16 once (~2^-8 relative);
    bf16 additionally stores impacts in bf16 — two roundings per
    term, so multi-term scores can drift past 6e-3 (a fuzz run
    measured 0.63% on a 5-term query)."""
    if precision == "f32_strict":
        return 1e-5, 1e-4
    if precision == "bf16":
        return 2e-2, 1e-3
    return 6e-3, 1e-3


def check_topk(queries, got_rows, oracles, strict, tag: str,
               limit: int):
    rtol, atol = strict if isinstance(strict, tuple) else (
        (1e-5, 1e-4) if strict else (6e-3, 1e-3))
    for q, row, oracle in zip(queries, got_rows, oracles):
        want_n = min(limit, len(oracle))
        if len(row) != want_n:
            return f"{tag}: {q!r} returned {len(row)} hits, want {want_n}"
        floor = None
        for doc_id, score in row:
            ref = oracle.get(doc_id)
            if ref is None:
                return f"{tag}: {q!r} returned non-matching doc {doc_id}"
            tol = atol + rtol * abs(ref)
            if abs(score - ref) > tol:
                return (f"{tag}: {q!r} doc {doc_id} score {score} "
                        f"!= oracle {ref}")
            floor = ref if floor is None else min(floor, ref)
        if row:
            others = [s for d, s in oracle.items()
                      if d not in {d2 for d2, _ in row}]
            if others:
                best_out = max(others)
                if best_out > floor + atol + rtol * abs(best_out):
                    return (f"{tag}: {q!r} missed doc scoring "
                            f"{best_out} > floor {floor}")
    return None


_MESHES: dict = {}

KNOB_SPACE = {
    "SEARCHLITE_SPARSE_PACKED": ("0", "1"),
    "SEARCHLITE_TERM_SPLIT": ("0", "1"),
    "SEARCHLITE_BATCH_PRUNE": ("auto", "union"),
    "SEARCHLITE_DENSE_M_BYTES": ("0", str(256 << 20)),
    "SEARCHLITE_PRECISION": ("", "f32_strict", "bf16"),
    "SEARCHLITE_M_BUDGET_BYTES": ("", "200000"),
    "SEARCHLITE_SINGLE_SPARSE_MIN_DOCS": ("", "1000"),
    "SEARCHLITE_WAND_SPARSE_BLOCKS": ("", "8"),
    "SEARCHLITE_HEAVY_TERM_BLOCKS": ("", "4"),
    "SEARCHLITE_MESH_DENSE": ("", "0"),
    "SEARCHLITE_RUNS_FMT": ("", "4"),
    # host tier: committed cpu-device placement + exec_scope routing
    # (on the cpu-default fuzz process "force" places on the LAST
    # virtual device; results must be unchanged)
    "SEARCHLITE_HOST_TIER": ("", "force"),
}


def run_iteration(it: int, seed: int) -> str | None:
    rng = random.Random(seed)
    knobs = {}
    for key, choices in KNOB_SPACE.items():
        val = rng.choice(choices)
        if val == "":
            os.environ.pop(key, None)
        else:
            os.environ[key] = val
            knobs[key] = val
    n_docs = rng.choice((500, 3000, 20000))
    vocab = rng.choice((50, 400, 3000))
    n_segments = rng.choice((1, 1, 2, 3))
    positions = rng.random() < 0.5
    delete_frac = rng.choice((0.0, 0.0, 0.05))
    limit = rng.choice((1, 3, 10))
    strict = mode_tols(os.environ.get("SEARCHLITE_PRECISION", ""))

    index = build_corpus(rng, n_docs, vocab, positions, n_segments,
                         delete_frac)
    reader = index.reader()
    nq = rng.choice((7, 32, 128))
    queries = []
    for _ in range(nq):
        terms = [f"t{rng.randrange(vocab)}"
                 for _ in range(rng.randint(1, 5))]
        if rng.random() < 0.15 and terms:
            terms.append(terms[0])  # repeated term: count x idf weight
        queries.append(" ".join(terms))
    oracles = [oracle_scores(reader, q) for q in queries]

    header = (f"iter {it} seed {seed} docs={n_docs} vocab={vocab} "
              f"segs={n_segments} dels={delete_frac} nq={nq} "
              f"limit={limit} knobs={knobs}")
    for execution in ("bm25", "wand", "bmw"):
        rows = reader.search_batch_many([queries], limit=limit,
                                        execution=execution)[0]
        err = check_topk(queries, rows, oracles, strict,
                         f"batch/{execution}", limit)
        if err:
            return f"{header}\n{err}"
        s, i, g = reader.search_batch_many([queries], limit=limit,
                                           execution=execution,
                                           output="arrays")[0]
        arr_rows = []
        for qi in range(len(queries)):
            n = int((s[qi] != -np.inf).sum())
            arr_rows.append([
                (reader.segments[int(g[qi, j])].doc_id(int(i[qi, j])),
                 float(s[qi, j])) for j in range(n)])
        err = check_topk(queries, arr_rows, oracles, strict,
                         f"arrays/{execution}", limit)
        if err:
            return f"{header}\n{err}"
    # multi-batch stream: the same queries as 3 batches in ONE
    # search_batch_many call — exercises the cross-batch fetch
    # bookkeeping (flat_vals cursor, fallback patch offsets
    # entry_off[bi] + li) that single-batch calls never touch
    thirds = [queries[0::3], queries[1::3], queries[2::3]]
    o_thirds = [oracles[0::3], oracles[1::3], oracles[2::3]]
    for execution in ("bm25", "wand"):
        outs = reader.search_batch_many(thirds, limit=limit,
                                        execution=execution)
        for b, (qs, rows, os_) in enumerate(zip(thirds, outs,
                                                o_thirds)):
            err = check_topk(qs, rows, os_, strict,
                             f"stream{b}/{execution}", limit)
            if err:
                return f"{header}\n{err}"

    # mesh execution: the doc-sharded batched path (per-chip candidate
    # strips + per-chip dense remainder, collective top-k merge) must match
    # the same oracle. Needs >1 local device — run the campaign with
    # XLA_FLAGS=--xla_force_host_platform_device_count=8. Meshes are
    # cached process-wide: the sharded scorers key their jit caches by
    # mesh identity, so a fresh mesh per iteration would recompile.
    import jax
    if len(jax.devices()) > 1 and rng.random() < 0.5:
        n_dev = rng.choice((2, 4, len(jax.devices())))
        mesh = _MESHES.get(n_dev)
        if mesh is None:
            from searchlite.parallel.mesh import make_mesh

            mesh = _MESHES[n_dev] = make_mesh(n_dev)
        for execution in ("bm25", "wand"):
            rows = reader.search_batch_many(
                [queries], limit=limit, execution=execution,
                mesh=mesh)[0]
            err = check_topk(queries, rows, oracles, strict,
                             f"mesh{n_dev}/{execution}", limit)
            if err:
                return f"{header}\n{err}"

    # structural merge mid-iteration (index/merge.py): fold all or
    # only the small segments, then re-validate the MERGED structures
    # against a fresh exact oracle (scores legitimately change when
    # tombstones expunge / df+avgdl fold corpus-wide, so the oracle is
    # recomputed from the merged reader). The remaining checks below
    # then run against the merged index — free extra coverage.
    if rng.random() < 0.4:
        max_docs = rng.choice((None, max(1, n_docs // n_segments)))
        merged = index.merge_segments(max_docs=max_docs)
        if merged:
            header += f" MERGED({merged},max_docs={max_docs})"
            reader = index.reader()
            oracles = [oracle_scores(reader, q) for q in queries]
            for execution in ("bm25", "wand"):
                rows = reader.search_batch_many(
                    [queries], limit=limit, execution=execution)[0]
                err = check_topk(queries, rows, oracles, strict,
                                 f"merged/{execution}", limit)
                if err:
                    return f"{header}\n{err}"

    # per-query path on a subsample
    for q, oracle in list(zip(queries, oracles))[:8]:
        res = reader.search({"query": q, "limit": limit})
        row = [(h.doc_id, h.score) for h in res.hits]
        err = check_topk([q], [row], [oracle], strict, "single", limit)
        if err:
            return f"{header}\n{err}"

    # per-query FILTERS through every batched execution vs the
    # single-query path with the same filter (mask-table dedup, the
    # union pruned path's filter rows, and the dense fallbacks)
    def rand_filter():
        r = rng.random()
        if r < 0.35:
            return {"KeywordEq": {"field": "cat",
                                  "value": f"c{rng.randrange(6)}"}}
        if r < 0.6:
            lo = rng.randrange(97)
            return {"I64Range": {"field": "price", "min": lo,
                                 "max": lo + rng.randrange(1, 40)}}
        if r < 0.8:
            return {"Or": [
                {"KeywordEq": {"field": "cat",
                               "value": f"c{rng.randrange(5)}"}},
                {"KeywordEq": {"field": "cat",
                               "value": f"c{rng.randrange(5)}"}}]}
        return None
    sub_q = queries[: min(24, len(queries))]
    filters = [rand_filter() for _ in sub_q]
    # filtered oracle: the engine's own HOST-side mask evaluation
    # (query/filters.py, numpy — deterministic, reference-semantics
    # tested) restricted over the f64 score oracle; the device paths
    # under test only ever see the mask as data
    from searchlite.api.types import Filter
    from searchlite.query.filters import compute_filters_mask

    def filtered_oracle(oracle, f):
        if f is None:
            return oracle
        keep: set[str] = set()
        for seg in reader.segments:
            mask = compute_filters_mask(seg.fast,
                                        [Filter.from_json(f)])
            for d in np.flatnonzero(mask):
                keep.add(seg.doc_id(int(d)))
        return {d: s for d, s in oracle.items() if d in keep}
    f_oracles = [filtered_oracle(o, f)
                 for o, f in zip(oracles[:len(sub_q)], filters)]
    for execution in ("bm25", "wand", "bmw"):
        rows = reader.search_batch_many(
            [sub_q], limit=limit, execution=execution,
            filters=[filters])[0]
        err = check_topk(sub_q, rows, f_oracles, strict,
                         f"filtered-batch/{execution}", limit)
        if err:
            return f"{header}\nfilters={filters}\n{err}"
    single_rows = []
    for q, f in zip(sub_q, filters):
        res = reader.search({"query": q, "limit": limit, "filter": f})
        single_rows.append([(h.doc_id, h.score) for h in res.hits])
    err = check_topk(sub_q, single_rows, f_oracles, strict,
                     "filtered-single", limit)
    if err:
        return f"{header}\nfilters={filters}\n{err}"

    # A/B routing check on the FULL single-query surface: the same
    # aggs + field-sort + filter request under (a) default routing and
    # (b) this iteration's knobs + a budget that forces the chunked
    # tile executor. Matched sets are exact across executors, so agg
    # counts and sort orders must agree exactly; f64 sums to small
    # tolerance (summation order).
    req = {"query": queries[0],
           "filter": filters[0],
           "limit": 10,
           "sort": [{"field": "price", "order": "desc"},
                    {"field": "_score", "order": "desc"}],
           "aggs": {"cats": {"type": "terms", "field": "cat"},
                    "ps": {"type": "stats", "field": "price"},
                    "ph": {"type": "histogram", "field": "price",
                           "interval": 25.0}}}
    saved = {k: os.environ.pop(k, None) for k in list(KNOB_SPACE)
             + ["SEARCHLITE_DEVICE_AGGS"]}
    res_a = reader.search(dict(req))
    for k, v in saved.items():
        if v is not None:
            os.environ[k] = v
    os.environ["SEARCHLITE_M_BUDGET_BYTES"] = "150000"
    os.environ["SEARCHLITE_DEVICE_AGGS"] = rng.choice(("0", "1"))
    try:
        res_b = reader.search(dict(req))
    finally:
        os.environ.pop("SEARCHLITE_DEVICE_AGGS", None)
        if saved.get("SEARCHLITE_M_BUDGET_BYTES") is not None:
            os.environ["SEARCHLITE_M_BUDGET_BYTES"] = \
                saved["SEARCHLITE_M_BUDGET_BYTES"]
        else:
            os.environ.pop("SEARCHLITE_M_BUDGET_BYTES", None)
    ids_a = [h.doc_id for h in res_a.hits]
    ids_b = [h.doc_id for h in res_b.hits]
    if ids_a != ids_b:
        return (f"{header}\nA/B sort: {req['query']!r} default "
                f"{ids_a} != knobs {ids_b}")
    ja = res_a.to_json().get("aggregations", {})
    jb = res_b.to_json().get("aggregations", {})

    def agg_eq(a, b, path="aggs"):
        if isinstance(a, dict) != isinstance(b, dict):
            return f"{path}: shape"
        if isinstance(a, dict):
            if set(a) != set(b):
                return f"{path}: keys {set(a)} != {set(b)}"
            for k in a:
                e = agg_eq(a[k], b[k], f"{path}.{k}")
                if e:
                    return e
            return None
        if isinstance(a, list):
            if len(a) != len(b):
                return f"{path}: len {len(a)} != {len(b)}"
            for i, (x, y) in enumerate(zip(a, b)):
                e = agg_eq(x, y, f"{path}[{i}]")
                if e:
                    return e
            return None
        if isinstance(a, float) or isinstance(b, float):
            aa, bb = float(a), float(b)
            if abs(aa - bb) > 1e-6 + 1e-6 * abs(bb):
                return f"{path}: {a} != {b}"
            return None
        return None if a == b else f"{path}: {a} != {b}"

    e = agg_eq(ja, jb)
    if e:
        return f"{header}\nA/B aggs mismatch ({e})"
    return None


def main():
    n_iters = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    base_seed = int(sys.argv[2]) if len(sys.argv) > 2 else 12345
    import jax

    jax.config.update("jax_platforms", "cpu")
    t0 = time.time()
    for it in range(n_iters):
        seed = base_seed + it
        t1 = time.time()
        err = run_iteration(it, seed)
        if err:
            print(f"FAIL\n{err}", flush=True)
            sys.exit(1)
        print(f"iter {it} ok ({time.time()-t1:.1f}s, "
              f"total {time.time()-t0:.0f}s)", flush=True)
    print("ALL OK", flush=True)


if __name__ == "__main__":
    main()
