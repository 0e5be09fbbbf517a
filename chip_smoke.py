"""Drive searchlite's main path once on one GPU and gate every answer.

Phases, each printing one JSON line; any failure ends the run with a
non-zero exit code and no result line:

- env: the card (``nvidia-smi``), jax/jaxlib versions, devices, and
  whether the native C++ ingest library built. Refuses a default
  backend other than ``gpu`` and a missing native library.
- ingest: an MS MARCO passage-shaped corpus (``tools/bench_scale.py``:
  seed 7, a Zipf vocabulary of 120,000 terms, 30-120 tokens a passage,
  fast fields ``cat``/``year``/``price``) through ``Index.create`` →
  ``writer.add_documents`` → ``commit``, on disk in a scratch directory.
- open: a reader; every ``DeviceSegment`` array must live on the GPU.
- search: 32 single queries, a stream of 4 batches of 1,024 through
  ``search_batch_many`` (``bm25`` and ``wand``, pairs and arrays), and 8
  filtered requests with terms/histogram/stats aggregations, all gated
  against the numpy reference (``searchlite/oracle.py``).
- surface: a 50,000-passage index with positions and 768-wide vectors
  (``emb`` f32, ``emb_bf16``, ``emb_int8``); filters, phrase,
  minimum_should_match with must_not, field sort, aggregations,
  function_score, collapse, cursor pages, batch, and vector and hybrid
  queries under each quantization, each checked with numpy.
- http: the HTTP server on a thread of this process (one JAX process
  per card); its answers must equal the direct reader calls.

The last line is ``{"ok": true, "device": {...}}``.

Tolerances. BM25 scores: ``searchlite.oracle.tolerance`` — by default
rtol 1e-2, atol 1e-3: impacts are stored in bf16 (up to 2^-8 relative
per impact) and f32 dots may run as TF32 (2^-11 per input), so a score
is off by at most 2^-8 + 2^-10 of itself and two docs within twice that
(9.8e-3) can trade places; with ``SEARCHLITE_PRECISION=f32_strict``
rtol 1e-6, atol 1e-4. Reordering within the tolerance is accepted.
Aggregations: bucket counts and min/max exact; ``stats`` sums and
averages within rtol 1e-4, because the device accumulates up to
millions of values in f32 while numpy uses f64. Vector scores: exact
f64 cosine; ``VECTOR_TOL`` per quantization.

``--four`` runs only the path across four cards: a ("query", "shard") =
(1, 4) mesh over four GPUs, and on the main index ``reader.search(req,
mesh=)`` over the surface requests its schema serves (all but phrase,
vector and hybrid, which need positions and vectors) and
``search_batch_many`` over a 4,096-query stream, each compared with the
same call on one device (doc ids equal, scores within 1e-4). It runs
under ``SEARCHLITE_PRECISION=f32_strict``: by default the one-device
path stores impacts in bf16 and sums ``stats`` in f32 on the device,
while the doc-sharded path keeps f32 impacts, so the two agree only
within the default tolerance, not to 1e-4.

Usage: python chip_smoke.py [--docs N] [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np

import searchlite  # noqa: F401  (sets up the compile cache before jax)
from searchlite.oracle import Bm25Oracle, Reference, tolerance
from tools.bench_scale import (build_queries, corpus_model, fast_values,
                               gen_chunk, N_CATS, SCHEMA)

MSMARCO_PASSAGES = 8_841_823
SURFACE_DOCS = 50_000
K = 10
AGG_RTOL = 1e-4
MESH_ATOL = 1e-4
# (rtol, atol) of a vector score against the f64 cosine: f32 storage
# with TF32 dots, bf16 storage (2^-8 per element), int8 with per-vector
# scale (step max|v|/127)
VECTOR_TOL = {"emb": (1e-3, 1e-4), "emb_bf16": (5e-3, 1e-3),
              "emb_int8": (2e-2, 3e-3)}


class GateError(AssertionError):
    """An answer disagreed with its reference."""


def gate(ok, what):
    if not ok:
        raise GateError(what)


def emit(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def nvidia_smi() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def phase_env(ctx, require_gpu=True, devices=1):
    import jax
    import jaxlib

    from searchlite.native import get_lib

    smi = nvidia_smi()
    if smi:
        print(smi, flush=True)
    native = get_lib() is not None
    emit("env", nvidia_smi=smi, jax=jax.__version__,
         jaxlib=jaxlib.__version__, backend=jax.default_backend(),
         devices=[str(d) for d in jax.devices()], native_ingest=native)
    if require_gpu:
        gate(jax.default_backend() == "gpu",
             f"default backend is {jax.default_backend()!r}, not 'gpu'")
        gate(len(jax.devices()) >= devices,
             f"{len(jax.devices())} devices, want {devices}")
    gate(native, "the native ingest library did not load")
    ctx.platform = jax.default_backend()


def phase_ingest(ctx, n_docs, path, chunk=200_000):
    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    probs, ctx.vocab = corpus_model()
    rng = np.random.default_rng(7)
    ctx.path = path
    ctx.index = Index.create(
        IndexOptions(path=path, create_if_missing=True,
                     storage=StorageType.FILESYSTEM,
                     enable_positions=False),
        Schema.from_json(SCHEMA))
    writer = ctx.index.writer()
    t0 = time.perf_counter()
    gen_s = 0.0
    for base in range(0, n_docs, chunk):
        g0 = time.perf_counter()
        docs = gen_chunk(rng, probs, ctx.vocab, min(chunk, n_docs - base),
                         base)
        gen_s += time.perf_counter() - g0
        writer.add_documents(docs)
    t1 = time.perf_counter()
    writer.commit()
    t2 = time.perf_counter()
    emit("ingest", docs=n_docs, generate_s=gen_s,
         add_s=t1 - t0 - gen_s, commit_s=t2 - t1,
         docs_per_s=n_docs / (t2 - t0),
         docs_per_s_engine=n_docs / (t2 - t0 - gen_s))


def device_arrays(reader):
    import jax

    out = []
    for dseg in reader.device_segments:
        for leaf in jax.tree_util.tree_leaves(vars(dseg)):
            if isinstance(leaf, jax.Array):
                out.append(leaf)
    return out


def check_placement(ctx, reader):
    arrays = device_arrays(reader)
    gate(arrays, "no DeviceSegment array was uploaded")
    platforms = {d.platform for a in arrays for d in a.devices()}
    gate(platforms == {ctx.platform},
         f"DeviceSegment arrays on {sorted(platforms)}")
    return len(arrays)


def memory(device):
    stats = device.memory_stats() or {}
    return {k: stats.get(k) for k in ("bytes_in_use", "peak_bytes_in_use",
                                      "bytes_limit")}


def phase_open(ctx):
    import jax

    t0 = time.perf_counter()
    ctx.reader = ctx.index.reader()
    upload_s = time.perf_counter() - t0
    n = check_placement(ctx, ctx.reader)
    ctx.oracle = Bm25Oracle(ctx.reader)
    ctx.docnum = [np.asarray(seg.doc_ids, dtype=np.int64)
                  for seg in ctx.reader.segments]
    emit("open", upload_s=upload_s, segments=len(ctx.reader.segments),
         device_arrays=n, **memory(jax.devices()[0]))


def pair_hits(oracle, pairs):
    return [(*oracle.locate(d), float(s)) for d, s in pairs]


def array_hits(scores, ords, segs, qi):
    live = scores[qi] > -np.inf
    return [(int(g), int(o), float(s)) for s, o, g in
            zip(scores[qi][live], ords[qi][live], segs[qi][live])]


def result_hits(oracle, result):
    return [(*oracle.locate(h.doc_id), float(h.score)) for h in result.hits]


def gate_ref(ref, hits, what, tol=None):
    why = ref.check(hits, tol)
    gate(why is None, f"{what}: {why}")


def make_queries(ctx, n, seed=11):
    return build_queries(np.random.default_rng(seed), n, ctx.vocab)


def phase_search(ctx, batch=1024, n_batches=4, n_singles=32, stride=1):
    """Single queries, the batched stream and filtered aggregations,
    each gated against the numpy reference. ``stride`` > 1 gates every
    stride-th query of the stream only (for corpora past 1M passages,
    where the f64 reference costs more than the engine)."""
    reader, oracle = ctx.reader, ctx.oracle
    queries = make_queries(ctx, n_singles + batch * n_batches)
    singles = queries[:n_singles]
    stream = [queries[n_singles + i * batch:n_singles + (i + 1) * batch]
              for i in range(n_batches)]

    t0 = time.perf_counter()
    for q in singles:
        res = reader.search({"query": q, "limit": K})
        gate_ref(Reference(oracle.scores(q.split()), K),
                 result_hits(oracle, res), f"single {q!r}")
    emit("search_single", queries=len(singles),
         s=time.perf_counter() - t0)

    outs = {}
    for execution in ("bm25", "wand"):
        for output in ("pairs", "arrays"):
            t0 = time.perf_counter()
            outs[execution, output] = reader.search_batch_many(
                stream, limit=K, execution=execution, output=output)
            emit("search_stream", execution=execution, output=output,
                 queries=batch * n_batches,
                 s_compile_included=time.perf_counter() - t0)
    t0 = time.perf_counter()
    gated = 0
    for bi, b in enumerate(stream):
        for qi in range(0, len(b), stride):
            ref = Reference(oracle.scores(b[qi].split()), K)
            for (execution, output), out in outs.items():
                hits = (pair_hits(oracle, out[bi][qi]) if output == "pairs"
                        else array_hits(*out[bi], qi))
                gate_ref(ref, hits, f"{execution}/{output} {b[qi]!r}")
            gated += 1
    emit("search_stream_gate", gated_queries=gated, surfaces=len(outs),
         s=time.perf_counter() - t0)
    check_placement(ctx, reader)
    phase_aggs(ctx, queries[:8])


AGGS = {"cats": {"type": "terms", "field": "cat", "size": N_CATS},
        "years": {"type": "histogram", "field": "year", "interval": 5},
        "year_stats": {"type": "stats", "field": "year"},
        "price_stats": {"type": "stats", "field": "price"}}


AGG_FILTERS = [
    None,
    {"KeywordEq": {"field": "cat", "value": "c3"}},
    {"I64Range": {"field": "year", "min": 2000, "max": 2009}},
    {"And": [{"KeywordEq": {"field": "cat", "value": "c7"}},
             {"I64Range": {"field": "year", "min": 1995, "max": 2015}}]},
    {"KeywordEq": {"field": "cat", "value": "c12"}},
    None,
    {"I64Range": {"field": "year", "min": 1990, "max": 1994}},
    {"And": [{"KeywordEq": {"field": "cat", "value": "c0"}},
             {"I64Range": {"field": "year", "min": 2010, "max": 2024}}]}]


def filter_mask(ctx, filt):
    """Per segment, numpy mask of a KeywordEq/I64Range/And filter,
    computed from the generator's field values."""
    out = []
    for d in ctx.docnum:
        cats, years, _ = fast_values(d)
        out.append(_mask(filt, cats, years))
    return out


def _mask(filt, cats, years):
    if filt is None:
        return np.ones(len(cats), dtype=bool)
    (kind, p), = filt.items()
    if kind == "KeywordEq":
        return cats == int(p["value"][1:])
    if kind == "I64Range":
        return (years >= p["min"]) & (years <= p["max"])
    if kind == "And":
        m = np.ones(len(cats), dtype=bool)
        for child in p:
            m &= _mask(child, cats, years)
        return m
    raise ValueError(kind)


def reference_aggs(ctx, match):
    cats, years, prices = (np.concatenate(x) for x in zip(
        *(fast_values(d[m]) for d, m in zip(ctx.docnum, match))))
    out = {"cats": {f"c{c}": int(n) for c, n in
                    zip(*np.unique(cats, return_counts=True))},
           "years": {float(y): int(n) for y, n in
                     zip(*np.unique(years // 5 * 5, return_counts=True))}}
    for name, v in (("year_stats", years), ("price_stats", prices)):
        v = v.astype(np.float64)
        out[name] = {"count": len(v), "min": v.min() if len(v) else None,
                     "max": v.max() if len(v) else None, "sum": v.sum(),
                     "avg": v.mean() if len(v) else None}
    return out


def gate_aggs(got, want, what):
    cats = {b["key"]: b["doc_count"] for b in got["cats"]["buckets"]}
    gate(cats == want["cats"], f"{what}: terms {cats} != {want['cats']}")
    years = {float(b["key"]): b["doc_count"]
             for b in got["years"]["buckets"] if b["doc_count"]}
    gate(years == want["years"],
         f"{what}: histogram {years} != {want['years']}")
    for name in ("year_stats", "price_stats"):
        g, w = got[name], want[name]
        gate(g["count"] == w["count"], f"{what}: {name} count")
        if not w["count"]:
            continue
        gate(g["min"] == w["min"] and g["max"] == w["max"],
             f"{what}: {name} min/max {g} != {w}")
        for key in ("sum", "avg"):
            gate(abs(g[key] - w[key]) <= AGG_RTOL * abs(w[key]),
                 f"{what}: {name} {key} {g[key]} != {w[key]}")


def phase_aggs(ctx, queries):
    t0 = time.perf_counter()
    for q, filt in zip(queries, AGG_FILTERS):
        req = {"query": q, "limit": 5, "aggs": AGGS}
        if filt is not None:
            req["filter"] = filt
        res = ctx.reader.search(req)
        fm = filter_mask(ctx, filt)
        scores = [s * m for s, m in zip(ctx.oracle.scores(q.split()), fm)]
        ref = Reference(scores, 5)
        gate_ref(ref, result_hits(ctx.oracle, res), f"aggs {q!r}")
        gate_aggs(res.aggregations, reference_aggs(ctx, ref.match),
                  f"aggs {q!r} {filt}")
    emit("search_aggs", requests=len(queries), s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# surface


def surface_schema(dim):
    schema = json.loads(json.dumps(SCHEMA))
    schema["vector_fields"] = [
        {"name": "emb", "dim": dim, "metric": "Cosine"},
        {"name": "emb_bf16", "dim": dim, "metric": "Cosine",
         "quantization": "bf16"},
        {"name": "emb_int8", "dim": dim, "metric": "Cosine",
         "quantization": "int8"}]
    return schema


def vector_owners(d):
    """Which docs carry which vector field: ``emb`` on 4 of 5 docs,
    the quantized copies on 1 of 5 (some docs have no vector)."""
    d = np.asarray(d)
    return {"emb": d % 5 != 0, "emb_bf16": d % 5 == 1,
            "emb_int8": d % 5 == 1}


def phase_surface(ctx, n_docs, path, dim=768, chunk=10_000):
    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    probs, vocab = corpus_model()
    rng = np.random.default_rng(8)
    vecs = np.random.default_rng(9).standard_normal(
        (n_docs, dim)).astype(np.float32)
    t0 = time.perf_counter()
    index = Index.create(
        IndexOptions(path=path, create_if_missing=True,
                     storage=StorageType.FILESYSTEM, enable_positions=True),
        Schema.from_json(surface_schema(dim)))
    writer = index.writer()
    owners = vector_owners(np.arange(n_docs))
    for base in range(0, n_docs, chunk):
        docs = gen_chunk(rng, probs, vocab, min(chunk, n_docs - base), base)
        for doc in docs:
            d = int(doc["_id"])
            v = vecs[d].tolist()
            for field, has in owners.items():
                if has[d]:
                    doc[field] = v
        writer.add_documents(docs)
    writer.commit()
    reader = index.reader()
    ingest_s = time.perf_counter() - t0
    s = SimpleNamespace(reader=reader, oracle=Bm25Oracle(reader),
                        docnum=[np.asarray(g.doc_ids, dtype=np.int64)
                                for g in reader.segments],
                        vecs=vecs, platform=ctx.platform)
    qv = np.random.default_rng(10).standard_normal((2, dim)).astype(
        np.float32)
    t0 = time.perf_counter()
    checked = run_surface(s, qv)
    check_placement(s, reader)
    emit("surface", docs=n_docs, dim=dim, ingest_s=ingest_s,
         s=time.perf_counter() - t0, checked=checked)


def lexical_requests():
    term = lambda v: {"type": "term", "field": "body", "value": v}  # noqa
    return {
        "filtered": {"query": "t1 t4", "limit": K,
                     "filter": {"KeywordEq": {"field": "cat",
                                              "value": "c2"}}},
        "msm+must_not": {
            "query": {"type": "bool",
                      "should": [term(v) for v in ("t5", "t6", "t7")],
                      "minimum_should_match": 2,
                      "must_not": [term("t9")]},
            "limit": K},
        "field_sort": {"query": "t1 t3", "limit": K,
                       "sort": [{"field": "year", "order": "asc"},
                                {"field": "_score", "order": "desc"}]},
        "aggs": {"query": "t2 t5", "limit": 5, "aggs": AGGS},
        "function_score": {
            "query": {"type": "function_score", "query": term("t3"),
                      "functions": [{"type": "field_value_factor",
                                     "field": "year", "factor": 0.5,
                                     "modifier": "log1p"}],
                      "boost_mode": "sum"},
            "limit": K},
        "collapse": {"query": "t1 t2", "limit": K,
                     "collapse": {"field": "cat"}},
    }


def vector_requests(qv):
    out = {}
    for field in VECTOR_TOL:
        out[f"vector:{field}"] = {
            "query": {"type": "vector", "field": field,
                      "vector": qv[0].tolist(), "alpha": 0.0},
            "limit": K}
        out[f"hybrid:{field}"] = {
            "query": "t1 t3", "limit": K,
            "vector_query": {"field": field, "vector": qv[1].tolist(),
                             "alpha": 0.5}}
    return out


def cosine(s, q, field):
    """Per segment (f64 cosine, has-vector mask) of ``field``."""
    v = s.vecs.astype(np.float64)
    q = q.astype(np.float64)
    cos = v @ q / (np.linalg.norm(v, axis=1) * np.linalg.norm(q))
    return ([cos[d] for d in s.docnum],
            [vector_owners(d)[field] for d in s.docnum])


def phrase_match(s, first, second):
    """Per segment, docs where ``second`` directly follows ``first``."""
    out = []
    for seg in s.reader.segments:
        m = np.zeros(seg.doc_count, dtype=bool)
        t1, t2 = (seg.terms.get(f"body:{t}") for t in (first, second))
        if t1 is not None and t2 is not None:
            docs1, _ = seg.postings.term_postings(t1)
            docs2, _ = seg.postings.term_postings(t2)
            both = np.intersect1d(docs1, docs2)
            i1 = np.searchsorted(docs1, both)
            i2 = np.searchsorted(docs2, both)
            for doc, a, b in zip(both, i1, i2):
                p1 = seg.postings.positions(t1, int(a))
                p2 = seg.postings.positions(t2, int(b))
                m[doc] = bool(np.intersect1d(p1 + 1, p2).size)
        out.append(m)
    return out


def run_surface(s, qv):
    """Run and check the surface request set; returns the names."""
    reader, oracle = s.reader, s.oracle
    tol = tolerance()
    checked = []

    def bm25(q):
        return oracle.scores(q.split())

    for name, req in {**lexical_requests(), **vector_requests(qv)}.items():
        res = reader.search(json.loads(json.dumps(req)))
        hits = result_hits(oracle, res)
        if name == "filtered":
            fm = filter_mask(s, req["filter"])
            gate_ref(Reference([a * m for a, m in zip(bm25(req["query"]),
                                                      fm)], K), hits, name)
        elif name == "msm+must_not":
            per = [oracle.scores([t]) for t in ("t5", "t6", "t7")]
            bad = oracle.scores(["t9"])
            match = [((a > 0).astype(int) + (b > 0) + (c > 0) >= 2)
                     & (x <= 0) for a, b, c, x in zip(*per, bad)]
            total = [a + b + c for a, b, c in zip(*per)]
            gate_ref(Reference(total, K, match=match), hits, name)
        elif name == "field_sort":
            sc = bm25(req["query"])
            keys = sorted(
                ((int(fast_values(s.docnum[si][o])[1]), -float(a[o]))
                 for si, a in enumerate(sc) for o in np.flatnonzero(a > 0)))
            got = [(int(fast_values(s.docnum[si][o])[1]), -sc[si][o])
                   for si, o, _ in hits]
            gate(len(got) == min(K, len(keys)), f"{name}: count")
            for (gy, gs), (wy, ws) in zip(got, keys):
                gate(gy == wy and abs(gs - ws) <= tol[1] + tol[0] * abs(ws),
                     f"{name}: key {(gy, gs)} != {(wy, ws)}")
            for si, o, sco in hits:
                gate(abs(sco - sc[si][o]) <= tol[1] + tol[0] * sc[si][o],
                     f"{name}: score")
        elif name == "aggs":
            ref = Reference(bm25(req["query"]), 5)
            gate_ref(ref, hits, name)
            gate_aggs(res.aggregations, reference_aggs(s, ref.match), name)
        elif name == "function_score":
            sc = oracle.scores(["t3"])
            boost = [np.log1p(0.5 * fast_values(d)[1]) for d in s.docnum]
            gate_ref(Reference([a + b for a, b in zip(sc, boost)], K,
                               match=[a > 0 for a in sc]), hits, name)
        elif name == "collapse":
            sc = bm25(req["query"])
            best = {}
            for si, a in enumerate(sc):
                cats = fast_values(s.docnum[si])[0]
                for c in range(N_CATS):
                    m = (cats == c) & (a > 0)
                    if m.any():
                        best[c] = max(best.get(c, 0.0), float(a[m].max()))
            got_cats = [int(fast_values(s.docnum[si][o])[0])
                        for si, o, _ in hits]
            # groups come from the top candidates only, so fewer than K
            # may return; a group left out must not beat the weakest
            gate(len(set(got_cats)) == len(got_cats)
                 and 0 < len(got_cats) <= min(K, len(best)),
                 f"{name}: groups {got_cats}")
            for c, (si, o, sco) in zip(got_cats, hits):
                gate(abs(sco - best[c]) <= tol[1] + tol[0] * best[c],
                     f"{name}: group {c} scored {sco}, want {best[c]}")
            left = [v for c, v in best.items() if c not in got_cats]
            if left and hits:
                gate(max(left) <= min(h[2] for h in hits) + tol[1]
                     + tol[0] * max(left), f"{name}: left out a group")
        elif name.startswith("vector:"):
            field = name.split(":")[1]
            cos, has = cosine(s, qv[0], field)
            gate_ref(Reference(cos, K, match=has), hits, name,
                     VECTOR_TOL[field])
        elif name.startswith("hybrid:"):
            field = name.split(":")[1]
            rtol, atol = VECTOR_TOL[field]
            cos, has = cosine(s, qv[1], field)
            sc = bm25(req["query"])
            gate(len(hits) == K, f"{name}: {len(hits)} hits")
            prev = np.inf
            for si, o, sco in hits:
                # a doc outside the lexical candidates blends BM25 0, one
                # outside the vector candidates blends cosine -1
                vs = (cos[si][o], -1.0) if has[si][o] else (-1.0,)
                ok = any(abs(sco - (0.5 * b + 0.5 * v))
                         <= 0.5 * (tol[1] + tol[0] * b)
                         + 0.5 * (atol + rtol * abs(v))
                         for b in (sc[si][o], 0.0) for v in vs)
                gate(ok, f"{name}: doc ({si}, {o}) scored {sco}")
                gate(sco <= prev + tol[1] + atol, f"{name}: order")
                prev = sco
        checked.append(name)

    phr = phrase_match(s, "t0", "t1")
    res = reader.search({"query": '"t0 t1"', "limit": K})
    n_phr = int(sum(m.sum() for m in phr))
    gate(len(res.hits) == min(K, n_phr), f"phrase: {len(res.hits)} hits")
    for si, o, sco in result_hits(oracle, res):
        gate(phr[si][o] and np.isfinite(sco), f"phrase: doc ({si}, {o})")
    checked.append("phrase")

    full = reader.search({"query": "t1 t2 t5", "limit": 21})
    gate_ref(Reference(bm25("t1 t2 t5"), 21), result_hits(oracle, full),
             "cursor base")
    pages, cursor = [], None
    for _ in range(3):
        r = reader.search({"query": "t1 t2 t5", "limit": 7,
                           **({"cursor": cursor} if cursor else {})})
        pages += [h.doc_id for h in r.hits]
        cursor = r.next_cursor
    gate(pages == [h.doc_id for h in full.hits], "cursor pages")
    checked.append("cursor")

    batch = ["t1 t4", "t0", "t9 t12 t20", "", "t30 t30"]
    for q, got in zip(batch, reader.search_batch(batch, limit=5)):
        gate_ref(Reference(bm25(q), 5), pair_hits(oracle, got),
                 f"batch {q!r}")
    checked.append("batch")
    return checked


# ---------------------------------------------------------------------------
# http


def phase_http(ctx):
    from searchlite.http_server import make_server

    server = make_server(ctx.path, bind="127.0.0.1:0",
                         require_existing_index=True)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def call(route, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{route}",
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            gate(resp.status == 200, f"{route}: HTTP {resp.status}")
            return json.loads(resp.read())

    t0 = time.perf_counter()
    try:
        call("/healthz")
        queries = make_queries(ctx, 16, seed=12)
        reqs = [{"query": queries[0], "limit": K},
                {"query": queries[1], "limit": K,
                 "filter": {"KeywordEq": {"field": "cat", "value": "c5"}}},
                {"query": queries[2], "limit": 5, "aggs": AGGS}]
        for req in reqs:
            got = call("/search", req)
            want = ctx.reader.search(json.loads(json.dumps(req)))
            gate([(h["doc_id"], h["score"]) for h in got["hits"]]
                 == [(h.doc_id, h.score) for h in want.hits],
                 f"/search {req['query']!r}")
            if "aggs" in req:
                gate(json.loads(json.dumps(want.aggregations))
                     == got["aggregations"], "/search aggregations")
        got = call("/search_batch", {"queries": queries, "limit": K})
        want = ctx.reader.search_batch(queries, limit=K)
        gate([[(h["doc_id"], h["score"]) for h in r]
              for r in got["results"]] == [list(map(tuple, r))
                                           for r in want],
             "/search_batch")
    finally:
        server.shutdown()
        server.server_close()
    emit("http", searches=len(reqs), batch=len(queries),
         s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# four cards


def same_hits(a, b, what):
    gate([d for d, _ in a] == [d for d, _ in b], f"{what}: doc ids")
    gate(all(abs(x - y) <= MESH_ATOL for (_, x), (_, y) in zip(a, b)),
         f"{what}: scores")


def phase_four(ctx, batch=1024, n_batches=4, n_devices=4):
    from searchlite.parallel.mesh import make_mesh

    mesh = make_mesh(n_devices, query_axis=1)
    gate(dict(mesh.shape) == {"query": 1, "shard": n_devices},
         f"mesh {dict(mesh.shape)}")
    reader = ctx.reader
    t0 = time.perf_counter()
    for name, req in lexical_requests().items():
        one = reader.search(json.loads(json.dumps(req)))
        four = reader.search(json.loads(json.dumps(req)), mesh=mesh)
        same_hits([(h.doc_id, h.score) for h in one.hits],
                  [(h.doc_id, h.score) for h in four.hits], name)
        gate(one.aggregations == four.aggregations, f"{name}: aggs")
    emit("four_search", requests=len(lexical_requests()),
         precision=os.environ.get("SEARCHLITE_PRECISION", "default"),
         s=time.perf_counter() - t0)
    queries = make_queries(ctx, batch * n_batches)
    stream = [queries[i * batch:(i + 1) * batch] for i in range(n_batches)]
    t0 = time.perf_counter()
    one = reader.search_batch_many(stream, limit=K)
    four = reader.search_batch_many(stream, limit=K, mesh=mesh)
    for bi in range(n_batches):
        for qi in range(batch):
            same_hits(one[bi][qi], four[bi][qi], f"stream {bi}/{qi}")
    emit("four_stream", queries=batch * n_batches, mesh=dict(mesh.shape),
         s=time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=1_000_000,
                    help=f"passages in the main index (up to "
                         f"{MSMARCO_PASSAGES:,}, the MS MARCO count)")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path")
    args = ap.parse_args(argv)
    if not 0 < args.docs <= MSMARCO_PASSAGES:
        ap.error(f"--docs must be in 1..{MSMARCO_PASSAGES}")

    if args.four:
        os.environ["SEARCHLITE_PRECISION"] = "f32_strict"
    import jax

    ctx = SimpleNamespace()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        phase_env(ctx, devices=4 if args.four else 1)
        phase_ingest(ctx, args.docs, os.path.join(work, "main"))
        phase_open(ctx)
        if args.four:
            phase_four(ctx)
        else:
            phase_search(ctx, stride=max(1, round(args.docs / 1e6)))
            phase_surface(ctx, SURFACE_DOCS, os.path.join(work, "surface"))
            phase_http(ctx)
        emit("memory", **memory(jax.devices()[0]))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
