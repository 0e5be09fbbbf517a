"""Seeded robustness fuzz: random corpora + random requests across the
feature surface must either succeed or raise typed Searchlite errors —
never crash with arbitrary exceptions."""

import math
import random

import numpy as np
import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.errors import SearchliteError
from searchlite.index import Index
from searchlite.index.manifest import Schema

VOCAB = [f"w{i}" for i in range(40)] + ["café", "naïve"]
TAGS = ["a", "b", "c", None]


@pytest.fixture(scope="module")
def index():
    rng = random.Random(99)
    schema = Schema.from_json({
        "text_fields": [{"name": "body", "analyzer": "default",
                         "stored": True, "indexed": True}],
        "keyword_fields": [{"name": "tag", "stored": True, "indexed": True,
                            "fast": True, "nullable": True}],
        "numeric_fields": [{"name": "n", "i64": True, "fast": True,
                            "stored": True, "nullable": True}],
        "vector_fields": [{"name": "v", "dim": 3, "metric": "Cosine"}],
    })
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY), schema)
    writer = idx.writer()
    for i in range(150):
        doc = {"_id": str(i),
               "body": " ".join(rng.choices(VOCAB, k=rng.randint(1, 15)))}
        tag = rng.choice(TAGS)
        if tag:
            doc["tag"] = tag
        if rng.random() < 0.8:
            doc["n"] = rng.randint(-5, 100)
        if rng.random() < 0.5:
            doc["v"] = [rng.random() for _ in range(3)]
        writer.add_document(doc)
        if i == 70:
            writer.commit()
    writer.commit()
    return idx


def random_query(rng, depth=0):
    kinds = ["string", "term", "prefix", "wildcard", "phrase", "match_all",
             "fuzzy_string", "vector"]
    if depth < 2:
        kinds += ["bool", "dis_max", "function_score", "script_score",
                  "constant_score"]
    kind = rng.choice(kinds)
    if kind == "string":
        parts = rng.choices(VOCAB + ["-w1", 'tag:a', '"w1 w2"'],
                            k=rng.randint(1, 3))
        return " ".join(parts)
    if kind == "fuzzy_string":
        return rng.choice(VOCAB)[:-1] + "x"
    if kind == "term":
        return {"type": "term", "field": rng.choice(["body", "tag"]),
                "value": rng.choice(VOCAB + ["a", "b"])}
    if kind == "prefix":
        return {"type": "prefix", "field": "body",
                "value": rng.choice(VOCAB)[:2]}
    if kind == "wildcard":
        return {"type": "wildcard", "field": "body", "value": "w*"}
    if kind == "phrase":
        return {"type": "phrase", "field": "body",
                "terms": rng.choices(VOCAB, k=2),
                "slop": rng.choice([0, 1, 3])}
    if kind == "match_all":
        return {"type": "match_all"}
    if kind == "vector":
        return {"type": "vector", "field": "v",
                "vector": [rng.random() for _ in range(3)],
                "alpha": rng.choice([0.0, 0.5, 1.0])}
    if kind == "bool":
        return {"type": "bool",
                "must": [random_query(rng, depth + 1)
                         for _ in range(rng.randint(0, 2))],
                "should": [random_query(rng, depth + 1)
                           for _ in range(rng.randint(0, 2))],
                "must_not": [random_query(rng, depth + 1)
                             for _ in range(rng.randint(0, 1))],
                "filter": [random_filter(rng)]
                if rng.random() < 0.5 else []}
    if kind == "dis_max":
        return {"type": "dis_max",
                "queries": [random_query(rng, depth + 1)
                            for _ in range(rng.randint(1, 3))],
                "tie_breaker": rng.choice([0.0, 0.3, 1.0])}
    if kind == "function_score":
        return {"type": "function_score",
                "query": random_query(rng, depth + 1),
                "functions": [
                    rng.choice([
                        {"type": "weight", "weight": 2.0},
                        {"type": "field_value_factor", "field": "n",
                         "factor": 0.5, "modifier": "log1p"},
                        {"type": "decay", "field": "n", "origin": 50,
                         "scale": 10},
                    ])],
                "score_mode": rng.choice(["sum", "multiply", "max"]),
                "boost_mode": rng.choice(["multiply", "sum", "replace"])}
    if kind == "script_score":
        return {"type": "script_score",
                "query": random_query(rng, depth + 1),
                "script": rng.choice(["_score * 2", "n + 1",
                                      "_score / (n + 0.5)"])}
    if kind == "constant_score":
        return {"type": "constant_score", "filter": random_filter(rng),
                "boost": 1.5}
    raise AssertionError(kind)


def random_filter(rng, depth=0):
    kinds = ["KeywordEq", "KeywordIn", "I64Range"]
    if depth < 1:
        kinds += ["And", "Or", "Not"]
    kind = rng.choice(kinds)
    if kind == "KeywordEq":
        return {"KeywordEq": {"field": "tag",
                              "value": rng.choice(["a", "b", "z"])}}
    if kind == "KeywordIn":
        return {"KeywordIn": {"field": "tag", "values": ["a", "c"]}}
    if kind == "I64Range":
        lo = rng.randint(-10, 50)
        return {"I64Range": {"field": "n", "min": lo,
                             "max": lo + rng.randint(0, 60)}}
    if kind == "And":
        return {"And": [random_filter(rng, depth + 1)
                        for _ in range(rng.randint(1, 2))]}
    if kind == "Or":
        return {"Or": [random_filter(rng, depth + 1)
                       for _ in range(rng.randint(1, 2))]}
    return {"Not": random_filter(rng, depth + 1)}


def random_aggs(rng):
    out = {}
    for _ in range(rng.randint(0, 2)):
        name = f"a{rng.randint(0, 9)}"
        out[name] = rng.choice([
            {"type": "terms", "field": "tag"},
            {"type": "stats", "field": "n"},
            {"type": "histogram", "field": "n", "interval": 10},
            {"type": "value_count", "field": "n"},
            {"type": "cardinality", "field": "tag"},
            {"type": "filter",
             "filter": {"KeywordEq": {"field": "tag", "value": "a"}},
             "aggs": {"s": {"type": "stats", "field": "n"}}},
        ])
    return out


def test_fuzz_requests_never_crash(index):
    rng = random.Random(2024)
    reader = index.reader()
    executed = 0
    for i in range(60):
        req = {"query": random_query(rng), "limit": rng.randint(1, 20)}
        if rng.random() < 0.4:
            req["filter"] = random_filter(rng)
        if rng.random() < 0.3:
            req["aggs"] = random_aggs(rng)
        if rng.random() < 0.3:
            req["sort"] = [{"field": rng.choice(["_score", "n", "tag"]),
                            "order": rng.choice(["asc", "desc"])}]
        if rng.random() < 0.3:
            req["fuzzy"] = {"max_edits": rng.choice([1, 2])}
        if rng.random() < 0.2:
            req["return_stored"] = True
            req["highlight_field"] = "body"
        if rng.random() < 0.2:
            req["collapse"] = {"field": "tag"}
        if rng.random() < 0.2:
            req["execution"] = rng.choice(["bm25", "wand", "bmw"])
        if rng.random() < 0.15:
            req["rescore"] = {"window_size": 5,
                              "query": {"type": "term", "field": "body",
                                        "value": "w1"}}
        if rng.random() < 0.15:
            req["explain"] = True
        if rng.random() < 0.15:
            req["profile"] = True
        try:
            res = reader.search(req)
            assert res.total_hits_estimate >= len(res.hits) or \
                res.total_hits_estimate >= 0
            executed += 1
        except SearchliteError:
            pass  # typed errors are acceptable outcomes
    assert executed >= 40  # the vast majority should succeed


def test_fuzz_pagination_consistency(index):
    """For random sortable requests, paginating must visit exactly the
    docs of the one-shot result, in order."""
    rng = random.Random(7)
    reader = index.reader()
    for _ in range(6):
        base = {"query": rng.choice(["w1 w2 w3", "w4", "w5 w6"]),
                "sort": rng.choice([[], [{"field": "n"}],
                                    [{"field": "tag", "order": "desc"},
                                     {"field": "n"}]])}
        try:
            full = reader.search(dict(base, limit=200))
        except SearchliteError:
            continue
        expected = [h.doc_id for h in full.hits]
        seen = []
        cursor = None
        for _page in range(100):
            req = dict(base, limit=rng.randint(2, 9))
            if cursor:
                req["cursor"] = cursor
            res = reader.search(req)
            seen.extend(h.doc_id for h in res.hits)
            cursor = res.next_cursor
            if cursor is None:
                break
        assert seen == expected


def test_fuzz_aggs_match_naive_oracle(index):
    """Aggregation VALUES (not just no-crash): random filters, compare
    terms/value_count/stats/histogram against a naive python recount
    over the documents the engine itself reports as stored."""
    rng = random.Random(31)
    reader = index.reader()

    # reconstruct the corpus from stored fields (via match_all paging)
    docs = {}
    res = reader.search({"query": {"type": "match_all"}, "limit": 1000,
                         "return_stored": True})
    for h in res.hits:
        docs[h.doc_id] = h.fields

    for _trial in range(25):
        flt = random_filter(rng)
        request = {"query": {"type": "match_all"}, "limit": 1,
                   "return_hits": False,
                   "aggs": {
                       "t": {"type": "terms", "field": "tag"},
                       "c": {"type": "value_count", "field": "n"},
                       "s": {"type": "stats", "field": "n"},
                       "h": {"type": "histogram", "field": "n",
                             "interval": 25},
                   }}
        if flt is not None:
            request["filter"] = flt
        out = reader.search(request)
        aggs = out.aggregations

        from searchlite.query.filters import compute_filters_mask
        matched_ids = set()
        for seg in reader.segments:
            mask = compute_filters_mask(
                seg.fast, [_filter_obj(flt)]) if flt is not None else \
                np.ones(seg.doc_count, dtype=bool)
            for doc in np.flatnonzero(mask):
                if not seg.is_deleted(int(doc)):
                    matched_ids.add(seg.doc_id(int(doc)))

        values = [docs[d].get("n") for d in matched_ids
                  if docs[d].get("n") is not None]
        tags = [docs[d].get("tag") for d in matched_ids
                if docs[d].get("tag") is not None]

        got_terms = {b["key"]: b["doc_count"]
                     for b in aggs["t"]["buckets"]}
        want_terms = {}
        for t in tags:
            want_terms[t] = want_terms.get(t, 0) + 1
        assert got_terms == want_terms, flt

        assert aggs["c"]["value"] == len(values), flt
        if values:
            assert aggs["s"]["count"] == len(values)
            assert aggs["s"]["min"] == min(values)
            assert aggs["s"]["max"] == max(values)
            assert abs(aggs["s"]["sum"] - sum(values)) < 1e-6
            want_h = {}
            for v in values:
                key = math.floor(v / 25) * 25.0
                want_h[key] = want_h.get(key, 0) + 1
            got_h = {b["key"]: b["doc_count"]
                     for b in aggs["h"]["buckets"]
                     if b["doc_count"] > 0}
            assert got_h == want_h, flt


def _filter_obj(flt):
    from searchlite.api.types import Filter
    return Filter.from_json(flt)


def test_fuzz_sort_drain_matches_naive_oracle():
    """Field sorts + cursor pagination against a naive oracle of the
    reference sort semantics: multi-valued fields take min (asc) / max
    (desc), missing sorts last, ties break by (segment, doc)."""
    rng = random.Random(63)
    schema = Schema.from_json({
        "text_fields": [{"name": "body", "analyzer": "default",
                         "stored": True, "indexed": True}],
        "keyword_fields": [{"name": "k", "stored": True, "indexed": True,
                            "fast": True, "nullable": True}],
        "numeric_fields": [{"name": "n", "i64": True, "fast": True,
                            "stored": True, "nullable": True}],
    })
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY), schema)
    writer = idx.writer()
    corpus = {}
    for i in range(90):
        doc = {"_id": f"d{i:03d}", "body": "common token"}
        if rng.random() < 0.85:
            vals = [rng.randint(0, 9) for _ in range(rng.randint(1, 3))]
            doc["n"] = vals if len(vals) > 1 else vals[0]
        if rng.random() < 0.85:
            vals = [rng.choice("abcdef") for _ in range(rng.randint(1, 2))]
            doc["k"] = vals if len(vals) > 1 else vals[0]
        corpus[doc["_id"]] = doc
        writer.add_document(doc)
        if i == 44:
            writer.commit()  # two segments
    writer.commit()
    reader = idx.reader()

    # engine doc order for tie-break: (segment_ord, doc ordinal)
    engine_rank = {}
    for seg_ord, seg in enumerate(reader.segments):
        for ordinal in range(seg.doc_count):
            engine_rank[seg.doc_id(ordinal)] = (seg_ord, ordinal)

    def oracle_key(doc_id, spec):
        parts = []
        for field, order in spec:
            v = corpus[doc_id].get(field)
            vals = v if isinstance(v, list) else ([v] if v is not None
                                                  else [])
            if not vals:
                parts.append((1, 0))  # missing last regardless of order
                continue
            chosen = min(vals) if order == "asc" else max(vals)
            rankv = chosen if order == "asc" else _neg(chosen)
            parts.append((0, rankv))
        return tuple(parts) + (engine_rank[doc_id],)

    def _neg(v):
        if isinstance(v, str):
            # descending strings: invert char ranks (ascii subset)
            return tuple(-ord(c) for c in v)
        return -v

    for _trial in range(10):
        n_fields = rng.randint(1, 2)
        spec = []
        for f in rng.sample(["n", "k"], k=n_fields):
            spec.append((f, rng.choice(["asc", "desc"])))
        want = sorted(corpus, key=lambda d: oracle_key(d, spec))

        got = []
        cursor = None
        sort_json = [{"field": f, "order": o} for f, o in spec]
        for _page in range(40):
            req = {"query": "common", "limit": 7, "sort": sort_json}
            if cursor:
                req["cursor"] = cursor
            res = reader.search(req)
            got.extend(h.doc_id for h in res.hits)
            cursor = res.next_cursor
            if not cursor:
                break
        assert got == want, (spec, got[:10], want[:10])


def test_fuzz_phrase_slop_matches_naive_oracle():
    """Phrase matching with slop vs a brute-force oracle over token
    positions (reference semantics: recursive ordered match where each
    next term may sit up to `slop` positions past the previous match)."""
    from searchlite.query.phrase import matches_phrase

    rng = random.Random(17)
    vocab = ["p", "q", "r", "s"]
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({"text_fields": [
            {"name": "body", "analyzer": "default", "stored": True,
             "indexed": True}]}))
    writer = idx.writer()
    texts = {}
    for i in range(80):
        toks = rng.choices(vocab, k=rng.randint(2, 12))
        texts[str(i)] = toks
        writer.add_document({"_id": str(i), "body": " ".join(toks)})
    writer.commit()
    reader = idx.reader()

    def oracle(tokens, terms, slop):
        # TOTAL gap budget across the phrase (parity: query/phrase.rs)
        positions = [[p for p, t in enumerate(tokens) if t == term]
                     for term in terms]
        if any(not p for p in positions):
            return False

        def walk(level, prev, remaining):
            if level == len(positions):
                return True
            for pos in positions[level]:
                if pos <= prev:
                    continue
                gap = max(pos - prev - 1, 0)
                if gap > remaining:
                    return False
                if walk(level + 1, pos, remaining - gap):
                    return True
            return False

        return any(walk(1, p0, slop) for p0 in positions[0])

    for _trial in range(30):
        terms = rng.choices(vocab, k=rng.randint(2, 3))
        slop = rng.choice([0, 1, 2])
        res = reader.search({
            "query": {"type": "phrase", "field": "body", "terms": terms,
                      "slop": slop},
            "limit": 100})
        got = sorted(h.doc_id for h in res.hits)
        want = sorted(d for d, toks in texts.items()
                      if oracle(toks, terms, slop))
        assert got == want, (terms, slop, got[:5], want[:5])


def _lev(a: str, b: str, cap: int = 3) -> int:
    if abs(len(a) - len(b)) > cap:
        return cap + 1
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def test_fuzz_fuzzy_expansion_matches_naive_oracle():
    """Fuzzy term matching vs brute-force Levenshtein over the corpus
    vocabulary: same matched doc sets under max_edits/prefix_length/
    min_length (reference: api/reader.rs:1394-1465 + fuzzy defaults)."""
    rng = random.Random(29)
    vocab = ["stone", "stork", "story", "shore", "chore", "spore",
             "sting", "stable", "cable", "fable"]
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({"text_fields": [
            {"name": "body", "analyzer": "default", "stored": True,
             "indexed": True}]}))
    writer = idx.writer()
    docs = {}
    for i in range(60):
        words = rng.sample(vocab, k=rng.randint(1, 3))
        docs[str(i)] = set(words)
        writer.add_document({"_id": str(i), "body": " ".join(words)})
    writer.commit()
    reader = idx.reader()

    for _trial in range(25):
        base = rng.choice(vocab)
        # random 0-2 edit typo
        word = list(base)
        for _ in range(rng.randint(0, 2)):
            op = rng.choice(["sub", "del", "ins"])
            pos = rng.randrange(1, max(len(word), 2))
            if op == "sub" and pos < len(word):
                word[pos] = rng.choice("abcdefghijklmnop")
            elif op == "del" and len(word) > 2 and pos < len(word):
                del word[pos]
            else:
                word.insert(pos, rng.choice("abcdefghijklmnop"))
        query = "".join(word)
        max_edits = rng.choice([1, 2])
        prefix_len = rng.choice([0, 1, 2])
        res = reader.search({
            "query": {"type": "term", "field": "body", "value": query},
            "fuzzy": {"enabled": True, "max_edits": max_edits,
                      "prefix_length": prefix_len, "min_length": 3,
                      "max_expansions": 50},
            "limit": 100})
        got = sorted(h.doc_id for h in res.hits)
        if len(query) < 3:
            # below min_length only exact matches qualify
            matching = {t for t in vocab if t == query}
        else:
            matching = {t for t in vocab
                        if t[:prefix_len] == query[:prefix_len]
                        and _lev(query, t) <= max_edits}
        want = sorted(d for d, words in docs.items() if words & matching)
        assert got == want, (query, max_edits, prefix_len,
                             sorted(matching), got[:5], want[:5])


def test_fuzz_wildcard_and_regex_match_naive_oracle():
    """Wildcard and anchored-regex expansion vs fnmatch/re over the
    corpus vocabulary (reference: api/reader.rs:1212-1374 — `*`/`?`
    wildcards, anchored regex, analyzer-lowercased patterns)."""
    import fnmatch
    import re

    rng = random.Random(41)
    vocab = ["walk", "walked", "walker", "wall", "wind", "window",
             "winter", "wander", "tent", "tint", "taint"]
    idx = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json({"text_fields": [
            {"name": "body", "analyzer": "default", "stored": True,
             "indexed": True}]}))
    writer = idx.writer()
    docs = {}
    for i in range(70):
        words = rng.sample(vocab, k=rng.randint(1, 3))
        docs[str(i)] = set(words)
        writer.add_document({"_id": str(i), "body": " ".join(words)})
    writer.commit()
    reader = idx.reader()

    wild_patterns = ["w*", "w?nd*", "*er", "wal?", "t?nt", "w*er", "zz*"]
    for pattern in wild_patterns:
        res = reader.search({
            "query": {"type": "wildcard", "field": "body",
                      "value": pattern},
            "limit": 100})
        got = sorted(h.doc_id for h in res.hits)
        matching = {t for t in vocab if fnmatch.fnmatchcase(t, pattern)}
        want = sorted(d for d, ws in docs.items() if ws & matching)
        assert got == want, (pattern, sorted(matching))

    regex_patterns = ["w.*", "w(al|in).*", ".*er", "t.nt", "w[ai]..(er)?"]
    for pattern in regex_patterns:
        res = reader.search({
            "query": {"type": "regex", "field": "body",
                      "value": pattern},
            "limit": 100})
        got = sorted(h.doc_id for h in res.hits)
        matching = {t for t in vocab if re.fullmatch(pattern, t)}
        want = sorted(d for d, ws in docs.items() if ws & matching)
        assert got == want, (pattern, sorted(matching))
