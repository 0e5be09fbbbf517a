"""Native C++ ingest accelerator tests: byte-identical output with the
pure-Python path, non-ASCII fallback, graceful degradation."""

import random

import numpy as np
import pytest

from searchlite.analysis.analyzer import Analyzer
from searchlite.index.postings import InvertedIndexBuilder


def native_available():
    from searchlite.native import get_lib

    return get_lib() is not None


pytestmark = pytest.mark.skipif(not native_available(),
                                reason="no C++ toolchain")


def test_native_matches_python_builder():
    from searchlite.native import NativeIndexBuilder

    rng = random.Random(11)
    analyzer = Analyzer("default")
    nb = NativeIndexBuilder(True)
    pb = InvertedIndexBuilder(True)
    words = ["Apple", "beta-42", "Gamma", "CAFE", "zz9", "a1b2"]
    for doc in range(300):
        text = " ".join(rng.choices(words, k=rng.randint(1, 25)))
        assert nb.add_text("body", doc, text, 0) is not None
        for tok in analyzer.analyze(text):
            pb.add_term(f"body:{tok.text}", doc, tok.position)
    pn, pp = nb.build(), pb.build()
    assert pn.terms == pp.terms
    np.testing.assert_array_equal(pn.block_docs, pp.block_docs)
    np.testing.assert_array_equal(pn.block_tfs, pp.block_tfs)
    np.testing.assert_array_equal(pn.term_df, pp.term_df)
    np.testing.assert_array_equal(pn.term_block_start, pp.term_block_start)
    np.testing.assert_array_equal(pn.pos_offsets, pp.pos_offsets)
    np.testing.assert_array_equal(pn.pos_values, pp.pos_values)
    np.testing.assert_array_equal(pn.block_max_tf, pp.block_max_tf)


def test_bulk_sharded_builder_deterministic(monkeypatch):
    """Bulk adds through N term-hash shards (phase-A/phase-B threading)
    must produce output identical to the sequential single-shard path —
    the sandbox often has 1 CPU, so the threaded path is forced here."""
    import numpy as np

    from searchlite.native import NativeIndexBuilder

    rng = random.Random(23)
    words = ["Apple", "beta-42", "Gamma", "CAFE", "zz9", "a1b2", "the"]

    def build(n_threads):
        monkeypatch.setenv("SEARCHLITE_INGEST_THREADS", str(n_threads))
        nb = NativeIndexBuilder(True)
        rng2 = random.Random(23)
        texts, doc_ords, fids, new_group = [], [], [], []
        for doc in range(500):
            # two values per doc: the position chain must span them
            for vi in range(2):
                texts.append(" ".join(
                    rng2.choices(words, k=rng2.randint(1, 25))).encode())
                doc_ords.append(doc)
                fids.append(0)
                new_group.append(1 if vi == 0 else 0)
        lens = np.asarray([len(t) for t in texts], dtype=np.int64)
        text_off = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=text_off[1:])
        counts = nb.add_texts(
            b"".join(texts), text_off,
            np.asarray(doc_ords, dtype=np.uint32),
            np.asarray(fids, dtype=np.int32),
            np.asarray(new_group, dtype=np.uint8),
            b"body:", np.asarray([0, 5], dtype=np.int32),
            np.zeros(1, dtype=np.uint8), np.zeros(1, dtype=np.uint8),
            np.zeros(1, dtype=np.uint8))
        return counts, nb.build()

    c1, p1 = build(1)
    c4, p4 = build(4)
    np.testing.assert_array_equal(c1, c4)
    assert p1.terms == p4.terms
    np.testing.assert_array_equal(p1.block_docs, p4.block_docs)
    np.testing.assert_array_equal(p1.block_tfs, p4.block_tfs)
    np.testing.assert_array_equal(p1.pos_offsets, p4.pos_offsets)
    np.testing.assert_array_equal(p1.pos_values, p4.pos_values)


def test_non_ascii_rejected_without_side_effects():
    from searchlite.native import NativeIndexBuilder

    nb = NativeIndexBuilder(True)
    assert nb.add_text("body", 0, "café au lait", 0) is None
    assert nb.add_text("body", 0, "plain ascii", 0) == (2, 1)
    data = nb.build()
    assert data.terms == ["body:ascii", "body:plain"]


def test_native_stemmer_matches_python():
    from searchlite.analysis import porter2
    from searchlite.native import native_stem

    words = ("running flies happily quantization nationalization "
             "agreed controlled hopping sized authorization news "
             "dying gently exceed generously").split()
    for w in words:
        assert native_stem(w) == porter2.stem(w), w


def test_english_analyzer_native_matches_python(monkeypatch):
    """Full english chain (stopwords en + stemmer) through the native
    path must index identically to the Python analyzer."""
    import numpy as np

    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema
    import searchlite.native as natmod

    schema = {
        "analyzers": [{
            "name": "english", "tokenizer": "default",
            "filters": [
                {"type": "stopwords", "stopwords": "en"},
                {"type": "stemmer", "stemmer": "english"},
            ],
        }],
        "text_fields": [{"name": "body", "analyzer": "english",
                         "stored": True, "indexed": True}],
    }
    docs = [
        {"_id": "1", "body": "The running dogs were chasing the cats"},
        {"_id": "2", "body": "a quantization of all the stopwords"},
        {"_id": "3", "body": "café words force a fallback here"},
        {"_id": "4", "body": ["multi valued running", "the second value"]},
    ]

    def build():
        index = Index.create(
            IndexOptions(path="", create_if_missing=True,
                         storage=StorageType.IN_MEMORY),
            Schema.from_json(schema))
        w = index.writer()
        w.add_documents(docs)
        w.commit()
        return index

    idx_native = build()
    monkeypatch.setenv("SEARCHLITE_DISABLE_NATIVE", "1")
    monkeypatch.setattr(natmod, "_LIB", None)
    monkeypatch.setattr(natmod, "_LIB_FAILED", False)
    idx_python = build()
    monkeypatch.delenv("SEARCHLITE_DISABLE_NATIVE")
    monkeypatch.setattr(natmod, "_LIB", None)
    monkeypatch.setattr(natmod, "_LIB_FAILED", False)

    sn = idx_native.reader().segments[0]
    sp = idx_python.reader().segments[0]
    assert sn.terms.terms == sp.terms.terms
    np.testing.assert_array_equal(sn.postings.block_docs,
                                  sp.postings.block_docs)
    np.testing.assert_array_equal(sn.postings.pos_values,
                                  sp.postings.pos_values)
    for query in ("running", "chase", "quantization", "café", "value"):
        rn = idx_native.reader().search({"query": query, "limit": 10})
        rp = idx_python.reader().search({"query": query, "limit": 10})
        assert [(h.doc_id, round(h.score, 5)) for h in rn.hits] == \
            [(h.doc_id, round(h.score, 5)) for h in rp.hits], query


def test_segment_writer_same_output_with_and_without_native(monkeypatch):
    """Indexes built with and without the native path search identically,
    including mixed ASCII/Unicode documents."""
    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema
    import searchlite.native as natmod

    docs = [
        {"_id": "1", "body": "plain ascii words here"},
        {"_id": "2", "body": "café unicode façade naïve"},
        {"_id": "3", "body": ["multi value", "café second"]},
    ]
    schema = {"text_fields": [{"name": "body", "analyzer": "default",
                               "stored": True, "indexed": True}]}

    def build():
        index = Index.create(
            IndexOptions(path="", create_if_missing=True,
                         storage=StorageType.IN_MEMORY),
            Schema.from_json(schema))
        w = index.writer()
        w.add_documents(docs)
        w.commit()
        return index

    idx_native = build()
    monkeypatch.setenv("SEARCHLITE_DISABLE_NATIVE", "1")
    monkeypatch.setattr(natmod, "_LIB", None)
    monkeypatch.setattr(natmod, "_LIB_FAILED", False)
    idx_python = build()
    monkeypatch.delenv("SEARCHLITE_DISABLE_NATIVE")
    monkeypatch.setattr(natmod, "_LIB", None)
    monkeypatch.setattr(natmod, "_LIB_FAILED", False)

    sn = idx_native.reader().segments[0]
    sp = idx_python.reader().segments[0]
    assert sn.terms.terms == sp.terms.terms
    np.testing.assert_array_equal(sn.postings.block_docs,
                                  sp.postings.block_docs)
    np.testing.assert_array_equal(sn.postings.pos_values,
                                  sp.postings.pos_values)
    for query in ("ascii", "café", "second value"):
        rn = idx_native.reader().search({"query": query, "limit": 10})
        rp = idx_python.reader().search({"query": query, "limit": 10})
        assert [(h.doc_id, round(h.score, 5)) for h in rn.hits] == \
            [(h.doc_id, round(h.score, 5)) for h in rp.hits]


def test_native_stemmer_fuzz_matches_python():
    """Property fuzz: the C++ Porter2 must agree with the Python
    implementation on arbitrary lowercase ASCII tokens (the only input
    the default tokenizer can feed it)."""
    from searchlite.analysis import porter2
    from searchlite.native import native_stem

    rng = random.Random(1234)
    alphabet = "abcdefghijklmnopqrstuvwxyz"
    suffixes = ["", "s", "es", "ed", "ing", "ly", "ation", "ization",
                "fulness", "ational", "iveness", "ement", "ities", "e",
                "y", "ies"]
    for _ in range(5000):
        stem = "".join(rng.choices(alphabet, k=rng.randint(1, 12)))
        word = stem + rng.choice(suffixes)
        assert native_stem(word) == porter2.stem(word), word


def test_native_tokenizer_fuzz_arbitrary_ascii():
    """Arbitrary printable-ASCII values must index byte-identically
    through the native and Python paths (punctuation, digits, case,
    repeated separators, empty tokens)."""
    from searchlite.native import NativeIndexBuilder

    rng = random.Random(77)
    chars = ("abcdefgh XYZ 0123 !@#$%^&*()-_=+[]{};:'\",.<>/?\\|`~\t\n"
             "qrstuv 789")
    analyzer = Analyzer("default")
    nb = NativeIndexBuilder(True)
    pb = InvertedIndexBuilder(True)
    for doc in range(400):
        text = "".join(rng.choices(chars, k=rng.randint(0, 60)))
        assert nb.add_text("f", doc, text, 0) is not None
        for tok in analyzer.analyze(text):
            pb.add_term(f"f:{tok.text}", doc, tok.position)
    pn, pp = nb.build(), pb.build()
    assert pn.terms == pp.terms
    np.testing.assert_array_equal(pn.block_docs, pp.block_docs)
    np.testing.assert_array_equal(pn.block_tfs, pp.block_tfs)
    np.testing.assert_array_equal(pn.pos_values, pp.pos_values)
    np.testing.assert_array_equal(pn.pos_offsets, pp.pos_offsets)


def test_native_english_chain_fuzz(monkeypatch):
    """Random texts heavy with stopwords through the full english chain:
    native vs Python must produce identical segments (exercises
    position resequencing over dropped tokens, all-stopword values,
    cross-value offsets)."""
    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema
    import searchlite.native as natmod

    rng = random.Random(5)
    stop_heavy = ("the and of to in is was for with running quickly "
                  "nationalization dogs cats a an it".split())
    docs = []
    for i in range(120):
        values = [" ".join(rng.choices(stop_heavy,
                                       k=rng.randint(0, 12)))
                  for _ in range(rng.randint(1, 3))]
        docs.append({"_id": str(i), "body": values})
    schema = {
        "analyzers": [{"name": "english", "tokenizer": "default",
                       "filters": [
                           {"type": "stopwords", "stopwords": "en"},
                           {"type": "stemmer", "stemmer": "english"}]}],
        "text_fields": [{"name": "body", "analyzer": "english",
                         "stored": False, "indexed": True}],
    }

    def build():
        index = Index.create(
            IndexOptions(path="", create_if_missing=True,
                         storage=StorageType.IN_MEMORY),
            Schema.from_json(schema))
        w = index.writer()
        w.add_documents(docs)
        w.commit()
        return index.reader().segments[0]

    sn = build()
    monkeypatch.setenv("SEARCHLITE_DISABLE_NATIVE", "1")
    monkeypatch.setattr(natmod, "_LIB", None)
    monkeypatch.setattr(natmod, "_LIB_FAILED", False)
    sp = build()
    monkeypatch.delenv("SEARCHLITE_DISABLE_NATIVE")
    monkeypatch.setattr(natmod, "_LIB", None)
    monkeypatch.setattr(natmod, "_LIB_FAILED", False)

    assert sn.terms.terms == sp.terms.terms
    np.testing.assert_array_equal(sn.postings.block_docs,
                                  sp.postings.block_docs)
    np.testing.assert_array_equal(sn.postings.block_tfs,
                                  sp.postings.block_tfs)
    np.testing.assert_array_equal(sn.postings.pos_values,
                                  sp.postings.pos_values)
    np.testing.assert_array_equal(sn.postings.pos_offsets,
                                  sp.postings.pos_offsets)
    col_n = sn.fast.column("_len:body")
    col_p = sp.fast.column("_len:body")
    np.testing.assert_array_equal(col_n.row_ids, col_p.row_ids)
    np.testing.assert_array_equal(col_n.values, col_p.values)


class TestNativeUnicode:
    """Native NFKC + UAX#29 + lowercase chain vs the Python pipeline
    (analysis/uax29.py + tokenizers.py): token streams must be
    byte-identical."""

    def _stream_native(self, texts, stopwords=None):
        from searchlite.native import NativeIndexBuilder

        nb = NativeIndexBuilder(True)
        if stopwords is not None:
            assert nb.register_stopwords(frozenset(stopwords))
        for doc, text in enumerate(texts):
            out = nb.add_text("f", doc, text, 0,
                              use_stopwords=stopwords is not None,
                              tokenizer="unicode")
            assert out is not None
        return nb.build()

    def _stream_python(self, texts, stopwords=None):
        descriptors = ([("stopwords", frozenset(stopwords))]
                       if stopwords is not None else [])
        from searchlite.analysis.analyzer import AnalyzerRegistry

        if stopwords is None:
            analyzer = Analyzer("unicode")
        else:
            analyzer = AnalyzerRegistry.from_defs([{
                "name": "u", "tokenizer": "unicode",
                "filters": [{"type": "stopwords",
                             "stopwords": sorted(stopwords)}],
            }]).get("u")
        pb = InvertedIndexBuilder(True)
        for doc, text in enumerate(texts):
            for tok in analyzer.analyze(text):
                pb.add_term(f"f:{tok.text}", doc, tok.position)
        return pb.build()

    def _assert_same(self, pn, pp):
        assert pn.terms == pp.terms
        np.testing.assert_array_equal(pn.block_docs, pp.block_docs)
        np.testing.assert_array_equal(pn.block_tfs, pp.block_tfs)
        np.testing.assert_array_equal(pn.term_df, pp.term_df)
        np.testing.assert_array_equal(pn.pos_offsets, pp.pos_offsets)
        np.testing.assert_array_equal(pn.pos_values, pp.pos_values)

    def test_multilingual_corpus(self):
        texts = [
            "Füße laufen ÜBER die Straße",
            "ＨＥＬＬＯ ﬁle x² ﬂow",
            "can't jump 32.3 feet, right?",
            "קל\"ב א' ГОД Δος ΑΣ ΣΑΣ",
            "가나다 한국어 각 조합",  # composed + jamo
            "カタカナ 日本語 ひらがな",
            "étude + Zalgo ȩ̴́x",  # ccc ordering
            "emoji 😀 flags 🇺🇸🇫🇷 zwj 👩‍🚀 done",
            "mixed_ExtendNumLet_2 a:b example.com 1,000.5",
            "مرحبا بالعالم हिन्दी ภาษาไทย",
            "",
            "   \t\r\n  ",
        ]
        self._assert_same(self._stream_native(texts),
                          self._stream_python(texts))

    def test_fuzz_codepoint_soup(self):
        rng = random.Random(71)
        pool = (
            "abcXYZÀÉÏüßΑΒΓΣςαбВгאב'ג\"کمह한각中カナ"
            "😀🇺🇸‍̴ְ̧́ \t\n.,:-_'\"0129٣²ﬁＡ"
            "ﷺ㌀¼")
        texts = []
        for _ in range(400):
            texts.append("".join(rng.choice(pool)
                                 for _ in range(rng.randint(0, 40))))
        self._assert_same(self._stream_native(texts),
                          self._stream_python(texts))

    def test_unicode_with_stopwords(self):
        stop = {"the", "ένα", "और"}
        texts = ["The THE the quick ένα και और भी fox"]
        self._assert_same(self._stream_native(texts, stop),
                          self._stream_python(texts, stop))

    def test_segment_writer_unicode_native_matches_python(self, monkeypatch):
        import random as _r

        from searchlite.index.manifest import Schema
        from searchlite.index.segment import SegmentWriter
        from searchlite.storage import InMemoryStorage

        rng = _r.Random(5)
        schema = Schema.from_json({
            "analyzers": [{"name": "u", "tokenizer": "unicode",
                           "filters": []}],
            "text_fields": [{"name": "body", "analyzer": "u",
                             "stored": False, "indexed": True}]})
        words = ["Füße", "ΑΣ", "한국어", "ﬁle", "étude", "中文",
                 "can't", "3.14", "🇺🇸", "مرحبا"]
        docs = [{"_id": str(i),
                 "body": " ".join(rng.choices(words, k=rng.randint(1, 12)))}
                for i in range(120)]

        def write(disable_native):
            if disable_native:
                monkeypatch.setenv("SEARCHLITE_DISABLE_NATIVE", "1")
            else:
                monkeypatch.delenv("SEARCHLITE_DISABLE_NATIVE",
                                   raising=False)
            import searchlite.native as native_mod
            monkeypatch.setattr(native_mod, "_LIB_FAILED", False)
            storage = InMemoryStorage()
            writer = SegmentWriter(schema, storage)
            meta = writer.write_segment(iter(docs), generation=1)
            return storage, meta

        from searchlite.index.segment import SegmentReader
        sa, ma = write(False)
        sb, mb = write(True)
        ra = SegmentReader(ma, sa)
        rb = SegmentReader(mb, sb)
        assert ra.postings.terms == rb.postings.terms
        np.testing.assert_array_equal(ra.postings.block_docs,
                                      rb.postings.block_docs)
        np.testing.assert_array_equal(ra.postings.block_tfs,
                                      rb.postings.block_tfs)
        np.testing.assert_array_equal(ra.postings.pos_values,
                                      rb.postings.pos_values)


def test_native_impacts_bit_identical_to_numpy():
    """slt_impacts (device-segment impact precompute in C) must be
    bit-identical to the numpy spec across corpus shapes, fields,
    deletes, and empty-avg edge cases."""
    import random

    import numpy as np

    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    rng = random.Random(42)
    nrng = np.random.default_rng(42)
    for _trial in range(3):
        idx = Index.create(
            IndexOptions(path="", create_if_missing=True,
                         storage=StorageType.IN_MEMORY,
                         enable_positions=rng.random() < 0.5),
            Schema.from_json({
                "text_fields": [
                    {"name": "body", "analyzer": "default",
                     "stored": False, "indexed": True},
                    {"name": "title", "analyzer": "default",
                     "stored": False, "indexed": True}]}))
        w = idx.writer()
        vocab = rng.choice((30, 500))
        for d in range(rng.choice((50, 800))):
            doc = {"_id": str(d),
                   "body": " ".join(
                       f"w{nrng.integers(vocab)}"
                       for _ in range(int(nrng.integers(1, 40))))}
            if rng.random() < 0.5:
                doc["title"] = f"w{nrng.integers(vocab)}"
            w.add_document(doc)
        w.commit()
        reader = idx.reader()
        for dseg in reader.device_segments:
            seg = dseg.reader
            postings = seg.postings
            if not postings.block_docs.size:
                continue
            term_df = postings.term_df.astype(np.int64)
            nf = len(dseg.len_field_ids) + 1
            doc_len = np.asarray(dseg.doc_len)
            avgdl = np.asarray(dseg.avgdl)
            tf_ = np.asarray(
                [dseg.len_field_ids.get(t.split(":", 1)[0], nf - 1)
                 for t in postings.terms], dtype=np.int32)
            a = dseg._impacts_native(postings, tf_, term_df, doc_len,
                                     avgdl)
            b = dseg._impacts_numpy(postings, tf_, term_df, doc_len,
                                    avgdl)
            assert a is not None
            for x, y, name in zip(a, b,
                                  ("bd", "bi", "bmax", "df", "imp")):
                xx, yy = np.asarray(x), np.asarray(y)
                assert xx.shape == yy.shape, name
                if xx.dtype == np.float32:
                    assert np.array_equal(xx.view(np.int32),
                                          yy.view(np.int32)), name
                else:
                    assert np.array_equal(xx, yy), name
