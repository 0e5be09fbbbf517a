"""Analyzer/tokenizer/stemmer tests.

Golden expectations mirror the reference's unit tests
(searchlite-core `analysis/analyzer.rs:479-570`, `analysis/tokenizer.rs:61-90`).
"""

from searchlite.analysis import porter2
from searchlite.analysis.analyzer import (
    Analyzer,
    AnalyzerRegistry,
    analyzer_from_def,
)
from searchlite.analysis.tokenizers import (
    default_tokenize,
    unicode_tokenize,
    whitespace_tokenize,
)
import pytest

from searchlite.errors import SchemaError


def texts(tokens):
    return [t.text for t in tokens]


def pairs(tokens):
    return [(t.text, t.position) for t in tokens]


class TestTokenizers:
    def test_default_tokenizes_words(self):
        out = default_tokenize("Rust: systems programming language")
        assert pairs(out) == [
            ("rust", 0), ("systems", 1), ("programming", 2), ("language", 3)
        ]

    def test_default_keeps_non_ascii_case(self):
        # Reference uses to_ascii_lowercase: non-ASCII untouched.
        out = default_tokenize("Ärger")
        assert texts(out) == ["Ärger"]

    def test_unicode_normalizes_and_folds(self):
        out = unicode_tokenize("CAFÉ ﬂavor")
        assert texts(out) == ["café", "flavor"]

    def test_whitespace_preserves_case(self):
        out = whitespace_tokenize("Hello  World")
        assert pairs(out) == [("Hello", 0), ("World", 1)]


class TestPorter2:
    @pytest.mark.parametrize(
        "word,expected",
        [
            ("running", "run"),
            ("runners", "runner"),
            ("caresses", "caress"),
            ("ponies", "poni"),
            ("ties", "tie"),
            ("cats", "cat"),
            ("feed", "feed"),
            ("agreed", "agre"),
            ("plastered", "plaster"),
            ("motoring", "motor"),
            ("sing", "sing"),
            ("conflated", "conflat"),
            ("troubling", "troubl"),
            ("sized", "size"),
            ("hopping", "hop"),
            ("tanned", "tan"),
            ("falling", "fall"),
            ("hissing", "hiss"),
            ("fizzed", "fizz"),
            ("failing", "fail"),
            ("filing", "file"),
            ("happy", "happi"),
            ("sky", "sky"),
            ("relational", "relat"),
            ("conditional", "condit"),
            ("rational", "ration"),
            ("valenci", "valenc"),
            ("hesitanci", "hesit"),
            ("digitizer", "digit"),
            ("conformabli", "conform"),
            ("radicalli", "radic"),
            ("differentli", "differ"),
            ("vileli", "vile"),
            ("analogousli", "analog"),
            ("vietnamization", "vietnam"),
            ("predication", "predic"),
            ("operator", "oper"),
            ("feudalism", "feudal"),
            ("decisiveness", "decis"),
            ("hopefulness", "hope"),
            ("callousness", "callous"),
            ("formaliti", "formal"),
            ("sensitiviti", "sensit"),
            ("sensibiliti", "sensibl"),
            ("triplicate", "triplic"),
            ("formative", "format"),
            ("formalize", "formal"),
            ("electriciti", "electr"),
            ("electrical", "electr"),
            ("hopeful", "hope"),
            ("goodness", "good"),
            ("revival", "reviv"),
            ("allowance", "allow"),
            ("inference", "infer"),
            ("airliner", "airlin"),
            ("gyroscopic", "gyroscop"),
            ("adjustable", "adjust"),
            ("defensible", "defens"),
            ("irritant", "irrit"),
            ("replacement", "replac"),
            ("adjustment", "adjust"),
            ("dependent", "depend"),
            ("adoption", "adopt"),
            ("communism", "communism"),
            ("activate", "activ"),
            ("angulariti", "angular"),
            ("homologous", "homolog"),
            ("effective", "effect"),
            ("bowdlerize", "bowdler"),
            ("probate", "probat"),
            ("rate", "rate"),
            ("cease", "ceas"),
            ("controll", "control"),
            ("roll", "roll"),
            ("skis", "ski"),
            ("dying", "die"),
            ("news", "news"),
            ("inning", "inning"),
            ("proceed", "proceed"),
            ("exceed", "exceed"),
            ("generate", "generat"),
            ("generously", "generous"),
        ],
    )
    def test_vocabulary(self, word, expected):
        assert porter2.stem(word) == expected


class TestAnalyzer:
    def test_default_analyzer_matches_legacy(self):
        analyzer = Analyzer("default")
        out = analyzer.analyze("Rust: systems programming language")
        assert texts(out) == ["rust", "systems", "programming", "language"]

    def test_stopwords_named_en(self):
        analyzer = analyzer_from_def(
            {"tokenizer": "default", "filters": [
                {"type": "stopwords", "stopwords": "en"}]}
        )
        out = analyzer.analyze("the quick brown fox")
        assert texts(out) == ["quick", "brown", "fox"]

    def test_stemmer_filter(self):
        analyzer = analyzer_from_def(
            {"tokenizer": "default", "filters": [
                {"type": "stemmer", "stemmer": "english"}]}
        )
        out = analyzer.analyze("running runners")
        assert texts(out) == ["run", "runner"]

    def test_synonyms_expand_same_position(self):
        analyzer = analyzer_from_def(
            {
                "tokenizer": "default",
                "filters": [
                    {"type": "synonyms",
                     "synonyms": [{"from": ["nyc"], "to": ["new", "york"]}]}
                ],
            }
        )
        out = analyzer.analyze("nyc subway")
        assert pairs(out) == [
            ("nyc", 0), ("new", 0), ("york", 0), ("subway", 1)
        ]

    def test_edge_ngram(self):
        analyzer = analyzer_from_def(
            {"tokenizer": "default",
             "filters": [{"type": "edge_ngram",
                          "edge_ngram": {"min": 1, "max": 3}}]}
        )
        out = analyzer.analyze("rust")
        assert texts(out) == ["r", "ru", "rus"]

    def test_filter_string_form(self):
        analyzer = analyzer_from_def(
            {"tokenizer": "whitespace", "filters": ["lowercase"]}
        )
        out = analyzer.analyze("Hello World")
        assert texts(out) == ["hello", "world"]

    def test_registry_rejects_default_name(self):
        with pytest.raises(SchemaError):
            AnalyzerRegistry.from_defs(
                [{"name": "default", "tokenizer": "default"}])

    def test_registry_rejects_duplicates(self):
        with pytest.raises(SchemaError):
            AnalyzerRegistry.from_defs(
                [
                    {"name": "a", "tokenizer": "default"},
                    {"name": "a", "tokenizer": "unicode"},
                ]
            )

    def test_normalize_pattern(self):
        assert Analyzer("default").normalize_pattern("AbC*") == "abc*"
        assert Analyzer("whitespace").normalize_pattern("AbC*") == "AbC*"

    def test_multi_word_synonym(self):
        analyzer = analyzer_from_def(
            {
                "tokenizer": "default",
                "filters": [
                    {"type": "synonyms",
                     "synonyms": [
                         {"from": ["big", "apple"], "to": ["nyc"]}]}
                ],
            }
        )
        out = analyzer.analyze("the big apple city")
        # Resequencing only collapses *consecutive* same-source positions
        # (parity: `analysis/analyzer.rs:441-454`), so the multi-word
        # replacement lands after its source tokens.
        assert pairs(out) == [
            ("the", 0), ("big", 1), ("apple", 2), ("nyc", 3), ("city", 4),
        ]
