"""Analyzer: tokenizer + ordered token filters, with a named registry.

Behavioral parity with searchlite-core `analysis/analyzer.rs`:
filters lowercase / stopwords / stemmer / synonyms / edge_ngram,
position resequencing after filtering, flexible filter-def parsing
(string or object forms), reserved ``default`` analyzer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from searchlite.analysis import porter2
from searchlite.analysis.tokenizers import TOKENIZERS, Token
from searchlite.errors import SchemaError

ENGLISH_STOPWORDS = frozenset(
    """a about after all also an and another any are as at be because been
    before being between both but by came can come could did do each for from
    get got had has have he her here him himself his how if in into is it like
    make many me might more most much must my never now of on only or other
    our out over said same see should since some still such take than that the
    their them then there these they this those through to too under up use
    very want was way we well were what when where which while who will with
    would you your""".split()
)


@dataclass
class SynonymRule:
    from_terms: list[str]
    to_terms: list[str]


@dataclass
class _EdgeNgram:
    min: int
    max: int


class Analyzer:
    def __init__(self, tokenizer: str = "default",
                 filters: list[Callable[[list[Token]], list[Token]]] | None = None,
                 lowercases: bool | None = None,
                 descriptors: list[tuple] | None = None):
        if tokenizer not in TOKENIZERS:
            raise SchemaError(f"unknown tokenizer `{tokenizer}`")
        self._tokenizer_name = tokenizer
        self._tokenize = TOKENIZERS[tokenizer]
        self._filters = filters or []
        if lowercases is None:
            lowercases = tokenizer in ("default", "unicode")
        self._lowercases = lowercases
        # plain `default` tokenizer with no filters: eligible for the
        # native (C++) ASCII fast path at ingest
        self.is_plain_default = (tokenizer == "default"
                                 and not self._filters)
        # native (C++) analyzer profile: (tokenizer, stopwords
        # frozenset|None, stem) when the chain runs natively —
        # default-tokenizer + [stopwords?][stemmer?] (lowercase is a
        # no-op for ASCII default tokens), or unicode-tokenizer +
        # [stopwords?] (NFKC + UAX#29 + lowercase in native/
        # slt_unicode.h; the English stemmer chain stays Python for
        # non-ASCII-token parity); None otherwise
        self.native_profile = None
        if tokenizer == "default":
            kinds = [d for d in (descriptors or [])
                     if d[0] != "lowercase"]
            seq = [k for k, _payload in kinds]
            if seq in ([], ["stopwords"], ["stemmer"],
                       ["stopwords", "stemmer"]):
                stop = next((payload for k, payload in kinds
                             if k == "stopwords"), None)
                stem = any(k == "stemmer" for k, _p in kinds)
                self.native_profile = ("default", stop, stem)
        elif tokenizer == "unicode":
            kinds = [d for d in (descriptors or [])
                     if d[0] != "lowercase"]
            seq = [k for k, _payload in kinds]
            if seq in ([], ["stopwords"]):
                stop = next((payload for k, payload in kinds
                             if k == "stopwords"), None)
                self.native_profile = ("unicode", stop, False)

    def analyze(self, text: str) -> list[Token]:
        tokens = self._tokenize(text)
        for f in self._filters:
            tokens = f(tokens)
        _resequence_positions(tokens)
        return tokens

    def normalize_pattern(self, pattern: str) -> str:
        """Lowercase patterns (wildcard/regex) iff this analyzer lowercases
        tokens — structure-preserving, no re-tokenization
        (parity: `analysis/analyzer.rs:33-46`)."""
        return pattern.lower() if self._lowercases else pattern


def _resequence_positions(tokens: list[Token]) -> None:
    """Renumber positions 0..n, keeping tokens that shared a source
    position (synonym expansions) at the same output position
    (parity: `analysis/analyzer.rs:441-454`)."""
    last_source: int | None = None
    nxt = 0
    for tok in tokens:
        original = tok.position
        if last_source != original:
            tok.position = nxt
            last_source = original
            nxt += 1
        else:
            tok.position = max(nxt - 1, 0)


def _lowercase_filter(tokens: list[Token]) -> list[Token]:
    for t in tokens:
        t.text = t.text.lower()
    return tokens


def _make_stopwords_filter(words: frozenset[str]):
    def apply(tokens: list[Token]) -> list[Token]:
        return [t for t in tokens if t.text not in words]

    return apply


def _stemmer_filter(tokens: list[Token]) -> list[Token]:
    for t in tokens:
        t.text = porter2.stem(t.text)
    return tokens


def _make_synonyms_filter(rules: list[SynonymRule]):
    def apply(tokens: list[Token]) -> list[Token]:
        if not rules:
            return tokens
        out: list[Token] = []
        i = 0
        n = len(tokens)
        while i < n:
            matched = False
            for rule in rules:
                flen = len(rule.from_terms)
                if flen == 0 or i + flen > n:
                    continue
                if all(ft == tokens[i + off].text
                       for off, ft in enumerate(rule.from_terms)):
                    out.extend(tokens[i:i + flen])
                    pos = tokens[i].position
                    out.extend(Token(to, pos) for to in rule.to_terms)
                    i += flen
                    matched = True
                    break
            if not matched:
                out.append(tokens[i])
                i += 1
        return out

    return apply


def _make_edge_ngram_filter(cfg: _EdgeNgram):
    def apply(tokens: list[Token]) -> list[Token]:
        out: list[Token] = []
        for tok in tokens:
            length = len(tok.text)
            hi = min(cfg.max, length)
            lo = min(cfg.min, hi)
            if lo == 0 or hi == 0:
                continue
            for size in range(lo, hi + 1):
                out.append(Token(tok.text[:size], tok.position))
        return out

    return apply


def _parse_filter_def(value) -> tuple[Callable, bool]:
    """Parse one filter definition (string or object form).

    Returns (filter_fn, is_lowercasing).
    """
    if isinstance(value, str):
        value = {"type": value}
    if not isinstance(value, dict):
        raise SchemaError("token filter must be string or object")

    kind = value.get("type")
    if kind is None:
        for key in ("lowercase", "stopwords", "stemmer", "synonyms", "edge_ngram"):
            if key in value:
                kind = key
                break
    if kind is None:
        raise SchemaError(
            "token filter must declare `type` or one of `lowercase`, "
            "`stopwords`, `stemmer`, `synonyms`, `edge_ngram` keys"
        )

    if kind == "lowercase":
        if value.get("lowercase") is False:
            raise SchemaError("lowercase filter expects `true`")
        return _lowercase_filter, True
    if kind == "stopwords":
        cfg = value.get("stopwords")
        if isinstance(cfg, str):
            if cfg.lower() in ("en", "english"):
                words = ENGLISH_STOPWORDS
            else:
                raise SchemaError(f"unsupported stopword list `{cfg}`")
        elif isinstance(cfg, list):
            words = frozenset(cfg)
        else:
            raise SchemaError("stopwords filter needs a name or list")
        return _make_stopwords_filter(words), False
    if kind == "stemmer":
        lang = value.get("stemmer", value.get("language"))
        if not isinstance(lang, str) or lang.lower() not in ("en", "eng", "english"):
            raise SchemaError(f"unsupported stemmer language `{lang}`")
        return _stemmer_filter, False
    if kind == "synonyms":
        rules_raw = value.get("synonyms")
        if not isinstance(rules_raw, list):
            raise SchemaError("synonyms filter needs a list of rules")
        rules = [
            SynonymRule(list(r.get("from", [])), list(r.get("to", [])))
            for r in rules_raw
        ]
        return _make_synonyms_filter(rules), False
    if kind == "edge_ngram":
        cfg = value.get("edge_ngram")
        if not isinstance(cfg, dict):
            raise SchemaError("edge_ngram filter needs {min, max}")
        mn, mx = int(cfg.get("min", 0)), int(cfg.get("max", 0))
        if mn <= 0 or mx <= 0:
            raise SchemaError("edge_ngram min and max must be positive")
        if mn > mx:
            raise SchemaError("edge_ngram min must be <= max")
        return _make_edge_ngram_filter(_EdgeNgram(mn, mx)), False
    raise SchemaError(f"unknown token filter `{kind}`")


def analyzer_from_def(definition: dict) -> Analyzer:
    """Build an Analyzer from a JSON definition
    ``{"name": ..., "tokenizer": ..., "filters": [...]}``."""
    tokenizer = definition.get("tokenizer", "default")
    filters = []
    descriptors: list[tuple] = []
    lowercases = tokenizer in ("default", "unicode")
    for fdef in definition.get("filters", []):
        fn, lc = _parse_filter_def(fdef)
        filters.append(fn)
        lowercases = lowercases or lc
        kind = fdef if isinstance(fdef, str) else fdef.get("type")
        if kind is None and isinstance(fdef, dict):
            for key in ("lowercase", "stopwords", "stemmer", "synonyms",
                        "edge_ngram"):
                if key in fdef:
                    kind = key
                    break
        payload = None
        if kind == "stopwords":
            cfg = fdef.get("stopwords") if isinstance(fdef, dict) else None
            if isinstance(cfg, str) and cfg.lower() in ("en", "english"):
                payload = ENGLISH_STOPWORDS
            elif isinstance(cfg, list):
                payload = frozenset(cfg)
        descriptors.append((kind, payload))
    return Analyzer(tokenizer, filters, lowercases=lowercases,
                    descriptors=descriptors)


@dataclass
class AnalyzerRegistry:
    analyzers: dict[str, Analyzer] = field(default_factory=dict)

    @classmethod
    def with_default(cls) -> "AnalyzerRegistry":
        return cls({"default": Analyzer("default", [])})

    @classmethod
    def from_defs(cls, defs: list[dict]) -> "AnalyzerRegistry":
        registry = cls.with_default()
        for definition in defs:
            name = definition.get("name")
            if not name:
                raise SchemaError("analyzer definition requires a name")
            if name == "default":
                raise SchemaError("analyzer name `default` is reserved")
            if name in registry.analyzers:
                raise SchemaError(f"duplicate analyzer `{name}`")
            registry.analyzers[name] = analyzer_from_def(definition)
        return registry

    def insert(self, name: str, analyzer: Analyzer) -> None:
        if name in self.analyzers:
            raise SchemaError(f"duplicate analyzer `{name}`")
        self.analyzers[name] = analyzer

    def get(self, name: str) -> Analyzer | None:
        return self.analyzers.get(name)
