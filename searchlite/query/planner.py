"""Query planner: lowers the query AST into the executable plan.

Semantics parity with searchlite-core `query/planner.rs`:

- term groups (fields + boosts, term, expansion kind, score flag, leaf),
- phrase specs (fields, terms, slop) — filter-only,
- a boolean matcher tree (MatchAll/Term/Phrase/QueryString/DisMax/Bool),
- a ScoreExpr tree (Leaf/Sum/DisMax-with-tiebreaker) over leaf indices,
- a ScoreNode custom-scoring tree (Constant/FunctionScore/RankFeature/
  ScriptScore wrappers).

Leaf allocation: best_fields multi_match allocates one leaf per field
(DisMax over field leaves); most_fields/cross_fields one leaf per group.
Defaults: prefix 50 / wildcard 100 / regex 100 max expansions.

The device executor consumes leaves as rows of a dense ``[n_leaves, n_docs]``
score matrix and evaluates the matcher over dense group-match masks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field
from typing import Any, Optional

from searchlite.api.types import Filter, FunctionSpec, QueryNode
from searchlite.errors import QueryError
from searchlite.query.parser import parse_query

DEFAULT_PREFIX_MAX_EXPANSIONS = 50
DEFAULT_WILDCARD_MAX_EXPANSIONS = 100
DEFAULT_REGEX_MAX_EXPANSIONS = 100


@dataclass
class FieldSpecInternal:
    field: str
    boost: float = 1.0
    leaf: Optional[int] = None


@dataclass
class TermGroupSpec:
    fields: list[FieldSpecInternal]
    term: str
    expansion: str                    # "exact" | "prefix" | "wildcard" | "regex"
    boost: float
    score: bool
    mode: str                         # "per_field" | "cross_fields"
    leaf: Optional[int]
    max_expansions: int = 0


@dataclass
class PhraseSpec:
    fields: list[str]
    terms: list[str]
    slop: int


@dataclass
class Matcher:
    """Boolean matcher tree node."""

    kind: str  # match_all | term | phrase | query_string | dis_max | bool
    # term/phrase: index; query_string: dict; dis_max: children;
    # bool: dict with must/should/must_not/filter/minimum_should_match
    payload: Any = None


@dataclass
class ScoreExpr:
    kind: str  # "leaf" | "sum" | "dis_max"
    leaf: int = 0
    children: list["ScoreExpr"] = dc_field(default_factory=list)
    tie_breaker: float = 0.0

    def signature(self) -> str:
        if self.kind == "leaf":
            return f"L{self.leaf}"
        inner = ",".join(c.signature() for c in self.children)
        if self.kind == "sum":
            return f"S({inner})"
        return f"D{self.tie_breaker}({inner})"


@dataclass
class ScoreNode:
    """Custom-scoring tree: wraps the base ScoreExpr with constant /
    function_score / rank_feature / script_score layers."""

    kind: str  # empty|expr|sum|dis_max|constant|function_score|rank_feature|script_score
    expr: Optional[ScoreExpr] = None
    children: list["ScoreNode"] = dc_field(default_factory=list)
    tie_breaker: float = 0.0
    params: dict[str, Any] = dc_field(default_factory=dict)


@dataclass
class QueryPlan:
    matcher: Matcher
    term_groups: list[TermGroupSpec]
    phrase_specs: list[PhraseSpec]
    scorer: Optional[ScoreExpr]
    score_tree: ScoreNode
    leaf_count: int

    def needs_score_hook(self) -> bool:
        return _score_node_nontrivial(self.score_tree)

    def is_plain_or_sum(self) -> bool:
        """True when this plan is a bare OR of exact scored terms whose
        score is the plain sum of leaf BM25 — i.e. matching ≡ positive
        score and total score ≡ Σ slot_impact × Σ leaf weight. The
        single-query sparse candidate route (api/reader.py::
        _try_sparse_single) relies on exactly this equivalence."""
        m = self.matcher
        if m.kind != "query_string":
            return False
        p = m.payload
        if p.get("phrase_groups") or p.get("not_term_groups"):
            return False
        if p.get("minimum_should_match") not in (None, 1):
            return False
        if not self.term_groups:
            return False
        for g in self.term_groups:
            if (g.expansion != "exact" or not g.score
                    or g.mode != "per_field" or g.boost <= 0.0):
                return False
            if any(f.boost <= 0.0 for f in g.fields):
                return False
        sc = self.scorer
        if sc is None:
            return False
        if sc.kind == "leaf":
            return True
        return (sc.kind == "sum"
                and all(c.kind == "leaf" for c in sc.children))


def _score_node_nontrivial(node: ScoreNode) -> bool:
    if node.kind in ("constant", "function_score", "rank_feature",
                     "script_score"):
        return True
    return any(_score_node_nontrivial(c) for c in node.children)


def validate_boost(value) -> float:
    v = 1.0 if value is None else float(value)
    if not math.isfinite(v) or v < 0.0 or math.copysign(1.0, v) < 0:
        raise QueryError("query boost must be finite and non-negative (>= 0)")
    return v


def validate_tie_breaker(value) -> float:
    v = 0.0 if value is None else float(value)
    if v < 0.0:
        raise QueryError("tie_breaker must be non-negative")
    if v > 1.0:
        raise QueryError("tie_breaker must be <= 1.0")
    return v


def resolve_minimum_should_match(spec, term_count: int,
                                 operator: str) -> Optional[int]:
    if term_count == 0:
        return None
    base = term_count if operator == "and" else 1
    if spec is None:
        return base
    if isinstance(spec, int):
        return min(spec, term_count)
    if isinstance(spec, str):
        if not spec.endswith("%"):
            raise QueryError(
                "minimum_should_match percentage must be a number with % suffix")
        try:
            percent = float(spec[:-1])
        except ValueError as e:
            raise QueryError(
                "minimum_should_match percentage must be a number with % "
                "suffix") from e
        if not 0.0 <= percent <= 100.0:
            raise QueryError(
                "minimum_should_match percentage must be between 0 and 100")
        raw = (percent / 100.0) * term_count
        return min(math.ceil(raw), term_count)
    raise QueryError("invalid minimum_should_match")


def _normalize_fields(fields, default_fields: list[str],
                      leaf: Optional[int]) -> list[FieldSpecInternal]:
    if fields is not None:
        return [FieldSpecInternal(s.field, validate_boost(s.boost), leaf)
                for s in fields]
    return [FieldSpecInternal(f, 1.0, leaf) for f in default_fields]


class _PlanBuilder:
    def __init__(self, default_fields: list[str]):
        self.default_fields = default_fields
        self.term_groups: list[TermGroupSpec] = []
        self.phrase_specs: list[PhraseSpec] = []
        self.next_leaf = 0

    def alloc_leaf(self) -> int:
        idx = self.next_leaf
        self.next_leaf += 1
        return idx

    def push_group(self, fields, term, expansion, boost, score, mode, leaf,
                   max_expansions=0) -> int:
        idx = len(self.term_groups)
        self.term_groups.append(TermGroupSpec(
            fields, term, expansion, boost, score, mode, leaf,
            max_expansions))
        return idx

    def push_phrase(self, fields, terms, slop) -> int:
        idx = len(self.phrase_specs)
        self.phrase_specs.append(PhraseSpec(fields, terms, slop))
        return idx

    # -- node lowering -------------------------------------------------------

    def build_node(self, node: QueryNode, score: bool, boost: float
                   ) -> tuple[Matcher, Optional[ScoreExpr], ScoreNode]:
        kind = node.kind
        handler = getattr(self, f"_build_{kind}", None)
        if handler is None:
            raise QueryError(f"unknown query node type `{kind}`")
        return handler(node, score, boost)

    def _build_match_all(self, node, score, boost):
        validate_boost(node.get("boost"))
        return Matcher("match_all"), None, ScoreNode("empty")

    def _query_string_parts(self, parsed, base_fields, score, total_boost,
                            minimum_should_match, fixed_specs=None,
                            mode="per_field", group_leaf="per_term"):
        term_groups, term_leaves = [], []
        for term in parsed.terms:
            if fixed_specs is not None:
                fields = [FieldSpecInternal(f.field, f.boost, f.leaf)
                          for f in fixed_specs]
                leaf = group_leaf if group_leaf != "per_term" else None
            else:
                if term.field is not None:
                    fields = [FieldSpecInternal(term.field, 1.0, None)]
                else:
                    fields = [FieldSpecInternal(f.field, f.boost, f.leaf)
                              for f in base_fields]
                leaf = self.alloc_leaf() if score else None
                if leaf is not None:
                    term_leaves.append(ScoreExpr("leaf", leaf=leaf))
            idx = self.push_group(fields, term.term, "exact", total_boost,
                                  score, mode, leaf)
            term_groups.append(idx)
        not_groups = []
        for term in parsed.not_terms:
            if fixed_specs is not None:
                fields = [FieldSpecInternal(f.field, f.boost, None)
                          for f in fixed_specs]
            elif term.field is not None:
                fields = [FieldSpecInternal(term.field, 1.0, None)]
            else:
                fields = [FieldSpecInternal(f.field, f.boost, None)
                          for f in base_fields]
            idx = self.push_group(fields, term.term, "exact", total_boost,
                                  False, mode, None)
            not_groups.append(idx)
        phrase_groups = []
        for phrase in parsed.phrases:
            if phrase.field is not None:
                pfields = [phrase.field]
            elif fixed_specs is not None:
                pfields = [f.field for f in fixed_specs]
            else:
                pfields = [f.field for f in base_fields]
            phrase_groups.append(self.push_phrase(pfields, phrase.terms, 0))
        matcher = Matcher("query_string", {
            "term_groups": term_groups,
            "phrase_groups": phrase_groups,
            "not_term_groups": not_groups,
            "minimum_should_match": minimum_should_match,
        })
        return matcher, term_leaves

    def _build_query_string(self, node, score, boost):
        node_boost = validate_boost(node.get("boost"))
        parsed = parse_query(node.params["query"])
        base_fields = _normalize_fields(
            node.get("fields"), self.default_fields, None)
        matcher, term_leaves = self._query_string_parts(
            parsed, base_fields, score, boost * node_boost, None)
        if not term_leaves:
            scorer = None
        elif len(term_leaves) == 1:
            scorer = term_leaves[0]
        else:
            scorer = ScoreExpr("sum", children=term_leaves)
        score_node = (ScoreNode("expr", expr=scorer)
                      if scorer is not None else ScoreNode("empty"))
        return matcher, scorer, score_node

    def _build_multi_match(self, node, score, boost):
        node_boost = validate_boost(node.get("boost"))
        operator = node.get("operator") or "or"
        parsed = parse_query(node.params["query"])
        required = resolve_minimum_should_match(
            node.get("minimum_should_match"), len(parsed.terms), operator)
        tie = validate_tie_breaker(node.get("tie_breaker"))
        match_type = node.get("match_type", "best_fields")
        fields = node.get("fields") or []
        if match_type == "best_fields":
            specs, leaves = [], []
            for spec in fields:
                leaf = self.alloc_leaf()
                leaves.append(ScoreExpr("leaf", leaf=leaf))
                specs.append(FieldSpecInternal(
                    spec.field, validate_boost(spec.boost), leaf))
            scorer = (ScoreExpr("dis_max", children=leaves, tie_breaker=tie)
                      if leaves else None)
            mode, group_leaf = "per_field", None
        elif match_type in ("most_fields", "cross_fields"):
            leaf = self.alloc_leaf() if score else None
            specs = _normalize_fields(fields, self.default_fields, leaf)
            scorer = ScoreExpr("leaf", leaf=leaf) if leaf is not None else None
            mode = ("cross_fields" if match_type == "cross_fields"
                    else "per_field")
            group_leaf = leaf
        else:
            raise QueryError(f"unknown multi_match type `{match_type}`")
        matcher, _ = self._query_string_parts(
            parsed, specs, score, boost * node_boost, required,
            fixed_specs=specs, mode=mode, group_leaf=group_leaf)
        score_node = (ScoreNode("expr", expr=scorer)
                      if scorer is not None else ScoreNode("empty"))
        return matcher, scorer, score_node

    def _build_dis_max(self, node, score, boost):
        node_boost = validate_boost(node.get("boost"))
        tie = validate_tie_breaker(node.get("tie_breaker"))
        matchers, scorers, score_nodes = [], [], []
        for child in node.params.get("queries", []):
            m, s, sn = self.build_node(child, score, boost * node_boost)
            matchers.append(m)
            if s is not None:
                scorers.append(s)
            if sn.kind != "empty":
                score_nodes.append(sn)
        matcher = Matcher("dis_max", matchers)
        if not scorers:
            scorer = None
        elif len(scorers) == 1:
            scorer = scorers[0]
        else:
            scorer = ScoreExpr("dis_max", children=scorers, tie_breaker=tie)
        if not score_nodes:
            score_node = ScoreNode("empty")
        elif len(score_nodes) == 1:
            score_node = score_nodes[0]
        else:
            score_node = ScoreNode("dis_max", children=score_nodes,
                                   tie_breaker=tie)
        return matcher, scorer, score_node

    def _single_term_node(self, node, score, boost, expansion,
                          default_expansions=0):
        node_boost = validate_boost(node.get("boost"))
        leaf = self.alloc_leaf() if score else None
        max_exp = node.get("max_expansions")
        idx = self.push_group(
            [FieldSpecInternal(node.params["field"], 1.0, None)],
            node.params["value"], expansion, boost * node_boost, score,
            "per_field", leaf,
            max_expansions=(max_exp if max_exp is not None
                            else default_expansions))
        scorer = ScoreExpr("leaf", leaf=leaf) if leaf is not None else None
        score_node = (ScoreNode("expr", expr=scorer)
                      if scorer is not None else ScoreNode("empty"))
        return Matcher("term", idx), scorer, score_node

    def _build_term(self, node, score, boost):
        return self._single_term_node(node, score, boost, "exact")

    def _build_prefix(self, node, score, boost):
        return self._single_term_node(
            node, score, boost, "prefix", DEFAULT_PREFIX_MAX_EXPANSIONS)

    def _build_wildcard(self, node, score, boost):
        return self._single_term_node(
            node, score, boost, "wildcard", DEFAULT_WILDCARD_MAX_EXPANSIONS)

    def _build_regex(self, node, score, boost):
        import re

        try:
            re.compile(node.params["value"])
        except re.error as e:
            raise QueryError(f"invalid regex: {e}") from e
        return self._single_term_node(
            node, score, boost, "regex", DEFAULT_REGEX_MAX_EXPANSIONS)

    def _build_phrase(self, node, score, boost):
        validate_boost(node.get("boost"))
        field = node.get("field")
        fields = [field] if field is not None else list(self.default_fields)
        idx = self.push_phrase(fields, list(node.params["terms"]),
                               int(node.get("slop") or 0))
        return Matcher("phrase", idx), None, ScoreNode("empty")

    def _build_bool(self, node, score, boost):
        node_boost = validate_boost(node.get("boost"))
        child_boost = boost * node_boost
        must_matchers, scorer_parts, score_nodes = [], [], []
        for child in node.params.get("must", []):
            m, s, sn = self.build_node(child, score, child_boost)
            must_matchers.append(m)
            if s is not None:
                scorer_parts.append(s)
            if sn.kind != "empty":
                score_nodes.append(sn)
        should_matchers = []
        for child in node.params.get("should", []):
            m, s, sn = self.build_node(child, score, child_boost)
            should_matchers.append(m)
            if s is not None:
                scorer_parts.append(s)
            if sn.kind != "empty":
                score_nodes.append(sn)
        must_not_matchers = []
        for child in node.params.get("must_not", []):
            m, s, sn = self.build_node(child, False, child_boost)
            must_not_matchers.append(m)
            if s is not None:
                scorer_parts.append(s)
            if sn.kind != "empty":
                score_nodes.append(sn)
        if not scorer_parts:
            scorer = None
        elif len(scorer_parts) == 1:
            scorer = scorer_parts[0]
        else:
            scorer = ScoreExpr("sum", children=scorer_parts)
        if not score_nodes:
            score_node = ScoreNode("empty")
        elif len(score_nodes) == 1:
            score_node = score_nodes[0]
        else:
            score_node = ScoreNode("sum", children=score_nodes)
        msm = node.get("minimum_should_match")
        matcher = Matcher("bool", {
            "must": must_matchers,
            "should": should_matchers,
            "must_not": must_not_matchers,
            "filter": list(node.params.get("filter", [])),
            "minimum_should_match": int(msm) if msm is not None else None,
        })
        return matcher, scorer, score_node

    def _build_constant_score(self, node, score, boost):
        node_boost = validate_boost(node.get("boost"))
        matcher = Matcher("bool", {
            "must": [], "should": [], "must_not": [],
            "filter": [node.params["filter"]],
            "minimum_should_match": None,
        })
        score_node = ScoreNode("constant", params={
            "score": boost * node_boost, "matcher": matcher})
        return matcher, None, score_node

    def _build_function_score(self, node, score, boost):
        node_boost = validate_boost(node.get("boost"))
        for key in ("max_boost", "min_score"):
            val = node.get(key)
            if val is not None and not math.isfinite(float(val)):
                raise QueryError(f"function_score `{key}` must be finite")
        matcher, scorer, base_node = self.build_node(
            node.params["query"], score, boost)
        score_node = ScoreNode("function_score", params={
            "matcher": matcher,
            "base": base_node,
            "functions": node.params.get("functions", []),
            "score_mode": node.get("score_mode") or "sum",
            "boost_mode": node.get("boost_mode") or "multiply",
            "max_boost": node.get("max_boost"),
            "min_score": node.get("min_score"),
            "boost": boost * node_boost,
        })
        return matcher, scorer, score_node

    def _build_rank_feature(self, node, score, boost):
        node_boost = validate_boost(node.get("boost"))
        matcher = Matcher("match_all")
        score_node = ScoreNode("rank_feature", params={
            "matcher": matcher,
            "field": node.params["field"],
            "modifier": node.get("modifier"),
            "missing": node.get("missing"),
            "boost": boost * node_boost,
        })
        return matcher, None, score_node

    def _build_script_score(self, node, score, boost):
        node_boost = validate_boost(node.get("boost"))
        matcher, scorer, base_node = self.build_node(
            node.params["query"], score, boost)
        score_node = ScoreNode("script_score", params={
            "matcher": matcher,
            "base": base_node,
            "script": node.params["script"],
            "params": node.get("params") or {},
            "boost": boost * node_boost,
        })
        return matcher, scorer, score_node

    def _build_vector(self, node, score, boost):
        # Vector clauses run on the vector path; MatchAll for BM25 planning.
        return Matcher("match_all"), None, ScoreNode("empty")


def _max_leaf(expr: ScoreExpr) -> int:
    if expr.kind == "leaf":
        return expr.leaf
    return max((_max_leaf(c) for c in expr.children), default=-1)


def build_query_plan(query, default_fields: list[str]) -> QueryPlan:
    """query: a raw query string or a QueryNode."""
    if isinstance(query, str):
        node = QueryNode("query_string",
                         {"query": query, "fields": None, "boost": None})
    else:
        node = query
    builder = _PlanBuilder(default_fields)
    matcher, scorer, score_node = builder.build_node(node, True, 1.0)
    leaf_count = builder.next_leaf
    if scorer is not None:
        leaf_count = max(leaf_count, _max_leaf(scorer) + 1)
    return QueryPlan(
        matcher=matcher,
        term_groups=builder.term_groups,
        phrase_specs=builder.phrase_specs,
        scorer=scorer,
        score_tree=score_node,
        leaf_count=leaf_count,
    )
