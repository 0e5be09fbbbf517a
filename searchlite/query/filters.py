"""Filter evaluation over fast-field columns.

Semantics parity with searchlite-core `query/filters.rs`:

- KeywordEq/KeywordIn are case-insensitive; numeric ranges inclusive.
- Nested filters bind to a single object: AND-grouped nested filters
  under one path must match within the SAME object, and nested-in-nested
  paths enforce parent lineage via the NestedParent columns
  (`filters.rs:13-188`).

Execution is mask-first: the top-level filter compiles to one boolean
``[n_docs]`` numpy mask via vectorized column predicates; per-object
nested groups fall back to a per-candidate-doc check over docs whose
nested-count column is non-zero.
"""

from __future__ import annotations

import numpy as np

from searchlite.api.types import Filter
from searchlite.errors import QueryError
from searchlite.index.fastfields import FastFields, nested_count_key


def _qualified(base: str, field: str) -> str:
    return f"{base}.{field}" if base else field


def compute_filter_mask(fast: FastFields, filt: Filter) -> np.ndarray:
    """Boolean [n_docs] mask of docs passing the filter."""
    n = fast.n_docs
    kind = filt.kind
    if kind == "KeywordEq":
        return fast.matches_keyword_in(
            filt.params["field"], [filt.params["value"]])
    if kind == "KeywordIn":
        return fast.matches_keyword_in(
            filt.params["field"], list(filt.params["values"]))
    if kind == "I64Range":
        return fast.matches_i64_range(
            filt.params["field"], filt.params["min"], filt.params["max"])
    if kind == "F64Range":
        return fast.matches_f64_range(
            filt.params["field"], filt.params["min"], filt.params["max"])
    if kind == "And":
        mask = np.ones(n, dtype=bool)
        # AND-group nested filters under one path must bind to the same
        # object — group them and evaluate per doc.
        nested_groups: dict[str, list[Filter]] = {}
        for child in filt.params:
            if child.kind == "Nested":
                nested_groups.setdefault(
                    child.params["path"], []).append(child.params["filter"])
            else:
                mask &= compute_filter_mask(fast, child)
        for path, group in nested_groups.items():
            mask &= _nested_group_mask(fast, path, group, mask)
        return mask
    if kind == "Or":
        mask = np.zeros(n, dtype=bool)
        for child in filt.params:
            mask |= compute_filter_mask(fast, child)
        return mask
    if kind == "Not":
        return ~compute_filter_mask(fast, filt.params)
    if kind == "Nested":
        return _nested_group_mask(
            fast, filt.params["path"], [filt.params["filter"]], None)
    raise QueryError(f"unknown filter kind `{kind}`")


def compute_filters_mask(fast: FastFields, filters: list[Filter]) -> np.ndarray:
    """AND of a filter list with same-object nested grouping
    (parity: `filters.rs:13-49`)."""
    return compute_filter_mask(fast, Filter("And", list(filters)))


def _nested_candidates(fast: FastFields, path: str,
                       restrict: np.ndarray | None) -> np.ndarray:
    col = fast.column(nested_count_key(path))
    if col is None:
        return np.zeros(0, dtype=np.int64)
    has = np.flatnonzero(np.diff(col.offsets) > 0)
    if restrict is not None:
        has = has[restrict[has]]
    return has


def _nested_group_mask(fast: FastFields, path: str, group: list[Filter],
                       restrict: np.ndarray | None) -> np.ndarray:
    mask = np.zeros(fast.n_docs, dtype=bool)
    for doc in _nested_candidates(fast, path, restrict):
        if _nested_group_passes(fast, int(doc), "", path, None, group):
            mask[doc] = True
    return mask


# ---------------------------------------------------------------------------
# Per-doc evaluation (used inside nested objects and by aggs/top_hits)
# ---------------------------------------------------------------------------

def passes_filter(fast: FastFields, doc: int, filt: Filter) -> bool:
    return _filter_matches(fast, doc, filt, "", None)


def passes_filters(fast: FastFields, doc: int, filters: list[Filter]) -> bool:
    return _passes_filters_at(fast, doc, filters, "", None)


def _passes_filters_at(fast: FastFields, doc: int, filters: list[Filter],
                       base_path: str, object_idx: int | None) -> bool:
    nested: dict[str, list[Filter]] = {}
    for filt in filters:
        if filt.kind == "Nested":
            nested.setdefault(
                filt.params["path"], []).append(filt.params["filter"])
        elif not _filter_matches(fast, doc, filt, base_path, object_idx):
            return False
    for path, group in nested.items():
        if not _nested_group_passes(fast, doc, base_path, path,
                                    object_idx, group):
            return False
    return True


def _nested_values_by_object(fast: FastFields, field: str, doc: int,
                             object_idx: int):
    return [v for o, v in fast.nested_values_with_objects(field, doc)
            if o == object_idx]


def _filter_matches(fast: FastFields, doc: int, filt: Filter,
                    base_path: str, object_idx: int | None) -> bool:
    kind = filt.kind
    if kind == "KeywordEq":
        full = _qualified(base_path, filt.params["field"])
        value = filt.params["value"]
        if object_idx is not None:
            vals = _nested_values_by_object(fast, full, doc, object_idx)
            return any(isinstance(v, str) and v.lower() == value.lower()
                       for v in vals)
        return any(v.lower() == value.lower()
                   for v in fast.str_values(full, doc))
    if kind == "KeywordIn":
        full = _qualified(base_path, filt.params["field"])
        wanted = {v.lower() for v in filt.params["values"]}
        if object_idx is not None:
            vals = _nested_values_by_object(fast, full, doc, object_idx)
            return any(isinstance(v, str) and v.lower() in wanted
                       for v in vals)
        return any(v.lower() in wanted for v in fast.str_values(full, doc))
    if kind in ("I64Range", "F64Range"):
        full = _qualified(base_path, filt.params["field"])
        lo, hi = filt.params["min"], filt.params["max"]
        if object_idx is not None:
            vals = _nested_values_by_object(fast, full, doc, object_idx)
        elif kind == "I64Range":
            vals = fast.i64_values(full, doc)
        else:
            vals = fast.numeric_values(full, doc)
        return any(lo <= v <= hi for v in vals
                   if isinstance(v, (int, float)))
    if kind == "Nested":
        return _nested_filter_passes(
            fast, doc, base_path, filt.params["path"], object_idx,
            filt.params["filter"])
    if kind == "And":
        return _passes_filters_at(fast, doc, filt.params, base_path,
                                  object_idx)
    if kind == "Or":
        return any(_filter_matches(fast, doc, child, base_path, object_idx)
                   for child in filt.params)
    if kind == "Not":
        return not _filter_matches(fast, doc, filt.params, base_path,
                                   object_idx)
    raise QueryError(f"unknown filter kind `{kind}`")


def _nested_group_passes(fast: FastFields, doc: int, base_path: str,
                         path: str, parent_idx: int | None,
                         filters: list[Filter]) -> bool:
    full_path = _qualified(base_path, path)
    object_count = fast.nested_object_count(full_path, doc)
    if object_count == 0:
        return False
    parents = fast.nested_parents(full_path, doc)
    for idx in range(object_count):
        if parent_idx is not None:
            if idx >= len(parents) or parents[idx] != parent_idx:
                continue
        if _passes_filters_at(fast, doc, filters, full_path, idx):
            return True
    return False


def _nested_filter_passes(fast: FastFields, doc: int, base_path: str,
                          path: str, parent_idx: int | None,
                          filt: Filter) -> bool:
    return _nested_group_passes(fast, doc, base_path, path, parent_idx,
                                [filt])


def validate_filter(schema, filt: Filter, base_path: str = "") -> None:
    """Static validation of filter field kinds against the schema."""
    kind = filt.kind
    if kind in ("KeywordEq", "KeywordIn"):
        full = _qualified(base_path, filt.params["field"])
        meta = schema.field_meta(full)
        if meta is not None and meta.kind not in ("keyword",):
            raise QueryError(
                f"filter field `{full}` must be a keyword field")
    elif kind in ("I64Range", "F64Range"):
        full = _qualified(base_path, filt.params["field"])
        meta = schema.field_meta(full)
        if meta is not None and meta.kind != "numeric":
            raise QueryError(
                f"filter field `{full}` must be a numeric field")
    elif kind == "Nested":
        validate_filter(schema, filt.params["filter"],
                        _qualified(base_path, filt.params["path"]))
    elif kind in ("And", "Or"):
        for child in filt.params:
            validate_filter(schema, child, base_path)
    elif kind == "Not":
        validate_filter(schema, filt.params, base_path)
