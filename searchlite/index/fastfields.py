"""Columnar fast fields: filterable/sortable/aggregatable per-doc values.

Functional parity with searchlite-core `index/fastfields.rs`, redesigned
columnar-first: every column is a CSR (offsets + values) numpy layout so
filters and aggregations are vectorized array predicates — on host via
numpy, on device by handing the same arrays to the DeviceIndex.

Column kinds: i64, f64, str (dictionary-encoded), their nested variants
(values additionally carry an object index), nested_count and
nested_parent bookkeeping columns. Reserved keys mirror the reference:
``__nested_count__{path}``, ``__nested_parent__{path}``, and
``_len:{field}`` for per-doc token counts used by BM25
(`index/fastfields.rs:1154-1163`).

Keyword matching is case-insensitive (`fastfields.rs:475-481`); numeric
ranges are inclusive.
"""

from __future__ import annotations

import io
import json
from dataclasses import dataclass, field as dc_field

import numpy as np

from searchlite.errors import StorageError

MAGIC = "FFV1"


def doc_length_key(field: str) -> str:
    return f"_len:{field}"


def nested_count_key(path: str) -> str:
    return f"__nested_count__{path}"


def nested_parent_key(path: str) -> str:
    return f"__nested_parent__{path}"


@dataclass
class Column:
    kind: str                 # "i64" | "f64" | "str"
    nested: bool
    offsets: np.ndarray       # int64 [n_docs+1]
    values: np.ndarray        # int64 | float64 | int32 (codes)
    row_ids: np.ndarray       # int32 [nnz] — owning doc of each value
    objects: np.ndarray | None = None   # int32 [nnz] for nested columns
    dictionary: list[str] = dc_field(default_factory=list)  # str columns
    is_list: bool = False     # any doc with >1 value

    _lower_dict: list[str] | None = None

    @property
    def n_docs(self) -> int:
        return len(self.offsets) - 1

    _rank_cache: tuple | None = None

    def lower_dict(self) -> list[str]:
        if self._lower_dict is None:
            self._lower_dict = [s.lower() for s in self.dictionary]
        return self._lower_dict

    def dict_ranks(self):
        """(rank_of_code [n_codes], sorted_values [n_codes]) — maps
        dictionary codes to lexicographic ranks for vectorized min/max."""
        if self._rank_cache is None:
            order = np.argsort(np.asarray(self.dictionary, dtype=object))
            rank = np.empty(len(order), dtype=np.int64)
            rank[order] = np.arange(len(order))
            sorted_vals = [self.dictionary[i] for i in order]
            self._rank_cache = (rank, sorted_vals)
        return self._rank_cache

    # -- vectorized predicates (host) ---------------------------------------

    def mask_keyword_in(self, keywords: list[str]) -> np.ndarray:
        """Docs with any value case-insensitively equal to any keyword."""
        wanted = {k.lower() for k in keywords}
        codes = [i for i, s in enumerate(self.lower_dict()) if s in wanted]
        mask = np.zeros(self.n_docs, dtype=bool)
        if not codes:
            return mask
        sel = np.isin(self.values, np.asarray(codes, dtype=self.values.dtype))
        mask[self.row_ids[sel]] = True
        return mask

    def mask_range(self, lo, hi) -> np.ndarray:
        """Docs with any value in [lo, hi] (inclusive)."""
        mask = np.zeros(self.n_docs, dtype=bool)
        sel = (self.values >= lo) & (self.values <= hi)
        mask[self.row_ids[sel]] = True
        return mask

    # -- per-doc accessors ---------------------------------------------------

    def doc_values(self, doc: int):
        lo, hi = int(self.offsets[doc]), int(self.offsets[doc + 1])
        vals = self.values[lo:hi]
        if self.kind == "str":
            return [self.dictionary[c] for c in vals]
        return vals.tolist()

    def doc_objects(self, doc: int) -> np.ndarray:
        lo, hi = int(self.offsets[doc]), int(self.offsets[doc + 1])
        return self.objects[lo:hi] if self.objects is not None else \
            np.zeros(hi - lo, dtype=np.int32)


class FastFieldsWriter:
    def __init__(self):
        # name -> {"kind", "nested", "docs": [], "objs": [], "vals": []}
        # — flat append-order arrays (calls arrive doc-ascending from
        # the segment writer; build() stable-sorts if they don't)
        self._cols: dict[str, dict] = {}

    def _col(self, name: str, kind: str, nested: bool) -> dict:
        col = self._cols.get(name)
        if col is None:
            col = {"kind": kind, "nested": nested,
                   "docs": [], "objs": [], "vals": []}
            self._cols[name] = col
        else:
            if col["kind"] != kind:
                # scalar<->list promotions share a kind; a genuine kind clash
                # (e.g. str then i64) mirrors the reference's promotion error.
                raise StorageError(
                    f"fast field `{name}` kind mismatch: "
                    f"{col['kind']} vs {kind}")
            col["nested"] = col["nested"] or nested
        return col

    @staticmethod
    def _push(col: dict, doc: int, values, object_idx, coerce):
        oi = object_idx or 0
        docs, objs, vals = col["docs"], col["objs"], col["vals"]
        for v in (values if isinstance(values, list) else [values]):
            docs.append(doc)
            objs.append(oi)
            vals.append(coerce(v))

    def set_i64(self, name: str, doc: int, values, object_idx: int | None = None):
        self._push(self._col(name, "i64", object_idx is not None),
                   doc, values, object_idx, int)

    def extend_i64(self, name: str, docs, values):
        """Bulk single-value appends: one entry per (doc, value) pair
        (ingest hot path — avoids 1 Python call per doc)."""
        from itertools import repeat

        col = self._col(name, "i64", False)
        col["docs"].extend(docs)
        col["objs"].extend(repeat(0, len(col["docs"]) - len(col["objs"])))
        col["vals"].extend(map(int, values))

    def extend_str(self, name: str, docs, values):
        from itertools import repeat

        col = self._col(name, "str", False)
        col["docs"].extend(docs)
        col["objs"].extend(repeat(0, len(col["docs"]) - len(col["objs"])))
        col["vals"].extend(map(str, values))

    def extend_f64(self, name: str, docs, values):
        from itertools import repeat

        col = self._col(name, "f64", False)
        col["docs"].extend(docs)
        col["objs"].extend(repeat(0, len(col["docs"]) - len(col["objs"])))
        col["vals"].extend(map(float, values))

    def set_f64(self, name: str, doc: int, values, object_idx: int | None = None):
        self._push(self._col(name, "f64", object_idx is not None),
                   doc, values, object_idx, float)

    def set_str(self, name: str, doc: int, values, object_idx: int | None = None):
        self._push(self._col(name, "str", object_idx is not None),
                   doc, values, object_idx, str)

    def set_nested_count(self, path: str, doc: int, count: int):
        self.set_i64(nested_count_key(path), doc, count)

    def set_nested_parent(self, path: str, doc: int, object_idx: int, parent: int):
        col = self._col(nested_parent_key(path), "i64", True)
        col["docs"].append(doc)
        col["objs"].append(object_idx)
        col["vals"].append(int(parent))

    def build(self, n_docs: int) -> "FastFields":
        columns: dict[str, Column] = {}
        for name, col in self._cols.items():
            kind = col["kind"]
            docs = np.asarray(col["docs"], dtype=np.int64)
            flat_vals = col["vals"]
            flat_objs = np.asarray(col["objs"], dtype=np.int32)
            if len(docs) and np.any(np.diff(docs) < 0):
                order = np.argsort(docs, kind="stable")
                docs = docs[order]
                flat_objs = flat_objs[order]
                flat_vals = [flat_vals[i] for i in order]
            counts = (np.bincount(docs, minlength=n_docs)
                      if len(docs) else
                      np.zeros(n_docs, dtype=np.int64))
            offsets = np.zeros(n_docs + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            is_list = bool(counts.max(initial=0) > 1)
            dictionary: list[str] = []
            if kind == "str":
                # first-occurrence dictionary encode, one C-speed pass
                # (setdefault evaluates len(uniq) before inserting)
                uniq: dict[str, int] = {}
                values = np.fromiter(
                    (uniq.setdefault(s, len(uniq)) for s in flat_vals),
                    dtype=np.int32, count=len(flat_vals))
                dictionary = list(uniq)
            elif kind == "i64":
                values = np.asarray(flat_vals, dtype=np.int64)
            else:
                values = np.asarray(flat_vals, dtype=np.float64)
            columns[name] = Column(
                kind=kind,
                nested=col["nested"],
                offsets=offsets,
                values=values,
                row_ids=docs.astype(np.int32),
                objects=flat_objs if col["nested"] else None,
                dictionary=dictionary,
                is_list=is_list,
            )
        return FastFields(columns=columns, n_docs=n_docs)


@dataclass
class FastFields:
    columns: dict[str, Column]
    n_docs: int

    def column(self, name: str) -> Column | None:
        return self.columns.get(name)

    # -- reference query API (parity: `fastfields.rs:490-899`) --------------

    def matches_keyword(self, field: str, value: str) -> np.ndarray:
        return self.matches_keyword_in(field, [value])

    def matches_keyword_in(self, field: str, values: list[str]) -> np.ndarray:
        col = self.columns.get(field)
        if col is None or col.kind != "str":
            return np.zeros(self.n_docs, dtype=bool)
        return col.mask_keyword_in(values)

    def matches_i64_range(self, field: str, lo: int, hi: int) -> np.ndarray:
        col = self.columns.get(field)
        if col is None or col.kind != "i64":
            return np.zeros(self.n_docs, dtype=bool)
        return col.mask_range(lo, hi)

    def matches_f64_range(self, field: str, lo: float, hi: float) -> np.ndarray:
        col = self.columns.get(field)
        if col is None:
            return np.zeros(self.n_docs, dtype=bool)
        if col.kind not in ("f64", "i64"):
            return np.zeros(self.n_docs, dtype=bool)
        return col.mask_range(lo, hi)

    def str_values(self, field: str, doc: int) -> list[str]:
        col = self.columns.get(field)
        if col is None or col.kind != "str":
            return []
        return col.doc_values(doc)

    def i64_values(self, field: str, doc: int) -> list[int]:
        col = self.columns.get(field)
        if col is None or col.kind != "i64":
            return []
        return col.doc_values(doc)

    def f64_values(self, field: str, doc: int) -> list[float]:
        col = self.columns.get(field)
        if col is None or col.kind != "f64":
            return []
        return col.doc_values(doc)

    def numeric_values(self, field: str, doc: int) -> list[float]:
        col = self.columns.get(field)
        if col is None or col.kind not in ("i64", "f64"):
            return []
        return [float(v) for v in col.doc_values(doc)]

    def doc_length(self, field: str, doc: int) -> float:
        vals = self.i64_values(doc_length_key(field), doc)
        return float(vals[0]) if vals else 0.0

    def nested_object_count(self, path: str, doc: int) -> int:
        vals = self.i64_values(nested_count_key(path), doc)
        return int(vals[0]) if vals else 0

    def nested_parents(self, path: str, doc: int) -> list[int]:
        col = self.columns.get(nested_parent_key(path))
        if col is None:
            return []
        lo, hi = int(col.offsets[doc]), int(col.offsets[doc + 1])
        parents = col.values[lo:hi]
        objects = col.objects[lo:hi] if col.objects is not None else None
        if objects is None:
            return parents.tolist()
        out = [-1] * (int(objects.max()) + 1 if len(objects) else 0)
        for obj, par in zip(objects.tolist(), parents.tolist()):
            while obj >= len(out):
                out.append(-1)
            out[obj] = par
        return out

    def nested_values_with_objects(self, field: str, doc: int):
        """[(object_idx, value)] for a nested column."""
        col = self.columns.get(field)
        if col is None:
            return []
        lo, hi = int(col.offsets[doc]), int(col.offsets[doc + 1])
        objs = (col.objects[lo:hi] if col.objects is not None
                else np.zeros(hi - lo, dtype=np.int32))
        vals = col.values[lo:hi]
        if col.kind == "str":
            return [(int(o), col.dictionary[c])
                    for o, c in zip(objs, vals)]
        return [(int(o), v) for o, v in zip(objs.tolist(), vals.tolist())]

    # -- serialization -------------------------------------------------------

    def to_bytes(self) -> bytes:
        header = {"magic": MAGIC, "n_docs": self.n_docs, "columns": []}
        arrays: dict[str, np.ndarray] = {}
        for i, (name, col) in enumerate(sorted(self.columns.items())):
            header["columns"].append({
                "name": name,
                "kind": col.kind,
                "nested": col.nested,
                "is_list": col.is_list,
                "dictionary": col.dictionary,
                "has_objects": col.objects is not None,
            })
            arrays[f"c{i}_offsets"] = col.offsets
            arrays[f"c{i}_values"] = col.values
            arrays[f"c{i}_rows"] = col.row_ids
            if col.objects is not None:
                arrays[f"c{i}_objects"] = col.objects
        buf = io.BytesIO()
        header_bytes = json.dumps(header).encode()
        arrays["header"] = np.frombuffer(header_bytes, dtype=np.uint8)
        np.savez(buf, **arrays)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "FastFields":
        try:
            npz = np.load(io.BytesIO(data), allow_pickle=False)
            header = json.loads(bytes(npz["header"]).decode())
        except Exception as e:  # noqa: BLE001
            raise StorageError(f"corrupt fast-fields file: {e}") from e
        if header.get("magic") != MAGIC:
            raise StorageError("fast-fields file has wrong magic")
        columns: dict[str, Column] = {}
        for i, cmeta in enumerate(header["columns"]):
            columns[cmeta["name"]] = Column(
                kind=cmeta["kind"],
                nested=cmeta["nested"],
                offsets=npz[f"c{i}_offsets"],
                values=npz[f"c{i}_values"],
                row_ids=npz[f"c{i}_rows"],
                objects=npz[f"c{i}_objects"] if cmeta["has_objects"] else None,
                dictionary=list(cmeta["dictionary"]),
                is_list=cmeta["is_list"],
            )
        return cls(columns=columns, n_docs=header["n_docs"])
