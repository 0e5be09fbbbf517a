"""Segment writer/reader: one immutable chunk of indexed documents.

Ingest semantics mirror searchlite-core `index/segment.rs`:

- ``collect_document`` splits a doc into text/keyword/i64/f64/stored/
  nested/vector buckets (`segment.rs:514-564`).
- Text values are analyzed per field with cross-value position offsets;
  per-doc token counts land in the ``_len:{field}`` fast column
  (`segment.rs:655-698`).
- Keywords are lowercased + deduped per doc for indexing, original-case
  values go to fast columns (`segment.rs:700-723`).
- Nested objects record counts, parent lineage, and per-object fast
  values (`segment.rs:749-813`).
- Cosine vectors are L2-normalized at ingest (`segment.rs:508-511`).
- Every output file's crc32 goes into the SegmentMeta and is verified
  at open (`segment.rs:908-932`, `:1239-1249`).

The on-disk postings/fast formats are the block-native layouts from
``postings.py`` / ``fastfields.py`` rather than the reference's byte
streams.
"""

from __future__ import annotations

import json
import os
import uuid as uuid_mod
from dataclasses import dataclass
from typing import Any, Iterable, Optional

import numpy as np

from searchlite.errors import SchemaError, StorageError
from searchlite.index import directory
from searchlite.index.docstore import DocStoreReader, DocStoreWriter
from searchlite.index.fastfields import (
    FastFields,
    FastFieldsWriter,
    doc_length_key,
)
from searchlite.index.manifest import (
    NestedField,
    ResolvedField,
    Schema,
    SegmentMeta,
)
from searchlite.index.postings import InvertedIndexBuilder, PostingsData
from searchlite.index.terms import TermsDict, read_terms, write_terms
from searchlite.storage import Storage
from searchlite.utils.checksum import crc32


# ---------------------------------------------------------------------------
# Document collection
# ---------------------------------------------------------------------------

class CollectedDocument:
    def __init__(self):
        self.doc_id: Optional[str] = None
        self.text: dict[str, list[str]] = {}
        self.keywords: dict[str, list[str]] = {}
        self.i64s: dict[str, list[int]] = {}
        self.f64s: dict[str, list[float]] = {}
        self.stored: dict[str, list[Any]] = {}
        self.nested_keywords: dict[str, list[list[str]]] = {}
        self.nested_i64s: dict[str, list[list[int]]] = {}
        self.nested_f64s: dict[str, list[list[float]]] = {}
        self.nested_counts: dict[str, int] = {}
        self.nested_parents: dict[str, list[int]] = {}
        self.nested_stored: dict[str, Any] = {}
        self.vectors: dict[str, Optional[list[float]]] = {}

    def push_stored(self, path: str, values: Iterable[Any]) -> None:
        self.stored.setdefault(path, []).extend(values)

    def finalize_stored(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for k, vals in self.stored.items():
            out[k] = vals[0] if len(vals) == 1 else vals
        out.update(self.nested_stored)
        return out


def _collect_strings(value) -> list[str]:
    if isinstance(value, str):
        return [value]
    if isinstance(value, list):
        return [v for v in value if isinstance(v, str)]
    return []


def _collect_i64s(value) -> list[int]:
    if isinstance(value, bool):
        return []
    if isinstance(value, int):
        return [value]
    if isinstance(value, list):
        return [v for v in value if isinstance(v, int) and not isinstance(v, bool)]
    return []


def _collect_f64s(value) -> list[float]:
    if isinstance(value, bool):
        return []
    if isinstance(value, (int, float)):
        return [float(value)]
    if isinstance(value, list):
        return [float(v) for v in value
                if isinstance(v, (int, float)) and not isinstance(v, bool)]
    return []


def _handle_field(meta: ResolvedField, value, collected: CollectedDocument,
                  store_value: bool) -> None:
    if meta.kind == "text":
        vals = _collect_strings(value)
        if meta.indexed and vals:
            collected.text.setdefault(meta.path, []).extend(vals)
        if meta.stored and store_value:
            collected.push_stored(meta.path, vals)
    elif meta.kind == "keyword":
        vals = _collect_strings(value)
        if vals:
            collected.keywords.setdefault(meta.path, []).extend(vals)
        if meta.stored and store_value:
            collected.push_stored(meta.path, vals)
    elif meta.kind == "numeric":
        if meta.numeric_i64:
            ivals = _collect_i64s(value)
            if ivals:
                collected.i64s.setdefault(meta.path, []).extend(ivals)
            if meta.stored and store_value:
                collected.push_stored(meta.path, ivals)
        else:
            fvals = _collect_f64s(value)
            if fvals:
                collected.f64s.setdefault(meta.path, []).extend(fvals)
            if meta.stored and store_value:
                collected.push_stored(meta.path, fvals)


def _stored_nested_value(nested: NestedField, value):
    if isinstance(value, list):
        filtered = [v2 for v in value
                    if (v2 := _stored_nested_value(nested, v)) is not None]
        return filtered or None
    if isinstance(value, dict):
        out = {}
        for prop in nested.fields:
            raw = value.get(prop.name)
            if raw is None:
                continue
            if prop.kind == "object":
                child = _stored_nested_value(prop.inner, raw)
                if child is not None:
                    out[prop.name] = child
            elif prop.inner.stored:
                out[prop.name] = raw
        return out or None
    return None


def _collect_nested(schema: Schema, nested: NestedField, value, prefix: str,
                    collected: CollectedDocument,
                    resolved: dict[str, ResolvedField], store_value: bool,
                    parent_idx: Optional[int]) -> None:
    if value is None:
        if nested.nullable:
            return
        raise SchemaError(f"nested field {prefix} cannot be null")
    if isinstance(value, list):
        collected.nested_counts[prefix] = len(value)
        entry = collected.nested_parents.setdefault(
            prefix, [-1] * len(value))
        if len(entry) < len(value):
            entry.extend([-1] * (len(value) - len(entry)))
        if parent_idx is not None:
            for i in range(len(value)):
                entry[i] = parent_idx
        for idx, v in enumerate(value):
            if v is None:
                if nested.nullable:
                    continue
                raise SchemaError(f"nested field {prefix} cannot be null")
            if not isinstance(v, dict):
                raise SchemaError(
                    f"nested field {prefix} must contain objects")
            _collect_nested_object(schema, nested, v, prefix, idx,
                                   collected, resolved)
    elif isinstance(value, dict):
        collected.nested_counts[prefix] = 1
        collected.nested_parents.setdefault(
            prefix, [parent_idx if parent_idx is not None else -1])
        _collect_nested_object(schema, nested, value, prefix, 0,
                               collected, resolved)
    else:
        raise SchemaError(f"nested field {prefix} must be object or array")
    if store_value:
        filtered = _stored_nested_value(nested, value)
        if filtered is not None:
            collected.nested_stored[prefix] = filtered


def _record_nested(bucket: dict, field: str, object_count: int,
                   object_idx: int, values: list) -> None:
    entry = bucket.setdefault(field, [[] for _ in range(object_count)])
    while len(entry) < object_count:
        entry.append([])
    if object_idx < len(entry):
        entry[object_idx].extend(values)


def _collect_nested_object(schema: Schema, nested: NestedField, obj: dict,
                           prefix: str, object_idx: int,
                           collected: CollectedDocument,
                           resolved: dict[str, ResolvedField]) -> None:
    object_count = collected.nested_counts.get(prefix, 0)
    for k, v in obj.items():
        prop = next((p for p in nested.fields if p.name == k), None)
        if prop is None:
            raise SchemaError(f"unknown nested field {prefix}.{k}")
        if prop.kind == "object":
            next_prefix = f"{prefix}.{prop.inner.name}"
            if v is None:
                if prop.inner.nullable:
                    continue
                raise SchemaError(
                    f"nested field {next_prefix} cannot be null")
            _collect_nested(schema, prop.inner, v, next_prefix, collected,
                            resolved, False, object_idx)
            continue
        full_path = f"{prefix}.{k}"
        meta = resolved.get(full_path)
        if meta is None:
            raise SchemaError(f"unknown nested field {prefix}.{k}")
        _handle_field(meta, v, collected, False)
        if meta.fast:
            if meta.kind == "keyword":
                vals = _collect_strings(v)
                if vals:
                    _record_nested(collected.nested_keywords, full_path,
                                   object_count, object_idx, vals)
            elif meta.kind == "numeric":
                if meta.numeric_i64:
                    ivals = _collect_i64s(v)
                    if ivals:
                        _record_nested(collected.nested_i64s, full_path,
                                       object_count, object_idx, ivals)
                else:
                    fvals = _collect_f64s(v)
                    if fvals:
                        _record_nested(collected.nested_f64s, full_path,
                                       object_count, object_idx, fvals)
    for prop in nested.fields:
        if prop.name in obj or prop.is_nullable():
            continue
        raise SchemaError(
            f"missing required nested field {prefix}.{prop.name}")


def collect_document(schema: Schema, doc: dict,
                     resolved: dict[str, ResolvedField]) -> CollectedDocument:
    collected = CollectedDocument()
    doc_id = doc.get(schema.doc_id_field)
    collected.doc_id = doc_id
    # the doc id is NOT written into the stored record: doc_ids
    # already live in the segment meta, and omitting it lets schemas
    # with no other stored fields hit the docstore's constant-record
    # fast path (no per-doc json+compress). SegmentReader.get_doc
    # injects it back, so the read surface is unchanged.
    vector_names = schema.vector_names()
    nested_map = schema.nested_map()
    for field, value in doc.items():
        if field == schema.doc_id_field:
            continue
        if field in vector_names:
            collected.vectors[field] = _collect_vector_value(
                schema, field, value)
            continue
        meta = resolved.get(field)
        if meta is not None:
            _handle_field(meta, value, collected, True)
            continue
        nested = nested_map.get(field)
        if nested is not None:
            if value is None:
                if nested.nullable:
                    continue
                raise SchemaError(
                    f"nested field {nested.name} cannot be null")
            _collect_nested(schema, nested, value, nested.name, collected,
                            resolved, True, None)
            continue
        raise SchemaError(f"unknown field {field}")
    return collected


def _collect_vector_value(schema: Schema, field: str, value
                          ) -> Optional[list[float]]:
    vf = schema.vector_field(field)
    if vf is None:
        raise SchemaError(f"unknown vector field {field}")
    if value is None:
        return None
    if not isinstance(value, list):
        raise SchemaError(f"vector field {field} must be an array")
    try:
        vals = [float(v) for v in value]
    except (TypeError, ValueError) as e:
        raise SchemaError(f"vector field {field} must contain numbers") from e
    if len(vals) != vf.dim:
        raise SchemaError(
            f"vector field {field} expected dimension {vf.dim}, "
            f"got {len(vals)}")
    if vf.metric == "cosine":
        norm = float(np.linalg.norm(vals))
        if norm > 0:
            vals = [v / norm for v in vals]
    return vals


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class _BulkTextBuffer:
    """Accumulates (doc, field) text-value groups for bulk native
    tokenization (NativeIndexBuilder.add_texts): one C call per few
    thousand values instead of one per value (~30us ctypes boundary
    each, measured ~1/3 of ingest time at 50k docs).

    Ordering contract: postings must stay doc-ascending per term. Items
    are appended in doc order and flushed in order, and term keys are
    disjoint across fields, so the only hazard is the same FIELD being
    processed both here and inline (non-ASCII fallback / a second
    stopword set): callers must flush() before inline-adding any field
    that has buffered items (`fields` exposes the live set)."""

    MAX_ITEMS = 8192
    MAX_BYTES = 4 << 20

    def __init__(self, builder, on_group, on_col=None):
        self._builder = builder
        self._on_group = on_group  # (field, doc_ord, token_count) ->
        # (field, lo_ord, counts_slice) -> ; columns fall back to the
        # per-item callback when no vectorized consumer is given
        self._on_col = on_col or (
            lambda field, lo_ord, counts: [
                on_group(field, lo_ord + i, int(c))
                for i, c in enumerate(counts)])
        self._field_ids: dict[tuple[str, bool, bool, bool], int] = {}
        self._prefixes: list[bytes] = []
        self._f_stop: list[int] = []
        self._f_stem: list[int] = []
        self._f_unicode: list[int] = []
        self._texts: list[bytes] = []
        self._doc_ords: list[int] = []
        self._item_fids: list[int] = []
        self._new_group: list[int] = []
        self._groups: list[tuple[str, int, int, int]] = []
        self._bytes = 0
        self.fields: set[str] = set()

    def field_id(self, field: str, use_stopwords: bool, use_stem: bool,
                 unicode_tok: bool) -> int:
        fkey = (field, use_stopwords, use_stem, unicode_tok)
        fid = self._field_ids.get(fkey)
        if fid is None:
            fid = len(self._prefixes)
            self._field_ids[fkey] = fid
            self._prefixes.append(f"{field}:".encode())
            self._f_stop.append(1 if use_stopwords else 0)
            self._f_stem.append(1 if use_stem else 0)
            self._f_unicode.append(1 if unicode_tok else 0)
        return fid

    def add_one(self, fid: int, field: str, doc_ord: int,
                text: str) -> None:
        """Single-value group with a pre-resolved field id — the
        overwhelmingly common shape on the ingest hot loop."""
        raw = text.encode()
        texts = self._texts
        lo = len(texts)
        texts.append(raw)
        self._bytes += len(raw)
        self._doc_ords.append(doc_ord)
        self._item_fids.append(fid)
        self._new_group.append(1)
        self._groups.append((field, doc_ord, lo, lo + 1))
        self.fields.add(field)
        if (lo + 1 >= self.MAX_ITEMS
                or self._bytes >= self.MAX_BYTES):
            self.flush()

    def add_column(self, fid: int, field: str, lo_ord: int,
                   raws: list[bytes]) -> None:
        """Columnar single-value groups: docs ``lo_ord..lo_ord+n`` each
        contribute one pre-encoded value of ``field`` (the columnar
        ingest fast path — no per-doc Python calls). Flush consumes
        the whole slice with one vectorized length callback."""
        n = len(raws)
        if n == 0:
            return
        lo = len(self._texts)
        self._texts.extend(raws)
        self._bytes += sum(map(len, raws))
        self._doc_ords.extend(range(lo_ord, lo_ord + n))
        self._item_fids.extend([fid] * n)
        self._new_group.extend([1] * n)
        self._groups.append((field, lo_ord, lo, lo + n, True))
        self.fields.add(field)
        if (len(self._texts) >= self.MAX_ITEMS
                or self._bytes >= self.MAX_BYTES):
            self.flush()

    def add_group(self, field: str, doc_ord: int, values: list[str],
                  use_stopwords: bool, use_stem: bool,
                  unicode_tok: bool) -> None:
        fid = self.field_id(field, use_stopwords, use_stem,
                            unicode_tok)
        lo = len(self._texts)
        first = 1
        for text in values:
            raw = text.encode()
            self._texts.append(raw)
            self._bytes += len(raw)
            self._doc_ords.append(doc_ord)
            self._item_fids.append(fid)
            self._new_group.append(first)
            first = 0
        self._groups.append((field, doc_ord, lo, len(self._texts)))
        self.fields.add(field)
        if (len(self._texts) >= self.MAX_ITEMS
                or self._bytes >= self.MAX_BYTES):
            self.flush()

    def flush(self) -> None:
        if not self._groups:
            return
        lens = np.fromiter((len(t) for t in self._texts),
                           dtype=np.int64, count=len(self._texts))
        text_off = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=text_off[1:])
        prefix_off = np.zeros(len(self._prefixes) + 1, dtype=np.int32)
        np.cumsum([len(p) for p in self._prefixes], out=prefix_off[1:])
        counts = self._builder.add_texts(
            b"".join(self._texts), text_off,
            np.asarray(self._doc_ords, dtype=np.uint32),
            np.asarray(self._item_fids, dtype=np.int32),
            np.asarray(self._new_group, dtype=np.uint8),
            b"".join(self._prefixes), prefix_off,
            np.asarray(self._f_stop, dtype=np.uint8),
            np.asarray(self._f_stem, dtype=np.uint8),
            np.asarray(self._f_unicode, dtype=np.uint8))
        for g in self._groups:
            if len(g) == 5:  # column slice: one count per doc
                field, lo_ord, lo, hi, _ = g
                self._on_col(field, lo_ord, counts[lo:hi])
            else:
                field, doc_ord, lo, hi = g
                self._on_group(field, doc_ord, int(counts[lo:hi].sum()))
        # field table persists across flushes (ids stay valid); items
        # and groups reset
        self._texts.clear()
        self._doc_ords.clear()
        self._item_fids.clear()
        self._new_group.clear()
        self._groups.clear()
        self._bytes = 0
        self.fields.clear()


class SegmentWriter:
    def __init__(self, schema: Schema, storage: Storage,
                 enable_positions: bool = True, compress: bool = False):
        self.schema = schema
        self.storage = storage
        self.enable_positions = enable_positions
        self.compress = compress

    def _text_field_fallback(self, field, col, plan, bulk,
                             postings_builder, fast_writer,
                             total_doc_lengths):
        """Per-doc ingest of ONE text field's column (the columnar
        pass's escape hatch for impure columns — missing values,
        lists, non-ASCII under the default tokenizer). Exact replica
        of the per-doc loop's inline text branch; term keys are
        field-disjoint so interleaving with other fields' buffered
        columns preserves per-term doc order."""
        _tag, analyzer, use_native, native_flags, native_tok = plan[:5]
        if field in bulk.fields:
            bulk.flush()
        for doc_ord, value in enumerate(col):
            values = _collect_strings(value)
            if not values:
                continue
            position_offset = 0
            doc_len = 0
            for text in values:
                if use_native:
                    fast = postings_builder.add_text(
                        field, doc_ord, text, position_offset,
                        *native_flags, tokenizer=native_tok)
                    if fast is not None:
                        count, max_pos = fast
                        doc_len += count
                        total_doc_lengths[field] = (
                            total_doc_lengths.get(field, 0) + count)
                        position_offset += (
                            (max_pos + 1) if max_pos is not None
                            else 1)
                        continue
                tokens = analyzer.analyze(text)
                doc_len += len(tokens)
                total_doc_lengths[field] = (
                    total_doc_lengths.get(field, 0) + len(tokens))
                for tok in tokens:
                    postings_builder.add_term(
                        f"{field}:{tok.text}", doc_ord,
                        position_offset + tok.position)
                if tokens:
                    position_offset += max(
                        t.position for t in tokens) + 1
                else:
                    position_offset += 1
            fast_writer.set_i64(
                doc_length_key(field), doc_ord, doc_len)

    def _ingest_columnar(self, docs, resolved, keyword_fast,
                         numeric_info, bulk, postings_builder,
                         fast_writer, doc_writer, doc_ids,
                         total_doc_lengths, text_plan) -> bool:
        """FIELD-major ingest for flat schemas — the per-doc
        collect/dispatch loop costs ~6 µs/doc in Python, a third of
        engine ingest time at 500k docs; columns cost one C-speed list
        pass per field instead. Applies when the schema is flat (no
        nested/vector/stored fields — gated by the caller + here) and
        docs were already validated (writer buffer path). Pure
        columns stream through bulk add_column / fastfields extends;
        impure ones fall back per-FIELD to the exact per-doc logic.
        Returns False (nothing consumed) when the corpus needs the
        per-doc path; output segments are byte-identical either way
        (tests/test_ingest_roundtrip.py)."""
        schema = self.schema
        id_field = schema.doc_id_field
        if any(f.stored for f in resolved.values()):
            return False
        allowed = set(resolved)
        allowed.add(id_field)
        seen: set = set()
        for d in docs:
            if type(d) is not dict:
                return False
            seen.update(d)
        if seen - allowed:
            return False  # per-doc path raises its unknown-field error
        n = len(docs)

        for field, meta in resolved.items():
            if field == id_field:
                continue  # collect_document never indexes the id
            col = [d.get(field) for d in docs]
            if meta.kind == "text":
                plan = text_plan(field)
                if plan[0] == "skip":
                    continue  # not indexed; stored gated above
                _tag, _analyzer, use_native, native_flags, \
                    native_tok = plan[:5]
                if (use_native
                        and all(type(x) is str for x in col)
                        and (native_tok == "unicode"
                             or all(x.isascii() for x in col))):
                    fid = bulk.field_id(field, native_flags[0],
                                        native_flags[1],
                                        native_tok == "unicode")
                    step = _BulkTextBuffer.MAX_ITEMS
                    for i in range(0, n, step):
                        bulk.add_column(
                            fid, field, i,
                            [t.encode() for t in col[i:i + step]])
                else:
                    self._text_field_fallback(
                        field, col, plan, bulk, postings_builder,
                        fast_writer, total_doc_lengths)
            elif meta.kind == "keyword":
                indexed = meta.indexed
                fast = field in keyword_fast
                if not indexed and not fast:
                    continue
                if all(type(x) is str for x in col):
                    if indexed:
                        for doc_ord, value in enumerate(col):
                            postings_builder.add_term(
                                f"{field}:{value.lower()}", doc_ord,
                                0, with_positions=False)
                    if fast:
                        fast_writer.extend_str(field, range(n), col)
                else:
                    for doc_ord, value in enumerate(col):
                        values = _collect_strings(value)
                        if indexed:
                            kseen: set[str] = set()
                            for v in values:
                                lower = v.lower()
                                if lower not in kseen:
                                    kseen.add(lower)
                                    postings_builder.add_term(
                                        f"{field}:{lower}", doc_ord,
                                        0, with_positions=False)
                        if fast and values:
                            fast_writer.set_str(field, doc_ord,
                                                values)
            elif meta.kind == "numeric":
                info = numeric_info.get(field)
                if not info or not info[1]:
                    continue  # not fast; stored gated above
                if meta.numeric_i64:
                    if all(type(x) is int for x in col):
                        fast_writer.extend_i64(field, range(n), col)
                    else:
                        for doc_ord, value in enumerate(col):
                            ivals = _collect_i64s(value)
                            if ivals:
                                fast_writer.set_i64(field, doc_ord,
                                                    ivals)
                else:
                    if all(type(x) in (int, float) for x in col):
                        fast_writer.extend_f64(field, range(n), col)
                    else:
                        for doc_ord, value in enumerate(col):
                            fvals = _collect_f64s(value)
                            if fvals:
                                fast_writer.set_f64(field, doc_ord,
                                                    fvals)

        doc_ids.extend(d.get(id_field) for d in docs)
        doc_writer.add_empty_documents(n)
        return True

    def write_segment(self, docs: Iterable[dict], generation: int,
                      validate: bool = True) -> SegmentMeta:
        """validate=False skips per-doc schema validation for docs that
        already passed it (writer.add_document validates before the WAL
        append; compaction re-reads docs a previous commit validated)."""
        seg_id = uuid_mod.uuid4().hex
        paths = directory.segment_paths(seg_id)
        analyzers = self.schema.build_analyzers()
        resolved = {f.path: f for f in self.schema.resolved_fields()}
        keyword_fast = {f.path for f in resolved.values()
                        if f.kind == "keyword" and f.fast}
        numeric_info = {f.path: (bool(f.numeric_i64), f.fast)
                        for f in resolved.values() if f.kind == "numeric"}

        postings_builder = None
        try:
            from searchlite.native import NativeIndexBuilder, get_lib

            if get_lib() is not None:
                postings_builder = NativeIndexBuilder(self.enable_positions)
        except Exception:  # noqa: BLE001 — fall back to pure Python
            postings_builder = None
        native = postings_builder is not None
        if postings_builder is None:
            postings_builder = InvertedIndexBuilder(self.enable_positions)
        fast_writer = FastFieldsWriter()
        total_doc_lengths: dict[str, int] = {}
        doc_ids: list[str] = []
        vector_buckets: dict[str, list[Optional[list[float]]]] = {
            vf.name: [] for vf in self.schema.vector_fields}

        bulk = None
        # bulk-path doc lengths accumulate in plain lists and land in
        # the fast column in one extend after the loop (the doc-length
        # column tolerates out-of-order appends: build() stable-sorts)
        bulk_lengths: dict[str, tuple[list[int], list[int]]] = {}
        if native and not os.environ.get("SEARCHLITE_DISABLE_BULK"):
            def _on_group(field: str, doc_ord: int, count: int) -> None:
                pair = bulk_lengths.get(field)
                if pair is None:
                    pair = bulk_lengths[field] = ([], [])
                pair[0].append(doc_ord)
                pair[1].append(count)

            def _on_col(field: str, lo_ord: int, counts) -> None:
                pair = bulk_lengths.get(field)
                if pair is None:
                    pair = bulk_lengths[field] = ([], [])
                pair[0].extend(range(lo_ord, lo_ord + len(counts)))
                pair[1].extend(counts.tolist())
            bulk = _BulkTextBuffer(postings_builder, _on_group, _on_col)

        # per-field text plan, resolved once per segment (analyzer
        # lookup, native-profile checks, and stopword registration are
        # schema-constant; register_stopwords is first-set-wins per
        # builder so the first answer holds for the whole segment)
        field_plans: dict[str, tuple] = {}

        def _text_plan(field: str) -> tuple:
            meta = resolved.get(field)
            if meta is not None and not meta.indexed:
                return ("skip",)
            analyzer = analyzers.index_analyzer(field)
            if analyzer is None:
                raise SchemaError(
                    f"no analyzer configured for field `{field}`")
            use_native = False
            native_flags = (False, False)
            native_tok = "default"
            if native and analyzer.native_profile is not None:
                native_tok, stopwords, stem_flag = \
                    analyzer.native_profile
                if stopwords is None:
                    use_native = True
                    native_flags = (False, stem_flag)
                elif postings_builder.register_stopwords(stopwords):
                    # one stopword set per segment builder; a second
                    # distinct set falls back to Python
                    use_native = True
                    native_flags = (True, stem_flag)
            return ("text", analyzer, use_native, native_flags,
                    native_tok)

        doc_file = self.storage.open_write(paths.docstore)
        doc_writer = DocStoreWriter(doc_file, self.compress)
        try:
            columnar_done = False
            if (bulk is not None and not validate
                    and isinstance(docs, list)
                    and not os.environ.get("SEARCHLITE_COLUMNAR_OFF")
                    and not self.schema.nested_fields
                    and not self.schema.vector_fields):
                columnar_done = self._ingest_columnar(
                    docs, resolved, keyword_fast, numeric_info, bulk,
                    postings_builder, fast_writer, doc_writer,
                    doc_ids, total_doc_lengths, _text_plan)
            for doc in ([] if columnar_done else docs):
                doc_ord = len(doc_ids)
                if validate:
                    self.schema.validate_document(doc)
                collected = collect_document(self.schema, doc, resolved)
                doc_key = collected.doc_id
                doc_ids.append(doc_key)

                for field, values in collected.text.items():
                    plan = field_plans.get(field)
                    if plan is None:
                        plan = field_plans[field] = _text_plan(field)
                    if plan[0] == "skip":
                        continue
                    _tag, analyzer, use_native, native_flags, \
                        native_tok = plan[:5]
                    position_offset = 0
                    doc_len = 0
                    if use_native and bulk is not None:
                        # whole-group bulk buffering (one C call per few
                        # thousand values); groups with any non-ASCII
                        # value under the default tokenizer take the
                        # inline per-value path below, after flushing
                        # any buffered items of the same field so each
                        # term's postings stay doc-ascending
                        if len(values) == 1:
                            text0 = values[0]
                            if native_tok == "unicode" \
                                    or text0.isascii():
                                if len(plan) == 5:
                                    plan = plan + (bulk.field_id(
                                        field, native_flags[0],
                                        native_flags[1],
                                        native_tok == "unicode"),)
                                    field_plans[field] = plan
                                bulk.add_one(plan[5], field, doc_ord,
                                             text0)
                                continue
                        elif native_tok == "unicode" or all(
                                t.isascii() for t in values):
                            bulk.add_group(
                                field, doc_ord, values, native_flags[0],
                                native_flags[1], native_tok == "unicode")
                            continue
                        if field in bulk.fields:
                            bulk.flush()
                    for text in values:
                        if use_native:
                            fast = postings_builder.add_text(
                                field, doc_ord, text, position_offset,
                                *native_flags, tokenizer=native_tok)
                            if fast is not None:
                                count, max_pos = fast
                                doc_len += count
                                total_doc_lengths[field] = (
                                    total_doc_lengths.get(field, 0) + count)
                                position_offset += (
                                    (max_pos + 1) if max_pos is not None
                                    else 1)
                                continue
                        tokens = analyzer.analyze(text)
                        doc_len += len(tokens)
                        total_doc_lengths[field] = (
                            total_doc_lengths.get(field, 0) + len(tokens))
                        for tok in tokens:
                            postings_builder.add_term(
                                f"{field}:{tok.text}", doc_ord,
                                position_offset + tok.position)
                        if tokens:
                            position_offset += max(
                                t.position for t in tokens) + 1
                        else:
                            # keep a gap between values even when filters
                            # drop every token (parity: segment.rs:690-692)
                            position_offset += 1
                    fast_writer.set_i64(
                        doc_length_key(field), doc_ord, doc_len)

                for field, values in collected.keywords.items():
                    meta = resolved.get(field)
                    indexed = meta.indexed if meta is not None else True
                    is_nested_field = "." in field
                    if indexed:
                        seen: set[str] = set()
                        for value in values:
                            lower = value.lower()
                            if lower not in seen:
                                seen.add(lower)
                                postings_builder.add_term(
                                    f"{field}:{lower}", doc_ord, 0,
                                    with_positions=False)
                    if field in keyword_fast and not is_nested_field and values:
                        fast_writer.set_str(field, doc_ord, values)

                for field, ivalues in collected.i64s.items():
                    info = numeric_info.get(field)
                    if info and info[1] and "." not in field and ivalues:
                        fast_writer.set_i64(field, doc_ord, ivalues)

                for field, fvalues in collected.f64s.items():
                    info = numeric_info.get(field)
                    if info and info[1] and "." not in field and fvalues:
                        fast_writer.set_f64(field, doc_ord, fvalues)

                for path, count in collected.nested_counts.items():
                    fast_writer.set_nested_count(path, doc_ord, count)
                for path, parents in collected.nested_parents.items():
                    for object_idx, parent in enumerate(parents):
                        fast_writer.set_nested_parent(
                            path, doc_ord, object_idx, parent)
                for field, objects in collected.nested_keywords.items():
                    for object_idx, vals in enumerate(objects):
                        if vals:
                            fast_writer.set_str(
                                field, doc_ord, vals, object_idx=object_idx)
                for field, objects in collected.nested_i64s.items():
                    for object_idx, ivals in enumerate(objects):
                        if ivals:
                            fast_writer.set_i64(
                                field, doc_ord, ivals, object_idx=object_idx)
                for field, objects in collected.nested_f64s.items():
                    for object_idx, fvals in enumerate(objects):
                        if fvals:
                            fast_writer.set_f64(
                                field, doc_ord, fvals, object_idx=object_idx)

                for vf in self.schema.vector_fields:
                    vector_buckets[vf.name].append(
                        collected.vectors.get(vf.name))

                doc_writer.add_document(collected.finalize_stored())
        finally:
            doc_writer.flush()
            doc_file.close()

        total_docs = len(doc_ids)

        if bulk is not None:
            bulk.flush()
        # deferred fast columns: one bulk extend per column instead of
        # one Python call per doc (_id + bulk-path doc lengths)
        if doc_ids:
            fast_writer.extend_str(self.schema.doc_id_field,
                                   range(total_docs), doc_ids)
        for field, (docs_l, counts_l) in bulk_lengths.items():
            fast_writer.extend_i64(doc_length_key(field), docs_l,
                                   counts_l)
            total_doc_lengths[field] = (
                total_doc_lengths.get(field, 0) + sum(counts_l))
        postings = postings_builder.build()
        self.storage.write_all(paths.terms, write_terms(postings.terms))
        self.storage.write_all(paths.postings, postings.to_bytes())
        fast = fast_writer.build(total_docs)
        self.storage.write_all(paths.fast, fast.to_bytes())

        avg_field_lengths = {
            field: (total / total_docs if total_docs else 0.0)
            for field, total in total_doc_lengths.items()
        }

        has_vectors = False
        vector_meta: dict[str, dict] = {}
        for vf in self.schema.vector_fields:
            bucket = vector_buckets[vf.name]
            vectors = np.zeros((total_docs, vf.dim), dtype=np.float32)
            present = np.zeros(total_docs, dtype=bool)
            for i, vec in enumerate(bucket):
                if vec is not None:
                    vectors[i] = vec
                    present[i] = True
            import io as _io
            buf = _io.BytesIO()
            np.savez(buf, vectors=vectors, present=present)
            self.storage.write_all(
                directory.vector_paths(paths, vf.name), buf.getvalue())
            vector_meta[vf.name] = {
                "dim": vf.dim, "metric": vf.metric,
                "vectors": int(present.sum()),
            }
            has_vectors = True

        seg_file_meta = {
            "doc_offsets": [],  # docstore offsets (filled below)
            "doc_ids": doc_ids,
            "avg_field_lengths": avg_field_lengths,
            "vector_fields": vector_meta,
            # resolved codec string ("zstd"/"zlib") or False;
            # older segments wrote a bare true meaning zlib
            "compress": doc_writer.codec or False,
            "enable_positions": self.enable_positions,
            # get_doc injects the id from doc_ids under this key
            # (stored records no longer carry it)
            "doc_id_field": self.schema.doc_id_field,
        }
        seg_file_meta["doc_offsets"] = doc_writer.offsets
        self.storage.write_all(
            paths.meta, json.dumps(seg_file_meta).encode())

        checksums = {}
        for key, path in (("terms", paths.terms), ("postings", paths.postings),
                          ("docstore", paths.docstore), ("fast", paths.fast),
                          ("meta", paths.meta)):
            checksums[key] = crc32(self.storage.read_to_end(path))
        for vf_name in vector_meta:
            vec_path = directory.vector_paths(paths, vf_name)
            checksums[f"vector_{vf_name}"] = crc32(
                self.storage.read_to_end(vec_path))

        return SegmentMeta(
            id=seg_id,
            generation=generation,
            doc_count=total_docs,
            max_doc_id=max(total_docs - 1, 0),
            blockmax=True,
            deleted_docs=[],
            avg_field_lengths=avg_field_lengths,
            checksums=checksums,
            has_vectors=has_vectors,
        )


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

@dataclass
class VectorData:
    dim: int
    metric: str
    vectors: np.ndarray   # [n_docs, dim] f32 (cosine: pre-normalized)
    present: np.ndarray   # [n_docs] bool


class SegmentReader:
    def __init__(self, meta: SegmentMeta, storage: Storage,
                 verify_checksums: bool = True):
        self.meta = meta
        paths = directory.segment_paths(meta.id)
        self.paths = paths

        file_map = {"terms": paths.terms, "postings": paths.postings,
                    "docstore": paths.docstore, "fast": paths.fast,
                    "meta": paths.meta}
        raw: dict[str, bytes] = {}
        for key, path in file_map.items():
            data = storage.read_to_end(path)
            if verify_checksums and key in meta.checksums:
                if crc32(data) != meta.checksums[key]:
                    raise StorageError(
                        f"segment {meta.id}: checksum mismatch for {key}")
            raw[key] = data

        seg_file_meta = json.loads(raw["meta"])
        self.doc_ids: list[str] = seg_file_meta["doc_ids"]
        # segments written before doc_id_field landed carry the id
        # inside every stored record instead (get_doc's update() then
        # overwrites the injected value with the identical stored one)
        self.doc_id_field: str = seg_file_meta.get(
            "doc_id_field", "_id")
        self.avg_field_lengths: dict[str, float] = dict(
            seg_file_meta.get("avg_field_lengths", {}))
        self.compress = seg_file_meta.get("compress", False)
        self.enable_positions = bool(
            seg_file_meta.get("enable_positions", True))

        terms_list = read_terms(raw["terms"])
        self.terms = TermsDict(terms_list)
        self.postings = PostingsData.from_bytes(raw["postings"], terms_list)
        self.fast = FastFields.from_bytes(raw["fast"])
        self.docstore = DocStoreReader(
            raw["docstore"], seg_file_meta["doc_offsets"], self.compress)

        self.deleted: set[int] = set(meta.deleted_docs)

        self.vectors: dict[str, VectorData] = {}
        for field, vmeta in seg_file_meta.get("vector_fields", {}).items():
            vec_path = directory.vector_paths(paths, field)
            data = storage.read_to_end(vec_path)
            key = f"vector_{field}"
            if verify_checksums and key in meta.checksums:
                if crc32(data) != meta.checksums[key]:
                    raise StorageError(
                        f"segment {meta.id}: checksum mismatch for {key}")
            import io as _io
            npz = np.load(_io.BytesIO(data), allow_pickle=False)
            self.vectors[field] = VectorData(
                dim=int(vmeta["dim"]), metric=vmeta["metric"],
                vectors=npz["vectors"], present=npz["present"])

    def clone_with_tombstones(self, meta: SegmentMeta) -> "SegmentReader":
        """Shallow copy for a tombstone-only change of the SAME segment
        uuid: every parsed structure (postings, fast columns, docstore,
        terms, doc_ids, vectors) is immutable and shared; only the
        meta + deleted set swap. Commits that merely tombstone docs in
        an existing segment skip the full file re-read + re-parse this
        way (api/reader.py::_cached_segment)."""
        import copy

        clone = copy.copy(self)
        clone.meta = meta
        clone.deleted = set(meta.deleted_docs)
        return clone

    @property
    def doc_count(self) -> int:
        return len(self.doc_ids)

    def is_deleted(self, ordinal: int) -> bool:
        return ordinal in self.deleted

    def live_docs(self) -> list[int]:
        return [i for i in range(self.doc_count) if i not in self.deleted]

    def get_doc(self, ordinal: int) -> dict:
        doc = {self.doc_id_field: self.doc_ids[ordinal]}
        doc.update(self.docstore.get(ordinal))
        return doc

    def doc_id(self, ordinal: int) -> str:
        return self.doc_ids[ordinal]

    def term_id(self, term: str) -> Optional[int]:
        return self.terms.get(term)

    def doc_freq(self, term: str) -> int:
        tid = self.terms.get(term)
        return int(self.postings.term_df[tid]) if tid is not None else 0

    def avg_field_length(self, field: str) -> float:
        return self.avg_field_lengths.get(field, 0.0)

    def postings_for(self, term: str):
        tid = self.terms.get(term)
        if tid is None:
            return None
        return self.postings.term_postings(tid)
