"""IndexReader: the search orchestrator.

Functional parity with searchlite-core `api/reader.rs`, re-architected
around dense device execution:

- The reference walks postings doc-at-a-time per segment
  (`api/reader.rs:2908-3128` + `query/wand.rs`); here each segment's
  postings live in HBM (``device/index.py``) and a ``CompiledQuery``
  (``ops/score.py``) scores/masks/top-ks the whole segment in one
  traced program.
- Term-group expansion (exact / fuzzy Levenshtein≤2 with prefix lock and
  1/0.4/0.2 distance weights / prefix / wildcard / regex, per-segment
  dictionary, max_expansions caps) stays host-side
  (`api/reader.rs:977-1465`).
- Phrase verification runs host-side over position sidecars and enters
  the device program as dense masks.
- Cursors carry manifest generation + sort-plan hash + last sort key and
  are rejected when stale (`api/reader.rs:622-902`).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
from dataclasses import dataclass, replace
from typing import Any, Optional

import numpy as np

from searchlite.api.types import (
    Filter,
    FuzzyOptions,
    Hit,
    SearchRequest,
    SearchResult,
)
from searchlite.device.index import DeviceSegment
from searchlite.errors import CursorError, QueryError, StorageError
from searchlite.index.highlight import (
    HighlightOptions,
    highlight_fragments,
    make_snippet,
)
from searchlite.index.segment import SegmentReader
from searchlite.models.bm25 import idf as bm25_idf
from searchlite.ops.score import CompiledQuery, next_pow2
from searchlite.query.filters import (
    compute_filters_mask,
    validate_filter,
)
from searchlite.query.phrase import matches_phrase
from searchlite.query.planner import QueryPlan, build_query_plan
from searchlite.query.sort import SortKey, SortPlan

MAX_CANDIDATE_SIZE = 20_000
MAX_CURSOR_ADVANCE = 50_000
# flat scatter indices of the dense [S, n1] M build are int32 on device;
# batches whose extent passes this route through the doc-sharded path
# (module constant so tests can lower it to exercise the routing)
FLAT_INDEX_LIMIT = 2**31
DEFAULT_SUGGEST_SCAN = 64
MAX_SUGGEST_CANDIDATES = 256
CURSOR_VERSION = 3

# Compiled executors are cached process-wide (keyed by plan structure +
# schema fingerprint): readers are reopened on every commit and must not
# retrigger XLA compilation for already-seen query shapes.
_GLOBAL_COMPILED: dict[str, "CompiledQuery"] = {}
_GLOBAL_SCORERS: dict[str, Any] = {}
# Segments are immutable (tombstone changes produce a new cache key),
# so their host arrays and HBM uploads are shared across the readers
# that commits keep reopening. Bounded FIFO eviction.
_GLOBAL_SEGMENTS: dict[tuple, tuple] = {}
# latest (seg, dseg) per (uuid, k1, b, placement) regardless of
# tombstone state — the clone source for tombstone-delta reopens
_GLOBAL_BASE: dict[tuple, tuple] = {}
_MAX_CACHED_SEGMENTS = 64
_GLOBAL_LOCK = threading.Lock()

# vector-search clamps (parity: `api/reader.rs:133-163`)
MAX_VECTOR_CLAUSES = 8
MAX_VECTOR_K = 1024
MAX_VECTOR_CANDIDATE_SIZE = 10_000
MAX_VECTOR_EF_SEARCH = 65_536
MAX_GLOBAL_CANDIDATES = MAX_CANDIDATE_SIZE
DEFAULT_VECTOR_ALPHA = 0.5
DEFAULT_EF_SEARCH = 40


@dataclass
class QualifiedTerm:
    field: str
    term: str
    key: str
    weight: float
    leaf: int


@dataclass
class RankedHit:
    key: SortKey
    score: float
    vector_score: Optional[float] = None
    explanation: Optional[dict] = None


@dataclass
class VectorClausePlan:
    field: str
    vector: list[float]
    k: int
    alpha: float
    ef_search: int
    candidate_size: int
    boost: float
    metric: str


@dataclass
class VectorPlan:
    clauses: list[VectorClausePlan]
    candidate_size: int
    vector_only: bool


def missing_vector_score(metric: str) -> float:
    # parity: `api/reader.rs:218-225`
    return -1.0 if metric == "cosine" else float(np.finfo(np.float32).min)


def blend_scores(bm25: float, vector_score: float, alpha: float) -> float:
    return alpha * bm25 + (1.0 - alpha) * vector_score


def compute_hybrid_score(key, bm25_score: float, plan: VectorPlan,
                         vector_scores: list[dict]):
    """(final_score, vector_score_sum_or_None, has_vector) —
    parity: `api/reader.rs:227-256`."""
    blended_sum = 0.0
    vector_sum = 0.0
    has_vector = False
    for clause, scores in zip(plan.clauses, vector_scores):
        raw = scores.get(key)
        if raw is not None:
            vector_sum += raw
            has_vector = True
        vec_score = raw if raw is not None \
            else missing_vector_score(clause.metric)
        if clause.alpha >= 1.0:
            blended = bm25_score
        elif clause.alpha <= 0.0:
            blended = vec_score
        else:
            blended = blend_scores(bm25_score, vec_score, clause.alpha)
        blended_sum += blended
    denom = max(len(plan.clauses), 1)
    return (blended_sum / denom, vector_sum if has_vector else None,
            has_vector)


def distance_weight(distance: int) -> float:
    return 1.0 / (distance + 1.0)


def bounded_levenshtein(a: str, b: str, max_edits: int) -> Optional[int]:
    la, lb = len(a), len(b)
    if abs(la - lb) > max_edits:
        return None
    if la == 0:
        return lb if lb <= max_edits else None
    if lb == 0:
        return la if la <= max_edits else None
    prev = list(range(lb + 1))
    for i, ca in enumerate(a):
        curr = [i + 1] + [0] * lb
        row_min = curr[0]
        for j, cb in enumerate(b):
            cost = 0 if ca == cb else 1
            val = min(prev[j + 1] + 1, curr[j] + 1, prev[j] + cost)
            curr[j + 1] = val
            row_min = min(row_min, val)
        if row_min > max_edits:
            return None
        prev = curr
    return prev[lb] if prev[lb] <= max_edits else None


def build_wildcard_regex(pattern: str) -> re.Pattern:
    buf = "^"
    for ch in pattern:
        if ch == "*":
            buf += ".*"
        elif ch == "?":
            buf += "."
        else:
            buf += re.escape(ch)
    buf += "$"
    try:
        return re.compile(buf)
    except re.error as e:
        raise QueryError(f"invalid wildcard `{pattern}`: {e}") from e


def wildcard_literal_prefix(pattern: str) -> str:
    return re.split(r"[*?]", pattern, maxsplit=1)[0]


def regex_literal_prefix(pattern: str) -> str:
    prefix = []
    escaped = False
    for i, ch in enumerate(pattern):
        if escaped:
            if ch == "\\":
                prefix.append(ch)
                escaped = False
                continue
            if ch in "dDwWsSbBpP":
                break
            prefix.append(ch)
            escaped = False
            continue
        if ch == "\\":
            escaped = True
        elif ch == "^" and not prefix:
            continue
        elif ch in ".*+?()[]{}|$":
            break
        else:
            prefix.append(ch)
    return "".join(prefix)


def ensure_keyword_fast(schema, field: str, context: str) -> None:
    meta = schema.field_meta(field)
    if meta is None or meta.kind != "keyword" or not meta.fast:
        raise QueryError(
            f"{context} field `{field}` must be a fast keyword field")


# ---------------------------------------------------------------------------
# Cursors
# ---------------------------------------------------------------------------

def encode_cursor(generation: int, returned: int, key: SortKey,
                  sort_plan: SortPlan, fast: bool) -> str:
    payload = {
        "v": CURSOR_VERSION,
        "gen": generation,
        "ret": returned,
        "hash": sort_plan.hash,
        "fast": fast,
        "key": key.to_json(),
    }
    return json.dumps(payload, separators=(",", ":")).encode().hex()


def decode_cursor(raw: str, generation: int, sort_plan: SortPlan,
                  fast: bool) -> dict:
    try:
        payload = json.loads(bytes.fromhex(raw))
    except (ValueError, json.JSONDecodeError) as e:
        raise CursorError("invalid cursor") from e
    if not isinstance(payload, dict) or payload.get("v") != CURSOR_VERSION:
        raise CursorError("invalid cursor version")
    if payload.get("gen") != generation:
        raise CursorError("cursor is stale: index has changed")
    if payload.get("hash") != sort_plan.hash:
        raise CursorError("cursor does not match the requested sort")
    if bool(payload.get("fast")) != fast:
        raise CursorError("cursor does not match the requested sort")
    try:
        key = SortKey.from_json(payload["key"], sort_plan.orders)
    except (KeyError, TypeError, ValueError) as e:
        raise CursorError("invalid cursor") from e
    returned = int(payload.get("ret", 0))
    if returned > MAX_CURSOR_ADVANCE:
        raise CursorError("cursor advanced past the pagination limit")
    return {"key": key, "returned": returned}


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def _host_tier_device(doc_count: int):
    """The cpu ``jax.Device`` a segment this size should live on, or
    None for normal accelerator residency. Off by default: only when
    ``SEARCHLITE_HOST_TIER_DOCS`` is set above 0 do segments under that
    many docs serve from the CPU backend while an accelerator is the
    default backend (searchable with no device upload or compile, and
    moved to the device once compaction folds them past the
    threshold); on a cpu-default process everything already runs on
    host. ``SEARCHLITE_HOST_TIER=force`` makes a cpu-default process
    place on its LAST cpu device instead — the tests drive the real
    placement/scoping/routing machinery that way (committed arrays on a
    non-default device) without accelerator hardware."""
    thr = int(os.environ.get("SEARCHLITE_HOST_TIER_DOCS", 0))
    if thr <= 0 or doc_count >= thr:
        return None
    try:
        import jax

        devs = jax.local_devices(backend="cpu")
        if jax.default_backend() != "cpu":
            return devs[0]
        if os.environ.get("SEARCHLITE_HOST_TIER") == "force" \
                and len(devs) > 1:
            return devs[-1]
        return None
    except Exception:  # cpu backend not in jax_platforms
        return None


def _cached_segment(storage, meta, ordinal: int, k1: float, b: float):
    """(SegmentReader, DeviceSegment) for an immutable segment, shared
    process-wide. Keyed by segment uuid + tombstone state + BM25 params
    + tier placement: commits that only ADD segments reuse every
    existing upload; merging tombstones into a segment clones the
    cached entry (shared immutable arrays + uploads, fresh
    deletion-derived state — DeviceSegment.clone_with_tombstones). Segment ordinals stay stable for a given id as
    long as no EARLIER segment leaves the manifest (commits append;
    merge_segments appends its fold at the tail so realtime folds of
    trailing small segments never shift the base segments' ordinals;
    compaction mints a new id). A merge that removes an early segment
    shifts later ordinals and rebuilds those entries on next use."""
    device = _host_tier_device(meta.doc_count)
    base_key = (meta.id, float(k1), float(b), device is None)
    key = base_key + (tuple(meta.deleted_docs),)
    with _GLOBAL_LOCK:
        hit = _GLOBAL_SEGMENTS.get(key)
        base = _GLOBAL_BASE.get(base_key)
    if hit is not None and hit[1].ord == ordinal:
        return hit
    if base is not None:
        # same segment uuid at a different tombstone state (or a
        # shifted ordinal after a merge removed an earlier segment):
        # tombstone-delta clone — the big immutable structures and
        # their HBM uploads are shared, only deletion-derived state
        # rebuilds (an upsert commit at a multi-M-doc corpus used to
        # re-parse + re-upload the whole segment here)
        seg = base[0].clone_with_tombstones(meta)
        dseg = base[1].clone_with_tombstones(seg, ordinal)
    else:
        seg = SegmentReader(meta, storage)
        dseg = DeviceSegment(seg, ordinal, k1=k1, b=b, device=device)
    with _GLOBAL_LOCK:
        _GLOBAL_SEGMENTS[key] = (seg, dseg)
        _GLOBAL_BASE[base_key] = (seg, dseg)
        while len(_GLOBAL_SEGMENTS) > _MAX_CACHED_SEGMENTS:
            _GLOBAL_SEGMENTS.pop(next(iter(_GLOBAL_SEGMENTS)))
        while len(_GLOBAL_BASE) > _MAX_CACHED_SEGMENTS:
            _GLOBAL_BASE.pop(next(iter(_GLOBAL_BASE)))
    return seg, dseg


class IndexReader:
    def __init__(self, index):
        self.index = index
        self.manifest = index.manifest  # snapshot
        self.schema = self.manifest.schema
        self.options = index.options
        self.analysis = self.schema.build_analyzers()
        self.segments: list[SegmentReader] = []
        self.device_segments: list[DeviceSegment] = []
        # A concurrent merge/compact can swap the manifest and delete
        # a snapshot's segment files between our snapshot and the
        # per-segment opens (uncached segments read from storage).
        # Segments only vanish once the LIVE manifest no longer
        # references them, so re-snapshotting and retrying converges.
        for attempt in range(8):
            try:
                for i, meta in enumerate(self.manifest.segments):
                    seg, dseg = _cached_segment(
                        index.storage, meta, i,
                        self.options.bm25_k1, self.options.bm25_b)
                    self.segments.append(seg)
                    self.device_segments.append(dseg)
                break
            except StorageError:
                if attempt == 7:
                    raise
                self.segments.clear()
                self.device_segments.clear()
                self.manifest = index.reload_manifest()
                self.schema = self.manifest.schema
                self.analysis = self.schema.build_analyzers()
        self.generation = max(
            (s.generation for s in self.manifest.segments), default=0)
        self._schema_fingerprint = hashlib.sha256(
            json.dumps(self.schema.to_json(),
                       sort_keys=True).encode()).hexdigest()[:16]

    # -- term expansion (host, over per-segment dictionaries) ----------------

    def _expand_term_groups(self, groups, fuzzy: Optional[FuzzyOptions]
                            ) -> tuple[list[QualifiedTerm], list[list[str]]]:
        qualified: list[QualifiedTerm] = []
        group_keys: list[list[str]] = []
        for group in groups:
            keys: list[str] = []
            seen_keys: set[str] = set()
            for fspec in group.fields:
                target_leaf = (fspec.leaf if fspec.leaf is not None
                               else group.leaf)
                weight = group.boost * fspec.boost
                kind = self.schema.field_kind(fspec.field)
                if kind == "text":
                    analyzer = self.analysis.search_analyzer(fspec.field)
                    if analyzer is None:
                        continue
                    if group.expansion == "exact":
                        tokens = [t.text for t in analyzer.analyze(group.term)]
                    else:
                        # Patterns (prefix/wildcard/regex/fuzzy source) are
                        # never tokenized: analysis strips the very
                        # metacharacters that make them patterns (`w*` would
                        # tokenize to `w` and silently become an exact
                        # match). Apply only structure-preserving
                        # normalization (analyzer.rs:33-46 normalize_pattern;
                        # expansion itself: api/reader.rs:1212-1374).
                        tokens = [analyzer.normalize_pattern(group.term)]
                    seen_tokens: set[str] = set()
                    for token in tokens:
                        if token in seen_tokens:
                            continue
                        seen_tokens.add(token)
                        scored, expanded = self._expand_term_for_group(
                            fspec.field, token, weight, group.score,
                            target_leaf, fuzzy, group.expansion,
                            group.max_expansions)
                        if group.score:
                            qualified.extend(scored)
                        for key in expanded:
                            if key not in seen_keys:
                                seen_keys.add(key)
                                keys.append(key)
                elif kind == "keyword":
                    term = group.term.lower()
                    scored, expanded = self._expand_term_for_group(
                        fspec.field, term, weight, group.score, target_leaf,
                        fuzzy, group.expansion, group.max_expansions)
                    if group.score:
                        qualified.extend(scored)
                    for key in expanded:
                        if key not in seen_keys:
                            seen_keys.add(key)
                            keys.append(key)
            group_keys.append(keys)
        return qualified, group_keys

    def _terms_with_prefix(self, prefix_key: str):
        for seg in self.segments:
            for term, _tid in seg.terms.iter_prefix(prefix_key):
                yield term

    def _expand_term_for_group(self, field, term, boost, score, leaf, fuzzy,
                               expansion, max_expansions):
        key = f"{field}:{term}"
        leaf_val = leaf if leaf is not None else 0
        if expansion == "exact":
            if not score or leaf is None:
                return [], [key]
            if fuzzy is None or min(fuzzy.max_edits, 2) == 0:
                return ([QualifiedTerm(field, term, key, boost, leaf_val)],
                        [key])
            return self._expand_fuzzy(field, term, boost, leaf_val, fuzzy)
        if max_expansions == 0:
            return [], []
        if expansion == "prefix":
            matcher = None
            literal = term
        elif expansion == "wildcard":
            matcher = build_wildcard_regex(term)
            literal = wildcard_literal_prefix(term)
        else:  # regex
            try:
                matcher = re.compile(f"^(?:{term})$")
            except re.error as e:
                raise QueryError(f"invalid regex `{term}`: {e}") from e
            literal = regex_literal_prefix(term)
        prefix_key = f"{field}:{literal}"
        field_prefix_len = len(field) + 1
        qualified, keys = [], []
        seen: set[str] = set()
        for seg in self.segments:
            expanded = 0
            for seg_key, _tid in seg.terms.iter_prefix(prefix_key):
                if expanded >= max_expansions:
                    break
                if len(seg_key) <= field_prefix_len:
                    continue
                token = seg_key[field_prefix_len:]
                if matcher is not None and not matcher.match(token):
                    continue
                if seg_key in seen:
                    continue
                seen.add(seg_key)
                if score and leaf is not None:
                    qualified.append(QualifiedTerm(
                        field, token, seg_key, boost, leaf_val))
                keys.append(seg_key)
                expanded += 1
        return qualified, keys

    def _expand_fuzzy(self, field, term, boost, leaf, fuzzy: FuzzyOptions):
        exact_key = f"{field}:{term}"
        qualified = [QualifiedTerm(field, term, exact_key,
                                   boost * distance_weight(0), leaf)]
        keys = [exact_key]
        term_len = len(term)
        if term_len < fuzzy.min_length or fuzzy.max_expansions == 0:
            return qualified, keys
        max_edits = min(fuzzy.max_edits, 2)
        prefix_len = min(fuzzy.prefix_length, term_len)
        prefix_key = f"{field}:{term[:prefix_len]}"
        field_prefix_len = len(field) + 1
        seen = {exact_key}
        expansions = 0
        for seg in self.segments:
            if expansions >= fuzzy.max_expansions:
                break
            for seg_key, _tid in seg.terms.iter_prefix(prefix_key):
                if expansions >= fuzzy.max_expansions:
                    break
                if len(seg_key) <= field_prefix_len:
                    continue
                candidate = seg_key[field_prefix_len:]
                if candidate == term:
                    continue
                if abs(len(candidate) - term_len) > max_edits:
                    continue
                distance = bounded_levenshtein(term, candidate, max_edits)
                if distance is None or distance == 0:
                    continue
                if seg_key not in seen:
                    seen.add(seg_key)
                    qualified.append(QualifiedTerm(
                        field, candidate, seg_key,
                        boost * distance_weight(distance), leaf))
                    keys.append(seg_key)
                    expansions += 1
        return qualified, keys

    # -- per-segment dense inputs ---------------------------------------------

    def _segment_query_args(self, dseg: DeviceSegment,
                            qualified: list[QualifiedTerm],
                            group_keys: list[list[str]],
                            n_leaves: int, n_groups: int):
        """Build the slot tables for the impact-matmul executor: one slot
        per distinct present term key, posting ranges into the segment's
        flat impact arrays, and the leaf-weight / leaf- and
        group-indicator matrices."""
        seg = dseg.reader
        postings = seg.postings
        live = float(max(dseg.live_docs, 0))

        slots: dict[str, int] = {}
        slot_start: list[int] = []
        slot_len: list[int] = []
        slot_idf: list[float] = []
        slot_bstart: list[int] = []
        slot_bcnt: list[int] = []
        slot_tids: list[int] = []

        def get_slot(key: str):
            s = slots.get(key)
            if s is None:
                tid = seg.terms.get(key)
                if tid is None:
                    return None
                s = len(slot_start)
                slots[key] = s
                df = int(postings.term_df[tid])
                slot_start.append(int(dseg.posting_base[tid]))
                slot_len.append(df)
                slot_idf.append(bm25_idf(float(df), live))
                slot_bstart.append(int(postings.term_block_start[tid]))
                slot_bcnt.append(int(postings.term_block_count[tid]))
                slot_tids.append(int(tid))
            return s

        merged: dict[tuple[str, int], float] = {}
        for qt in qualified:
            merged[(qt.key, qt.leaf)] = \
                merged.get((qt.key, qt.leaf), 0.0) + qt.weight

        entries = []  # (slot, leaf, idf*weight)
        postings_touched = 0
        slot_weight: dict[int, float] = {}
        for (key, leaf), weight in merged.items():
            s = get_slot(key)
            if s is None:
                continue
            entries.append((s, leaf, slot_idf[s] * weight))
            slot_weight[s] = slot_weight.get(s, 0.0) + slot_idf[s] * weight
            postings_touched += slot_len[s]
        group_entries = []  # (slot, group)
        for g, keys in enumerate(group_keys):
            for key in keys:
                s = get_slot(key)
                if s is not None:
                    group_entries.append((s, g))

        from searchlite.ops.impact import build_block_tables, pow4_bucket

        s_pad = next_pow2(max(len(slot_start), 8))
        p_pad = pow4_bucket(sum(slot_len))
        # coarse (pow-4) buckets: ad-hoc single queries hit many sizes
        # and compile latency dominates their scatter cost
        blk_idx, slot_row, nb_pad = build_block_tables(
            slot_bstart, slot_bcnt, sentinel_row=dseg.n_block_rows,
            coarse=True)
        L = max(n_leaves, 1)
        G = max(n_groups, 1)
        out = {
            "slot_start": np.zeros(s_pad, dtype=np.int32),
            "slot_len": np.zeros(s_pad, dtype=np.int32),
            "blk_idx": blk_idx,
            "slot_row": slot_row,
            "nb_pad": nb_pad,
            "s_pad": s_pad,
            "w_leaf": np.zeros((L, s_pad), dtype=np.float32),
            "leaf_ind": np.zeros((L, s_pad), dtype=np.float32),
            "group_ind": np.zeros((G, s_pad), dtype=np.float32),
            "p_pad": p_pad,
            "n_scored": len(entries),
            "postings_touched": postings_touched,
            "slot_keys": {key: s for key, s in slots.items()},
            "slot_weight": slot_weight,
            "slot_tids": np.asarray(slot_tids, dtype=np.int64),
            "n_slots": len(slot_start),
        }
        out["slot_start"][:len(slot_start)] = slot_start
        out["slot_len"][:len(slot_len)] = slot_len
        for s, leaf, w in entries:
            out["w_leaf"][leaf, s] += w
            out["leaf_ind"][leaf, s] = 1.0
        for s, g in group_entries:
            out["group_ind"][g, s] = 1.0
        # dense M exceeding int32 indexing (or the HBM budget, checked
        # by the caller) routes through the chunked tile executor
        # instead of failing — no S*n1 wall
        out["overflow"] = s_pad * dseg.n1 + nb_pad * 128 >= 2**31
        return out

    def _segment_phrase_masks(self, seg: SegmentReader, phrase_specs,
                              n1: Optional[int] = None) -> np.ndarray:
        # n1 = the DEVICE doc-axis width (dseg.n1, which may be
        # bucket-padded past doc_count+1); host-only callers omit it
        if n1 is None:
            n1 = seg.doc_count + 1
        masks = np.zeros((max(len(phrase_specs), 1), n1), dtype=bool)
        for p_idx, spec in enumerate(phrase_specs):
            for field in spec.fields:
                if self.schema.field_kind(field) != "text":
                    continue
                analyzer = self.analysis.search_analyzer(field)
                if analyzer is None:
                    continue
                tokens = analyzer.analyze(" ".join(spec.terms))
                if not tokens:
                    continue
                # variants per position (synonyms share a position)
                by_pos: dict[int, list[str]] = {}
                for tok in tokens:
                    by_pos.setdefault(tok.position, []).append(tok.text)
                positions = [by_pos[p] for p in sorted(by_pos)]
                # per position: doc -> merged sorted position array
                per_pos_docs: list[dict[int, np.ndarray]] = []
                ok = True
                for variants in positions:
                    docs_map: dict[int, list[np.ndarray]] = {}
                    for text in variants:
                        tid = seg.terms.get(f"{field}:{text}")
                        if tid is None:
                            continue
                        docs, _tfs = seg.postings.term_postings(tid)
                        for posting_idx, doc in enumerate(docs.tolist()):
                            pos = seg.postings.positions(tid, posting_idx)
                            docs_map.setdefault(doc, []).append(pos)
                    if not docs_map:
                        ok = False
                        break
                    per_pos_docs.append({
                        doc: np.sort(np.concatenate(lists))
                        for doc, lists in docs_map.items()
                    })
                if not ok or not per_pos_docs:
                    continue
                candidates = set(per_pos_docs[0])
                for m in per_pos_docs[1:]:
                    candidates &= set(m)
                for doc in candidates:
                    plists = [m[doc] for m in per_pos_docs]
                    if matches_phrase(plists, spec.slop):
                        masks[p_idx, doc] = True
        return masks

    def _segment_filter_masks(self, seg: SegmentReader, filter_slots,
                              n1: Optional[int] = None) -> np.ndarray:
        if n1 is None:
            n1 = seg.doc_count + 1
        masks = np.zeros((max(len(filter_slots), 1), n1), dtype=bool)
        for i, filters in enumerate(filter_slots):
            masks[i, :seg.doc_count] = compute_filters_mask(
                seg.fast, list(filters))
        return masks

    def _segment_columns(self, seg: SegmentReader, columns: list[str],
                         n1: Optional[int] = None):
        if n1 is None:
            n1 = seg.doc_count + 1
        vals = np.zeros((max(len(columns), 1), n1), dtype=np.float32)
        has = np.zeros((max(len(columns), 1), n1), dtype=bool)
        for i, field in enumerate(columns):
            col = seg.fast.column(field)
            if col is None:
                continue
            present = np.diff(col.offsets) > 0
            first_idx = col.offsets[:-1][present]
            vals[i, :seg.doc_count][present] = \
                col.values[first_idx].astype(np.float32)
            has[i, :seg.doc_count] = present
        return vals, has

    # -- main entry --------------------------------------------------------------

    def search_scroll(self, req, max_pages: Optional[int] = None,
                      block_docs: int = 2000, mesh=None
                      ) -> list[SearchResult]:
        """Drain a paginated result stream in BLOCKS: one device pass
        fetches up to ``block_docs`` hits, sliced host-side into pages
        of ``req.limit``. The page/hit sequence is identical to looping
        ``search`` with ``next_cursor`` (tested), but a full drain
        costs ~(total/block_docs) device round trips instead of one per
        page. The reference drains pages in-process
        (`searchlite-core/benches/end_to_end.rs:236-313`); this is the
        device-side equivalent of that access pattern.

        Each returned page carries ``next_cursor`` — block-interior
        pages get an exact per-page cursor (same encoding the page
        loop produces), so a client can stop mid-drain and resume with
        plain ``search``. The drain ends when hits are exhausted or
        ``max_pages`` is reached."""
        if isinstance(req, dict):
            req = SearchRequest.from_json(req)
        if req.limit <= 0:
            raise QueryError("search request must set limit > 0")
        page_limit = req.limit
        block = max(page_limit, min(block_docs, MAX_CANDIDATE_SIZE))
        block -= block % page_limit or 0
        sort_plan = SortPlan.from_request(self.schema, req.sort)
        score_fast_path = (sort_plan.is_score_only()
                           and sort_plan.primary_order() == "desc")
        pages: list[SearchResult] = []
        cursor = req.cursor
        returned = 0
        if cursor is not None:
            returned = decode_cursor(cursor, self.generation, sort_plan,
                                     score_fast_path)["returned"]
        while max_pages is None or len(pages) < max_pages:
            block_req = replace(req, limit=block, cursor=cursor,
                                candidate_size=max(
                                    req.candidate_size or 0, block))
            res = self.search(block_req, mesh=mesh)
            n_pages = -(-len(res.hits) // page_limit) if res.hits else 0
            for p in range(n_pages):
                lo = p * page_limit
                page_hits = res.hits[lo:lo + page_limit]
                last_in_block = lo + page_limit >= len(res.hits)
                if last_in_block:
                    next_cur = res.next_cursor
                else:
                    # exact per-page cursor: same key material the page
                    # loop would encode (the page's last hit)
                    last = page_hits[-1]
                    next_cur = encode_cursor(
                        self.generation,
                        returned + lo + len(page_hits),
                        last.sort_key, sort_plan, score_fast_path) \
                        if last.sort_key is not None else None
                pages.append(SearchResult(
                    total_hits_estimate=res.total_hits_estimate,
                    total_groups=res.total_groups,
                    hits=page_hits,
                    next_cursor=next_cur,
                    aggregations=res.aggregations if p == 0 else {},
                    suggest=res.suggest if p == 0 else {},
                    profile=res.profile if p == 0 else None,
                ))
                if max_pages is not None and len(pages) >= max_pages:
                    break
            returned += len(res.hits)
            cursor = res.next_cursor
            if cursor is None or not res.hits:
                break
        return pages

    def search(self, req, mesh=None) -> SearchResult:
        """Execute one search request. With ``mesh`` (a
        ``jax.sharding.Mesh`` with a "shard" axis), per-segment
        execution runs doc-sharded across the mesh's chips
        (parallel/query.py) — the full request surface (filters,
        phrases, minimum_should_match, field sort, cursors, collapse,
        aggregations, custom scoring) produces results identical to
        single-chip execution."""
        if isinstance(req, dict):
            req = SearchRequest.from_json(req)
        if req.limit <= 0:
            raise QueryError("search request must set limit > 0")
        if not req.return_hits and req.cursor is not None:
            raise QueryError(
                "cursor is not supported when return_hits is false")
        if req.collapse is not None:
            ensure_keyword_fast(self.schema, req.collapse.field, "collapse")
        if req.filter is not None:
            validate_filter(self.schema, req.filter)

        sort_plan = SortPlan.from_request(self.schema, req.sort)
        score_fast_path = (sort_plan.is_score_only()
                           and sort_plan.primary_order() == "desc")
        cursor_state = None
        if req.cursor is not None:
            cursor_state = decode_cursor(
                req.cursor, self.generation, sort_plan, score_fast_path)
        cursor_key = cursor_state["key"] if cursor_state else None
        cursor_returned = cursor_state["returned"] if cursor_state else 0

        default_fields = (req.fields if req.fields is not None
                          else [f.name for f in self.schema.text_fields])

        vector_plan = self._build_vector_plan(req)
        if vector_plan is not None and not vector_plan.vector_only \
                and all(c.alpha >= 1.0 for c in vector_plan.clauses):
            vector_plan = None
        if vector_plan is not None and vector_plan.vector_only:
            return self._search_vector_only(req, sort_plan, cursor_state,
                                            vector_plan, mesh=mesh)

        base_candidate = min(
            max(req.candidate_size or req.limit, req.limit),
            MAX_CANDIDATE_SIZE)
        effective_limit = (max(vector_plan.candidate_size, req.limit)
                           if vector_plan is not None else base_candidate)
        top_k = (effective_limit + 1) if req.return_hits else 0

        plan = build_query_plan(
            req.query, default_fields)
        k1, b = self.options.bm25_k1, self.options.bm25_b
        compiled = self._compile(plan, k1, b)

        qualified, group_keys = self._expand_term_groups(
            plan.term_groups, req.fuzzy)
        highlight_terms: list[str] = []
        seen_hl: set[str] = set()
        for qt in qualified:
            if qt.term not in seen_hl:
                seen_hl.add(qt.term)
                highlight_terms.append(qt.term)
        highlight_phrases = self._phrase_term_map(plan.phrase_specs)

        need_scores = sort_plan.uses_score() or compiled.needs_hook \
            or req.explain
        has_scored = bool(qualified)

        from searchlite.query.aggs import (
            AggregationPipeline,
            validate_aggregations,
        )

        validate_aggregations(self.schema, req.aggs)
        agg_pipeline = (AggregationPipeline(req.aggs, highlight_terms,
                                            self.schema)
                        if req.aggs else None)

        start_time = time.monotonic()
        all_hits: list[RankedHit] = []
        total_matches = 0
        saw_cursor = cursor_state is None
        agg_results = []
        text_masks: dict[int, np.ndarray] = {}
        stats = {"scored_docs": 0, "candidates_examined": 0,
                 "postings_advanced": 0}

        import jax.numpy as jnp

        # phase 1 — launch: per-segment host prep + async dispatch. All
        # segments' device work runs while later segments' host prep
        # proceeds; nothing blocks until the single bulk fetch below.
        # Aggregations that can reduce ON DEVICE (ops/device_aggs.py)
        # skip the full doc-axis mask fetch — per segment: a segment
        # whose columns can't run device-side falls back to the host
        # collectors over a fetched mask.
        needs_mask_base = (not score_fast_path
                           or req.collapse is not None)
        agg_dev_candidate = (agg_pipeline is not None
                             and not needs_mask_base
                             and vector_plan is None
                             and mesh is None
                             and os.environ.get(
                                 "SEARCHLITE_DEVICE_AGGS", "1") != "0")
        from searchlite.ops.precision import strict as _strict
        needs_mask_host = needs_mask_base or agg_pipeline is not None
        use_cursor = (cursor_key is not None and score_fast_path
                      and vector_plan is None)
        # real doc-tile pruning (ops/tiles.py) is sound only when the
        # request is a plain score-desc top-k: aggregations need every
        # match, custom scoring breaks the BM25 upper bound, cursors
        # need the cursor doc's exact score present
        prune_min = int(os.environ.get(
            "SEARCHLITE_PRUNE_MIN_POSTINGS", 100_000))
        pruning_ok = (req.execution in ("wand", "bmw")
                      and score_fast_path and req.return_hits
                      and cursor_state is None and agg_pipeline is None
                      and vector_plan is None and req.collapse is None
                      and not compiled.needs_hook and has_scored)
        pruning_real = False
        pruning_simulated = False
        # plain OR-of-terms requests with no masks/aggs/cursor ride the
        # sparse candidate scorer: only the query's own posting blocks
        # are gathered — no [S, n1] matrix, no doc-axis work at ANY
        # corpus size (the forced-bm25 single-query fix at multi-M docs)
        sparse_single_ok = (
            score_fast_path and req.return_hits
            and cursor_state is None and agg_pipeline is None
            and vector_plan is None and req.collapse is None
            and not compiled.needs_hook and has_scored
            and req.filter is None and not use_cursor
            and not req.explain
            and not plan.phrase_specs and not compiled.filter_slots
            and plan.is_plain_or_sum()
            and os.environ.get("SEARCHLITE_SINGLE_SPARSE", "1") != "0")
        pending = []  # (dseg, qargs, fetch_refs)
        pruned_jobs = []  # deferred doc-tile pruned segments

        def launch_dense(dseg, qargs, phrase_masks, filter_masks,
                         col_vals, col_has, root_mask, cs, eq_mode,
                         cdoc, k):
            with dseg.exec_scope():
                return launch_dense_inner(
                    dseg, qargs, phrase_masks, filter_masks, col_vals,
                    col_has, root_mask, cs, eq_mode, cdoc, k)

        def launch_dense_inner(dseg, qargs, phrase_masks, filter_masks,
                               col_vals, col_has, root_mask, cs,
                               eq_mode, cdoc, k):
            run = compiled.executor()
            (top_scores, top_idx, match_count, final_mask, adjusted,
             cursor_seen, text_mask) = run(
                dseg.block_docs, dseg.block_impacts, dseg.deleted,
                jnp.asarray(qargs["blk_idx"]),
                jnp.asarray(qargs["slot_row"]),
                jnp.asarray(qargs["w_leaf"]),
                jnp.asarray(qargs["leaf_ind"]),
                jnp.asarray(qargs["group_ind"]),
                jnp.asarray(phrase_masks), jnp.asarray(filter_masks),
                jnp.asarray(col_vals), jnp.asarray(col_has),
                jnp.asarray(root_mask),
                jnp.float32(cs), jnp.int32(eq_mode), jnp.int32(cdoc),
                k=k, s_pad=qargs["s_pad"], has_scored_terms=has_scored,
                need_scores=need_scores, use_cursor=use_cursor)
            fetch = [top_scores, top_idx, match_count, cursor_seen]
            needs_mask = needs_mask_host
            agg_refs = []
            if agg_dev_candidate:
                from searchlite.ops.device_aggs import (
                    launch_device_aggs,
                    plan_device_aggs,
                )

                plan_da = plan_device_aggs(dseg, req.aggs, _strict())
                if plan_da is not None:
                    meta, agg_refs = launch_device_aggs(
                        dseg, plan_da, final_mask)
                    qargs["_dev_aggs"] = (meta, len(agg_refs))
                    needs_mask = needs_mask_base
            if needs_mask:
                fetch.append(final_mask)
            qargs["_fetched_mask"] = needs_mask
            if vector_plan is not None:
                fetch.append(text_mask)
            if need_scores and not score_fast_path:
                fetch.append(adjusted)
            fetch.extend(agg_refs)  # device agg partials fetch LAST
            return (dseg, qargs, fetch)
        for dseg in self.device_segments:
            seg = dseg.reader
            if seg.doc_count == 0:
                if agg_pipeline is not None:
                    agg_results.append(agg_pipeline.empty_intermediate())
                continue
            qargs = self._segment_query_args(
                dseg, qualified, group_keys, compiled.n_leaves,
                compiled.n_groups)
            phrase_masks = self._segment_phrase_masks(
                seg, plan.phrase_specs, n1=dseg.n1)
            filter_masks = self._segment_filter_masks(
                seg, compiled.filter_slots, n1=dseg.n1)
            col_vals, col_has = self._segment_columns(
                seg, compiled.columns, n1=dseg.n1)
            root_mask = np.ones(dseg.n1, dtype=bool)
            if req.filter is not None:
                root_mask[:seg.doc_count] = compute_filters_mask(
                    seg.fast, [req.filter])
                root_mask[seg.doc_count:] = False

            if use_cursor:
                cs = float(cursor_key.parts[0])
                if dseg.ord < cursor_key.segment_ord:
                    eq_mode, cdoc = 0, 0
                elif dseg.ord == cursor_key.segment_ord:
                    eq_mode, cdoc = 1, cursor_key.doc_id
                else:
                    eq_mode, cdoc = 2, 0
            else:
                cs, eq_mode, cdoc = 0.0, 2, 0

            k = min(max(top_k, 1), dseg.n1)
            if mesh is not None:
                ts, ti, mc, fm, adj, tm = self._search_segment_sharded(
                    mesh, dseg, compiled, qargs, phrase_masks,
                    filter_masks, col_vals, col_has, root_mask, k,
                    has_scored, need_scores)
                if vector_plan is not None:
                    text_masks[dseg.ord] = tm
                if score_fast_path and cursor_state is None \
                        and agg_pipeline is None and req.collapse is None \
                        and vector_plan is None:
                    # device-merged collective top-k feeds the fast path
                    qargs["_pruned_pre"] = (
                        ts, ti, mc, qargs["postings_touched"])
                else:
                    # general host path: doc-sharded masks reassembled
                    qargs["_chunked_pre"] = (fm, adj, tm)
                pending.append((dseg, qargs, []))
                continue
            m_budget = int(os.environ.get(
                "SEARCHLITE_M_BUDGET_BYTES", 2 * 1024**3))
            oversize = (qargs["overflow"]
                        or qargs["s_pad"] * dseg.n1 * 4 > m_budget)
            # the sparse single route goes FIRST: when it applies
            # (plain OR, ≥min_docs corpus, certificate sound) it is
            # one dispatch + one fetch (~RTT-floored) vs the tile
            # waves' 2-3 round trips + run-table uploads — measured
            # p50 ~30 ms vs ~200-350 ms at 5M (probe_single_device);
            # on certificate fall-through the wasted dispatch costs
            # one RTT and the tile path still runs
            if sparse_single_ok:
                sp = self._try_sparse_single(dseg, qargs, k)
                if sp is not None:
                    qargs["_pruned_pre"] = sp
                    pending.append((dseg, qargs, []))
                    continue
            if pruning_ok and qargs["n_slots"] > 0 \
                    and dseg.device is None \
                    and (oversize
                         or qargs["postings_touched"] >= prune_min):
                # deferred: pruned segments run wave-pipelined together
                # after this loop (3 bulk fetches total, not 3/segment)
                pruned_jobs.append((dseg, qargs, phrase_masks,
                                    filter_masks, col_vals, col_has,
                                    root_mask, k, oversize))
                continue
            if oversize:
                # dense M won't fit — exact chunked tile execution,
                # results flow through the general (host) branch
                mask_c, adjusted_c, text_c = self._run_segment_chunked(
                    dseg, compiled, qargs, phrase_masks, filter_masks,
                    col_vals, col_has, root_mask, has_scored,
                    need_scores, vector_plan is not None)
                qargs["_chunked_pre"] = (mask_c, adjusted_c, text_c)
                pending.append((dseg, qargs, []))
                continue
            pending.append(launch_dense(
                dseg, qargs, phrase_masks, filter_masks, col_vals,
                col_has, root_mask, cs, eq_mode, cdoc, k))

        if pruned_jobs:
            results = self._retry_oom(
                lambda: self._run_pruned_jobs(
                    [job[:8] for job in pruned_jobs], compiled,
                    has_scored, need_scores,
                    bmw_block_size=req.bmw_block_size))
            for job, pre in zip(pruned_jobs, results):
                (dseg, qargs, phrase_masks, filter_masks, col_vals,
                 col_has, root_mask, k, oversize) = job
                if pre is not None:
                    qargs["_pruned_pre"] = pre
                    pruning_real = True
                    pending.append((dseg, qargs, []))
                elif oversize:
                    mask_c, adjusted_c, text_c = \
                        self._run_segment_chunked(
                            dseg, compiled, qargs, phrase_masks,
                            filter_masks, col_vals, col_has, root_mask,
                            has_scored, need_scores,
                            vector_plan is not None)
                    qargs["_chunked_pre"] = (mask_c, adjusted_c, text_c)
                    pending.append((dseg, qargs, []))
                else:
                    pending.append(launch_dense(
                        dseg, qargs, phrase_masks, filter_masks,
                        col_vals, col_has, root_mask, 0.0, 2, 0, k))

        import jax

        # one host<->device round trip for everything every segment needs
        flat_refs = [ref for _dseg, _qargs, fetch in pending
                     for ref in fetch]
        flat_vals = list(jax.device_get(tuple(flat_refs)))

        # phase 2 — host processing, in segment order
        vals_cursor = 0
        for dseg, qargs, fetch in pending:
            seg = dseg.reader
            fetched = flat_vals[vals_cursor:vals_cursor + len(fetch)]
            vals_cursor += len(fetch)
            if "_pruned_pre" in qargs:
                # real doc-tile pruned execution already completed
                top_scores_np, top_idx_np, match_count, real_postings = \
                    qargs["_pruned_pre"]
                cursor_seen = False
                mask_np = None
                adjusted_np = None
                stats["postings_advanced"] += real_postings
            elif "_chunked_pre" in qargs:
                # chunked tile execution: host arrays, general branch
                mask_full, adjusted_np, text_c = qargs["_chunked_pre"]
                mask_np = mask_full[:seg.doc_count]
                top_scores_np = top_idx_np = None
                match_count = int(mask_np.sum())
                cursor_seen = False
                if vector_plan is not None:
                    text_masks[dseg.ord] = text_c
                stats["postings_advanced"] += qargs["postings_touched"]
            else:
                top_scores_np, top_idx_np, match_count, cursor_seen = \
                    fetched[:4]
                cursor = 4
                mask_np = None
                if qargs.get("_fetched_mask"):
                    mask_np = np.array(fetched[cursor])[:seg.doc_count]
                    cursor += 1
                if vector_plan is not None:
                    text_masks[dseg.ord] = fetched[cursor]
                    cursor += 1
                adjusted_np = None
                if need_scores and not score_fast_path:
                    adjusted_np = fetched[cursor]

                # postings telemetry: for wand/bmw on requests where
                # real pruning is disabled (aggs, cursors, hooks, small
                # segments), report the COUNTERFACTUAL postings a
                # block-max pruned traversal would touch, flagged
                # pruning_simulated=true in the profile
                if req.profile and req.execution in ("wand", "bmw") \
                        and score_fast_path and req.return_hits:
                    stats["postings_advanced"] += self._pruned_postings(
                        dseg, qargs, top_scores_np, req.limit,
                        req.execution)
                    pruning_simulated = True
                else:
                    stats["postings_advanced"] += \
                        qargs["postings_touched"]

            if use_cursor and bool(cursor_seen):
                saw_cursor = True

            if score_fast_path and "_chunked_pre" not in qargs:
                total_matches += int(match_count)
                stats["scored_docs"] += int(match_count)
                stats["candidates_examined"] += int(match_count)
                if req.return_hits:
                    scores_np = top_scores_np
                    idx_np = top_idx_np
                    valid = scores_np > -np.inf
                    for score, doc in zip(scores_np[valid].tolist(),
                                          idx_np[valid].tolist()):
                        key = SortKey([float(score)], sort_plan.orders,
                                      dseg.ord, int(doc))
                        all_hits.append(RankedHit(key=key,
                                                  score=float(score)))
            else:
                # general path: vectorized rank arrays over the matched
                # set; SortKey objects built only for the top slice.
                # (i64 sort values beyond 2^53 lose rank precision in
                # the float64 encoding — exactness restored by the final
                # SortKey ordering of the selected slice.)
                matched = np.flatnonzero(mask_np)
                if adjusted_np is not None and len(matched):
                    matched_scores = adjusted_np[matched].astype(
                        np.float64)
                else:
                    matched_scores = np.zeros(len(matched),
                                              dtype=np.float64)
                stats["scored_docs"] += len(matched)
                stats["candidates_examined"] += len(matched)
                ranks = sort_plan.rank_arrays(seg.fast, matched,
                                              matched_scores)
                if cursor_key is not None and vector_plan is None \
                        and len(matched):
                    cr = sort_plan.cursor_ranks(cursor_key, seg.fast)
                    gt = np.zeros(len(matched), dtype=bool)
                    eq = np.ones(len(matched), dtype=bool)
                    for rk, c in zip(ranks, cr):
                        gt |= eq & (rk > c)
                        eq &= rk == c
                    if dseg.ord > cursor_key.segment_ord:
                        tie_after = eq
                    elif dseg.ord == cursor_key.segment_ord:
                        tie_after = eq & (matched > cursor_key.doc_id)
                        if bool((eq & (matched ==
                                       cursor_key.doc_id)).any()):
                            saw_cursor = True
                    else:
                        tie_after = np.zeros(len(matched), dtype=bool)
                    keep = gt | tie_after
                    mask_np[matched[~keep]] = False
                    matched = matched[keep]
                    matched_scores = matched_scores[keep]
                    ranks = [r[keep] for r in ranks]
                total_matches += len(matched)
                if req.return_hits and len(matched):
                    order = np.lexsort(
                        tuple([matched.astype(np.float64)]
                              + list(reversed(ranks))))
                    top = order[:max(top_k, 1)]
                    top_docs = matched[top]
                    top_scores2 = matched_scores[top]
                    keys = sort_plan.build_keys_bulk(
                        seg.fast, top_docs, top_scores2, dseg.ord)
                    all_hits.extend(
                        RankedHit(key=key, score=float(s))
                        for key, s in zip(keys, top_scores2.tolist()))

            if agg_pipeline is not None:
                if "_dev_aggs" in qargs:
                    from searchlite.ops.device_aggs import (
                        build_intermediates,
                    )

                    meta, n_refs = qargs["_dev_aggs"]
                    agg_results.append(build_intermediates(
                        meta, fetched[len(fetched) - n_refs:]))
                else:
                    agg_results.append(agg_pipeline.collect_segment(
                        seg, dseg.ord, np.flatnonzero(mask_np)))

        if vector_plan is not None:
            vector_scores = self._collect_vector_maps(
                vector_plan, req, text_masks, mesh=mesh)
            saw = [saw_cursor]
            all_hits = self._merge_vector_hits(
                all_hits, vector_scores, vector_plan, sort_plan,
                cursor_key, saw)
            saw_cursor = saw[0]

        if not saw_cursor:
            raise CursorError("stale or invalid cursor for this result set")

        hits = all_hits
        if req.return_hits:
            hits.sort(key=lambda h: _KeyWrap(h.key))
        search_ms = (time.monotonic() - start_time) * 1000.0

        timings: dict[str, float] = {}
        rescore_stats = {"scored_docs": 0, "candidates_examined": 0,
                         "postings_advanced": 0}
        if req.return_hits and req.rescore is not None:
            t0 = time.monotonic()
            self._rescore_hits(hits, req.rescore, default_fields, sort_plan,
                               req, rescore_stats)
            timings["rescore_ms"] = (time.monotonic() - t0) * 1000.0

        if req.explain:
            for h in hits:
                if h.explanation is None:
                    functions = []
                    if compiled.needs_hook:
                        functions = self._explain_functions(
                            compiled, plan.score_tree,
                            h.key.segment_ord, h.key.doc_id,
                            plan=plan, group_keys=group_keys)
                    h.explanation = {
                        "base_score": h.score,
                        "functions": functions,
                        "rescore": None,
                        "final_score": h.score,
                    }
                else:
                    h.explanation["final_score"] = h.score

        total_hits_value = total_matches + cursor_returned
        total_groups = None
        group_inner: list[list[RankedHit]] = []
        if req.return_hits and req.collapse is not None:
            groups = self._collapse_hits(hits, req.collapse, sort_plan)
            total_groups = len(groups)
            group_inner = [inner for _top, inner in groups]
            hits = [top for top, _inner in groups]

        next_cursor = None
        out_hits: list[Hit] = []
        if req.return_hits:
            if len(hits) > req.limit:
                last = hits[req.limit - 1]
                returned = cursor_returned + req.limit
                next_cursor = encode_cursor(
                    self.generation, returned, last.key, sort_plan,
                    score_fast_path)
                hits = hits[:req.limit]
                group_inner = group_inner[:req.limit]
            for i, h in enumerate(hits):
                hit = self._materialize_hit(h, req, highlight_terms,
                                            highlight_phrases)
                if hit is None:
                    continue
                if group_inner and i < len(group_inner) and group_inner[i]:
                    inner_hits = [
                        ih for rh in group_inner[i]
                        if (ih := self._materialize_hit(
                            rh, req, highlight_terms,
                            highlight_phrases)) is not None
                    ]
                    if inner_hits:
                        hit.inner_hits = inner_hits
                out_hits.append(hit)

        aggregations = {}
        if agg_pipeline is not None:
            aggregations = agg_pipeline.merge_and_finalize(agg_results)

        suggest = {}
        if req.suggest:
            suggest = self._execute_suggest(req.suggest)

        profile = None
        if req.profile:
            timings["search_ms"] = search_ms
            execution_stats = dict(stats)
            if req.execution in ("wand", "bmw"):
                # honest pruning semantics: postings_advanced is a real
                # measurement when the doc-tile pruned path ran, a
                # counterfactual model otherwise
                execution_stats["pruning_simulated"] = (
                    pruning_simulated or not pruning_real)
            profile = {
                "execution": execution_stats,
                "rescore": dict(rescore_stats) if req.rescore else None,
                "timings": timings,
            }

        return SearchResult(
            total_hits_estimate=total_hits_value,
            total_groups=total_groups,
            hits=out_hits,
            next_cursor=next_cursor,
            aggregations=aggregations,
            suggest=suggest,
            profile=profile,
        )

    # -- vector search -------------------------------------------------------

    def _build_vector_plan(self, req) -> Optional[VectorPlan]:
        """Parity: `api/reader.rs:2001-2184`."""
        vector_nodes: list = []
        has_non_vector = [False]

        def collect(node):
            kind = node.kind
            if kind == "vector":
                from searchlite.api.types import VectorQuery

                vector_nodes.append(VectorQuery.from_json(node.params))
                return
            if kind == "bool":
                if node.params.get("filter"):
                    has_non_vector[0] = True
                for key in ("must", "should", "must_not"):
                    for child in node.params.get(key, []):
                        collect(child)
                        if child.kind != "vector":
                            has_non_vector[0] = True
                return
            if kind == "dis_max":
                for child in node.params.get("queries", []):
                    collect(child)
                    if child.kind != "vector":
                        has_non_vector[0] = True
                return
            if kind in ("function_score", "script_score"):
                collect(node.params["query"])
                has_non_vector[0] = True
                return
            has_non_vector[0] = True

        from searchlite.api.types import QueryNode

        if isinstance(req.query, QueryNode):
            collect(req.query)
        else:
            has_non_vector[0] = True

        if vector_nodes and req.vector_query is not None:
            raise QueryError(
                "cannot set both `vector_query` and a `vector` query node")
        if vector_nodes:
            vectors = vector_nodes
        elif req.vector_query is not None:
            vectors = [req.vector_query]
        else:
            return None
        if len(vectors) > MAX_VECTOR_CLAUSES:
            raise QueryError(
                f"too many vector clauses: got {len(vectors)}, max "
                f"supported {MAX_VECTOR_CLAUSES}")
        vector_only = not has_non_vector[0]
        clauses: list[VectorClausePlan] = []
        max_k = 0
        total_k = 0
        base_candidate = min(
            max(req.candidate_size if req.candidate_size is not None
                else max(req.limit, 10) * 2, req.limit),
            MAX_GLOBAL_CANDIDATES)
        import math as _math

        for vq in vectors:
            field = self.schema.vector_field(vq.field)
            if field is None:
                raise QueryError(f"unknown vector field `{vq.field}`")
            if len(vq.vector) != field.dim:
                raise QueryError(
                    f"vector field `{field.name}` expects dimension "
                    f"{field.dim}, got {len(vq.vector)}")
            query_vec = [float(v) for v in vq.vector]
            if field.metric == "cosine":
                norm = _math.sqrt(sum(v * v for v in query_vec))
                if norm > 0:
                    query_vec = [v / norm for v in query_vec]
            alpha = vq.alpha if vq.alpha is not None else DEFAULT_VECTOR_ALPHA
            if not (0.0 <= alpha <= 1.0) or not _math.isfinite(alpha):
                raise QueryError(
                    "vector alpha must be a finite value between 0 and 1 "
                    "inclusive")
            k = max(vq.k if vq.k is not None else req.limit, 1)
            k = min(k, MAX_VECTOR_K)
            candidate_size = (vq.candidate_size
                              if vq.candidate_size is not None
                              else max(k, req.limit, 10) * 2)
            candidate_size = min(max(candidate_size, k),
                                 MAX_VECTOR_CANDIDATE_SIZE)
            ef_search = (vq.ef_search if vq.ef_search is not None
                         else max(DEFAULT_EF_SEARCH, candidate_size))
            ef_search = min(ef_search, MAX_VECTOR_EF_SEARCH)
            boost = vq.boost if vq.boost is not None else 1.0
            if boost < 0.0 or not _math.isfinite(boost):
                raise QueryError(
                    "vector boost must be finite and non-negative")
            max_k = max(max_k, k)
            total_k += k
            clauses.append(VectorClausePlan(
                field=vq.field, vector=query_vec, k=k, alpha=alpha,
                ef_search=ef_search, candidate_size=candidate_size,
                boost=boost, metric=field.metric))
        if not clauses:
            return None
        candidate_size = max(base_candidate, max_k)
        if candidate_size + total_k > MAX_GLOBAL_CANDIDATES:
            candidate_size = max(MAX_GLOBAL_CANDIDATES - total_k, req.limit)
        if candidate_size == 0:
            candidate_size = max(max_k, 1)
        return VectorPlan(clauses=clauses, candidate_size=candidate_size,
                          vector_only=vector_only)

    def _collect_vector_maps(self, plan: VectorPlan, req,
                             text_masks: Optional[dict[int, np.ndarray]],
                             mesh=None) -> list[dict]:
        """Per-clause {(segment_ord, doc): boosted similarity} maps —
        exact brute-force matmul replacing the reference's HNSW beam
        (`api/reader.rs:2377-2460`). With ``mesh``, vector rows shard
        over chips and the top-k merges over collectives — identical results."""
        from searchlite.ops.vector import (
            vector_topk,
            vector_topk_sharded,
        )

        per_clause: list[dict] = [dict() for _ in plan.clauses]
        for dseg in self.device_segments:
            seg = dseg.reader
            if seg.doc_count == 0:
                continue
            base_mask = np.ones(seg.doc_count, dtype=bool)
            for d in seg.deleted:
                if 0 <= d < seg.doc_count:
                    base_mask[d] = False
            if req.filter is not None:
                base_mask &= compute_filters_mask(seg.fast, [req.filter])
            if req.vector_filter is not None:
                base_mask &= compute_filters_mask(
                    seg.fast, [req.vector_filter])
            if text_masks is not None:
                tm = text_masks.get(dseg.ord)
                if tm is None:
                    continue
                base_mask &= tm[:seg.doc_count]
            for idx, clause in enumerate(plan.clauses):
                vdata = seg.vectors.get(clause.field)
                if vdata is None or not vdata.present.any():
                    continue
                search_k = min(max(clause.candidate_size, clause.k),
                               seg.doc_count)
                query = np.asarray([clause.vector], dtype=np.float32)
                vf = self.schema.vector_field(clause.field)
                quant = vf.quantization if vf else None
                if mesh is not None:
                    scores, ids = vector_topk_sharded(
                        vdata, base_mask, query, search_k,
                        clause.metric, mesh, quantization=quant)
                else:
                    with dseg.exec_scope():
                        scores, ids = vector_topk(
                            vdata, base_mask, query, search_k,
                            clause.metric, quantization=quant)
                for score, doc in zip(scores[0].tolist(), ids[0].tolist()):
                    if score == -np.inf:
                        continue
                    per_clause[idx][(dseg.ord, int(doc))] = \
                        float(score) * clause.boost
        # global truncation per clause to candidate_size, best-first
        out = []
        for idx, scores_map in enumerate(per_clause):
            cap = plan.clauses[idx].candidate_size
            if cap and len(scores_map) > cap:
                items = sorted(scores_map.items(),
                               key=lambda kv: (-kv[1], kv[0]))[:cap]
                scores_map = dict(items)
            out.append(scores_map)
        return out

    def _merge_vector_hits(self, hits: list[RankedHit], vector_scores,
                           plan: VectorPlan, sort_plan: SortPlan,
                           cursor_key, saw_cursor: list) -> list[RankedHit]:
        """Parity: `api/reader.rs:2464-2538`."""
        bm25_map = {(h.key.segment_ord, h.key.doc_id): h for h in hits}
        candidate_keys = set(bm25_map)
        for scores_map in vector_scores:
            candidate_keys.update(scores_map)
        all_vector_only = all(c.alpha <= 0.0 for c in plan.clauses)
        merged: list[RankedHit] = []
        for key_tuple in candidate_keys:
            seg_ord, doc = key_tuple
            existing = bm25_map.get(key_tuple)
            bm25_score = existing.score if existing else 0.0
            explanation = existing.explanation if existing else None
            final_score, vector_score, has_vector = compute_hybrid_score(
                key_tuple, bm25_score, plan, vector_scores)
            if all_vector_only and not has_vector:
                continue
            if explanation is not None:
                explanation["final_score"] = final_score
            seg = self.segments[seg_ord]
            key = sort_plan.build_key(seg.fast, doc, final_score, seg_ord)
            if cursor_key is not None:
                cmp = key._cmp(cursor_key)
                if cmp == 0:
                    saw_cursor[0] = True
                if cmp <= 0:
                    continue
            merged.append(RankedHit(key=key, score=final_score,
                                    vector_score=vector_score,
                                    explanation=explanation))
        return merged

    def _search_vector_only(self, req, sort_plan: SortPlan, cursor_state,
                            plan: VectorPlan, mesh=None) -> SearchResult:
        """Pure-vector path (parity: `api/reader.rs:2187-2376`)."""
        from searchlite.query.aggs import (
            AggregationPipeline,
            validate_aggregations,
        )

        score_fast_path = (sort_plan.is_score_only()
                           and sort_plan.primary_order() == "desc")
        cursor_key = cursor_state["key"] if cursor_state else None
        cursor_returned = cursor_state["returned"] if cursor_state else 0
        validate_aggregations(self.schema, req.aggs)
        agg_pipeline = (AggregationPipeline(req.aggs, [], self.schema)
                        if req.aggs else None)
        vector_scores = self._collect_vector_maps(plan, req, None,
                                                  mesh=mesh)

        saw_cursor = [cursor_state is None or not req.return_hits]
        total_matches = 0
        hits: list[RankedHit] = []
        agg_results = []
        seg_docs_by_ord: dict[int, set[int]] = {}
        for scores_map in vector_scores:
            for (seg_ord, doc) in scores_map:
                seg_docs_by_ord.setdefault(seg_ord, set()).add(doc)
        for dseg in self.device_segments:
            seg = dseg.reader
            docs = sorted(seg_docs_by_ord.get(dseg.ord, ()))
            matched_for_aggs = []
            for doc in docs:
                key_tuple = (dseg.ord, doc)
                final_score, vector_score, _ = compute_hybrid_score(
                    key_tuple, 0.0, plan, vector_scores)
                if req.return_hits:
                    key = sort_plan.build_key(
                        seg.fast, doc, final_score, dseg.ord)
                    if cursor_key is not None:
                        cmp = key._cmp(cursor_key)
                        if cmp == 0:
                            saw_cursor[0] = True
                        if cmp <= 0:
                            continue
                total_matches += 1
                matched_for_aggs.append(doc)
                if req.return_hits:
                    hits.append(RankedHit(key=key, score=final_score,
                                          vector_score=vector_score))
            if agg_pipeline is not None:
                agg_results.append(agg_pipeline.collect_segment(
                    seg, dseg.ord,
                    np.asarray(matched_for_aggs, dtype=np.int64)))
        if not saw_cursor[0]:
            raise CursorError("stale or invalid cursor for this result set")

        if req.return_hits:
            hits.sort(key=lambda h: _KeyWrap(h.key))

        total_groups = None
        group_inner: list[list[RankedHit]] = []
        if req.return_hits and req.collapse is not None:
            ensure_keyword_fast(self.schema, req.collapse.field, "collapse")
            groups = self._collapse_hits(hits, req.collapse, sort_plan)
            total_groups = len(groups)
            group_inner = [inner for _top, inner in groups]
            hits = [top for top, _inner in groups]

        next_cursor = None
        out_hits: list[Hit] = []
        if req.return_hits:
            if len(hits) > req.limit:
                last = hits[req.limit - 1]
                next_cursor = encode_cursor(
                    self.generation, cursor_returned + req.limit, last.key,
                    sort_plan, score_fast_path)
                hits = hits[:req.limit]
                group_inner = group_inner[:req.limit]
            for i, h in enumerate(hits):
                hit = self._materialize_hit(h, req, [], {})
                if hit is None:
                    continue
                if group_inner and i < len(group_inner) and group_inner[i]:
                    inner_hits = [
                        ih for rh in group_inner[i]
                        if (ih := self._materialize_hit(rh, req, [], {}))
                        is not None
                    ]
                    if inner_hits:
                        hit.inner_hits = inner_hits
                out_hits.append(hit)

        aggregations = {}
        if agg_pipeline is not None:
            aggregations = agg_pipeline.merge_and_finalize(agg_results)
        suggest = self._execute_suggest(req.suggest) if req.suggest else {}
        return SearchResult(
            total_hits_estimate=total_matches + cursor_returned,
            total_groups=total_groups,
            hits=out_hits,
            next_cursor=next_cursor,
            aggregations=aggregations,
            suggest=suggest,
            profile={"execution": {"scored_docs": total_matches,
                                   "candidates_examined": total_matches,
                                   "postings_advanced": 0},
                     "rescore": None,
                     "timings": {}} if req.profile else None,
        )

    # -- batched search --------------------------------------------------------

    def _run_pruned_jobs(self, jobs, compiled, has_scored: bool,
                         need_scores: bool, bmw_block_size=None):
        """Doc-tile pruned single-query execution (ops/tiles.py),
        wave-PIPELINED across segments: wave 1 bounds every tile's
        best-possible score with one small matmul per segment, then at
        most two exact-scoring waves over compacted tile columns — at
        most THREE bulk host<->device round trips for all segments
        combined, matching the dense path's single-fetch discipline.

        Exact — identical top-k to the dense executor (reference
        contract `tests/pruning.rs:44-105`); sound for any
        matcher/filter/phrase because masks only shrink the match set
        and every doc in a scored tile is evaluated with ALL its
        postings.

        ``jobs``: list of (dseg, qargs, phrase_masks, filter_masks,
        col_vals, col_has, root_mask, k). Returns a per-job list of
        (scores [k], docs [k], match_count, postings_touched) or None
        (caller falls back to dense/chunked for that segment)."""
        import jax
        import jax.numpy as jnp

        from searchlite.ops.tiles import get_tile_index

        tile_width = None
        if bmw_block_size:
            tile_width = max(128, -(-int(bmw_block_size) // 128) * 128)
        seed_env = int(os.environ.get("SEARCHLITE_SEED_TILES", 0))

        # --- wave 1: per-tile upper bounds (one launch per segment) ---
        state: list[dict] = []
        for (dseg, qargs, *_masks, _k) in jobs:
            if bool((qargs["w_leaf"] < 0).any()):
                # negative boosts break the upper bound
                state.append({"fallback": True})
                continue
            tl = get_tile_index(dseg, tile_width)
            n_slots = qargs["n_slots"]
            tids = qargs["slot_tids"][:n_slots]
            s_pad = qargs["s_pad"]
            # UB weights = column sums of w_leaf: >= any sum/dis-max
            # (tie_breaker <= 1) expression over non-negative leaves
            wsum = qargs["w_leaf"].sum(axis=0).astype(np.float32)
            nz = np.flatnonzero(wsum > 0)
            w_pad = next_pow2(max(len(nz), 8))
            w_idx = np.arange(w_pad, dtype=np.int32) + s_pad
            w_idx[:len(nz)] = nz
            w_val = np.zeros(w_pad, dtype=np.float32)
            w_val[:len(nz)] = wsum[nz]
            blk_idx, slot_row, _ = tl.ub_block_tables(tids)
            ub_ref = self._ub_scorer()(
                tl.tile_docs, tl.tile_maxes, jnp.asarray(blk_idx),
                jnp.asarray(slot_row), jnp.asarray(w_idx),
                jnp.asarray(w_val),
                n_t1=tl.n_tiles + 1, s_pad=s_pad, n_queries=1)
            state.append({"tl": tl, "tids": tids, "ub_ref": ub_ref})

        ub_vals = iter(jax.device_get(tuple(
            st["ub_ref"] for st in state if "ub_ref" in st)))

        def launch_wave(job, st, tiles):
            """Dispatch one exact-scoring wave as HBM-budgeted chunk
            launches; returns a list of (tiles_chunk, refs, postings),
            or None on int32 overflow (dense/chunked fallback)."""
            dseg, qargs = job[0], job[1]
            phrase_masks, filter_masks, col_vals, col_has, root_mask = \
                job[2:7]
            k = job[7]
            tl = st["tl"]
            s_pad = qargs["s_pad"]
            overflow = []

            def launch_one(chunk):
                chunk = tl.pad_tiles(np.asarray(chunk))
                runs = tl.run_tables(st["tids"], chunk)
                n_cols = runs["n_cols"]
                if s_pad * n_cols + runs["p_pad"] >= 2**31:
                    overflow.append(True)
                    return None
                refs = compiled.tile_executor()(
                    dseg.docs_flat, dseg.impacts_flat,
                    tl.deleted_tiles,
                    jnp.asarray(chunk.astype(np.int32)),
                    jnp.asarray(runs["packed"]),
                    jnp.asarray(qargs["w_leaf"]),
                    jnp.asarray(qargs["leaf_ind"]),
                    jnp.asarray(qargs["group_ind"]),
                    jnp.asarray(tl.gather_cols(phrase_masks, chunk,
                                               False)),
                    jnp.asarray(tl.gather_cols(filter_masks, chunk,
                                               False)),
                    jnp.asarray(tl.gather_cols(col_vals, chunk, 0.0)),
                    jnp.asarray(tl.gather_cols(col_has, chunk, False)),
                    jnp.asarray(tl.gather_cols(root_mask, chunk, False)),
                    k=min(k, n_cols), s_pad=s_pad, n_cols=n_cols,
                    p_pad=runs["p_pad"], fmt=runs["packed_fmt"],
                    has_scored_terms=has_scored, need_scores=need_scores)
                return (chunk, refs, runs["postings"])

            out = []
            for chunk in self._plan_wave_chunks(tl, st["tids"], tiles,
                                                s_pad):
                out.extend(self._launch_chunk_retrying(chunk, launch_one))
                if overflow:
                    return None
            return out

        # --- wave 2: seed tiles (per-query top-C by bound) ---
        for job, st in zip(jobs, state):
            if "ub_ref" not in st:
                continue
            tl = st["tl"]
            k = job[7]
            ub = np.asarray(next(ub_vals))[0, :tl.n_tiles]
            st["ub"] = ub
            seed_c = min(seed_env or max(4, -(-4 * k // tl.T)),
                         tl.n_tiles)
            if seed_c < tl.n_tiles:
                part = np.argpartition(-ub, seed_c - 1)[:seed_c]
            else:
                part = np.arange(tl.n_tiles)
            tiles = np.unique(part[ub[part] > 0.0])
            if len(tiles) == 0:
                st["result"] = (np.full(k, -np.inf, dtype=np.float32),
                                np.zeros(k, dtype=np.int64), 0, 0)
                continue
            launched = launch_wave(job, st, tiles)
            if launched is None:
                st.clear()
                st["fallback"] = True
                continue
            st["wave"] = launched
            st["scored"] = np.zeros(tl.n_tiles, dtype=bool)
            st["scores"] = []
            st["docs"] = []
            st["mc"] = 0
            st["postings"] = 0

        # --- fetch wave 2, compute survivors, wave 3, finalize ---
        for wave_i in range(2):
            flat = [x for st in state if "wave" in st
                    for _t, refs, _p in st["wave"] for x in refs[:3]]
            if not flat:
                break
            vals = iter(jax.device_get(tuple(flat)))
            for job, st in zip(jobs, state):
                if "wave" not in st:
                    continue
                launched = st.pop("wave")
                tl = st["tl"]
                k = job[7]
                for tiles, _refs, postings in launched:
                    ts = np.asarray(next(vals))
                    ti = np.asarray(next(vals))
                    mc = next(vals)
                    st["scores"].append(ts)
                    st["docs"].append(tl.map_ids(tiles, ti))
                    st["mc"] += int(mc)
                    st["postings"] += postings
                    st["scored"][tiles[tiles < tl.n_tiles]] = True
                merged = np.concatenate(st["scores"])
                valid = merged > -np.inf
                theta = (np.partition(merged[valid], -k)[-k]
                         if int(valid.sum()) >= k else -np.inf)
                surv = (st["ub"] >= theta) & (st["ub"] > 0.0) \
                    & ~st["scored"]
                extra = np.flatnonzero(surv)
                if wave_i == 0 and len(extra):
                    launched = launch_wave(job, st, extra)
                    if launched is None:
                        st.clear()
                        st["fallback"] = True
                        continue
                    st["wave"] = launched
                    continue
                # finalize: exact merged top-k
                scores_cat = np.concatenate(st["scores"])
                docs_cat = np.concatenate(st["docs"])
                order = np.lexsort((docs_cat, -scores_cat))[:k]
                out_s = np.full(k, -np.inf, dtype=np.float32)
                out_d = np.zeros(k, dtype=np.int64)
                out_s[:len(order)] = scores_cat[order]
                out_d[:len(order)] = docs_cat[order]
                st["result"] = (out_s, out_d, st["mc"], st["postings"])

        return [st.get("result") for st in state]

    def _search_segment_sharded(self, mesh, dseg, compiled, qargs,
                                phrase_masks, filter_masks, col_vals,
                                col_has, root_mask, k: int,
                                has_scored: bool, need_scores: bool):
        """Execute one segment's full query over a device mesh
        (parallel/query.py): doc-sharded postings, per-chip local M +
        compiled core, collective top-k merge / match-count psum, doc-sharded
        mask outputs reassembled for the host result paths. Returns the
        same tuple shape the dense executor fetch produces:
        (top_scores, top_idx, match_count, final_mask, adjusted,
        text_mask), trimmed to the segment's n1."""
        import jax
        import jax.numpy as jnp

        from searchlite.ops.impact import pow4_bucket
        from searchlite.parallel.query import (
            make_sharded_query_executor,
            pad_doc_axis,
        )

        n_shards = mesh.shape["shard"]
        shards = dseg.doc_shards(n_shards)
        # local doc coords are doc - d*shard_width, always < shard_width
        width = shards["shard_width"]
        n1p = width * n_shards
        n_terms = shards["n_terms"]
        counts = shards["counts"]
        base = shards["posting_base"]

        # per-chip posting slices (uniform pow-4 bucket) — segment-
        # static, so built + uploaded ONCE per (segment, n_shards)
        # and cached on the shards dict (rebuilding them per query
        # copies the segment's whole posting set on the host)
        shard_lo = base[np.arange(n_shards) * n_terms]
        shard_hi = base[(np.arange(n_shards) + 1) * n_terms]
        per = pow4_bucket(int((shard_hi - shard_lo).max()), minimum=1024)
        cached_local = shards.get("padded_local")
        if cached_local is None or cached_local[0] != per:
            docs_local = np.zeros(n_shards * per, dtype=np.int32)
            imps_local = np.zeros(n_shards * per, dtype=np.float32)
            for d in range(n_shards):
                lo, hi = int(shard_lo[d]), int(shard_hi[d])
                docs_local[d * per: d * per + hi - lo] = \
                    shards["docs_sh_np"][lo:hi]
                imps_local[d * per: d * per + hi - lo] = \
                    shards["imps_sh_np"][lo:hi]
            import jax.numpy as _jnp

            cached_local = (per, _jnp.asarray(docs_local),
                            _jnp.asarray(imps_local))
            shards["padded_local"] = cached_local
        docs_local, imps_local = cached_local[1], cached_local[2]

        # per-chip slot tables for this query's slots
        n_slots = qargs["n_slots"]
        tids = qargs["slot_tids"][:n_slots]
        s_pad = qargs["s_pad"]
        slot_start2 = np.zeros((n_shards, s_pad), dtype=np.int32)
        slot_len2 = np.zeros((n_shards, s_pad), dtype=np.int32)
        if n_slots:
            for d in range(n_shards):
                keys = d * n_terms + tids
                slot_start2[d, :n_slots] = (base[keys]
                                            - shard_lo[d]).astype(
                                                np.int32)
                slot_len2[d, :n_slots] = counts[keys]
        p_pad = pow4_bucket(
            max(int(slot_len2.sum(axis=1).max()), 1), minimum=1024)

        deleted = pad_doc_axis(dseg.deleted_np, n1p, True)
        ph = pad_doc_axis(phrase_masks, n1p, False)
        fl = pad_doc_axis(filter_masks, n1p, False)
        cv = pad_doc_axis(col_vals, n1p, 0.0)
        ch = pad_doc_axis(col_has, n1p, False)
        rm = pad_doc_axis(root_mask, n1p, False)

        cache_key = ("sharded", id(mesh), width)
        run = compiled._jit_cache.get(cache_key)
        if run is None:
            run = make_sharded_query_executor(mesh, compiled, width)
            compiled._jit_cache[cache_key] = run

        (ts, ti, mc, fm, adj, tm) = run(
            jnp.asarray(docs_local), jnp.asarray(imps_local),
            jnp.asarray(deleted),
            jnp.asarray(slot_start2), jnp.asarray(slot_len2),
            jnp.asarray(qargs["w_leaf"]), jnp.asarray(qargs["leaf_ind"]),
            jnp.asarray(qargs["group_ind"]),
            jnp.asarray(ph), jnp.asarray(fl),
            jnp.asarray(cv), jnp.asarray(ch), jnp.asarray(rm),
            k=min(k, n1p), p_pad=p_pad, has_scored_terms=has_scored,
            need_scores=need_scores)
        ts, ti, mc, fm, adj, tm = jax.device_get(
            (ts, ti, mc, fm, adj, tm))
        n1 = dseg.n1
        # copies: device_get arrays are read-only; the general result
        # path mutates the mask (cursor skip)
        return (np.asarray(ts), np.asarray(ti), int(mc),
                np.array(fm)[:n1], np.array(adj)[:n1],
                np.array(tm)[:n1])

    def _run_segment_chunked(self, dseg, *args, **kwargs):
        with dseg.exec_scope():
            return self._run_segment_chunked_inner(dseg, *args, **kwargs)

    def _run_segment_chunked_inner(self, dseg, compiled, qargs, phrase_masks,
                                   filter_masks, col_vals, col_has, root_mask,
                                   has_scored: bool, need_scores: bool,
                                   need_text_mask: bool):
        """Exact full execution in tile-column chunks for segments whose
        dense [S, n1] impact matrix would exceed int32 indexing or the
        HBM budget. Every tile is scored (no pruning); the per-column
        mask/adjusted/text outputs are stitched back into doc-space host
        arrays and flow through the general result path. Removes the
        single-query S·n1 wall — corpus size is bounded by host memory,
        not one device allocation."""
        import jax
        import jax.numpy as jnp

        from searchlite.ops.tiles import get_tile_index

        tl = get_tile_index(dseg)
        s_pad = qargs["s_pad"]
        budget = int(os.environ.get(
            "SEARCHLITE_M_BUDGET_BYTES", 2 * 1024**3))
        max_cols = max(min(budget // (max(s_pad, 1) * 4),
                           (2**31 - 1) // (s_pad + 2)), tl.T)
        tiles_per_chunk = max(1, max_cols // tl.T)
        tids = qargs["slot_tids"][:qargs["n_slots"]]
        run_exec = compiled.tile_mask_executor()

        launches = []  # (lo_col, n_real_cols, refs)
        for start in range(0, tl.n_tiles, tiles_per_chunk):
            stop = min(start + tiles_per_chunk, tl.n_tiles)
            tiles = np.arange(start, stop, dtype=np.int64)
            runs = tl.run_tables(tids, tiles)
            n_cols = runs["n_cols"]
            ph2 = tl.gather_cols(phrase_masks, tiles, fill=False)
            fl2 = tl.gather_cols(filter_masks, tiles, fill=False)
            cv2 = tl.gather_cols(col_vals, tiles, fill=0.0)
            ch2 = tl.gather_cols(col_has, tiles, fill=False)
            rm2 = tl.gather_cols(root_mask, tiles, fill=False)
            refs = run_exec(
                dseg.docs_flat, dseg.impacts_flat, tl.deleted_tiles,
                jnp.asarray(tiles.astype(np.int32)),
                jnp.asarray(runs["packed"]),
                jnp.asarray(qargs["w_leaf"]),
                jnp.asarray(qargs["leaf_ind"]),
                jnp.asarray(qargs["group_ind"]),
                jnp.asarray(ph2), jnp.asarray(fl2),
                jnp.asarray(cv2), jnp.asarray(ch2), jnp.asarray(rm2),
                s_pad=s_pad, n_cols=n_cols, p_pad=runs["p_pad"],
                fmt=runs["packed_fmt"],
                has_scored_terms=has_scored, need_scores=need_scores)
            launches.append((start * tl.T, n_cols, refs))

        flat = [x for _lo, _n, refs in launches for x in refs]
        vals = iter(jax.device_get(tuple(flat)))
        n1 = dseg.n1
        mask_np = np.zeros(n1, dtype=bool)
        adjusted_np = np.zeros(n1, dtype=np.float32)
        text_np = np.zeros(n1, dtype=bool) if need_text_mask else None
        for lo, n_cols, _refs in launches:
            fm = np.asarray(next(vals))
            adj = np.asarray(next(vals))
            tm = np.asarray(next(vals))
            hi = min(lo + n_cols, n1)
            span = hi - lo
            mask_np[lo:hi] = fm[:span]
            adjusted_np[lo:hi] = adj[:span]
            if text_np is not None:
                text_np[lo:hi] = tm[:span]
        return mask_np, adjusted_np, text_np

    def search_batch(self, queries: list[str], limit: int = 10,
                     fields: Optional[list[str]] = None,
                     execution: str = "bm25",
                     filters: Optional[list] = None,
                     limits: Optional[list[int]] = None,
                     mesh=None
                     ) -> list[list[tuple[str, float]]]:
        """Score a batch of query strings in one device launch per
        segment (the data-parallel axis of the engine). Supports plain term queries (OR semantics, summed
        BM25) — the common search workload. Returns per query a list of
        ``(doc_id, score)`` pairs, exact top-``limit``, ordered like the
        single-query path (score desc, doc asc).

        ``execution``: ``bm25`` scores every posting densely;
        ``wand``/``bmw`` run the doc-tile pruned execution
        (ops/tiles.py) — identical results, fewer postings touched.

        Structured per-query knobs (reference surface
        `api/types.rs:395-520`, the subset that batches):

        - ``filters``: per-query Filter JSON (or None), aligned with
          ``queries``. Distinct filters are deduplicated into one mask
          table per segment; scoring applies each query's mask row.
          Results match the single-query path with the same ``filter``.
        - ``limits``: per-query result sizes (default ``limit``).

        Queries containing phrases/negations should use :meth:`search`.
        """
        return self.search_batch_many(
            [queries], limit=limit, fields=fields, execution=execution,
            filters=None if filters is None else [filters],
            limits=None if limits is None else [limits],
            mesh=mesh)[0]

    def _analyze_batches(self, batches, fields):
        """Parse + analyze query strings into per-query (field, token)
        pairs; analysis memoized per (field, raw-term) across ALL
        batches — workloads repeat terms heavily."""
        from searchlite.query.parser import parse_query

        # analyzer output is deterministic per (field, raw term) for a
        # fixed schema, so the memo lives on the reader and persists
        # across calls — repeated terms (the common serving case) skip
        # the tokenizer/stemmer chain entirely
        token_cache = getattr(self, "_token_cache", None)
        if token_cache is None:
            token_cache = self._token_cache = {}

        def term_pairs(field: str, raw_term: str):
            key = (field, raw_term)
            hit = token_cache.get(key)
            if hit is None:
                kind = self.schema.field_kind(field)
                if kind == "keyword":
                    hit = [(field, raw_term.lower())]
                else:
                    analyzer = self.analysis.search_analyzer(field)
                    hit = ([] if analyzer is None else
                           [(field, tok.text)
                            for tok in analyzer.analyze(raw_term)])
                token_cache[key] = hit
            return hit

        out = []
        for queries in batches:
            analyzed: list[list[tuple[str, str]]] = []
            for raw in queries:
                pairs: list[tuple[str, str]] = []
                if '"' not in raw and ":" not in raw and "-" not in raw:
                    # plain term query: token split IS the parse (no
                    # phrases/negations/field prefixes possible), skip
                    # the dataclass-building parser on the hot path
                    for tok in raw.split():
                        for field in fields:
                            pairs.extend(term_pairs(field, tok))
                    analyzed.append(pairs)
                    continue
                parsed = parse_query(raw)
                for term in parsed.terms:
                    term_fields = ([term.field] if term.field is not None
                                   else fields)
                    for field in term_fields:
                        pairs.extend(term_pairs(field, term.term))
                analyzed.append(pairs)
            out.append(analyzed)
        return out

    def _batch_filter_tables(self, batches, filters):
        """Validate + deduplicate per-query filters for a batch stream.
        Returns per batch (fidx [Q] int32, distinct [Filter, ...]) or
        (None, None) when the batch has no filters; fidx 0 = no filter
        (row 0 of the per-segment mask table is all-true)."""
        out = []
        if filters is None:
            return [(None, None)] * len(batches)
        if len(filters) != len(batches):
            raise QueryError("filters must align with batches")
        for queries, batch_filters in zip(batches, filters):
            if batch_filters is None:
                out.append((None, None))
                continue
            if len(batch_filters) != len(queries):
                raise QueryError("filters must align with queries")
            distinct: list = []
            by_key: dict[str, int] = {}
            fidx = np.zeros(len(queries), dtype=np.int32)
            for i, f in enumerate(batch_filters):
                if f is None:
                    continue
                fobj = Filter.from_json(f)
                validate_filter(self.schema, fobj)
                key = json.dumps(fobj.to_json(), sort_keys=True)
                fid = by_key.get(key)
                if fid is None:
                    distinct.append(fobj)
                    fid = len(distinct)  # 1-based; 0 = match-all
                    by_key[key] = fid
                fidx[i] = fid
            if not distinct:
                out.append((None, None))
            else:
                out.append((fidx, distinct))
        return out

    def _segment_filter_rows_np(self, dseg, distinct) -> np.ndarray:
        """[F+1, n1] bool mask table for one segment: row 0 all-true,
        rows 1..F the distinct filters. Cached per (segment, filters)."""
        seg = dseg.reader
        key = tuple(json.dumps(f.to_json(), sort_keys=True)
                    for f in distinct)
        cached = getattr(dseg, "_filter_rows_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        rows = np.zeros((len(distinct) + 1, dseg.n1), dtype=bool)
        rows[0, :seg.doc_count] = True
        for i, fobj in enumerate(distinct):
            rows[i + 1, :seg.doc_count] = compute_filters_mask(
                seg.fast, [fobj])
        dseg._filter_rows_cache = (key, rows)
        return rows

    def _segment_filter_rows(self, dseg, distinct):
        import jax.numpy as jnp

        rows = self._segment_filter_rows_np(dseg, distinct)
        key = tuple(json.dumps(f.to_json(), sort_keys=True)
                    for f in distinct)
        cached = getattr(dseg, "_filter_rows_dev_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        rows_dev = jnp.asarray(rows)
        dseg._filter_rows_dev_cache = (key, rows_dev)
        return rows_dev

    def search_batch_many(self, batches: list[list[str]], limit: int = 10,
                          fields: Optional[list[str]] = None,
                          execution: str = "bm25",
                          filters: Optional[list] = None,
                          limits: Optional[list] = None,
                          output: str = "pairs",
                          mesh=None
                          ) -> list:
        """Pipelined form of :meth:`search_batch` for a stream of
        batches: every batch's device work is dispatched asynchronously
        before ANY result is fetched, so host prep, device compute, and
        the host<->device round trip all overlap across batches (the
        sustained-throughput serving pattern). Results are identical to
        calling ``search_batch`` per batch. ``filters``/``limits`` are
        per-batch lists aligned with ``batches``.

        ``output="pairs"`` (default) returns per batch a list of
        ``(doc_id, score)`` lists. ``output="arrays"`` returns per
        batch ``(scores [Q,k] f32, doc_ords [Q,k] i32, seg_ords [Q,k]
        i32)`` numpy arrays — rows are (score desc, (seg, doc) asc),
        entries past a row's match count hold -inf scores; map ords to
        doc-id strings via ``reader.segments[seg].doc_ids[ord]``. The
        arrays form skips per-hit Python object materialization (the
        reference engine's benches likewise return raw doc addresses,
        `searchlite-core/benches/end_to_end.rs`)."""
        import jax
        import jax.numpy as jnp

        from searchlite.ops.impact import build_impact_batch

        if limit <= 0:
            raise QueryError("limit must be > 0")
        if execution not in ("bm25", "wand", "bmw"):
            raise QueryError(f"unknown execution strategy `{execution}`")
        if output not in ("pairs", "arrays"):
            raise QueryError(f"unknown output form `{output}`")
        if fields is None:
            fields = [f.name for f in self.schema.text_fields]
        limits = self._check_batch_limits(batches, limit, limits)
        filter_tables = self._batch_filter_tables(batches, filters)
        # Micro-batch coalescing: a stream of narrow filterless batches
        # pays its per-batch FIXED cost (native prep + table build +
        # launch submission over the link) once per batch — measured
        # ~19 ms/batch at 100k docs vs a 5.5 us/query marginal rate, so
        # a b1024 stream loses to its own b4096 re-chunk 2.4x on
        # identical queries. Re-chunk consecutive batches into
        # <=SEARCHLITE_BATCH_COALESCE-query launches and split the
        # outputs back: per-query rows are independent, so each batch
        # gets its exact top-k (scores differ only by f32 summation-
        # order ulps from the wider padded shapes — divergence D10;
        # bench.py's oracle gate covers the wide buckets). Per-batch
        # filters or mesh execution keep their own launches; per-query
        # `limits` concatenate losslessly.
        coalesce = int(os.environ.get("SEARCHLITE_BATCH_COALESCE",
                                      "4096"))
        if (mesh is None and coalesce > 0 and len(batches) > 1
                and all(f[0] is None for f in filter_tables)
                and max(len(b) for b in batches) <= coalesce // 2):
            groups: list[tuple[int, int]] = []
            start, total = 0, 0
            for i, b in enumerate(batches):
                if total and total + len(b) > coalesce:
                    groups.append((start, i))
                    start, total = i, 0
                total += len(b)
            groups.append((start, len(batches)))
            if len(groups) < len(batches):
                merged = [[q for b in batches[s:e] for q in b]
                          for s, e in groups]
                merged_limits = [np.concatenate(limits[s:e])
                                 for s, e in groups]
                outs = self.search_batch_many(
                    merged, limit=limit, fields=fields,
                    execution=execution, limits=merged_limits,
                    output=output)
                split: list = []
                for (s, e), gout in zip(groups, outs):
                    row = 0
                    for bi, b in enumerate(batches[s:e], start=s):
                        if output == "arrays":
                            sc, di, sg = gout
                            # column count matches the un-coalesced
                            # path: this batch's own max limit (the
                            # group's k is the max over the group)
                            kb = (int(limits[bi].max())
                                  if len(limits[bi]) else limit)
                            kb = min(kb, sc.shape[1])
                            split.append(
                                (sc[row:row + len(b), :kb],
                                 di[row:row + len(b), :kb],
                                 sg[row:row + len(b), :kb]))
                        else:
                            split.append(gout[row:row + len(b)])
                        row += len(b)
                return split
        if mesh is not None \
                and not any(f[0] is not None for f in filter_tables):
            # doc-sharded execution over the mesh: every strategy
            # returns exact top-k, so wand/bmw ride the same sharded
            # candidate path (per-chip postings shrink 1/D — MORE rows
            # prune, not fewer). Filtered batches keep the single-chip
            # path below (per-query mask rows are doc-axis-global).
            return self._retry_oom(
                lambda: self._search_batch_mesh_many(
                    batches, limit, fields, limits, output, mesh))
        if execution in ("wand", "bmw"):
            # per-query pruning is the default batched pruned path
            # (union waves degrade to a dense scan on Zipf batches);
            # filtered batches keep the union path, whose run scorer
            # applies per-query filter rows
            mode = os.environ.get("SEARCHLITE_BATCH_PRUNE", "auto")
            has_filters = any(f[0] is not None for f in filter_tables)
            # at multi-M-doc corpora the pq path's per-wave run-table
            # uploads and weak Zipf-batch pruning lose badly to the
            # candidate-strip route (measured 17 vs ~1000s of QPS at
            # 5M) — wand/bmw are execution HINTS with identical exact
            # top-k, so route them through the strip/dense scorer
            # below, like the mesh path already does. =pq pins the
            # tile path regardless of the corpus size.
            strip_min = int(os.environ.get(
                "SEARCHLITE_BATCH_STRIP_MIN_DOCS", "2000000"))
            live = [d for d in self.device_segments
                    if d.reader.doc_count > 0]
            strip_route = (mode == "auto" and not has_filters and live
                           and all(d.n1 >= strip_min for d in live))
            if not strip_route:
                if mode != "union" and not has_filters:
                    return self._retry_oom(
                        lambda: self._search_batch_pruned_pq(
                            batches, limit, fields, limits,
                            output=output))
                return self._retry_oom(
                    lambda: self._search_batch_pruned_many(
                        batches, limit, fields, filter_tables, limits,
                        output=output))

        # memory budget for the dense M + score matrices on one chip;
        # past it, loop host-defined doc shards
        m_budget_bytes = int(os.environ.get(
            "SEARCHLITE_M_BUDGET_BYTES", 2 * 1024**3))

        # phase 1 — per batch: analyze, build args, dispatch all
        # segments. The native prep (C++ tokenize + dictionary lookup,
        # ops/impact.py::build_impact_batch_native) handles plain term
        # batches in one call; anything it rejects falls back to the
        # Python analyze + build path, computed lazily on first need.
        from searchlite.ops.impact import build_impact_batch_native

        # opt-in host-phase accounting (SEARCHLITE_HOST_PROFILE=1):
        # wall time per phase accumulated on the reader — the device
        # overlaps all of it, so these bound the pipelined throughput
        prof = None
        if os.environ.get("SEARCHLITE_HOST_PROFILE"):
            prof = getattr(self, "_host_profile", None)
            if prof is None:
                prof = self._host_profile = {
                    "prep": 0.0, "dispatch": 0.0, "fetch": 0.0,
                    "fallback": 0.0, "merge": 0.0, "batches": 0}
            prof["batches"] += len(batches)

        analyzed_all = None
        launches = []  # per batch: list of (seg_ord, scores, ids)
        pending_recs = []  # term-split soundness checks (+ bi/li)
        for bi, (queries, (fidx, distinct), blimits) in enumerate(
                zip(batches, filter_tables, limits)):
            k_batch = int(max(blimits)) if len(blimits) else limit
            launched: list[tuple[int, Any, Any]] = []
            for dseg in self.device_segments:
                seg = dseg.reader
                if seg.doc_count == 0:
                    continue
                if prof is not None:
                    t_prep = time.perf_counter()
                qb = build_impact_batch_native(
                    seg, dseg, queries, fields, self.analysis,
                    self.schema, lazy_tables=True)
                if qb is None:
                    if analyzed_all is None:
                        analyzed_all = self._analyze_batches(
                            batches, fields)
                    qb = build_impact_batch(seg, dseg, analyzed_all[bi],
                                            lazy_tables=True)
                if prof is not None:
                    t_disp = time.perf_counter()
                    prof["prep"] += t_disp - t_prep
                s_pad = qb["s_pad"]
                est_bytes = (s_pad + len(queries)) * dseg.n1 * 4
                pend: list = []
                if (est_bytes <= m_budget_bytes
                        and qb["flat_extent"] < FLAT_INDEX_LIMIT):
                    k = min(k_batch, dseg.n1)
                    scores, ids = self._launch_batch_segment(
                        dseg, qb, k, fidx, distinct, pending=pend)
                else:
                    # oversized corpus: the sparse candidate scorer
                    # needs no doc-axis matrix at ALL, so it routes
                    # around the shard loop entirely; only the heavy
                    # remainder pays the sharded dense scan
                    scores = ids = None
                    if fidx is None:
                        out = self._try_sparse_candidates(
                            dseg, qb, min(k_batch, dseg.n1),
                            shard_budget=m_budget_bytes,
                            pending=pend)
                        if out is not None:
                            scores, ids = out
                    if scores is None:
                        pend = []
                        scores, ids = self._search_batch_sharded(
                            dseg, None, qb, k_batch, est_bytes,
                            m_budget_bytes, fidx, distinct)
                for rec in pend:
                    rec["bi"] = bi
                    rec["li"] = len(launched)
                    pending_recs.append(rec)
                launched.append((dseg.ord, scores, ids))
                if prof is not None:
                    prof["dispatch"] += time.perf_counter() - t_disp
            launches.append(launched)

        # phase 2 — ONE bulk fetch for every batch and segment (the
        # term-split soundness flags ride the same fetch)
        if prof is not None:
            t_fetch = time.perf_counter()
        flat_refs = [x for launched in launches
                     for _ord, scores, ids in launched
                     for x in (scores, ids)]
        n_main = len(flat_refs)
        flat_refs += [rec["sound"] for rec in pending_recs]
        flat_vals = list(jax.device_get(tuple(flat_refs)))
        if prof is not None:
            t_fb = time.perf_counter()
            prof["fetch"] += t_fb - t_fetch
        if pending_recs:
            self._apply_split_fallbacks(
                launches, flat_vals, n_main, pending_recs)
            del flat_vals[n_main:]
        if prof is not None:
            t_merge = time.perf_counter()
            prof["fallback"] += t_merge - t_fb

        # phase 3 — host merge per batch
        out: list = []
        cursor = 0
        for queries, launched, blimits in zip(batches, launches, limits):
            per_segment = []
            for seg_ord, _s, _i in launched:
                per_segment.append((seg_ord,
                                    np.asarray(flat_vals[cursor]),
                                    np.asarray(flat_vals[cursor + 1])))
                cursor += 2
            out.append(self._merge_batch_output(
                queries, per_segment, blimits, output, limit))
        if prof is not None:
            prof["merge"] += time.perf_counter() - t_merge
        return out

    def _merge_batch_output(self, queries, per_segment, blimits,
                            output: str, limit: int):
        """One batch's per-segment (seg_ord, scores, ids) -> the
        requested result surface; handles the no-live-segments case
        (empty index) for both forms."""
        if output == "arrays":
            if not per_segment:
                k = int(blimits.max()) if len(blimits) else limit
                q = len(queries)
                return (np.full((q, k), -np.inf, dtype=np.float32),
                        np.zeros((q, k), dtype=np.int32),
                        np.zeros((q, k), dtype=np.int32))
            return self._merge_batch_arrays(per_segment, blimits)
        if not per_segment:
            return [[] for _ in queries]
        return self._merge_batch_results(queries, per_segment, blimits)

    def _merge_batch_arrays(self, per_segment, limits):
        """Merge per-segment top-k (scores, ids) into batch-order
        (scores, doc_ords, seg_ords) arrays — (score desc, (seg, doc)
        asc), -inf past each row's match count / per-query limit. One
        lexsort, no per-hit Python objects."""
        if len(per_segment) == 1:
            seg_ord, scores, ids = per_segment[0]
            scores = scores.astype(np.float32, copy=True)
            ids = ids.astype(np.int32, copy=False)
            seg_arr = np.full(ids.shape, seg_ord, dtype=np.int32)
        else:
            scores = np.concatenate(
                [s for _o, s, _i in per_segment], axis=1).astype(
                    np.float32)
            ids = np.concatenate(
                [i for _o, _s, i in per_segment], axis=1).astype(
                    np.int32)
            seg_arr = np.concatenate(
                [np.full(i.shape, o, dtype=np.int32)
                 for o, _s, i in per_segment], axis=1)
            order = np.lexsort((ids, seg_arr, -scores), axis=-1)
            k = min(scores.shape[1],
                    int(limits.max()) if len(limits) else
                    scores.shape[1])
            order = order[:, :k]
            scores = np.take_along_axis(scores, order, axis=1)
            ids = np.take_along_axis(ids, order, axis=1)
            seg_arr = np.take_along_axis(seg_arr, order, axis=1)
        col = np.arange(scores.shape[1])
        scores[col[None, :] >= np.asarray(limits)[:, None]] = -np.inf
        return scores, ids, seg_arr

    def _mesh_batch_scorer(self, mesh):
        """Process-wide cache of the jitted sharded batch scorer per
        mesh — rebuilt wrappers recompile every shape bucket on every
        call (the round-3 pq-path recompile-pollution lesson)."""
        from searchlite.parallel.query import (
            make_sharded_batch_scorer,
        )

        key = ("mesh_batch", id(mesh),
               tuple(sorted(mesh.shape.items())))
        with _GLOBAL_LOCK:
            run = _GLOBAL_SCORERS.get(key)
            if run is None:
                run = make_sharded_batch_scorer(mesh)
                _GLOBAL_SCORERS[key] = run
        return run

    def _launch_batch_mesh_segment(self, mesh, dseg, qb, k: int,
                                   cap: int):
        """Dispatch one segment's batched scoring doc-sharded over the
        mesh. Rows light on their WORST shard (per-shard strip blocks
        <= ``cap``; per-chip postings shrink ~1/D, so sharding admits
        MORE rows than the single-chip cap) ride the sharded candidate
        scorer — one replicated packed-table upload, local strips, collective
        top-k merge. The remainder runs doc-sharded dense scoring
        (per-chip M, ``_launch_heavy_mesh``), falling back to the
        single-chip dense scorers when that path's guards reject it.
        Returns the async launch record; the caller bulk-fetches."""
        import jax.numpy as jnp

        from searchlite.ops.impact import (
            csr_row_lengths,
            pow15_bucket,
            subset_impact_batch,
        )
        from searchlite.ops.sparse import (
            _emit_packed_rows,
            _packed_applies,
        )

        from searchlite.ops.sparse import tier_bounds

        n_shards = mesh.shape["shard"]
        nq = qb["n_queries"]
        light_idx = np.zeros(0, dtype=np.int64)
        heavy_idx = np.arange(nq, dtype=np.int64)
        tiers = []          # (row ordinals into batch order, ts, td)
        if (cap > 0 and k <= 1024 and qb["n_slots"] > 0
                and _packed_applies(qb)):
            mt = dseg.mesh_sparse_tables(n_shards)
            bl2 = mt["blocks"].reshape(n_shards, -1)    # [D, n_terms]
            ent_tids = qb["slot_tids"][qb["qs_slot"]]
            counts = csr_row_lengths(qb)
            row_of = np.repeat(np.arange(nq, dtype=np.int64), counts)
            per = bl2[:, ent_tids]                       # [D, E]
            rows = np.zeros(n_shards * nq, dtype=np.int64)
            if per.size:
                idx2 = (np.arange(n_shards, dtype=np.int64)[:, None]
                        * nq + row_of[None, :]).ravel()
                np.add.at(rows, idx2, per.ravel())
            row_max = rows.reshape(n_shards, nq).max(axis=0)
            sel = row_max <= cap
            light_idx = np.flatnonzero(sel)
            heavy_idx = np.flatnonzero(~sel)
            # pow-4 tiers by WORST-shard strip width (one launch per
            # occupied tier), so a single wide row can't inflate every
            # other row's candidate strip — the mesh twin of
            # partition_sparse_batch_tiered
            run = self._mesh_batch_scorer(mesh) if len(light_idx) \
                else None
            nblk_min = -(-k // 128)
            prev = -1
            for bound in tier_bounds(cap):
                t_sel = ((row_max[light_idx] > prev)
                         & (row_max[light_idx] <= bound))
                prev = bound
                if not t_sel.any():
                    continue
                t_rows = light_idx[t_sel]
                g = _emit_packed_rows(qb, t_rows, dseg.idf32,
                                      bl_min=16)
                nblk = pow15_bucket(
                    max(int(row_max[t_rows].max()), nblk_min, 1),
                    minimum=16)
                ts, td = run(
                    mt["block_docs"], mt["block_impacts"],
                    mt["tid_tbl"], jnp.asarray(g["packed"]),
                    jnp.asarray(g["ovr"]), mt["sent"],
                    k=k, t_pad=g["t_pad"], nblk=nblk,
                    log2_run=g["log2_run"], n_ovr=g["n_ovr"])
                tiers.append((t_rows, ts, td))
        heavy = None
        if len(heavy_idx):
            hqb = (qb if len(heavy_idx) == nq
                   else subset_impact_batch(qb, heavy_idx))
            heavy = self._launch_heavy_mesh(mesh, dseg, hqb, k)
            if heavy is None:
                # single-chip fallback with the SAME size routing the
                # non-mesh caller performs: oversized segments loop
                # host doc shards instead of building one giant M
                budget = int(os.environ.get(
                    "SEARCHLITE_M_BUDGET_BYTES", 2 * 1024**3))
                est_h = (hqb["s_pad"] + hqb["n_queries"]) \
                    * dseg.n1 * 4
                if (est_h <= budget
                        and hqb["flat_extent"] < FLAT_INDEX_LIMIT):
                    heavy = self._launch_batch_segment(
                        dseg, hqb, k, allow_sparse=False)
                else:
                    heavy = self._search_batch_sharded(
                        dseg, None, hqb, k, est_h, budget)
        return {"tiers": tiers, "heavy": heavy,
                "heavy_idx": heavy_idx, "nq": nq, "k": k}

    def _launch_heavy_mesh(self, mesh, dseg, hqb, k: int):
        """Dispatch the heavy (head-term) remainder of a mesh batch
        doc-sharded: per-shard block tables expanded from the
        segment's mesh layout feed
        parallel/query.py::make_sharded_dense_batch_scorer (per-chip
        M over 1/D of the doc axis + the same W@M matmul). Returns
        None when the path doesn't apply (caller falls back to the
        single-chip dense scorers): SEARCHLITE_MESH_DENSE=0, or a
        per-chip M that would exceed int32 indexing."""
        import jax.numpy as jnp

        from searchlite.ops.impact import (
            ensure_dense_tables,
            pow2_bucket,
        )

        if os.environ.get("SEARCHLITE_MESH_DENSE", "1") == "0":
            return None
        n_shards = mesh.shape["shard"]
        mt = dseg.mesh_sparse_tables(n_shards)
        ensure_dense_tables(hqb)
        s_pad = hqb["s_pad"]
        width = mt["width"]
        if s_pad * (width + 1) >= FLAT_INDEX_LIMIT:
            return None
        n_slots = hqb["n_slots"]
        tids = hqb["slot_tids"][:n_slots]
        bl2 = mt["blocks"].reshape(n_shards, -1)
        st2 = mt["local_start_np"]
        cnt = bl2[:, tids]                       # [D, n_slots]
        start = st2[:, tids]
        nb = cnt.sum(axis=1)
        nb_pad = pow2_bucket(max(int(nb.max()), 1), minimum=64)
        sent = mt["bp"] - 1
        blk_idx = np.full((n_shards, nb_pad), sent, dtype=np.int32)
        slot_row = np.zeros((n_shards, nb_pad), dtype=np.int32)
        for d in range(n_shards):
            c = cnt[d]
            total = int(nb[d])
            if not total:
                continue
            slot_of = np.repeat(
                np.arange(n_slots, dtype=np.int64), c)
            begin = np.concatenate([[0], np.cumsum(c)[:-1]])
            blk = (np.repeat(start[d] - begin, c)
                   + np.arange(total, dtype=np.int64))
            blk_idx[d, :total] = blk
            slot_row[d, :total] = slot_of
        precision = os.environ.get("SEARCHLITE_PRECISION", "f32")
        key = ("mesh_dense", id(mesh),
               tuple(sorted(mesh.shape.items())), precision)
        with _GLOBAL_LOCK:
            run = _GLOBAL_SCORERS.get(key)
            if run is None:
                from searchlite.parallel.query import (
                    make_sharded_dense_batch_scorer,
                )

                run = make_sharded_dense_batch_scorer(mesh, precision)
                _GLOBAL_SCORERS[key] = run
        return run(
            mt["block_docs"], mt["block_impacts"],
            jnp.asarray(blk_idx), jnp.asarray(slot_row),
            jnp.asarray(hqb["w_idx"]), jnp.asarray(hqb["w_val"]),
            k=k, s_pad=s_pad, n_queries=hqb["n_queries"],
            width=width)

    def _search_batch_mesh_many(self, batches, limit: int, fields,
                                limits, output: str, mesh):
        """Pipelined batch-stream execution doc-sharded over a device
        mesh (``search_batch_many(mesh=)``): phase 1 dispatches every
        batch's per-segment mesh + remainder launches asynchronously,
        phase 2 is ONE bulk fetch, phase 3 stitches rows back into
        batch order on host and merges segments exactly like the
        single-chip path (same (score desc, (seg, doc) asc) contract —
        ``parallel/query.py::make_sharded_batch_scorer`` preserves it
        across chips). Results match the single-chip batch API."""
        import jax

        cap = int(os.environ.get("SEARCHLITE_SPARSE_MAX_BLOCKS", "32"))
        analyzed_box = [None]
        launches = []          # per batch: list of (seg_ord, entry)
        for bi, (queries, blimits) in enumerate(zip(batches, limits)):
            k_batch = int(max(blimits)) if len(blimits) else limit
            launched = []
            for dseg in self.device_segments:
                seg = dseg.reader
                if seg.doc_count == 0:
                    continue
                qb = self._qb_lazy_native(seg, dseg, batches, bi,
                                          fields, analyzed_box)
                entry = self._launch_batch_mesh_segment(
                    mesh, dseg, qb, min(k_batch, dseg.n1), cap)
                launched.append((dseg.ord, entry))
            launches.append(launched)

        refs = []
        for launched in launches:
            for _ord, e in launched:
                for _rows, ts, td in e["tiers"]:
                    refs.extend((ts, td))
                if e["heavy"] is not None:
                    refs.extend(e["heavy"])
        vals = iter(jax.device_get(tuple(refs)))

        out = []
        for queries, launched, blimits in zip(batches, launches,
                                              limits):
            per_segment = []
            for seg_ord, e in launched:
                nq, k = e["nq"], e["k"]
                scores = np.full((nq, k), -np.inf, dtype=np.float32)
                ids = np.zeros((nq, k), dtype=np.int32)
                for rows, _ts, _td in e["tiers"]:
                    ls = np.asarray(next(vals))
                    li = np.asarray(next(vals))
                    n = len(rows)
                    scores[rows] = ls[:n]
                    ids[rows] = li[:n]
                if e["heavy"] is not None:
                    hs = np.asarray(next(vals))
                    hi = np.asarray(next(vals))
                    n = len(e["heavy_idx"])
                    scores[e["heavy_idx"]] = hs[:n]
                    ids[e["heavy_idx"]] = hi[:n]
                per_segment.append((seg_ord, scores, ids))
            out.append(self._merge_batch_output(
                queries, per_segment, blimits, output, limit))
        return out

    def _check_batch_limits(self, batches, limit: int, limits):
        """Normalize per-query limits: one int array per batch."""
        if limits is None:
            return [np.full(len(qs), limit, dtype=np.int64)
                    for qs in batches]
        if len(limits) != len(batches):
            raise QueryError("limits must align with batches")
        out = []
        for qs, bl in zip(batches, limits):
            if bl is None:
                out.append(np.full(len(qs), limit, dtype=np.int64))
                continue
            if len(bl) != len(qs):
                raise QueryError("limits must align with queries")
            arr = np.asarray(bl, dtype=np.int64)
            if len(arr) and arr.min() <= 0:
                raise QueryError("every limit must be > 0")
            out.append(arr)
        return out

    def _merge_batch_results(self, queries, per_segment, limits):
        if isinstance(limits, int):
            limits = np.full(len(queries), limits, dtype=np.int64)
        results: list[list[tuple[str, float]]] = []
        if len(per_segment) == 1:
            # single-segment fast path: top_k output is already in the
            # merge order (score desc, doc asc — lowest-index-first ties)
            seg_ord, scores, ids = per_segment[0]
            seg = self.segments[seg_ord]
            dids_arr = getattr(seg, "_doc_ids_obj_arr", None)
            if dids_arr is None or len(dids_arr) != len(seg.doc_ids):
                dids_arr = np.asarray(seg.doc_ids, dtype=object)
                seg._doc_ids_obj_arr = dids_arr
            scores = np.ascontiguousarray(np.asarray(scores),
                                          dtype=np.float32)
            ids = np.asarray(ids)
            # top_k output is score-descending with -inf (non-matches)
            # last, so the valid entries of each row are a prefix
            take = np.minimum((scores != -np.inf).sum(axis=1),
                              limits).astype(np.int64)
            # pad entries (past each row's valid prefix) may carry the
            # sentinel doc ord — clip before the gather, they're never
            # read
            docstrs = dids_arr[np.minimum(ids, len(dids_arr) - 1)]
            return self._materialize_pairs(docstrs, scores, take)

        scores, ids, seg_arr = self._merge_batch_arrays(
            per_segment, limits)
        # doc-id strings per merged cell, gathered one segment at a time
        docstrs = np.empty(ids.shape, dtype=object)
        for seg_ord, _s, _i in per_segment:
            seg = self.segments[seg_ord]
            dids_arr = getattr(seg, "_doc_ids_obj_arr", None)
            if dids_arr is None or len(dids_arr) != len(seg.doc_ids):
                dids_arr = np.asarray(seg.doc_ids, dtype=object)
                seg._doc_ids_obj_arr = dids_arr
            mask = seg_arr == seg_ord
            docstrs[mask] = dids_arr[
                np.minimum(ids[mask], len(dids_arr) - 1)]
        take = (scores != -np.inf).sum(axis=1).astype(np.int64)
        return self._materialize_pairs(docstrs, scores, take)

    @staticmethod
    def _materialize_pairs(docstrs, scores, take):
        """[Q, k] (doc-id object array, f32 scores) + per-row take
        counts -> list of [(doc_id, score), ...]. The C extension
        (native/slt_results.c) builds the tuples ~10x faster than
        bytecode; the Python loop below is the behavioral spec."""
        from searchlite.native import get_results_mod

        mod = get_results_mod()
        if mod is not None:
            # the extension requires C-contiguous buffers; device
            # fetches can hand us strided views (no-op when already
            # contiguous)
            return mod.build(
                np.ascontiguousarray(docstrs),
                np.ascontiguousarray(scores, dtype=np.float32),
                np.ascontiguousarray(take, dtype=np.int64))
        results = []
        scores_l = scores.tolist()
        for n, drow, srow in zip(take.tolist(), docstrs, scores_l):
            n = int(n)
            results.append(list(zip(drow[:n].tolist(), srow[:n])))
        return results

    # -- doc-tile pruned batch execution (real WAND/BMW) ------------------

    def _search_batch_pruned_pq(self, batches, limit: int, fields,
                                limits=None, output: str = "pairs"):
        """PER-QUERY doc-tile pruned batch execution. The union-wave
        path below scores the union of all queries' candidate tiles —
        on Zipf batches that union covers the corpus and pruning
        degrades to a dense scan (measured: 14 QPS vs 143 dense at 5M
        docs, round 2). Here every query keeps a PRIVATE candidate
        space: its top-C tiles by upper bound, scored in a compacted
        [Q·tpq, C·T] matrix built from per-(query, term, tile) posting
        runs (TileIndex.run_tables_per_query — ~1 MB of run tables per
        wave, one packed [3, r_pad] upload, where the union path
        shipped ~64 MB), then survivor
        rounds until no tile with UB ≥ that query's threshold remains
        unprocessed. Per-query exactness argument is tiles.py's,
        applied per query row; fuzzed in tests/test_pruning.py.

        Device-side: seed selection (top-C by UB), threshold + running
        top-k merge, and doc-id mapping all stay on device — the host
        only sees [Q, C] tile ids per wave (the [Q, n_tiles] UB matrix
        never crosses the link). Waves are pipelined across all
        (batch, segment) work items: one bulk fetch per wave round."""
        import jax
        import jax.numpy as jnp

        from searchlite.ops.tiles import get_tile_index

        if limits is None:
            limits = [np.full(len(qs), limit, dtype=np.int64)
                      for qs in batches]
        ub_scorer = self._ub_scorer()
        selector = self._pq_seed_selector()
        scorer = self._pq_run_scorer()
        merger = self._pq_topk_merge()
        analyzed_box = [None]  # Python analysis only if native rejects

        class _Item:
            __slots__ = ("bi", "dseg", "tl", "qb", "ub", "q_tids",
                         "w_b", "tpq_pad", "k", "lims", "processed",
                         "theta", "run_s", "run_d", "rounds", "done",
                         "sparse", "hmap")

        sparse_cap = int(os.environ.get(
            "SEARCHLITE_WAND_SPARSE_BLOCKS",
            os.environ.get("SEARCHLITE_SPARSE_MAX_BLOCKS", "512")))

        # wave 0 — UB launches for every (batch, segment)
        items: list = []
        for bi in range(len(batches)):
            for dseg in self.device_segments:
                seg = dseg.reader
                if seg.doc_count == 0:
                    continue
                it = _Item()
                it.bi = bi
                it.dseg = dseg
                it.tl = get_tile_index(dseg)
                it.qb = self._qb_lazy_native(
                    seg, dseg, batches, bi, fields, analyzed_box)
                it.done = False
                it.sparse = None
                it.hmap = None
                it.run_s = None
                it.run_d = None
                q = it.qb["n_queries"]
                it.k = min(int(limits[bi].max()) if len(limits[bi])
                           else limit, dseg.n1)
                it.lims = jnp.asarray(np.minimum(
                    limits[bi], it.k).astype(np.int32))
                if it.qb["n_slots"] == 0:
                    it.ub = None
                    it.done = True
                    items.append(it)
                    continue
                # light queries (block span under the cap) skip the
                # tile machinery entirely: the sparse candidate scorer
                # gathers ONLY their own postings — strictly fewer
                # touched postings than any block-skip traversal, and
                # no per-wave run-table uploads. Only the heavy
                # (head-term) remainder runs tile waves.
                launched = None
                if sparse_cap > 0 and it.k <= 1024:
                    launched = self._sparse_light_launch(
                        dseg, it.qb, it.k, sparse_cap)
                if launched is not None:
                    ts, td, part = launched
                    it.sparse = (ts, td, part["light_idx"])
                    heavy_idx = part["heavy_idx"]
                    if len(heavy_idx) == 0:
                        it.ub = None
                        it.done = True
                        items.append(it)
                        continue
                    from searchlite.ops.impact import (
                        subset_impact_batch,
                    )

                    it.hmap = heavy_idx
                    it.qb = subset_impact_batch(it.qb, heavy_idx)
                    q = it.qb["n_queries"]
                    lims_h = np.full(q, it.k, dtype=np.int64)
                    lims_h[:len(heavy_idx)] = np.minimum(
                        limits[bi][heavy_idx], it.k)
                    it.lims = jnp.asarray(lims_h.astype(np.int32))
                # per-query term/weight tables (vectorized from the
                # qb's slot CSR; rows are slot-ascending)
                from searchlite.ops.impact import (
                    csr_row_lengths,
                    csr_take_rows,
                )
                from searchlite.ops.impact import (
                    ensure_dense_tables,
                )

                ensure_dense_tables(it.qb)  # qb was built lazily
                tids = it.qb["slot_tids"]
                counts = csr_row_lengths(it.qb)
                all_q = np.arange(q, dtype=np.int64)
                idx, sc, pos = csr_take_rows(
                    it.qb["qs_start"], counts, all_q)
                tpq = int(sc.max()) if len(sc) else 1
                it.tpq_pad = next_pow2(max(tpq, 2))
                q_tids = np.full((q, it.tpq_pad), -1, dtype=np.int64)
                w_b = np.zeros((q, it.tpq_pad), dtype=np.float32)
                rows_rep = np.repeat(all_q, sc)
                q_tids[rows_rep, pos] = tids[it.qb["qs_slot"][idx]]
                w_b[rows_rep, pos] = it.qb["qs_w"][idx]
                it.q_tids = q_tids
                it.w_b = jnp.asarray(w_b)
                blk_idx, slot_row, _ = it.tl.ub_block_tables(
                    tids[:it.qb["n_slots"]])
                it.ub = ub_scorer(
                    it.tl.tile_docs, it.tl.tile_maxes,
                    jnp.asarray(blk_idx), jnp.asarray(slot_row),
                    jnp.asarray(it.qb["w_idx"]),
                    jnp.asarray(it.qb["w_val"]),
                    n_t1=it.tl.n_tiles + 1, s_pad=it.qb["s_pad"],
                    n_queries=q)[:, :it.tl.n_tiles]
                it.processed = jnp.zeros((q, it.tl.n_tiles), dtype=bool)
                it.theta = jnp.full((q,), -np.inf, dtype=jnp.float32)
                it.run_s = None
                it.run_d = None
                it.rounds = 0
                items.append(it)

        seed_c = int(os.environ.get(
            "SEARCHLITE_SEED_TILES_PER_QUERY", 0))

        m_budget = int(os.environ.get(
            "SEARCHLITE_M_BUDGET_BYTES", 2 * 1024**3))

        def launch_select(it):
            c = seed_c or max(2, -(-it.k // it.tl.T) + 1)
            # survivor rounds widen geometrically (capped buckets) so a
            # loose-bound query can't force thousands of tiny rounds
            c = min(c << min(it.rounds, 6), max(64, c))
            # M_b is [Q·tpq, C·T] — cap C by the device memory budget
            q = it.qb["n_queries"]
            c_mem = max(1, m_budget // (8 * q * it.tpq_pad * it.tl.T))
            c = min(c, next_pow2(c_mem) // 2 or 1)
            c = next_pow2(min(max(c, -(-it.k // it.tl.T)),
                              it.tl.n_tiles))
            it.rounds += 1
            ids, remaining, processed = selector(
                it.ub, it.processed, it.theta, c=c)
            it.processed = processed
            return ids, remaining

        # seed round + survivor rounds share one loop: select -> fetch
        # ids -> score+merge (all pipelined per round)
        live = [it for it in items if not it.done]
        while live:
            sel_refs = [launch_select(it) for it in live]
            fetched = jax.device_get(tuple(
                x for pair in sel_refs for x in pair))
            for i, it in enumerate(live):
                ids_np = np.asarray(fetched[2 * i])
                remaining = int(np.asarray(fetched[2 * i + 1]).sum())
                n_real = int((ids_np < it.tl.n_tiles).sum())
                if n_real == 0:
                    it.done = True
                    continue
                q_tiles = np.sort(ids_np.astype(np.int64), axis=1)
                runs = it.tl.run_tables_per_query(
                    it.q_tids, q_tiles, it.tpq_pad)
                n_cols = runs["n_cols"]
                top, docs = scorer(
                    it.dseg.docs_flat, it.dseg.impacts_flat,
                    it.tl.deleted_tiles,
                    jnp.asarray(q_tiles.astype(np.int32)), it.w_b,
                    jnp.asarray(runs["packed"]),
                    k=it.k, n_cols=n_cols, p_pad=runs["p_pad"],
                    tpq_pad=it.tpq_pad, t=it.tl.T,
                    fmt=runs["packed_fmt"])
                if top.shape[1] < it.k:  # n_cols < k: pad to k wide
                    pad = it.k - top.shape[1]
                    top = jnp.pad(top, ((0, 0), (0, pad)),
                                  constant_values=-np.inf)
                    docs = jnp.pad(docs, ((0, 0), (0, pad)))
                if it.run_s is None:
                    empty_s = jnp.full((top.shape[0], 0), -np.inf,
                                       dtype=jnp.float32)
                    empty_d = jnp.zeros((top.shape[0], 0),
                                        dtype=jnp.int32)
                    it.run_s, it.run_d, it.theta = merger(
                        top, docs, empty_s, empty_d, it.lims)
                else:
                    it.run_s, it.run_d, it.theta = merger(
                        it.run_s, it.run_d, top, docs, it.lims)
                if remaining == 0:
                    it.done = True
            live = [it for it in items if not it.done]

        # fetch final per-item results (bulk)
        final_refs = []
        for it in items:
            if it.run_s is not None:
                final_refs.extend((it.run_s, it.run_d))
            if it.sparse is not None:
                final_refs.extend(it.sparse[:2])
        final_vals = iter(jax.device_get(tuple(final_refs)))
        per_batch_segments: list[list] = [[] for _ in batches]
        for it in items:
            if it.run_s is None and it.sparse is None:
                continue
            nq = len(batches[it.bi])
            if it.run_s is not None:
                s_np = np.asarray(next(final_vals))
                d_np = np.asarray(next(final_vals)).astype(np.int64)
                d_np = np.where(s_np > -np.inf, d_np, 0)
            else:
                s_np = d_np = None
            if it.sparse is not None:
                ts = np.asarray(next(final_vals))
                td = np.asarray(next(final_vals)).astype(np.int64)
                light_idx = it.sparse[2]
                k = ts.shape[1]
                s_full = np.full((nq, k), -np.inf, dtype=np.float32)
                d_full = np.zeros((nq, k), dtype=np.int64)
                s_full[light_idx] = ts[:len(light_idx)]
                d_full[light_idx] = np.where(
                    ts[:len(light_idx)] > -np.inf,
                    td[:len(light_idx)], 0)
                if s_np is not None and it.hmap is not None:
                    s_full[it.hmap] = s_np[:len(it.hmap), :k]
                    d_full[it.hmap] = d_np[:len(it.hmap), :k]
                s_np, d_np = s_full, d_full
            per_batch_segments[it.bi].append(
                (it.dseg.ord, s_np, d_np))
        out = []
        for bi, (queries, per_segment) in enumerate(
                zip(batches, per_batch_segments)):
            out.append(self._merge_batch_output(
                queries, per_segment, limits[bi], output, limit))
        return out

    def _search_batch_pruned_many(self, batches, limit: int, fields,
                                  filter_tables=None, limits=None,
                                  output: str = "pairs"):
        """Three-wave doc-tile pruned execution (ops/tiles.py): wave 1
        computes per-tile score upper bounds (one small matmul),
        wave 2 exactly scores each query's top tiles by bound, wave 3
        scores the remaining tiles whose bound reaches the observed
        top-k threshold (usually none). Per-query results are exact —
        identical to the dense path (the reference's pruning contract,
        `tests/pruning.rs:44-105`). Waves are pipelined across all
        batches and segments: three bulk fetches total, regardless of
        batch count. Per-query filters shrink the match set only, so
        the UB bound stays sound; thresholds use filtered exact
        scores."""
        import jax
        import jax.numpy as jnp

        from searchlite.ops.tiles import get_tile_index

        if filter_tables is None:
            filter_tables = [(None, None)] * len(batches)
        if limits is None:
            limits = [np.full(len(qs), limit, dtype=np.int64)
                      for qs in batches]
        seed_c = int(os.environ.get("SEARCHLITE_SEED_TILES", 0))
        ub_scorer = self._ub_scorer()
        run_scorer = self._run_scorer()

        analyzed_box = [None]  # Python analysis only if native rejects

        # wave 1 — per (batch, segment): UB matrix launch
        work = []  # (batch_i, dseg, tl, qb, ub_ref)
        for bi in range(len(batches)):
            for dseg in self.device_segments:
                seg = dseg.reader
                if seg.doc_count == 0:
                    continue
                qb = self._qb_lazy_native(
                    seg, dseg, batches, bi, fields, analyzed_box,
                    lazy_tables=False)
                tl = get_tile_index(dseg)
                n_slots = qb["n_slots"]
                if n_slots == 0:
                    work.append((bi, dseg, tl, qb, None))
                    continue
                blk_idx, slot_row, _ = tl.ub_block_tables(
                    qb["slot_tids"][:n_slots])
                ub_ref = ub_scorer(
                    tl.tile_docs, tl.tile_maxes,
                    jnp.asarray(blk_idx), jnp.asarray(slot_row),
                    jnp.asarray(qb["w_idx"]), jnp.asarray(qb["w_val"]),
                    n_t1=tl.n_tiles + 1, s_pad=qb["s_pad"],
                    n_queries=qb["n_queries"])
                work.append((bi, dseg, tl, qb, ub_ref))

        ub_vals = jax.device_get(tuple(
            ref for *_x, ref in work if ref is not None))
        ub_iter = iter(ub_vals)

        # wave 2 — seed tiles: per query the top-C tiles by UB
        wave2 = []  # (ub, seed_tiles, refs or None)
        for bi, dseg, tl, qb, ub_ref in work:
            if ub_ref is None:
                wave2.append((None, None, None))
                continue
            k_batch = int(limits[bi].max()) if len(limits[bi]) else limit
            ub = np.asarray(next(ub_iter))[:, :tl.n_tiles]
            c = seed_c or max(4, -(-4 * k_batch // tl.T))
            c = min(c, tl.n_tiles)
            # per-query top-c positive-UB tiles
            if c < tl.n_tiles:
                part = np.argpartition(-ub, c - 1, axis=1)[:, :c]
            else:
                part = np.broadcast_to(
                    np.arange(tl.n_tiles), ub.shape).copy()
            pos = ub[np.arange(ub.shape[0])[:, None], part] > 0.0
            seed = np.unique(part[pos])
            if len(seed) == 0:
                wave2.append((ub, seed, None))
                continue
            refs = self._launch_tile_runs(dseg, tl, qb, seed, k_batch,
                                          run_scorer, filter_tables[bi])
            wave2.append((ub, seed, refs))

        flat2 = [x for _ub, _seed, refs in wave2 if refs is not None
                 for chunk in refs for x in chunk[:2]]
        vals2 = iter(jax.device_get(tuple(flat2)))

        # wave 3 — survivors: tiles with UB >= theta for any query
        wave3 = []  # (seed_res or None, extra_tiles, refs or None)
        for (bi, dseg, tl, qb, _r), (ub, seed, refs) in zip(work, wave2):
            if refs is None:
                wave3.append((None, None, None))
                continue
            k_batch = int(limits[bi].max()) if len(limits[bi]) else limit
            s_parts, d_parts = [], []
            for _s, _i, chunk_tiles, _p in refs:
                s_np = np.asarray(next(vals2))
                i_np = np.asarray(next(vals2))
                s_parts.append(s_np)
                d_parts.append(tl.map_ids(chunk_tiles, i_np))
            scores2 = np.concatenate(s_parts, axis=1)
            docs2 = np.concatenate(d_parts, axis=1)
            # rows must be (score desc, doc asc)-sorted for the per-query
            # threshold pick below; single-chunk rows already are, chunked
            # rows need the merge sort
            if len(refs) > 1:
                order = np.lexsort((docs2, -scores2), axis=-1)
                scores2 = np.take_along_axis(scores2, order, axis=1)
                docs2 = np.take_along_axis(docs2, order, axis=1)
            nq = scores2.shape[0]
            valid = scores2 > -np.inf
            nvalid = valid.sum(axis=1)
            # per-query threshold at that query's OWN limit (tighter
            # than the batch max, still exact)
            theta = np.full(nq, -np.inf, dtype=np.float64)
            lims = np.minimum(limits[bi], scores2.shape[1]).astype(int)
            full = nvalid >= lims
            qs = np.flatnonzero(full)
            if len(qs):
                theta[qs] = scores2[qs, lims[qs] - 1]
            # survivors: UB >= theta_q for ANY q, minus the seed set
            surv = ((ub >= theta[:, None]) & (ub > 0.0)).any(axis=0)
            surv[seed] = False
            extra = np.flatnonzero(surv).astype(seed.dtype)
            res = (scores2, docs2)
            if len(extra) == 0:
                wave3.append((res, extra, None))
                continue
            refs3 = self._launch_tile_runs(dseg, tl, qb, extra, k_batch,
                                           run_scorer, filter_tables[bi])
            wave3.append((res, extra, refs3))

        flat3 = [x for _res, _extra, refs in wave3 if refs is not None
                 for chunk in refs for x in chunk[:2]]
        vals3 = iter(jax.device_get(tuple(flat3)))

        # merge per (batch, segment) then across segments per batch
        per_batch_segments: list[list] = [[] for _ in batches]
        for (bi, dseg, tl, qb, _r), (res, extra, refs3) in zip(work,
                                                               wave3):
            if res is None:
                continue
            k_batch = int(limits[bi].max()) if len(limits[bi]) else limit
            scores2, docs2 = res
            if refs3 is not None:
                s_parts, d_parts = [scores2], [docs2]
                for _s, _i, chunk_tiles, _p in refs3:
                    s_np = np.asarray(next(vals3))
                    i_np = np.asarray(next(vals3))
                    s_parts.append(s_np)
                    d_parts.append(tl.map_ids(chunk_tiles, i_np))
                scores2 = np.concatenate(s_parts, axis=1)
                docs2 = np.concatenate(d_parts, axis=1)
            # exact per-query top-limit: sort by (-score, doc)
            order = np.lexsort((docs2, -scores2), axis=-1)[:, :k_batch]
            top_s = np.take_along_axis(scores2, order, axis=1)
            top_d = np.take_along_axis(docs2, order, axis=1)
            # re-mask pads that leaked through the merge
            top_d = np.where(top_s > -np.inf, top_d, 0)
            per_batch_segments[bi].append(
                (dseg.ord, top_s.astype(np.float32), top_d))

        out = []
        for bi, (queries, per_segment) in enumerate(
                zip(batches, per_batch_segments)):
            out.append(self._merge_batch_output(
                queries, per_segment, limits[bi], output, limit))
        return out

    @staticmethod
    def _plan_wave_chunks(tl, slot_tids, tiles, s_pad: int) -> list:
        """Split a wave's tile set into launch chunks bounded by the
        HBM budget, counting BOTH the M matrix (4·s_pad·T per tile) and
        the posting-proportional device intermediates of
        build_m_from_runs (~8 pow4-padded arrays of 4 bytes per posting
        slot — the part the M-only bound missed; observed
        RESOURCE_EXHAUSTED at 5M docs where one chunk's postings padded
        to 256M slots). Returns a list of tile-subset arrays."""
        from searchlite.ops.tiles import pow4_bucket  # noqa: PLC0415

        budget = int(os.environ.get(
            "SEARCHLITE_M_BUDGET_BYTES", 2 * 1024**3)) // 2
        per_tile_m = 4 * max(s_pad, 1) * tl.T
        tile_posts = tl.tile_postings(slot_tids, tiles)
        csum = np.concatenate([[0], np.cumsum(tile_posts)])

        def fits(lo, hi):
            # launches pad the tile count to pow2 (compile bucketing)
            m_bytes = per_tile_m * next_pow2(hi - lo)
            p_pad = pow4_bucket(max(int(csum[hi] - csum[lo]), 1),
                                minimum=1024)
            return m_bytes + 32 * p_pad <= budget

        max_tiles_m = max(1, budget // per_tile_m)
        chunks = []
        lo, n_sel = 0, len(tiles)
        while lo < n_sel:
            hi = min(lo + max_tiles_m, n_sel)
            # largest prefix that fits (binary search over hi)
            good, bad = lo + 1, hi + 1
            while bad - good > 1:
                mid = (good + bad) // 2
                if fits(lo, mid):
                    good = mid
                else:
                    bad = mid
            hi = good
            chunks.append(tiles[lo:hi])
            lo = hi
        return chunks

    def _launch_tile_runs(self, dseg, tl, qb, tiles, limit: int,
                          run_scorer, filter_table=(None, None)):
        """Dispatch one exact-scoring wave over the selected tiles,
        split into HBM-budgeted launches (see _plan_wave_chunks — the
        wave-3 survivor set is unbounded). Returns a list of
        (scores_ref, ids_ref, tiles_chunk, postings_count); per-chunk
        top-k are merged host-side by the caller (exactness unaffected:
        every selected tile is still scored exactly). A launch that
        still exhausts HBM evicts rebuildable device caches (doc-shard
        re-blocks, dense rows, whole-segment block arrays) and retries
        on progressively smaller chunks."""
        chunks = self._plan_wave_chunks(
            tl, qb["slot_tids"][:qb["n_slots"]], tiles, qb["s_pad"])
        out = []
        for chunk in chunks:
            out.extend(self._launch_chunk_retrying(
                chunk, lambda c: self._launch_tile_runs_one(
                    dseg, tl, qb, c, limit, run_scorer, filter_table)))
        return out

    def _evict_and_collect(self):
        for ds in self.device_segments:
            ds.evict_device_caches()
        import gc  # noqa: PLC0415

        gc.collect()

    def _retry_oom(self, run):
        """Coarse outer retry: jax dispatch is async, so an execution-
        time RESOURCE_EXHAUSTED surfaces at the wave's blocking FETCH,
        past the per-launch retry in _launch_chunk_retrying. Evict
        rebuildable device caches and re-run the whole pruned pass once
        (exactness unaffected — the pass is pure). The retry happens
        AFTER the except block exits: the exception's traceback pins
        the failed pass's frames — and their device buffer refs — for
        the handler's lifetime, which would defeat the eviction."""
        try:
            return run()
        except Exception as e:  # noqa: BLE001 — jax raises backend types
            if "RESOURCE_EXHAUSTED" not in str(e):
                raise
        self._evict_and_collect()
        return run()

    def _launch_chunk_retrying(self, chunk, launch_one) -> list:
        # retries run outside the except blocks — see _retry_oom
        try:
            return [launch_one(chunk)]
        except Exception as e:  # noqa: BLE001 — jax raises backend types
            if "RESOURCE_EXHAUSTED" not in str(e):
                raise
        self._evict_and_collect()
        try:
            return [launch_one(chunk)]
        except Exception as e2:  # noqa: BLE001
            if "RESOURCE_EXHAUSTED" not in str(e2) or len(chunk) <= 1:
                raise
        mid = len(chunk) // 2
        return (self._launch_chunk_retrying(chunk[:mid], launch_one)
                + self._launch_chunk_retrying(chunk[mid:], launch_one))

    def _launch_tile_runs_one(self, dseg, *args, **kwargs):
        with dseg.exec_scope():
            return self._launch_tile_runs_one_inner(dseg, *args, **kwargs)

    def _launch_tile_runs_one_inner(self, dseg, tl, qb, tiles, limit: int,
                                    run_scorer, filter_table=(None, None)):
        import jax.numpy as jnp

        # pow2 tile count → compile-cache bucketed wave shapes
        tiles = tl.pad_tiles(np.asarray(tiles))
        n_slots = qb["n_slots"]
        runs = tl.run_tables(qb["slot_tids"][:n_slots], tiles)
        n_cols = runs["n_cols"]
        s_pad = qb["s_pad"]
        if s_pad * n_cols + runs["p_pad"] >= 2**31:
            raise QueryError(
                "tile wave exceeds int32 device indexing; lower "
                "SEARCHLITE_SEED_TILES or shard the corpus")
        fidx, distinct = filter_table
        use_filters = fidx is not None
        if use_filters:
            rows_np = self._segment_filter_rows_np(dseg, distinct)
            filter_rows = jnp.asarray(
                tl.gather_cols(rows_np, tiles, fill=False))
            fidx_dev = jnp.asarray(fidx)
        else:
            filter_rows = jnp.zeros((1, 1), dtype=bool)
            fidx_dev = jnp.zeros(1, dtype=jnp.int32)
        scores, ids = run_scorer(
            dseg.docs_flat, dseg.impacts_flat,
            tl.deleted_tiles, jnp.asarray(tiles.astype(np.int32)),
            jnp.asarray(runs["packed"]),
            jnp.asarray(qb["w_idx"]), jnp.asarray(qb["w_val"]),
            filter_rows, fidx_dev,
            k=min(limit, n_cols), n_cols=n_cols, p_pad=runs["p_pad"],
            s_pad=s_pad, n_queries=qb["n_queries"],
            use_filters=use_filters, fmt=runs["packed_fmt"])
        return (scores, ids, tiles, runs["postings"])

    def _ub_scorer(self):
        from searchlite.ops.tiles import make_ub_scorer

        with _GLOBAL_LOCK:
            scorer = _GLOBAL_SCORERS.get(("tile_ub",))
            if scorer is None:
                scorer = make_ub_scorer()
                _GLOBAL_SCORERS[("tile_ub",)] = scorer
            return scorer

    def _run_scorer(self):
        from searchlite.ops.tiles import make_run_batch_scorer

        with _GLOBAL_LOCK:
            scorer = _GLOBAL_SCORERS.get(("tile_runs",))
            if scorer is None:
                scorer = make_run_batch_scorer()
                _GLOBAL_SCORERS[("tile_runs",)] = scorer
            return scorer

    # The pq-path jit wrappers MUST be process-cached: a fresh
    # jax.jit wrapper per search call would recompile every wave
    # shape bucket on every call.

    def _pq_seed_selector(self):
        from searchlite.ops.tiles import make_seed_selector

        with _GLOBAL_LOCK:
            fn = _GLOBAL_SCORERS.get(("pq_seed",))
            if fn is None:
                fn = make_seed_selector()
                _GLOBAL_SCORERS[("pq_seed",)] = fn
            return fn

    def _pq_run_scorer(self):
        from searchlite.ops.tiles import make_pq_run_scorer

        # the M storage dtype is baked in at trace time from the
        # precision mode — key the cache on it
        precision = os.environ.get("SEARCHLITE_PRECISION", "f32")
        with _GLOBAL_LOCK:
            fn = _GLOBAL_SCORERS.get(("pq_runs", precision))
            if fn is None:
                fn = make_pq_run_scorer()
                _GLOBAL_SCORERS[("pq_runs", precision)] = fn
            return fn

    def _pq_topk_merge(self):
        from searchlite.ops.tiles import make_topk_merge

        with _GLOBAL_LOCK:
            fn = _GLOBAL_SCORERS.get(("pq_merge",))
            if fn is None:
                fn = make_topk_merge()
                _GLOBAL_SCORERS[("pq_merge",)] = fn
            return fn

    def _pruned_postings(self, dseg, qargs, top_scores_np,
                         limit: int, strategy: str) -> int:
        """Counterfactual block-max pruning telemetry (the reference's
        wand/bmw counters, `query/wand.rs:45-50`): with the exact top-k
        threshold known, count the postings a pruned traversal would
        still advance. wand uses term-level upper bounds, bmw per-block
        upper bounds (our block size is fixed at 128)."""
        seg = dseg.reader
        postings = seg.postings
        valid = top_scores_np[top_scores_np > -np.inf]
        if len(valid) < limit:
            return qargs["postings_touched"]
        threshold = float(valid[min(limit, len(valid)) - 1])
        slot_weight = qargs["slot_weight"]
        slot_keys = qargs["slot_keys"]
        term_ubs: dict[int, float] = {}
        slot_blocks: dict[int, tuple[int, int, int]] = {}
        for key, s in slot_keys.items():
            w = slot_weight.get(s)
            if w is None:
                continue
            tid = seg.terms.get(key)
            if tid is None:
                continue
            start = int(postings.term_block_start[tid])
            nb = int(postings.term_block_count[tid])
            df = int(postings.term_df[tid])
            slot_blocks[s] = (start, nb, df)
            bub = dseg.block_max_impact[start:start + nb]
            term_ubs[s] = float(bub.max() * w) if nb else 0.0
        total_ub = sum(term_ubs.values())
        advanced = 0
        for s, (start, nb, df) in slot_blocks.items():
            w = slot_weight[s]
            others = total_ub - term_ubs[s]
            if strategy == "wand":
                if term_ubs[s] + others >= threshold:
                    advanced += df
                continue
            bub = dseg.block_max_impact[start:start + nb] * w
            survive = (bub + others) >= threshold
            sizes = np.full(nb, 128, dtype=np.int64)
            if nb:
                sizes[-1] = df - 128 * (nb - 1)
            advanced += int(sizes[survive].sum())
        return advanced

    def _search_batch_sharded(self, dseg, analyzed, qb, limit: int,
                              est_bytes: int, budget: int,
                              fidx=None, distinct=None):
        """Doc-sharded batched scoring for corpora whose dense M would
        exceed the memory budget: loop host-defined doc shards (each
        shard's postings stay term-major/doc-ascending), score each with
        the same kernel, merge top-k host-side. This shard loop is the
        single-chip analogue of multi-chip doc sharding."""
        import jax
        import jax.numpy as jnp

        from searchlite.ops.impact import (
            ensure_dense_tables,
            pow2_bucket,
        )

        ensure_dense_tables(qb)
        n_shards = 1
        while est_bytes // n_shards > budget:
            n_shards *= 2
        # per-shard flat scatter must also fit int32 indexing (the byte
        # budget usually implies this; not when the budget is raised or
        # FLAT_INDEX_LIMIT is lowered by tests)
        while (qb["s_pad"] * (-(-dseg.n1 // n_shards) + 1)
               + qb["nb_pad"] * 128 >= FLAT_INDEX_LIMIT
               and n_shards < dseg.n1):
            n_shards *= 2
        shards = dseg.doc_shards(n_shards)
        width = shards["shard_width"]
        n_terms = shards["n_terms"]
        scorer = self._expand_batched_scorer()
        tids = qb["slot_tids"]
        s_pad = qb["s_pad"]
        q = qb["n_queries"]
        per_shard = []
        # keep host→device transfers small: per-batch uploads are one stacked
        # [n_shards, 2, s_pad] array of per-slot block ranges — the
        # O(total_blocks) gather tables (~64 MB/batch at 5M docs) are
        # expanded ON DEVICE (expand_block_tables_dev). Batch-invariant
        # per-shard deleted masks are cached device-side on the shard
        # dict; w arrays upload once, not once per shard. nb_pad is a
        # uniform pow-2 bucket so all shard launches share one trace
        # (pow-2, not pow-4: every pad block is 128 wasted updates on
        # the update-count-bound M scatter).
        bs_stack = np.zeros((n_shards, 2, s_pad), dtype=np.int32)
        max_blocks = 1
        for d in range(n_shards):
            keys = d * n_terms + tids
            bcnts = shards["blocks"][keys]
            bs_stack[d, 0, :len(tids)] = shards["block_base"][keys]
            bs_stack[d, 1, :len(tids)] = bcnts
            max_blocks = max(max_blocks, int(bcnts.sum()))
        max_blocks = pow2_bucket(max_blocks, minimum=32)
        use_filters = fidx is not None
        del_stack = shards.get("deleted_stack")
        if del_stack is None:
            deleted_np = dseg.deleted_np
            stacked = np.ones((n_shards, width + 1), dtype=bool)
            for d in range(n_shards):
                lo = d * width
                hi = min(lo + width, dseg.n1)
                if hi > lo:
                    stacked[d, : hi - lo] = deleted_np[lo:hi]
            del_stack = jnp.asarray(stacked)
            shards["deleted_stack"] = del_stack
        sentinel_dev = shards.get("sentinel_dev")
        if sentinel_dev is None:
            sentinel_dev = jnp.int32(shards["sentinel_row"])
            shards["sentinel_dev"] = sentinel_dev
        bs_dev = jnp.asarray(bs_stack)
        w_idx_dev = jnp.asarray(qb["w_idx"])
        w_val_dev = jnp.asarray(qb["w_val"])
        if use_filters:
            rows_np = self._segment_filter_rows_np(dseg, distinct)
            rows_stack = np.zeros(
                (n_shards, rows_np.shape[0], width + 1), dtype=bool)
            for d in range(n_shards):
                lo = d * width
                hi = min(lo + width, dseg.n1)
                if hi > lo:
                    rows_stack[d, :, : hi - lo] = rows_np[:, lo:hi]
            rows_dev = jnp.asarray(rows_stack)
            fidx_dev = jnp.asarray(fidx)
        else:
            rows_dev = jnp.zeros((n_shards, 1, 1), dtype=bool)
            fidx_dev = jnp.zeros(1, dtype=jnp.int32)
        for d in range(n_shards):
            lo = d * width
            hi = min(lo + width, dseg.n1)
            if hi <= lo:
                continue  # trailing empty shard (n_shards rounded up)
            k = min(limit, width)
            scores, ids = scorer(
                shards["block_docs"], shards["block_impacts"],
                del_stack[d],
                bs_dev[d, 0], bs_dev[d, 1], sentinel_dev,
                w_idx_dev, w_val_dev,
                rows_dev[d], fidx_dev,
                k=k, s_pad=s_pad, nb_pad=max_blocks, n_queries=q,
                use_filters=use_filters)
            per_shard.append((scores, ids, lo))
        all_scores = []
        all_ids = []
        for scores, ids, lo in per_shard:
            s_np, i_np = jax.device_get((scores, ids))
            all_scores.append(s_np)
            all_ids.append(i_np + lo)
        cat_scores = np.concatenate(all_scores, axis=1)
        cat_ids = np.concatenate(all_ids, axis=1)
        # stable merge: sort by (-score, id)
        order = np.lexsort((cat_ids, -cat_scores), axis=-1)[:, :limit]
        return (np.take_along_axis(cat_scores, order, axis=1),
                np.take_along_axis(cat_ids, order, axis=1))

    def _apply_split_fallbacks(self, launches, flat_vals, n_main,
                               pending_recs):
        """Fallback wave for the term-split sparse path: rows whose
        soundness certificate failed (their candidate-strip top-k is
        not provably the dense result — _candidate_core_split) are
        re-scored through the dense scorers and patched into the
        fetched per-(batch, segment) arrays in place. Sound workloads
        pay only the flag bytes on the main fetch; the wave adds one
        dispatch + fetch round only when failures exist."""
        import jax

        from searchlite.ops.impact import subset_impact_batch

        entry_off = np.cumsum(
            [0] + [len(launched) for launched in launches])
        patches = []
        for rec, flags in zip(pending_recs, flat_vals[n_main:]):
            flags = np.asarray(flags)
            li = rec["light_idx"]
            bad = li[~flags[: len(li)]]
            if len(bad) == 0:
                continue
            dseg = rec["dseg"]
            # diagnostics: rows per reader that needed the dense wave
            self._split_fallback_rows = getattr(
                self, "_split_fallback_rows", 0) + len(bad)
            hqb = subset_impact_batch(rec["qb"], np.asarray(bad))
            sb = rec["shard_budget"]
            est = (hqb["s_pad"] + hqb["n_queries"]) * dseg.n1 * 4
            out = None
            if sb:
                # oversized corpus: re-score unsound rows on full
                # candidate strips (exact, no certificate) — never
                # pay the doc-sharded dense scan for a fallback wave
                out = self._full_strip_launch(dseg, hqb, rec["k"])
            if out is not None:
                ps, pi = out
            elif sb and (est > sb
                         or hqb["flat_extent"] >= FLAT_INDEX_LIMIT):
                ps, pi = self._search_batch_sharded(
                    dseg, None, hqb, rec["k"], est, sb)
            else:
                ps, pi = self._launch_batch_segment(
                    dseg, hqb, rec["k"], allow_sparse=False)
            patches.append((rec, bad, ps, pi))
        if not patches:
            return
        vals = iter(jax.device_get(tuple(
            x for _r, _b, s, i in patches for x in (s, i))))
        for rec, bad, _s, _i in patches:
            ps = np.asarray(next(vals))
            pi = np.asarray(next(vals))
            pos = 2 * (int(entry_off[rec["bi"]]) + rec["li"])
            sc = np.array(flat_vals[pos], copy=True)
            ids = np.array(flat_vals[pos + 1], copy=True)
            sc[bad] = ps[: len(bad)]
            ids[bad] = pi[: len(bad)]
            flat_vals[pos] = sc
            flat_vals[pos + 1] = ids

    def _launch_batch_segment(self, dseg, *args, **kwargs):
        with dseg.exec_scope():
            return self._launch_batch_segment_inner(dseg, *args, **kwargs)

    def _launch_batch_segment_inner(self, dseg, qb, k: int, fidx=None,
                                    distinct=None, allow_sparse: bool = True,
                                    pending=None):
        """Dispatch one segment's batched scoring. Unfiltered batches
        route through the sparse candidate scorer first (ops/sparse.py:
        top-k over each query's own gathered postings — no doc-axis
        score matrix; measured 7.7x the split scorer at the headline
        shapes), with head-term queries falling back to the dense
        scorers below. With SEARCHLITE_DENSE_M_BYTES set, high-df slots
        of the dense path route through precomputed dense impact rows
        (direct matmul) instead of the update-bound scatter — identical
        results. (fidx, distinct): per-query filter rows (see
        _batch_filter_tables), or None for unfiltered."""
        import jax.numpy as jnp

        use_filters = fidx is not None
        if allow_sparse and not use_filters:
            out = self._try_sparse_candidates(dseg, qb, k,
                                              pending=pending)
            if out is not None:
                return out
        if qb["flat_extent"] >= FLAT_INDEX_LIMIT:
            raise QueryError(
                "impact matrix exceeds int32 indexing; route through "
                "the doc-sharded batch path")
        from searchlite.ops.impact import ensure_dense_tables

        ensure_dense_tables(qb)
        if use_filters:
            filter_rows = self._segment_filter_rows(dseg, distinct)
            fidx_dev = jnp.asarray(fidx)
        else:
            filter_rows, fidx_dev = self._no_filter_placeholders()
        # default ON; 0 disables. 2 GiB default (bf16 rows
        # on accelerators — ops/precision.py): on Zipf workloads this
        # routes nearly all batch postings through the direct dense
        # matmul, shrinking the update-bound scatter toward zero;
        # evictable under HBM pressure (evict_device_caches).
        dense_budget = int(os.environ.get(
            "SEARCHLITE_DENSE_M_BYTES", 2 * 1024**3))
        if dense_budget > 0:
            from searchlite.ops.impact import split_impact_batch

            dense = dseg.dense_rows(dense_budget)
            if dense is not None:
                split = split_impact_batch(
                    qb, dense["row_of_tid"],
                    n_rows=len(dense["row_of_tid"]), n1=dseg.n1)
                if split is not None:
                    scorer = self._split_batched_scorer()
                    return scorer(
                        dseg.block_docs, dseg.block_impacts,
                        dense["m_dense"], dseg.deleted,
                        jnp.asarray(split["packed"]),
                        filter_rows, fidx_dev,
                        k=k, s_pad=split["s_pad"],
                        n_queries=qb["n_queries"],
                        nb_pad=split["nb_pad"],
                        wd_pad=split["wd_pad"],
                        ws_pad=split["ws_pad"],
                        use_filters=use_filters)
        scorer = self._batched_scorer()
        return scorer(
            dseg.block_docs, dseg.block_impacts, dseg.deleted,
            jnp.asarray(qb["blk_idx"]), jnp.asarray(qb["slot_row"]),
            jnp.asarray(qb["w_idx"]), jnp.asarray(qb["w_val"]),
            filter_rows, fidx_dev,
            k=k, s_pad=qb["s_pad"], n_queries=qb["n_queries"],
            use_filters=use_filters)

    def _qb_lazy_native(self, seg, dseg, batches, bi, fields,
                        analyzed_box, lazy_tables: bool = True):
        """Build one (batch, segment) qb through the native C++ prep
        fast path, falling back to Python analysis (computed once for
        the whole stream, cached in ``analyzed_box[0]``) when the
        native side rejects the batch."""
        from searchlite.ops.impact import (
            build_impact_batch,
            build_impact_batch_native,
        )

        qb = build_impact_batch_native(
            seg, dseg, batches[bi], fields, self.analysis,
            self.schema, lazy_tables=lazy_tables)
        if qb is None:
            if analyzed_box[0] is None:
                analyzed_box[0] = self._analyze_batches(
                    batches, fields)
            qb = build_impact_batch(seg, dseg, analyzed_box[0][bi],
                                    lazy_tables=lazy_tables)
        return qb

    def _sparse_light_launch(self, dseg, qb, k: int, max_blocks: int,
                             allow_split: bool = False):
        """Partition a qb's light rows and dispatch them through the
        sparse candidate scorer. Preferred form: packed uploads (one
        [Bg, t_pad] int32 per pow-4 block-count tier; block ranges +
        idf gathered from the segment-resident tid table) with the
        tier results gathered back into light-row order on device —
        tiering keeps a single wide query from inflating every other
        row's candidate strip. Falls back to one explicit
        [3, Bl, t_pad] table when the packed format doesn't apply.

        With ``allow_split`` (callers that can run a dense fallback
        wave), the TERM-split partition widens eligibility to
        head-term rows: their light terms ride the strip, heavy terms
        are added by point lookup, and the returned partition carries
        per-light-row ``sound`` flags (device bool ref) the caller
        MUST honor — unsound rows' results are not exact and must be
        re-scored dense (ops/sparse.py::_candidate_core_split).

        Returns (scores, ids, partition) with scores/ids rows aligned
        to partition["light_idx"], or None when no query qualifies.
        Results are bit-identical between the packed forms
        (tests/test_sparse_packed.py)."""
        import jax.numpy as jnp

        from searchlite.ops.impact import next_pow2
        from searchlite.ops.sparse import (
            make_group_gather,
            make_group_gather_sound,
            partition_sparse_batch,
            partition_sparse_batch_split,
            partition_sparse_batch_tiered,
        )

        part = None
        term_cap = 0
        use_packed = os.environ.get(
            "SEARCHLITE_SPARSE_PACKED", "1") != "0"
        if (allow_split and use_packed
                and os.environ.get("SEARCHLITE_TERM_SPLIT", "1")
                != "0"):
            # heavy ⇔ over max_blocks/16 (≈ df > n1/40 at the scaled
            # oversized-corpus cap): round 5 LOWERED this from
            # max_blocks/2 — the routing census (probe_route_census,
            # 5M) showed the shipped cap left 260.6M strip lanes per
            # 512 queries vs 18.7-34.8M at caps 512-1024, and the
            # round-4 "5M pathology" (mid-df heads failing the
            # certificate) was NOT HUB rivaling θ: fail_theta ≈ 0 in
            # the exact host simulation (probe_split_cert); the
            # failures were the kp cut sitting far below the candidate
            # band (p50 ≈ 120-165, max < 5k — probe_split_band), fixed
            # by the SEARCHLITE_SPLIT_KP floor below
            term_cap = int(os.environ.get(
                "SEARCHLITE_HEAVY_TERM_BLOCKS",
                str(max_blocks if max_blocks <= 512
                    else max(512, max_blocks // 16))))
            h_max = int(os.environ.get("SEARCHLITE_HEAVY_SLOTS", "4"))
            ub_ratio = float(os.environ.get(
                "SEARCHLITE_SPLIT_UB_RATIO", "0.5"))
            part = partition_sparse_batch_split(
                qb, max_blocks, dseg.idf32, k, term_cap, h_max,
                maximp=dseg.heavy_lookup_host(term_cap)["maximp"],
                ub_ratio=ub_ratio)
        if part is None and use_packed:
            part = partition_sparse_batch_tiered(
                qb, max_blocks, dseg.idf32, k)
        if part is not None:
            groups = part["groups"]
            kp = next_pow2(max(4 * k, 64))
            outs = []
            flags = []
            any_split = False
            for g in groups:
                if g.get("hvy") is not None:
                    # kp must clear the candidate BAND — the set
                    # {tail + HUB >= θ} a doc-at-a-time WAND would
                    # score. Measured at 5M (probe_split_band): band
                    # p50 ≈ 120-165, max < 5k, so a 4096 floor
                    # certifies ~100% of split rows where the old
                    # width-scaled kp (min 64) failed most of them.
                    # The lookups are chunked 128-wide gathers (one
                    # pass, ~memory speed) — still cheap relative to
                    # the strip sort they replace.
                    kp_g = next_pow2(min(
                        max(kp, g["nblk"] * 128 // 64,
                            int(os.environ.get(
                                "SEARCHLITE_SPLIT_KP", "4096"))),
                        8192))
                    hl = dseg.heavy_lookup(term_cap)
                    ss = self._sparse_candidate_scorer_split()
                    ts_g, td_g, snd = ss(
                        dseg.block_docs, dseg.block_impacts_live,
                        dseg.sparse_tid_tbl, hl["tbl"], hl["base"],
                        hl["log2g"], hl["maximp"],
                        jnp.asarray(g["packed"]),
                        jnp.asarray(g["ovr"]),
                        jnp.asarray(g["hvy"]), dseg.sparse_sentinels,
                        k=k, kp=kp_g, t_pad=g["t_pad"], nblk=g["nblk"],
                        log2_run=g["log2_run"], h_pad=g["h_pad"],
                        n_ovr=g["n_ovr"])
                    outs.append((ts_g, td_g))
                    flags.append(snd)
                    any_split = True
                else:
                    scorer = self._sparse_candidate_scorer_packed()
                    outs.append(scorer(
                        dseg.block_docs, dseg.block_impacts_live,
                        dseg.sparse_tid_tbl, jnp.asarray(g["packed"]),
                        jnp.asarray(g["ovr"]), dseg.sparse_sentinels,
                        k=k, t_pad=g["t_pad"], nblk=g["nblk"],
                        log2_run=g["log2_run"], n_ovr=g["n_ovr"]))
                    flags.append(None)
            n_light = len(part["light_idx"])
            if (len(groups) == 1
                    and len(groups[0]["pos_in_light"]) == n_light
                    and np.array_equal(
                        groups[0]["pos_in_light"],
                        np.arange(n_light, dtype=np.int64))):
                # single occupied tier covering every light row IN
                # ORDER — the group IS the light-order result. The
                # coverage check must count ROWS, not compare padded
                # shapes: a group that silently dropped rows (e.g.
                # 0-block rows outside every tier) would shift every
                # result below the gap (found by tools/fuzz_matrix.py);
                # the order check matters because chunked tiers emit
                # width-sorted row order (ops/sparse.py::_chunk_rows)
                ts, td = outs[0]
                if any_split:
                    part["sound"] = flags[0]
                return ts, td, part
            bl = part["bl"]
            posmaps = np.full(
                sum(g["packed"].shape[0] for g in groups), bl,
                dtype=np.int32)
            off = 0
            for g in groups:
                posmaps[off:off + len(g["pos_in_light"])] = \
                    g["pos_in_light"]
                off += g["packed"].shape[0]
            if any_split:
                flags = [f if f is not None
                         else jnp.ones((outs[i][0].shape[0],),
                                       dtype=bool)
                         for i, f in enumerate(flags)]
                with _GLOBAL_LOCK:
                    gatherer = _GLOBAL_SCORERS.get(
                        ("group_gather_sound",))
                    if gatherer is None:
                        gatherer = make_group_gather_sound()
                        _GLOBAL_SCORERS[("group_gather_sound",)] = \
                            gatherer
                ts, td, snd = gatherer(
                    tuple(o[0] for o in outs),
                    tuple(o[1] for o in outs), tuple(flags),
                    jnp.asarray(posmaps), bl=bl)
                part["sound"] = snd
                assert n_light <= bl
                return ts, td, part
            with _GLOBAL_LOCK:
                gatherer = _GLOBAL_SCORERS.get(("group_gather",))
                if gatherer is None:
                    gatherer = make_group_gather()
                    _GLOBAL_SCORERS[("group_gather",)] = gatherer
            ts, td = gatherer(
                tuple(o[0] for o in outs), tuple(o[1] for o in outs),
                jnp.asarray(posmaps), bl=bl)
            assert n_light <= bl
            return ts, td, part
        part = partition_sparse_batch(qb, max_blocks)
        if part is None or k > part["nblk"] * 128:
            return None
        from searchlite.ops.sparse import STRIP_CHUNK_ELEMS
        if part["bl"] * part["nblk"] * 128 > 2 * STRIP_CHUNK_ELEMS:
            # the explicit-table fallback is un-chunked (one [bl,
            # nblk*128] strip sort); past ~2 GB of candidate lanes the
            # sort's HLO temps alone exceed HBM — refuse and let the
            # caller run the dense path instead (the packed/tiered
            # partitions above chunk rows and never get here)
            return None
        scorer = self._sparse_candidate_scorer()
        ts, td = scorer(
            dseg.block_docs, dseg.block_impacts_live,
            jnp.asarray(part["tbl"]), dseg.sparse_sentinels,
            k=k, t_pad=part["t_pad"], nblk=part["nblk"],
            log2_run=part["log2_run"])
        return ts, td, part

    def _full_strip_launch(self, dseg, qb, k: int):
        """Exact, certificate-free scoring of a (usually small) subset
        of head-term rows at an oversized corpus: EVERY term of every
        row rides the candidate strip (``max_blocks`` = the widest
        row's block count, row-chunked per STRIP_CHUNK_ELEMS), so the
        result is the plain packed scorer's — exact by construction.

        This replaces the doc-sharded dense scan as the oversized-
        corpus fallback for ineligible/unsound term-split rows: those
        rows have moderate total df (a truly massive head term has
        near-zero idf, so its HUB is negligible and its row never
        falls back), which is exactly where full strips are cheap —
        ~2 ms per million candidates vs seconds per dense wave
        (tools/probe_scale_batch.py, 5M docs). Returns (scores, ids)
        device refs with rows in subset order (bl-padded), or None
        when the packed strip path doesn't apply (caller falls back
        dense)."""
        nq = int(qb["n_queries"])
        if nq == 0 or k > 1024:
            return None
        mb = max(int(qb["q_nblk"].max()), 1)
        with dseg.exec_scope():
            launched = self._sparse_light_launch(
                dseg, qb, k, mb, allow_split=False)
        if launched is None:
            return None
        ts, td, part = launched
        if len(part["heavy_idx"]) or len(part["light_idx"]) != nq:
            return None  # defensive: cap covers every row's blocks
        return ts, td

    def _try_sparse_candidates(self, dseg, qb, k: int,
                               shard_budget: int = 0, pending=None):
        """Route a batch through the sparse candidate scorer
        (ops/sparse.py). Queries whose gathered posting strips fit in
        SEARCHLITE_SPARSE_MAX_BLOCKS blocks are scored over their own
        candidates only; the heavy remainder (head-term queries) is
        re-packed (subset_impact_batch) and recursed through the dense
        scorers, and both row groups are scattered back into batch
        order on device. With ``shard_budget`` set (the oversized-
        corpus branch) a wider default block cap applies and the heavy
        remainder runs the doc-sharded scan.

        With ``pending`` (a list), the TERM-split partition also
        admits head-term rows (light terms on the strip, heavy terms
        by point lookup — batched WAND); a record with the per-row
        soundness flags (device ref) is appended, and the caller MUST
        fetch them and re-score unsound rows dense
        (_apply_split_fallbacks). Returns None when the path doesn't
        apply — the caller falls through to the dense scorers."""
        import jax.numpy as jnp

        from searchlite.ops.impact import subset_impact_batch

        mb_env = os.environ.get("SEARCHLITE_SPARSE_MAX_BLOCKS")
        if mb_env is not None:
            max_blocks = int(mb_env)
        elif shard_budget:
            # oversized corpora: scale the strip cap with the corpus so
            # mid-df head terms (df up to ~n1/5) ride candidate strips
            # instead of the doc-sharded dense scan — at 5M docs the
            # strip sort costs ~2 ms per million candidates while ONE
            # dense wave costs seconds (see _full_strip_launch). The
            # cap is 2x the implied term_cap (one mid head + tails)
            max_blocks = max(512, 2 * (dseg.n1 // 640))
        else:
            max_blocks = 32
        if max_blocks <= 0 or k > 1024:
            return None
        nq = qb["n_queries"]
        if nq == 0 or qb["n_slots"] == 0:
            return None
        launched = self._sparse_light_launch(
            dseg, qb, k, max_blocks, allow_split=pending is not None)
        if launched is None:
            return None
        ts, td, part = launched
        light_idx = part["light_idx"]
        heavy_idx = part["heavy_idx"]
        if part.get("sound") is not None:
            pending.append({
                "dseg": dseg, "qb": qb, "light_idx": light_idx,
                "sound": part["sound"], "k": k,
                "shard_budget": shard_budget})
        if len(heavy_idx) == 0 and len(light_idx) == nq \
                and ts.shape[0] == nq:
            return ts, td
        bl = ts.shape[0]
        light_map = np.full(bl, nq, dtype=np.int32)
        light_map[:len(light_idx)] = light_idx
        if len(heavy_idx):
            hqb = subset_impact_batch(qb, heavy_idx)
            est_h = (hqb["s_pad"] + hqb["n_queries"]) * dseg.n1 * 4
            out_h = None
            if shard_budget:
                # oversized corpus: score the remainder rows on FULL
                # candidate strips (every term, no certificate) — the
                # doc-sharded dense scan pays seconds per wave at 5M+
                out_h = self._full_strip_launch(dseg, hqb, k)
            if out_h is not None:
                hs, hi = out_h
            elif shard_budget and (est_h > shard_budget
                                   or hqb["flat_extent"]
                                   >= FLAT_INDEX_LIMIT):
                hs, hi = self._search_batch_sharded(
                    dseg, None, hqb, k, est_h, shard_budget)
                hs, hi = jnp.asarray(hs), jnp.asarray(hi)
            else:
                hs, hi = self._launch_batch_segment(
                    dseg, hqb, k, allow_sparse=False)
            heavy_map = np.full(hs.shape[0], nq, dtype=np.int32)
            heavy_map[:len(heavy_idx)] = heavy_idx
        else:
            hs, hi = self._empty_heavy_rows(k)
            heavy_map = np.full(1, nq, dtype=np.int32)
        combine = self._row_combiner()
        return combine(ts, td, hs, hi,
                       jnp.asarray(np.concatenate(
                           [light_map, heavy_map])), n_rows=nq)

    def _try_sparse_single(self, dseg, qargs, k: int):
        with dseg.exec_scope():
            return self._try_sparse_single_inner(dseg, qargs, k)

    def _try_sparse_single_inner(self, dseg, qargs, k: int):
        """One plain OR query through the sparse candidate scorer
        (ops/sparse.py): a [1, t_pad] table of the query's posting
        block ranges and summed leaf weights, scored over its own
        candidate strip only. Exact under QueryPlan.is_plain_or_sum
        (match ≡ positive score; count from the scorer's ok mask).
        Fetches (scores, ids, count) in ONE round trip per segment.
        Returns None when the query's block span exceeds the cap (the
        dense/pruned paths win there) — caller falls through."""
        import jax
        import jax.numpy as jnp

        from searchlite.ops.impact import next_pow2, pow15_bucket

        mb_env = os.environ.get("SEARCHLITE_SINGLE_SPARSE_BLOCKS")
        if mb_env is not None:
            max_blocks = int(mb_env)
        else:
            # corpus-scaled strip cap, same policy as the batched
            # split route (_launch_batch_segment): at multi-M docs
            # mid-df terms ride the strip (sort ~2 ms/M candidates)
            # rather than forcing the 10x-slower tile waves
            max_blocks = max(512, 2 * (dseg.n1 // 640))
        if max_blocks <= 0 or k > 1024:
            return None
        # corpus-size gate: at small n1 the dense executor is already
        # RTT-floored and bit-reproduces the historical scoring path;
        # the candidate gather's f32 summation order differs at ulp
        # level (divergence D10, COMPONENTS.md), so the route only
        # turns on where it buys real latency
        min_docs = int(os.environ.get(
            "SEARCHLITE_SINGLE_SPARSE_MIN_DOCS", "1000000"))
        if dseg.n1 < min_docs:
            return None
        n_slots = qargs["n_slots"]
        if n_slots == 0:
            return None
        postings = dseg.reader.postings
        tids = qargs["slot_tids"]
        bstart = postings.term_block_start[tids].astype(np.int64)
        bcnt = postings.term_block_count[tids].astype(np.int64)
        total = int(bcnt.sum())
        w = np.zeros(n_slots, dtype=np.float32)
        for s, v in qargs["slot_weight"].items():
            w[s] = v
        if total == 0 or k > total * 128 or (w <= 0).any():
            return None
        if total > max_blocks:
            # TERM-split single-query route: up to h_max heavy (head)
            # terms are added by full-strip point lookup; the result
            # carries a soundness certificate (θ > Σ HUBᵢ — docs
            # outside the strip match heavy terms only) — when it
            # fails, fall through to the dense/pruned paths. Counts:
            # exact with ONE heavy (|light ∪ heavy| = n_strip +
            # live_df − overlap); a lower-bound estimate with several
            # (n_strip + maxᵢ(live_dfᵢ − overlapᵢ) ≤ |union|), within
            # the `total_hits_estimate` contract the pruned tile path
            # already uses (reference api/reader.rs:101 names the
            # field an estimate; tests/test_pruning.py pins ≤ dense).
            if os.environ.get("SEARCHLITE_TERM_SPLIT", "1") == "0":
                return None
            term_cap = int(os.environ.get(
                "SEARCHLITE_HEAVY_TERM_BLOCKS",
                str(max_blocks if max_blocks <= 512
                    else max(512, max_blocks // 16))))
            h_max = int(os.environ.get("SEARCHLITE_HEAVY_SLOTS", "4"))
            if int(bcnt.max()) <= term_cap:
                return None
            # heavy = the MINIMAL set of largest over-cap terms whose
            # removal fits the remaining strip under the cap (greedy,
            # largest first, up to h_max): one heavy keeps counts
            # exact, so extra heads ride the strip whenever they fit
            over = np.flatnonzero(bcnt > term_cap)
            order = over[np.argsort(-bcnt[over], kind="stable")]
            h_slots = []
            light_total = total
            for s in order:
                if len(h_slots) >= h_max:
                    break
                h_slots.append(int(s))
                light_total -= int(bcnt[s])
                if light_total <= max_blocks:
                    break
            h_slots = np.asarray(h_slots, dtype=np.int64)
            heavy = np.zeros(n_slots, dtype=bool)
            heavy[h_slots] = True
            if (light_total == 0 or light_total > max_blocks
                    or k > light_total * 128):
                return None
            h_tids = [int(tids[s]) for s in h_slots]
            hl_host = dseg.heavy_lookup_host(term_cap)
            ub_ratio = float(os.environ.get(
                "SEARCHLITE_SPLIT_UB_RATIO", "0.5"))
            maximp = hl_host["maximp"]
            hub_sum = float((w[h_slots]
                             * maximp[tids[h_slots]]).sum())
            lmax = float((w[~heavy]
                          * maximp[tids[~heavy]]).max())
            if ub_ratio > 0 and hub_sum >= ub_ratio * lmax:
                return None  # certificate unlikely — go dense/pruned
            lt = int((~heavy).sum())
            t_pad = next_pow2(max(lt, 2))
            tbl = np.zeros((3, 1, t_pad), dtype=np.int32)
            tbl[0, 0, :lt] = bstart[~heavy]
            tbl[1, 0, :lt] = bcnt[~heavy]
            tbl[2, 0, :lt] = w[~heavy].view(np.int32)
            h_pad = next_pow2(max(len(h_slots), 1))
            hvy = np.zeros((2, h_pad), dtype=np.int32)
            hvy[0, :len(h_slots)] = h_tids
            hvy[1, :len(h_slots)] = w[h_slots].view(np.int32)
            hl = dseg.heavy_lookup(term_cap)
            scorer = self._sparse_single_split_scorer()
            ts, td, n_strip, overlap, sound = scorer(
                dseg.block_docs, dseg.block_impacts_live,
                hl["tbl"], hl["base"], hl["log2g"],
                dseg.sparse_tid_tbl, hl["maximp"],
                jnp.asarray(tbl), jnp.asarray(hvy),
                dseg.sparse_sentinels,
                k=k, t_pad=t_pad,
                nblk=pow15_bucket(light_total, minimum=16),
                log2_run=max((t_pad - 1).bit_length(), 1))
            ts, td, n_strip, overlap, sound = jax.device_get(
                (ts, td, n_strip, overlap, sound))
            if not bool(np.asarray(sound)[0]):
                return None
            ov = np.asarray(overlap)
            ns = int(np.asarray(n_strip)[0])
            if len(h_slots) == 1:
                cnt = (ns + dseg.live_term_df(h_tids[0])
                       - int(ov[0]))
            else:
                cnt = ns + max(
                    dseg.live_term_df(t) - int(ov[i])
                    for i, t in enumerate(h_tids))
            return (np.asarray(ts)[0], np.asarray(td)[0], cnt,
                    qargs["postings_touched"])
        t_pad = next_pow2(max(n_slots, 2))
        tbl = np.zeros((3, 1, t_pad), dtype=np.int32)
        tbl[0, 0, :n_slots] = bstart
        tbl[1, 0, :n_slots] = bcnt
        tbl[2, 0, :n_slots] = w.view(np.int32)
        scorer = self._sparse_candidate_scorer()
        ts, td, cnt = scorer(
            dseg.block_docs, dseg.block_impacts_live,
            jnp.asarray(tbl), dseg.sparse_sentinels,
            k=k, t_pad=t_pad, nblk=pow15_bucket(total, minimum=16),
            log2_run=max((t_pad - 1).bit_length(), 1),
            with_counts=True)
        ts, td, cnt = jax.device_get((ts, td, cnt))
        return (np.asarray(ts)[0], np.asarray(td)[0],
                int(cnt[0]), qargs["postings_touched"])

    def _empty_heavy_rows(self, k: int):
        """Cached all-pad heavy rows for sparse batches with no heavy
        remainder — avoids two eager device allocations per batch."""
        import jax.numpy as jnp

        with _GLOBAL_LOCK:
            pair = _GLOBAL_SCORERS.get(("empty_heavy", k))
            if pair is None:
                pair = (jnp.full((1, k), -jnp.inf, dtype=jnp.float32),
                        jnp.zeros((1, k), dtype=jnp.int32))
                _GLOBAL_SCORERS[("empty_heavy", k)] = pair
            return pair

    def _no_filter_placeholders(self):
        """Cached dummy (filter_rows, fidx) device arrays for
        unfiltered dense launches — avoids two eager device
        allocations per batch."""
        import jax.numpy as jnp

        with _GLOBAL_LOCK:
            pair = _GLOBAL_SCORERS.get(("no_filter",))
            if pair is None:
                pair = (jnp.zeros((1, 1), dtype=bool),
                        jnp.zeros(1, dtype=jnp.int32))
                _GLOBAL_SCORERS[("no_filter",)] = pair
            return pair

    def _sparse_candidate_scorer(self):
        from searchlite.ops.sparse import make_sparse_candidate_scorer

        with _GLOBAL_LOCK:
            scorer = _GLOBAL_SCORERS.get(("sparse_cand",))
            if scorer is None:
                scorer = make_sparse_candidate_scorer()
                _GLOBAL_SCORERS[("sparse_cand",)] = scorer
            return scorer

    def _sparse_candidate_scorer_packed(self):
        from searchlite.ops.sparse import (
            make_sparse_candidate_scorer_packed,
        )

        with _GLOBAL_LOCK:
            scorer = _GLOBAL_SCORERS.get(("sparse_cand_packed",))
            if scorer is None:
                scorer = make_sparse_candidate_scorer_packed()
                _GLOBAL_SCORERS[("sparse_cand_packed",)] = scorer
            return scorer

    def _sparse_candidate_scorer_split(self):
        from searchlite.ops.sparse import (
            make_sparse_candidate_scorer_split,
        )

        with _GLOBAL_LOCK:
            scorer = _GLOBAL_SCORERS.get(("sparse_cand_split",))
            if scorer is None:
                scorer = make_sparse_candidate_scorer_split()
                _GLOBAL_SCORERS[("sparse_cand_split",)] = scorer
            return scorer

    def _sparse_single_split_scorer(self):
        from searchlite.ops.sparse import (
            make_sparse_single_split_scorer,
        )

        with _GLOBAL_LOCK:
            scorer = _GLOBAL_SCORERS.get(("sparse_single_split",))
            if scorer is None:
                scorer = make_sparse_single_split_scorer()
                _GLOBAL_SCORERS[("sparse_single_split",)] = scorer
            return scorer

    def _row_combiner(self):
        from searchlite.ops.sparse import make_row_combiner

        with _GLOBAL_LOCK:
            fn = _GLOBAL_SCORERS.get(("row_combine",))
            if fn is None:
                fn = make_row_combiner()
                _GLOBAL_SCORERS[("row_combine",)] = fn
            return fn

    def _split_batched_scorer(self):
        from searchlite.ops.impact import make_split_impact_scorer

        precision = os.environ.get("SEARCHLITE_PRECISION", "f32")
        with _GLOBAL_LOCK:
            scorer = _GLOBAL_SCORERS.get(("split", precision))
            if scorer is None:
                scorer = make_split_impact_scorer(precision)
                _GLOBAL_SCORERS[("split", precision)] = scorer
            return scorer

    def _batched_scorer(self):
        from searchlite.ops.impact import make_impact_scorer

        precision = os.environ.get("SEARCHLITE_PRECISION", "f32")
        with _GLOBAL_LOCK:
            scorer = _GLOBAL_SCORERS.get(("block", precision))
            if scorer is None:
                scorer = make_impact_scorer(precision)
                _GLOBAL_SCORERS[("block", precision)] = scorer
            return scorer

    def _expand_batched_scorer(self):
        from searchlite.ops.impact import make_expand_impact_scorer

        precision = os.environ.get("SEARCHLITE_PRECISION", "f32")
        with _GLOBAL_LOCK:
            scorer = _GLOBAL_SCORERS.get(("block_expand", precision))
            if scorer is None:
                scorer = make_expand_impact_scorer(precision)
                _GLOBAL_SCORERS[("block_expand", precision)] = scorer
            return scorer

    def _flat_batched_scorer(self):
        from searchlite.ops.impact import make_flat_impact_scorer

        precision = os.environ.get("SEARCHLITE_PRECISION", "f32")
        with _GLOBAL_LOCK:
            scorer = _GLOBAL_SCORERS.get(("flat", precision))
            if scorer is None:
                scorer = make_flat_impact_scorer(precision)
                _GLOBAL_SCORERS[("flat", precision)] = scorer
            return scorer

    def _compile(self, plan: QueryPlan, k1: float, b: float) -> CompiledQuery:
        # cache by plan structure + schema fingerprint, process-wide:
        # readers are recreated on every commit and must reuse traces
        sig = repr((_plan_sig(plan), self._schema_fingerprint, k1, b))
        with _GLOBAL_LOCK:
            cq = _GLOBAL_COMPILED.get(sig)
            if cq is None:
                cq = CompiledQuery(plan, self.schema, k1, b)
                _GLOBAL_COMPILED[sig] = cq
            return cq

    def _group_matches_doc(self, seg, keys, doc: int) -> bool:
        """Does the doc contain any of the group's terms? (host-side
        QueryEvaluator term check, `api/reader.rs:1481-1598`)."""
        postings = seg.postings
        for key in keys:
            tid = seg.terms.get(key)
            if tid is None:
                continue
            docs, _tfs = postings.term_postings(tid)
            i = np.searchsorted(docs, doc)
            if i < len(docs) and docs[i] == doc:
                return True
        return False

    def _matcher_matches_host(self, matcher, seg, compiled,
                              group_keys, phrase_masks, doc: int) -> bool:
        """Host-side evaluation of the boolean matcher tree for ONE doc
        — the explain path's exact counterpart of the traced
        `_eval_matcher` (reference `QueryEvaluator`,
        `api/reader.rs:1467-1598`)."""
        from searchlite.query.filters import passes_filter

        kind = matcher.kind
        if kind == "match_all":
            return True
        if kind == "term":
            return self._group_matches_doc(
                seg, group_keys[matcher.payload], doc)
        if kind == "phrase":
            return bool(phrase_masks[matcher.payload, doc])
        if kind == "query_string":
            p = matcher.payload
            if not p["term_groups"] and not p["phrase_groups"] \
                    and not p["not_term_groups"]:
                return False
            for idx in p["not_term_groups"]:
                if self._group_matches_doc(seg, group_keys[idx], doc):
                    return False
            for idx in p["phrase_groups"]:
                if not phrase_masks[idx, doc]:
                    return False
            if not p["term_groups"]:
                return True
            counts = sum(
                1 for idx in p["term_groups"]
                if self._group_matches_doc(seg, group_keys[idx], doc))
            required = p["minimum_should_match"]
            required = 1 if required is None else required
            return counts >= required
        if kind == "dis_max":
            return any(self._matcher_matches_host(
                c, seg, compiled, group_keys, phrase_masks, doc)
                for c in matcher.payload)
        if kind == "bool":
            p = matcher.payload
            for child in p["must"]:
                if not self._matcher_matches_host(
                        child, seg, compiled, group_keys, phrase_masks,
                        doc):
                    return False
            for child in p["must_not"]:
                if self._matcher_matches_host(
                        child, seg, compiled, group_keys, phrase_masks,
                        doc):
                    return False
            slot = compiled._matcher_filter_slot.get(id(matcher))
            if slot is not None:
                for f in compiled.filter_slots[slot]:
                    if not passes_filter(seg.fast, doc, f):
                        return False
            should = p["should"]
            if should:
                count = sum(
                    1 for child in should
                    if self._matcher_matches_host(
                        child, seg, compiled, group_keys, phrase_masks,
                        doc))
                min_should = p["minimum_should_match"]
                if min_should is None:
                    min_should = (1 if not p["must"] and not p["filter"]
                                  else 0)
                return count >= min_should
            if p["minimum_should_match"] not in (None, 0):
                return False
            return True
        return False

    def _explain_functions(self, compiled: CompiledQuery, score_tree,
                           segment_ord: int, doc: int, plan=None,
                           group_keys=None) -> list[dict]:
        """Per-hit custom-scoring breakdown (function contributions),
        recomputed host-side for the returned hits only
        (parity shape: `api/reader.rs::FunctionExplanation`). Each
        score node's MATCHER is evaluated for the doc — unmatched nodes
        contribute nothing (they scored 0 in the traced path)."""
        from searchlite.query.filters import passes_filter

        seg = self.segments[segment_ord]
        fast = seg.fast
        out: list[dict] = []
        phrase_masks = None
        if plan is not None and plan.phrase_specs:
            phrase_masks = self._segment_phrase_masks(
                seg, plan.phrase_specs)

        def node_matched(node) -> bool:
            matcher = node.params.get("matcher")
            if matcher is None or group_keys is None:
                return True
            return self._matcher_matches_host(
                matcher, seg, compiled, group_keys, phrase_masks, doc)

        def numeric_value(field: str):
            vals = fast.numeric_values(field, doc)
            return float(vals[0]) if vals else None

        def walk(node):
            if node.kind == "function_score":
                if not node_matched(node):
                    walk(node.params["base"])
                    for child in node.children:
                        walk(child)
                    return
                info = compiled._compiled_nodes.get(id(node), {})
                for func in info.get("functions", []):
                    if func.filter is not None and not passes_filter(
                            fast, doc, func.filter):
                        continue
                    if func.kind == "weight":
                        out.append({"type": "weight",
                                    "value": func.params["weight"],
                                    "field": None})
                    elif func.kind == "field_value_factor":
                        raw = numeric_value(func.params["field"])
                        if raw is None:
                            raw = func.params["missing"]
                        import numpy as _np

                        from searchlite.query.score_functions import (
                            apply_modifier_dense,
                        )

                        val = float(apply_modifier_dense(
                            _np, _np.asarray([raw * func.params["factor"]]),
                            func.params["modifier"])[0])
                        out.append({"type": "field_value_factor",
                                    "value": val,
                                    "field": func.params["field"]})
                    elif func.kind == "decay":
                        raw = numeric_value(func.params["field"])
                        if raw is None:
                            continue
                        import numpy as _np

                        from searchlite.query.score_functions import (
                            decay_dense,
                        )

                        dist = abs(raw - func.params["origin"]) - \
                            func.params["offset"]
                        norm = max(dist, 0.0) / func.params["scale"]
                        val = float(decay_dense(
                            _np, func.params["decay"],
                            _np.asarray([norm]),
                            func.params["function"])[0])
                        out.append({
                            "type": f"decay_{func.params['function']}",
                            "value": val,
                            "field": func.params["field"]})
                walk(node.params["base"])
            elif node.kind == "rank_feature":
                if node_matched(node):
                    raw = numeric_value(node.params["field"])
                    out.append({"type": "rank_feature",
                                "value": raw if raw is not None
                                else node.params.get("missing") or 0.0,
                                "field": node.params["field"]})
            elif node.kind == "script_score":
                if node_matched(node):
                    out.append({"type": "script_score", "value": None,
                                "field": None})
                walk(node.params["base"])
            for child in node.children:
                walk(child)

        walk(score_tree)
        return out

    def _phrase_term_map(self, phrase_specs) -> dict[str, list[list[str]]]:
        out: dict[str, list[list[str]]] = {}
        for spec in phrase_specs:
            for field in spec.fields:
                out.setdefault(field, []).append(list(spec.terms))
        return out

    # -- rescore ------------------------------------------------------------------

    def _rescore_hits(self, hits: list[RankedHit], rescore_req,
                      default_fields, sort_plan, req, stats) -> None:
        if not hits or rescore_req.window_size == 0:
            return
        window = min(rescore_req.window_size, len(hits))
        plan = build_query_plan(rescore_req.query, default_fields)
        compiled = self._compile(plan, self.options.bm25_k1,
                                 self.options.bm25_b)
        qualified, group_keys = self._expand_term_groups(
            plan.term_groups, req.fuzzy)
        has_scored = bool(qualified)

        import jax.numpy as jnp

        # run the rescore query per involved segment; gather scores+masks
        seg_scores: dict[int, np.ndarray] = {}
        seg_masks: dict[int, np.ndarray] = {}
        involved = {h.key.segment_ord for h in hits[:window]}
        for dseg in self.device_segments:
            if dseg.ord not in involved or dseg.reader.doc_count == 0:
                continue
            seg = dseg.reader
            qargs = self._segment_query_args(
                dseg, qualified, group_keys, compiled.n_leaves,
                compiled.n_groups)
            phrase_masks = self._segment_phrase_masks(
                seg, plan.phrase_specs, n1=dseg.n1)
            filter_masks = self._segment_filter_masks(
                seg, compiled.filter_slots, n1=dseg.n1)
            col_vals, col_has = self._segment_columns(
                seg, compiled.columns, n1=dseg.n1)
            root_mask = np.ones(dseg.n1, dtype=bool)
            run = compiled.executor()
            (_ts, _ti, _mc, final_mask, adjusted, _cs, _tm) = run(
                dseg.block_docs, dseg.block_impacts, dseg.deleted,
                jnp.asarray(qargs["blk_idx"]),
                jnp.asarray(qargs["slot_row"]),
                jnp.asarray(qargs["w_leaf"]),
                jnp.asarray(qargs["leaf_ind"]),
                jnp.asarray(qargs["group_ind"]),
                jnp.asarray(phrase_masks), jnp.asarray(filter_masks),
                jnp.asarray(col_vals), jnp.asarray(col_has),
                jnp.asarray(root_mask),
                jnp.float32(0.0), jnp.int32(2), jnp.int32(0),
                k=1, s_pad=qargs["s_pad"], has_scored_terms=has_scored,
                need_scores=True, use_cursor=False)
            seg_scores[dseg.ord] = np.asarray(adjusted)
            seg_masks[dseg.ord] = np.asarray(final_mask)
            stats["postings_advanced"] += qargs["postings_touched"]

        mode = rescore_req.score_mode
        for h in hits[:window]:
            ord_, doc = h.key.segment_ord, h.key.doc_id
            mask = seg_masks.get(ord_)
            if mask is None or not mask[doc]:
                continue
            rescore_score = float(seg_scores[ord_][doc])
            stats["scored_docs"] += 1
            orig = h.score
            if mode in ("total", "sum"):
                combined = orig + rescore_score
            elif mode == "multiply":
                combined = orig * rescore_score
            elif mode == "max":
                combined = max(orig, rescore_score)
            else:
                combined = min(orig, rescore_score)
            h.score = combined
            if h.explanation is not None:
                h.explanation["rescore"] = {
                    "rescore_score": rescore_score,
                    "combined_score": combined,
                }
            elif req.explain:
                h.explanation = {
                    "base_score": orig,
                    "functions": [],
                    "rescore": {"rescore_score": rescore_score,
                                "combined_score": combined},
                    "final_score": combined,
                }
            # update score-part of the key so re-sorting reflects rescore
            if sort_plan.uses_score():
                parts = list(h.key.parts)
                for i, f in enumerate(sort_plan.fields):
                    if f.kind == "score":
                        parts[i] = combined
                h.key = SortKey(parts, h.key.orders, h.key.segment_ord,
                                h.key.doc_id)
        hits[:window] = sorted(hits[:window], key=lambda h: _KeyWrap(h.key))

    # -- collapse -----------------------------------------------------------------

    def _collapse_hits(self, hits: list[RankedHit], collapse, sort_plan
                       ) -> list[tuple[RankedHit, list[RankedHit]]]:
        field = collapse.field
        groups: dict[Any, tuple[RankedHit, list[RankedHit]]] = {}
        order: list[Any] = []
        for h in hits:
            seg = self.segments[h.key.segment_ord]
            col = seg.fast.column(field)
            if col is not None and col.is_list:
                raise QueryError(
                    f"collapse field `{field}` must be single-valued")
            values = seg.fast.str_values(field, h.key.doc_id)
            group_key = values[0] if values else None
            if group_key not in groups:
                groups[group_key] = (h, [])
                order.append(group_key)
            else:
                groups[group_key][1].append(h)
        out = []
        for group_key in order:
            top, inner = groups[group_key]
            if collapse.inner_hits is not None:
                ih = collapse.inner_hits
                if ih.sort:
                    inner_plan = SortPlan.from_request(self.schema, ih.sort)
                    rekeyed = [
                        RankedHit(
                            key=inner_plan.build_key(
                                self.segments[x.key.segment_ord].fast,
                                x.key.doc_id, x.score, x.key.segment_ord),
                            score=x.score, explanation=x.explanation)
                        for x in inner
                    ]
                    rekeyed.sort(key=lambda h: _KeyWrap(h.key))
                    inner = rekeyed
                start = ih.from_
                size = ih.size if ih.size is not None else 3
                inner = inner[start:start + size]
            else:
                inner = []
            out.append((top, inner))
        return out

    # -- suggest ------------------------------------------------------------------

    def _execute_suggest(self, suggest_reqs) -> dict:
        out = {}
        for name, sreq in suggest_reqs.items():
            if self.schema.field_kind(sreq.field) not in ("text", "keyword"):
                raise QueryError(
                    f"suggest field `{sreq.field}` must be text or keyword")
            analyzer = self.analysis.search_analyzer(sreq.field)
            prefix = sreq.prefix
            if analyzer is not None:
                prefix = analyzer.normalize_pattern(prefix)
            else:
                prefix = prefix.lower()
            candidates: dict[str, float] = {}
            doc_freqs: dict[str, int] = {}
            field_prefix_len = len(sreq.field) + 1

            def consider(term: str, seg, tid):
                _docs, tfs = seg.postings.term_postings(tid)
                score = float(tfs.sum())
                candidates[term] = candidates.get(term, 0.0) + score
                doc_freqs[term] = doc_freqs.get(term, 0) + \
                    int(seg.postings.term_df[tid])

            for seg in self.segments:
                scanned = 0
                for key, tid in seg.terms.iter_prefix(
                        f"{sreq.field}:{prefix}"):
                    if scanned >= MAX_SUGGEST_CANDIDATES:
                        break
                    term = key[field_prefix_len:]
                    consider(term, seg, tid)
                    scanned += 1
            if sreq.fuzzy is not None and len(candidates) < sreq.size:
                max_edits = min(sreq.fuzzy.max_edits, 2)
                plen = min(sreq.fuzzy.prefix_length, len(prefix))
                for seg in self.segments:
                    scanned = 0
                    for key, tid in seg.terms.iter_prefix(
                            f"{sreq.field}:{prefix[:plen]}"):
                        if scanned >= MAX_SUGGEST_CANDIDATES:
                            break
                        term = key[field_prefix_len:]
                        scanned += 1
                        if term in candidates:
                            continue
                        candidate_prefix = term[:len(prefix)]
                        if bounded_levenshtein(
                                prefix, candidate_prefix,
                                max_edits) is not None:
                            consider(term, seg, tid)
            ranked = sorted(candidates.items(),
                            key=lambda kv: (-kv[1], kv[0]))[:sreq.size]
            out[name] = {
                "options": [
                    {"text": term, "score": score,
                     "doc_freq": doc_freqs.get(term, 0)}
                    for term, score in ranked
                ]
            }
        return out

    # -- hit materialization --------------------------------------------------------

    def _materialize_hit(self, ranked: RankedHit, req,
                         highlight_terms: list[str],
                         phrase_terms: dict) -> Optional[Hit]:
        seg = self.segments[ranked.key.segment_ord]
        doc = ranked.key.doc_id
        if doc >= seg.doc_count:
            return None
        doc_id_str = seg.doc_id(doc)
        need_doc = (req.return_stored or req.highlight_field is not None
                    or req.highlight is not None)
        doc_cache = None
        if need_doc:
            try:
                doc_cache = seg.get_doc(doc)
            except Exception:  # noqa: BLE001
                doc_cache = None

        snippet = None
        if req.highlight_field is not None and doc_cache is not None:
            text_val = doc_cache.get(req.highlight_field)
            if isinstance(text_val, str):
                phrases = self._normalize_phrases(
                    phrase_terms.get(req.highlight_field, []),
                    req.highlight_field)
                snippet = make_snippet(text_val, highlight_terms, phrases)

        highlights = None
        if req.highlight is not None and doc_cache is not None:
            highlights = {}
            for field, opts in req.highlight.fields.items():
                text_val = doc_cache.get(field)
                if not isinstance(text_val, str):
                    continue
                analyzer = self.analysis.search_analyzer(field)
                if analyzer is not None:
                    seen = set()
                    terms = []
                    for term in highlight_terms:
                        for tok in analyzer.analyze(term):
                            if tok.text not in seen:
                                seen.add(tok.text)
                                terms.append(tok.text)
                else:
                    terms = list(highlight_terms)
                phrases = self._normalize_phrases(
                    phrase_terms.get(field, []), field)
                frags = highlight_fragments(
                    text_val, terms, phrases,
                    HighlightOptions(opts.pre_tag, opts.post_tag,
                                     opts.fragment_size,
                                     opts.number_of_fragments))
                if frags:
                    highlights[field] = frags
            if not highlights:
                highlights = None

        return Hit(
            doc_id=doc_id_str,
            score=ranked.score,
            vector_score=ranked.vector_score,
            fields=doc_cache if req.return_stored else None,
            snippet=snippet,
            explanation=ranked.explanation,
            highlights=highlights,
            sort_key=ranked.key,
        )

    def _normalize_phrases(self, phrases: list[list[str]],
                           field: str) -> list[list[str]]:
        analyzer = self.analysis.search_analyzer(field)
        if analyzer is None:
            return phrases
        out = []
        for phrase in phrases:
            tokens = analyzer.analyze(" ".join(phrase))
            if tokens:
                out.append([t.text for t in tokens])
        return out


class _KeyWrap:
    """functools-friendly comparison wrapper around SortKey."""

    __slots__ = ("key",)

    def __init__(self, key: SortKey):
        self.key = key

    def __lt__(self, other):
        return self.key._cmp(other.key) < 0


def _plan_sig(plan: QueryPlan) -> str:
    def matcher_sig(m) -> str:
        if m.kind in ("term", "phrase"):
            return f"{m.kind}{m.payload}"
        if m.kind == "match_all":
            return "all"
        if m.kind == "query_string":
            p = m.payload
            return (f"qs({p['term_groups']},{p['phrase_groups']},"
                    f"{p['not_term_groups']},{p['minimum_should_match']})")
        if m.kind == "dis_max":
            return "dm(" + ",".join(matcher_sig(c) for c in m.payload) + ")"
        p = m.payload
        return ("bool(" + ",".join(matcher_sig(c) for c in p["must"]) + ";"
                + ",".join(matcher_sig(c) for c in p["should"]) + ";"
                + ",".join(matcher_sig(c) for c in p["must_not"]) + ";"
                + json.dumps([f.to_json() for f in p["filter"]],
                             sort_keys=True)
                + f";{p['minimum_should_match']})")

    def node_sig(n) -> str:
        base = f"{n.kind}[{n.expr.signature() if n.expr else ''}]"
        if n.params:
            safe = {k: v for k, v in n.params.items()
                    if k not in ("matcher", "base")}
            try:
                base += json.dumps(safe, sort_keys=True, default=repr)
            except TypeError:
                base += repr(sorted(safe))
            if "matcher" in n.params:
                base += matcher_sig(n.params["matcher"])
            if "base" in n.params:
                base += node_sig(n.params["base"])
        return base + "(" + ",".join(node_sig(c) for c in n.children) + ")"

    scorer_sig = plan.scorer.signature() if plan.scorer else "-"
    return (f"{matcher_sig(plan.matcher)}|{scorer_sig}|"
            f"{node_sig(plan.score_tree)}|{plan.leaf_count}|"
            f"{len(plan.term_groups)}|{len(plan.phrase_specs)}")
