"""IndexWriter: WAL-first upserts/deletes with atomic commits.

Parity with searchlite-core `api/writer.rs`:

- Every add/delete is appended + flushed to the WAL *before* being
  buffered (`writer.rs:74-104`); the constructor replays pending WAL
  ops so an uncommitted batch survives a crash (`writer.rs:37-72`).
- ``commit()`` under the global writer lock: reload the live-doc map
  if the manifest generation moved, fold ops last-write-wins into new
  docs + tombstones, write one new segment for the batch, merge
  tombstones into SegmentMeta.deleted_docs, store the manifest, append
  a WAL Commit marker, then truncate the WAL — rolling back manifest /
  WAL / new segment files on failure (`writer.rs:106-239`).
- ``rollback()`` clears pending ops + truncates the WAL.
"""

from __future__ import annotations

import logging
import os

from searchlite.errors import SearchliteError

logger = logging.getLogger("searchlite.writer")
from searchlite.index import Index
from searchlite.index.manifest import Manifest
from searchlite.index.segment import SegmentWriter
from searchlite.index.wal import ADD_DOC, DELETE_DOC_ID, Wal


def _segment_doc_ids(storage, seg_meta):
    """Ordinal-ordered doc-id array of one segment, cached process-
    wide by the segment's immutable uuid. The commit-time upsert
    locate needs ONLY this array; building a full SegmentReader per
    segment per commit read and parsed every segment file — O(corpus)
    per realtime commit. A cache miss reads just the segment meta
    JSON."""
    import numpy as np

    from searchlite.index import directory

    with _DOC_IDS_LOCK:
        hit = _DOC_IDS_CACHE.get(seg_meta.id)
    if hit is not None:
        return hit
    import json

    data = storage.read_to_end(
        directory.segment_paths(seg_meta.id).meta)
    arr = np.asarray(json.loads(data)["doc_ids"])
    with _DOC_IDS_LOCK:
        _DOC_IDS_CACHE[seg_meta.id] = arr
        while len(_DOC_IDS_CACHE) > 256:
            _DOC_IDS_CACHE.pop(next(iter(_DOC_IDS_CACHE)))
    return arr


_DOC_IDS_CACHE: dict = {}
import threading as _threading  # noqa: E402

_DOC_IDS_LOCK = _threading.Lock()

# background auto-merge: one worker thread per process, one pending
# request per Index — a commit that finds a merge already queued or
# running just leaves it to fold whatever is small when it executes
_MERGE_PENDING: set = set()
_MERGE_LOCK = _threading.Lock()


def _select_merge_tier(segments, small_docs: int, auto: int,
                       merging_ids=frozenset()):
    """Lucene-TieredMergePolicy-flavored selection: bucket the small
    segments by pow-4 doc-count tier and fold only the most crowded
    SMALLEST tier. The round-4 policy folded ALL small segments each
    pass, so every pass re-read and re-wrote the previous fold output
    until it graduated past ``small_docs`` — ~40x write amplification
    at 200-doc commit batches (measured as a 305-segment backlog on
    the async device A/B: the merge drain rate fell below the commit
    arrival rate and search latency rode the segment count). Tiers
    make each doc re-merge O(log4) times, which is what keeps the
    drain rate above any sustainable commit rate. Returns segment ids
    to fold, or None when no tier is over threshold."""
    import math

    tiers: dict[int, list] = {}
    for s in segments:
        if s.doc_count <= small_docs and s.id not in merging_ids:
            t = int(math.log(max(s.doc_count, 1), 4))
            tiers.setdefault(t, []).append(s)
    for t in sorted(tiers):
        if len(tiers[t]) > auto:
            return [s.id for s in tiers[t][:64]]
    return None


def _submit_background_merge(index, small_docs: int,
                             auto: int) -> None:
    key = id(index)
    with _MERGE_LOCK:
        if key in _MERGE_PENDING:
            return
        _MERGE_PENDING.add(key)

    def run():
        try:
            # drain loop: fold tier after tier (cascades included —
            # four 200-doc folds become an 800-doc tier, and so on)
            # until no tier is over threshold, so one thread catches
            # the backlog up without waiting for new commit triggers
            while True:
                manifest = index.reload_manifest()
                sel = _select_merge_tier(manifest.segments,
                                         small_docs, auto)
                if sel is None:
                    break
                if index.merge_segments(segment_ids=sel) == 0:
                    break
        except Exception:  # noqa: BLE001 — next commit re-triggers
            logger.exception("background auto-merge failed")
        finally:
            with _MERGE_LOCK:
                _MERGE_PENDING.discard(key)

    _threading.Thread(target=run, name="searchlite-auto-merge",
                      daemon=True).start()


def wait_for_background_merges(timeout: float | None = 60.0) -> None:
    """Block until no background auto-merge is pending (tests and
    orderly shutdowns). ``timeout=None`` waits however long the fold
    takes (the CLI uses this: killing a one-shot process early would
    abandon the fold mid-write)."""
    import time

    deadline = None if timeout is None else time.monotonic() + timeout
    while deadline is None or time.monotonic() < deadline:
        with _MERGE_LOCK:
            if not _MERGE_PENDING:
                return
        time.sleep(0.01)
    raise TimeoutError("background merges still pending")


class IndexWriter:
    def __init__(self, index: Index):
        self.index = index
        self.wal = Wal(index.storage)
        # op list preserving order: ("add", doc) | ("delete", doc_id)
        self._ops: list[tuple[str, object]] = []
        self._generation = index.manifest.generation
        # crash replay: uncommitted WAL ops become pending again
        for entry_type, payload in Wal.last_pending_ops(index.storage):
            if entry_type == ADD_DOC:
                self._ops.append(("add", payload))
            elif entry_type == DELETE_DOC_ID:
                self._ops.append(("delete", payload))

    # -- buffered operations -------------------------------------------------

    def add_document(self, doc: dict) -> None:
        self.index.schema.validate_document(doc)
        self.wal.append_add_doc(doc)
        self._ops.append(("add", doc))

    def add_documents(self, docs: list[dict],
                      raws: list[bytes | None] | None = None) -> None:
        """Bulk add: validates EVERY document before any WAL append
        (all-or-nothing on validation errors; the per-doc form appends
        each doc as it validates), then writes the WAL entries in one
        storage append.

        ``raws`` (optional): per-doc raw JSON bytes from an NDJSON
        surface; passed through to the WAL so entries splice the
        client's bytes instead of re-serializing (see
        ``Wal.append_add_docs``)."""
        self.index.schema.validate_documents(docs)
        self.wal.append_add_docs(docs, raws=raws)
        self._ops.extend(("add", doc) for doc in docs)

    def delete_document(self, doc_id: str) -> None:
        self.wal.append_delete_doc_id(doc_id)
        self._ops.append(("delete", doc_id))

    def delete_documents(self, doc_ids: list[str]) -> None:
        self.wal.append_delete_doc_ids(doc_ids)
        self._ops.extend(("delete", doc_id) for doc_id in doc_ids)

    def rollback(self) -> None:
        self._ops.clear()
        self.wal.truncate()

    @property
    def pending_ops(self) -> int:
        return len(self._ops)

    # -- commit ----------------------------------------------------------------

    def commit(self) -> None:
        if not self._ops:
            return
        with self.index.writer_lock:
            manifest = self.index.reload_manifest()

            # Fold ops: last-write-wins per doc id.
            pending_new: dict[str, dict] = {}
            tombstones: set[str] = set()
            for op, payload in self._ops:
                if op == "add":
                    doc_id = payload.get(manifest.schema.doc_id_field)
                    pending_new[doc_id] = payload
                    tombstones.discard(doc_id)
                else:
                    tombstones.add(payload)
                    pending_new.pop(payload, None)

            # Locate prior versions of upserted/deleted ids across
            # segments. Every add is an upsert candidate, so this runs
            # on every commit against existing segments — vectorized
            # (sorted-ids searchsorted) instead of a per-doc Python
            # set lookup, which was O(corpus) per commit.
            ids_to_remove = set(pending_new) | tombstones
            new_deleted: dict[str, set[int]] = {}
            if ids_to_remove and manifest.segments:
                import numpy as np

                ids_sorted = np.sort(np.asarray(list(ids_to_remove)))
                for seg_meta in manifest.segments:
                    docs_arr = _segment_doc_ids(self.index.storage,
                                                seg_meta)
                    if not docs_arr.size:
                        continue
                    pos = np.searchsorted(ids_sorted, docs_arr)
                    pos = np.minimum(pos, len(ids_sorted) - 1)
                    ords = np.nonzero(ids_sorted[pos] == docs_arr)[0]
                    if not ords.size:
                        continue
                    existing = set(seg_meta.deleted_docs)
                    hit = {int(o) for o in ords} - existing
                    if hit:
                        new_deleted.setdefault(
                            seg_meta.id, set()).update(hit)

            new_segment = None
            if pending_new:
                writer = SegmentWriter(
                    manifest.schema, self.index.storage,
                    enable_positions=self.index.options.enable_positions,
                    compress=self.index.options.compress_docstore)
                next_gen = max(
                    (s.generation for s in manifest.segments), default=0) + 1
                # docs were validated in add_document (WAL-first path)
                new_segment = writer.write_segment(
                    list(pending_new.values()), next_gen, validate=False)

            old_manifest_json = manifest.to_json()
            for seg_meta in manifest.segments:
                extra = new_deleted.get(seg_meta.id)
                if extra:
                    seg_meta.deleted_docs = sorted(
                        set(seg_meta.deleted_docs) | extra)
            if new_segment is not None:
                manifest.segments.append(new_segment)
            manifest.generation += 1

            try:
                manifest.store(self.index.storage)
                self.wal.append_commit()
                self.wal.truncate()
            except Exception as e:
                # roll back: restore old manifest, drop new segment files
                try:
                    import json as _json

                    self.index.storage.atomic_write(
                        "MANIFEST.json",
                        _json.dumps(old_manifest_json, indent=2).encode())
                except Exception:  # noqa: BLE001
                    pass
                if new_segment is not None:
                    self.index.cleanup_segments([new_segment.id])
                raise SearchliteError(f"commit failed: {e}") from e

            self.index.set_manifest(manifest)
            logger.debug(
                "commit: %d new docs, %d tombstoned, generation %d",
                len(pending_new), sum(len(s) for s in new_deleted.values()),
                manifest.generation)
            self._ops.clear()
            self._generation = manifest.generation

            # opt-in tiered auto-merge: once more than N small segments
            # accumulate, structurally fold them into one
            # (Index.merge_segments — no stored fields needed). This is
            # the log-structured write story's read-side bound AND the
            # host tier's graduation path: merged realtime segments
            # cross SEARCHLITE_HOST_TIER_DOCS and re-enter the cache
            # HBM-resident.
            opts = self.index.options
            auto = int(os.environ.get(
                "SEARCHLITE_AUTO_MERGE",
                getattr(opts, "auto_merge_segments", 0) or 0))
            stall_params = None
            if auto > 0:
                opt_docs = getattr(opts, "auto_merge_docs", None)
                # HOST_TIER_DOCS=0 means "tier disabled", never "merge
                # nothing" — fall back to the default threshold there
                tier_docs = int(os.environ.get(
                    "SEARCHLITE_HOST_TIER_DOCS", "16384")) or 16384
                small_docs = int(os.environ.get(
                    "SEARCHLITE_AUTO_MERGE_DOCS",
                    opt_docs if opt_docs is not None else tier_docs))
                async_merge = (os.environ.get(
                    "SEARCHLITE_AUTO_MERGE_ASYNC") == "1"
                    or getattr(opts, "auto_merge_async", False))
                if async_merge:
                    # Lucene-ConcurrentMergeScheduler-style: fold on a
                    # background thread so commit latency never pays
                    # the merge; the drain loop re-selects tier by
                    # tier under the writer lock, so racing commits
                    # are safe. Backpressure (the stall loop below)
                    # runs AFTER this commit releases the writer lock
                    # — the background swap needs it.
                    if _select_merge_tier(manifest.segments,
                                          small_docs, auto) is not None:
                        _submit_background_merge(self.index,
                                                 small_docs, auto)
                    stall_params = (small_docs, auto)
                else:
                    while True:
                        sel = _select_merge_tier(
                            self.index.manifest.segments, small_docs,
                            auto)
                        if sel is None:
                            break
                        if self.index.merge_segments(
                                segment_ids=sel) == 0:
                            break
                    self._generation = \
                        self.index.manifest.generation
        if stall_params is not None:
            self._stall_for_merges(*stall_params)

    def _stall_for_merges(self, small_docs: int, auto: int) -> None:
        """Lucene-style merge stall: when async indexing outruns the
        background merge drain, block the WRITER (never searches)
        until the small-segment backlog shrinks below the stall cap,
        so per-search cost — which scales with live segment count —
        stays bounded. Measured without this on the 1-CPU device A/B:
        305 live segments mid-run and 113 s search p50. Off by
        default unless async merge is on; SEARCHLITE_AUTO_MERGE_STALL
        sets the cap in segments (0 disables)."""
        import time as _time

        stall = int(os.environ.get("SEARCHLITE_AUTO_MERGE_STALL",
                                   str(auto * 6)))
        if stall <= 0:
            return
        deadline = _time.monotonic() + 300.0
        warned = False
        while _time.monotonic() < deadline:
            manifest = self.index.reload_manifest()
            small_n = sum(1 for s in manifest.segments
                          if s.doc_count <= small_docs)
            # exit when the backlog is bounded OR as drained as the
            # tier policy allows (balanced tiers can legitimately hold
            # ~auto segments per pow-4 tier with nothing foldable —
            # waiting on that state would spin the full deadline)
            if small_n <= stall or _select_merge_tier(
                    manifest.segments, small_docs, auto) is None:
                return
            if not warned:
                logger.debug("merge stall: %d small segments > cap %d",
                             small_n, stall)
                warned = True
            # re-arm in case the drain thread exited between commits
            _submit_background_merge(self.index, small_docs, auto)
            _time.sleep(0.05)
        logger.warning("merge stall timed out after 300s")
