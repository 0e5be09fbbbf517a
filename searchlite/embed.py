"""Embedding API: the reference's C-FFI surface as JSON-in/JSON-out.

The reference exposes 5 unsafe extern fns for embedding from C
(`searchlite-ffi/src/lib.rs:20-195`): index_open/close, add_json (adds
AND commits), commit, search (query string or QueryNode JSON + optional
aggs, result JSON out). This module provides that contract as stable
functions over opaque handles and JSON strings; the REAL C ABI lives in
`native/slt_ffi.cpp` (built to `libsearchlite.so` with header
`native/searchlite.h` via `searchlite.native.build_ffi_lib()`),
which embeds CPython and delegates to these functions — so C hosts get
the same 5 symbols the reference ships.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from searchlite.api.types import IndexOptions, SearchRequest
from searchlite.errors import SearchliteError
from searchlite.index import Index

_HANDLES: dict[int, Index] = {}
_NEXT = [1]
_LOCK = threading.Lock()


def searchlite_index_open(path: str, create_if_missing: bool = True,
                          bm25_k1: float = 0.9, bm25_b: float = 0.4) -> int:
    """Open (or create) an index; returns an opaque handle (0 = error)."""
    try:
        index = Index.open(IndexOptions(
            path=path, create_if_missing=create_if_missing,
            bm25_k1=bm25_k1, bm25_b=bm25_b))
    except SearchliteError:
        return 0
    with _LOCK:
        handle = _NEXT[0]
        _NEXT[0] += 1
        _HANDLES[handle] = index
    return handle


def searchlite_index_close(handle: int) -> None:
    with _LOCK:
        _HANDLES.pop(handle, None)


def _index(handle: int) -> Optional[Index]:
    with _LOCK:
        return _HANDLES.get(handle)


def searchlite_add_json(handle: int, doc_json: str) -> int:
    """Add one JSON document AND commit (parity: `ffi/src/lib.rs`
    searchlite_add_json). Returns 0 on success, -1 on error."""
    index = _index(handle)
    if index is None:
        return -1
    try:
        doc = json.loads(doc_json)
        writer = index.writer()
        writer.add_document(doc)
        writer.commit()
        return 0
    except (SearchliteError, json.JSONDecodeError):
        return -1


def searchlite_commit(handle: int) -> int:
    index = _index(handle)
    if index is None:
        return -1
    try:
        index.writer().commit()
        return 0
    except SearchliteError:
        return -1


def searchlite_search(handle: int, query: str, limit: int = 10,
                      cursor: Optional[str] = None,
                      aggs_json: Optional[str] = None) -> Optional[str]:
    """Search with a query string or a QueryNode JSON object; returns the
    result as a JSON string (None on error)."""
    index = _index(handle)
    if index is None:
        return None
    try:
        raw = query.strip()
        if raw.startswith("{"):
            query_value = json.loads(raw)
        else:
            query_value = raw
        request = {"query": query_value, "limit": limit,
                   "return_stored": True}
        if cursor:
            request["cursor"] = cursor
        if aggs_json:
            request["aggs"] = json.loads(aggs_json)
        result = index.reader().search(SearchRequest.from_json(request))
        return json.dumps(result.to_json(), ensure_ascii=False)
    except (SearchliteError, json.JSONDecodeError):
        return None
