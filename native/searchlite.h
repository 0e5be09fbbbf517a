/* searchlite C embedding API.
 *
 * The same 5-function contract as the reference's C FFI surface
 * (`searchlite-ffi/src/lib.rs:20-195`, header `searchlite-ffi/searchlite.h`):
 * open/close an index by path, add a JSON document (adds AND commits),
 * commit, and search (query string or QueryNode JSON) with the result
 * JSON written into a caller buffer.
 *
 * The library embeds CPython and drives `searchlite.embed`; the
 * host process needs no Python code of its own, but `searchlite`
 * must be importable (set PYTHONPATH if it is not installed). If the
 * host application already embeds Python, the library piggybacks on
 * that interpreter; all functions are safe to call from any thread
 * (the GIL is acquired per call).
 *
 * Build: see `searchlite.native.build_ffi_lib()` or
 *   g++ -O3 -shared -fPIC -std=c++17 $(python3-config --includes) \
 *       slt_ffi.cpp -o libsearchlite.so \
 *       $(python3-config --embed --ldflags)
 */
#ifndef SEARCHLITE_H
#define SEARCHLITE_H

#ifdef __cplusplus
extern "C" {
#endif

/* Opaque index handle; 0 means error/invalid. */
typedef long long searchlite_handle;

/* Open (or create, when create_if_missing != 0) the index at `path`.
 * Returns 0 on failure. */
searchlite_handle searchlite_index_open(const char* path,
                                        int create_if_missing);

/* Close a handle. Idempotent; unknown handles are ignored. */
void searchlite_index_close(searchlite_handle handle);

/* Parse one JSON document, add it, and commit (matching the
 * reference's add-and-commit semantics). Returns 0 ok, -1 error. */
int searchlite_add_json(searchlite_handle handle, const char* doc_json);

/* Commit any pending operations. Returns 0 ok, -1 error. */
int searchlite_commit(searchlite_handle handle);

/* Search. `query` is either a query string ("title:hello world") or a
 * QueryNode JSON object ("{\"term\": ...}"). `cursor` and `aggs_json`
 * may be NULL. The full result JSON is written NUL-terminated into
 * `out` (up to out_cap bytes including the NUL).
 *
 * Returns the number of bytes required for the full result (excluding
 * the NUL) — if that is >= out_cap the output was truncated and the
 * caller should retry with a larger buffer — or -1 on error. */
long long searchlite_search(searchlite_handle handle, const char* query,
                            int limit, const char* cursor,
                            const char* aggs_json, char* out,
                            long long out_cap);

#ifdef __cplusplus
}
#endif

#endif /* SEARCHLITE_H */
