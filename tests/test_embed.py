"""Embedding API roundtrip (parity: `searchlite-ffi/src/lib.rs:197-264`)."""

import json

from searchlite import embed


def test_ffi_style_roundtrip(tmp_path):
    handle = embed.searchlite_index_open(str(tmp_path / "idx"))
    assert handle != 0
    assert embed.searchlite_add_json(
        handle, json.dumps({"_id": "1", "body": "hello embedded world"})) == 0
    out = embed.searchlite_search(handle, "embedded", limit=5)
    assert out is not None
    result = json.loads(out)
    assert result["total_hits_estimate"] == 1
    assert result["hits"][0]["doc_id"] == "1"
    # QueryNode JSON form
    out2 = embed.searchlite_search(handle, json.dumps(
        {"type": "term", "field": "body", "value": "hello"}))
    assert json.loads(out2)["total_hits_estimate"] == 1
    # aggs passthrough: the default schema has no fast fields, so the
    # validation error surfaces as the FFI error sentinel (None)
    out3 = embed.searchlite_search(
        handle, "hello", aggs_json=json.dumps(
            {"c": {"type": "value_count", "field": "body"}}))
    assert out3 is None
    embed.searchlite_index_close(handle)
    assert embed.searchlite_add_json(handle, "{}") == -1
    assert embed.searchlite_search(handle, "x") is None


def test_bad_handle_and_bad_json(tmp_path):
    assert embed.searchlite_add_json(999999, "{}") == -1
    handle = embed.searchlite_index_open(str(tmp_path / "idx2"))
    assert embed.searchlite_add_json(handle, "not json") == -1
    embed.searchlite_index_close(handle)
