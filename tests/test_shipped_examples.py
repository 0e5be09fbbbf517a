"""Run every shipped example suite (examples/*/): build the index from
schema.json + docs.jsonl, execute each queries/*.json, check the
embedded expectations."""

import glob
import json
import os

import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(
    d for d in glob.glob(os.path.join(HERE, "examples", "*"))
    if os.path.isdir(d))


def build(example_dir):
    with open(os.path.join(example_dir, "schema.json")) as f:
        schema = Schema.from_json(json.load(f))
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY), schema)
    writer = index.writer()
    with open(os.path.join(example_dir, "docs.jsonl")) as f:
        for line in f:
            if line.strip():
                writer.add_document(json.loads(line))
    writer.commit()
    return index


def example_cases():
    for d in EXAMPLES:
        for q in sorted(glob.glob(os.path.join(d, "queries", "*.json"))):
            yield (os.path.basename(d), q)


@pytest.mark.parametrize("suite,query_path",
                         list(example_cases()),
                         ids=lambda v: os.path.basename(str(v)).replace(
                             ".json", ""))
def test_shipped_example(suite, query_path):
    example_dir = os.path.dirname(os.path.dirname(query_path))
    index = build(example_dir)
    with open(query_path) as f:
        raw = json.load(f)
    expects = {k: raw.pop(k) for k in list(raw)
               if k.startswith("expect_")}
    result = index.reader().search(raw)
    ids = [h.doc_id for h in result.hits]
    if "expect_ids" in expects:
        assert ids == expects["expect_ids"], (query_path, ids)
    if "expect_ids_contain" in expects:
        assert set(expects["expect_ids_contain"]) <= set(ids), \
            (query_path, ids)
    if "expect_collection" in expects:
        for h in result.hits:
            assert h.fields.get("collection") == \
                expects["expect_collection"], (query_path, ids)
    if "expect_aggs" in expects:
        spec = expects["expect_aggs"]
        if "genres_top" in spec:
            got = sorted(b["key"] for b in
                         result.aggregations["genres"]["buckets"][:3])
            assert "|".join(got) == spec["genres_top"], result.aggregations


def test_examples_present():
    assert len(EXAMPLES) >= 2
    assert len(list(example_cases())) >= 10


def test_library_catalog_on_disk_roundtrip(tmp_path):
    """The richest example suite through FsStorage: write, reopen from
    disk (checksum verification included), and run every canned query."""
    d = os.path.join(HERE, "examples", "library-catalog")
    with open(os.path.join(d, "schema.json")) as f:
        schema = Schema.from_json(json.load(f))
    index = Index.create(
        IndexOptions(path=str(tmp_path / "idx"), create_if_missing=True),
        schema)
    writer = index.writer()
    with open(os.path.join(d, "docs.jsonl")) as f:
        for line in f:
            if line.strip():
                writer.add_document(json.loads(line))
    writer.commit()
    del index

    reopened = Index.open(IndexOptions(path=str(tmp_path / "idx"),
                                       create_if_missing=False))
    for qpath in sorted(glob.glob(os.path.join(d, "queries", "*.json"))):
        with open(qpath) as f:
            raw = json.load(f)
        expects = {k: raw.pop(k) for k in list(raw)
                   if k.startswith("expect_")}
        result = reopened.reader().search(raw)
        ids = [h.doc_id for h in result.hits]
        if "expect_ids" in expects:
            assert ids == expects["expect_ids"], (qpath, ids)
