"""Acceptance tests against the reference's example suites
(acceptance configs 1-3): docs.jsonl quickstart flow and the
recipes/video-games canned request JSONs."""

import json
import os

import pytest

from searchlite.api.types import IndexOptions, StorageType
from searchlite.index import Index
from searchlite.index.manifest import Schema

REF = "/root/reference"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference fixtures not mounted")


def mem_index(schema_json):
    return Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json(schema_json))


def load_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class TestQuickstart:
    """Config 1: docs.jsonl + README quickstart schema."""

    SCHEMA = {
        "text_fields": [{"name": "body", "analyzer": "default",
                         "stored": True, "indexed": True}],
        "keyword_fields": [{"name": "lang", "stored": True, "indexed": True,
                            "fast": True}],
        "numeric_fields": [{"name": "year", "i64": True, "fast": True,
                            "stored": True}],
    }

    def test_docs_jsonl_flow(self):
        index = mem_index(self.SCHEMA)
        writer = index.writer()
        docs = load_jsonl(f"{REF}/docs.jsonl")
        writer.add_documents(docs)
        writer.commit()
        reader = index.reader()
        res = reader.search({
            "query": {"type": "query_string", "query": "rust language",
                      "fields": ["body"]},
            "filter": {"And": [
                {"KeywordEq": {"field": "lang", "value": "en"}},
                {"I64Range": {"field": "year", "min": 2020, "max": 2025}},
            ]},
            "limit": 5,
            "return_stored": True,
        })
        assert res.total_hits_estimate >= 1
        assert res.hits[0].doc_id == "doc-1"


def _mark_nested_nullable(props):
    for prop in props:
        prop["nullable"] = True
        if prop.get("type") == "object":
            _mark_nested_nullable(prop.get("fields", []))


@pytest.fixture(scope="module")
def recipes_reader():
    schema = json.load(open(f"{REF}/examples/recipes/schema.json"))
    # NOTE: the upstream example data omits optional nested props (e.g.
    # ingredients[].prep) that its own schema marks required — the
    # reference's validate_document (`index/manifest.rs:325-351`) would
    # reject it too. Mark nested props nullable to ingest the data.
    for nested in schema.get("nested_fields", []):
        _mark_nested_nullable(nested.get("fields", []))
    index = mem_index(schema)
    writer = index.writer()
    writer.add_documents(load_jsonl(f"{REF}/examples/recipes/data.jsonl"))
    writer.commit()
    return index.reader()


class TestRecipes:
    """Config 2: the recipes example with its canned request JSONs."""

    def queries(self):
        qdir = f"{REF}/examples/recipes/queries"
        return sorted(os.listdir(qdir))

    def test_all_canned_queries_execute(self, recipes_reader):
        qdir = f"{REF}/examples/recipes/queries"
        executed = 0
        for name in self.queries():
            request = json.load(open(f"{qdir}/{name}"))
            res = recipes_reader.search(request)
            assert res is not None, name
            executed += 1
        assert executed >= 10

    def test_weeknight_orzo_vegetarian(self, recipes_reader):
        request = json.load(open(
            f"{REF}/examples/recipes/queries/weeknight-orzo-vegetarian.json"))
        res = recipes_reader.search(request)
        assert res.total_hits_estimate >= 1
        assert any("orzo" in json.dumps(h.to_json()).lower()
                   for h in res.hits)

    def test_fuzzy_weeknight_orzo(self, recipes_reader):
        request = json.load(open(
            f"{REF}/examples/recipes/queries/fuzzy-weeknight-orzo.json"))
        res = recipes_reader.search(request)
        assert res.total_hits_estimate >= 1

    def test_agg_macros_by_diet(self, recipes_reader):
        request = json.load(open(
            f"{REF}/examples/recipes/queries/agg-macros-by-diet.json"))
        res = recipes_reader.search(request)
        assert res.aggregations


class TestVideoGamesQueries:
    """Config 3: video-games canned queries (schema-only example —
    no data.jsonl upstream), validated against synthetic docs."""

    def test_schema_loads_and_queries_parse(self):
        schema = json.load(open(f"{REF}/examples/video-games/schema.json"))
        # Upstream declares doc_id both as doc_id_field and as a keyword
        # field; the reference's validate_config rejects that overlap
        # (`index/manifest.rs:141-150`), so drop the duplicate column.
        schema["keyword_fields"] = [
            f for f in schema["keyword_fields"] if f["name"] != "doc_id"]
        index = mem_index(schema)
        writer = index.writer()
        writer.add_document({
            "doc_id": "g1", "doc_type": "review", "title": "Great game",
            "text": "a modern speedrun classic on ps5",
            "summary": "solid", "era": "modern", "platforms": ["ps5"],
            "genres": ["action"], "language": "en",
            "release_year": 2022, "review_score_out_of_10": 9.5,
            "game": {"game_id": "game-1", "name": "Zelda Like"},
        })
        writer.commit()
        reader = index.reader()
        qdir = f"{REF}/examples/video-games/queries"
        from searchlite.api.types import SearchRequest

        parsed = 0
        for name in sorted(os.listdir(qdir)):
            request = json.load(open(f"{qdir}/{name}"))
            SearchRequest.from_json(request)  # must parse
            parsed += 1
        assert parsed >= 10
        res = reader.search({"query": "speedrun", "limit": 5})
        assert res.total_hits_estimate == 1

    def test_canned_queries_against_crafted_docs(self):
        schema = json.load(open(f"{REF}/examples/video-games/schema.json"))
        schema["keyword_fields"] = [
            f for f in schema["keyword_fields"] if f["name"] != "doc_id"]
        index = mem_index(schema)
        writer = index.writer()
        writer.add_documents([
            {
                "doc_id": "route-1", "doc_type": "speedrun_route",
                "era": "retro", "category": "Any%",
                "title": "Sub-100 route", "language": "en",
                "text": "speedrun routing momentum preservation through "
                        "the castle skip",
                "target_time_minutes": 95,
                "splits": [
                    {"split": "castle escape", "target_time_min": 20},
                    {"split": "boss rush momentum", "target_time_min": 45},
                ],
                "techniques": ["wall clip", "momentum preservation"],
            },
            {
                "doc_id": "cheat-1", "doc_type": "cheat_codes",
                "era": "retro", "title": "Classic cheats", "language": "en",
                "platforms": ["NES"],
                "text": "cheat code listing",
                "codes": [
                    {"input": "up up down down",
                     "effect": "Infinite Lives granted in debug mode"},
                ],
            },
            {
                "doc_id": "review-1", "doc_type": "review", "era": "modern",
                "title": "Modern review", "language": "en",
                "text": "a modern masterpiece on ps5",
                "platforms": ["ps5"], "release_year": 2023,
                "review_score_out_of_10": 9.2,
                "game": {"game_id": "g-1", "name": "Example Quest"},
            },
        ])
        writer.commit()
        reader = index.reader()
        qdir = f"{REF}/examples/video-games/queries"

        route = json.load(open(f"{qdir}/speedrun-route-sub100.json"))
        res = reader.search(route)
        assert [h.doc_id for h in res.hits] == ["route-1"]
        assert res.hits[0].snippet is not None

        cheat = json.load(open(f"{qdir}/retro-cheat-infinite-lives.json"))
        res2 = reader.search(cheat)
        assert [h.doc_id for h in res2.hits] == ["cheat-1"]

        aggs = json.load(open(f"{qdir}/aggregations-era-platforms.json"))
        res3 = reader.search(aggs)
        assert res3.aggregations

        # every canned query must execute without error on this corpus
        for name in sorted(os.listdir(qdir)):
            request = json.load(open(f"{qdir}/{name}"))
            reader.search(request)
