"""BASELINE config sweep timings: the reference's
example workloads, run end-to-end and TIMED — one JSON line per
scenario. Configs (BASELINE.md):

1. quickstart — `docs.jsonl` + `index-schema.json` through the CLI
   surface (init/add/commit/search, in-process `cli.main`).
2. recipes — phrase + multi-field highlighting + edge_ngram prefix
   over `examples/recipes/data.jsonl`, all canned request JSONs.
3. video-games — keyword/numeric fast fields + nested filters over a
   synthetic corpus in the example's schema, all canned request JSONs.

Config 4 (MS MARCO) is tools/bench_scale.py (data not mounted; the
synthetic stand-in is validated there); config 5 (vector/hybrid) is
covered by benches/micro.py's vector_only_10k / hybrid_blend_10k.

Usage: python benches/configs.py  (add --cpu to pin the CPU backend)
"""

from __future__ import annotations

import json
import os
import random
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

REF = "/root/reference"


def emit(**kv):
    print(json.dumps(kv), flush=True)


def load_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def p50(latencies):
    return round(sorted(latencies)[len(latencies) // 2] * 1000, 2)


def time_queries(reader, requests, reps=5):
    for r in requests:  # warm / compile
        reader.search(r)
    lat = []
    for _ in range(reps):
        for r in requests:
            t0 = time.perf_counter()
            reader.search(r)
            lat.append(time.perf_counter() - t0)
    return p50(lat)


QUICKSTART_SCHEMA = {
    # the README quickstart's index schema (docs.jsonl fields;
    # /root/reference/index-schema.json is the META-schema)
    "text_fields": [{"name": "body", "analyzer": "default",
                     "stored": True, "indexed": True}],
    "keyword_fields": [{"name": "lang", "stored": True,
                        "indexed": True, "fast": True}],
    "numeric_fields": [{"name": "year", "i64": True, "fast": True,
                        "stored": True}],
}


def config1_quickstart():
    from searchlite import cli

    with tempfile.TemporaryDirectory() as tmp:
        idx_dir = os.path.join(tmp, "idx")
        schema_path = os.path.join(tmp, "schema.json")
        with open(schema_path, "w") as f:
            json.dump(QUICKSTART_SCHEMA, f)
        t0 = time.perf_counter()
        assert cli.main(["init", idx_dir, schema_path]) == 0
        assert cli.main(["add", idx_dir, f"{REF}/docs.jsonl"]) == 0
        assert cli.main(["commit", idx_dir]) == 0
        ingest_s = time.perf_counter() - t0
        # search via the CLI surface (stdout captured implicitly)
        import contextlib
        import io

        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.main(["search", idx_dir, "-q",
                                 "rust search", "--limit", "5"]) == 0
            lat.append(time.perf_counter() - t0)
            out = json.loads(buf.getvalue())
            assert out["hits"], "quickstart search returned no hits"
        emit(bench="config1_quickstart_cli", unit="ms",
             value=p50(lat), ingest_s=round(ingest_s, 2))


def _mark_nested_nullable(props):
    # upstream example data omits optional nested props its own schema
    # marks required (see tests/test_examples.py)
    for prop in props:
        prop["nullable"] = True
        if prop.get("type") == "object":
            _mark_nested_nullable(prop.get("fields", []))


def config2_recipes():
    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    schema = json.load(open(f"{REF}/examples/recipes/schema.json"))
    for nested in schema.get("nested_fields", []):
        _mark_nested_nullable(nested.get("fields", []))
    t0 = time.perf_counter()
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json(schema))
    writer = index.writer()
    writer.add_documents(load_jsonl(f"{REF}/examples/recipes/data.jsonl"))
    writer.commit()
    ingest_s = time.perf_counter() - t0
    reader = index.reader()
    qdir = f"{REF}/examples/recipes/queries"
    requests = [json.load(open(f"{qdir}/{n}"))
                for n in sorted(os.listdir(qdir))]
    emit(bench="config2_recipes_canned_queries", unit="ms",
         value=time_queries(reader, requests),
         n_queries=len(requests), ingest_s=round(ingest_s, 2))


def _videogames_docs(n=4000, seed=17):
    rng = random.Random(seed)
    eras = ["retro", "modern"]
    plats = ["NES", "SNES", "ps5", "pc", "switch"]
    genres = ["action", "rpg", "puzzle", "racing"]
    techniques = ["wall clip", "momentum preservation", "clip dash",
                  "frame skip"]
    docs = []
    for i in range(n):
        kind = rng.choice(["review", "speedrun_route", "cheat_codes",
                           "achievement_guide", "emulation_notes"])
        doc = {
            "doc_id": f"d{i}", "doc_type": kind,
            "era": rng.choice(eras), "language": "en",
            "title": f"{rng.choice(['classic', 'modern'])} "
                     f"{rng.choice(['speedrun', 'review', 'guide'])} "
                     f"{i}",
            "text": " ".join(rng.choices(
                ["speedrun", "masterpiece", "castle", "momentum",
                 "cheat", "platinum", "crt", "shader", "emulation",
                 "score", "boss", "rush", "route", "classic", "ps5"],
                k=rng.randint(8, 30))),
        }
        if kind == "review":
            doc.update({
                "platforms": rng.sample(plats, k=rng.randint(1, 3)),
                "genres": rng.sample(genres, k=rng.randint(1, 2)),
                "release_year": rng.randint(1988, 2024),
                "review_score_out_of_10": round(rng.uniform(3, 10), 1),
                "game": {"game_id": f"g{i % 200}",
                         "name": f"Game {i % 200}"},
            })
        elif kind == "speedrun_route":
            doc.update({
                "category": rng.choice(["Any%", "100%"]),
                "target_time_minutes": rng.randint(30, 200),
                "splits": [{"split": f"s{j}",
                            "target_time_min": rng.randint(5, 60)}
                           for j in range(rng.randint(1, 4))],
                "techniques": rng.sample(techniques,
                                         k=rng.randint(1, 3)),
            })
        elif kind == "cheat_codes":
            doc.update({
                "platforms": rng.sample(plats, k=1),
                "codes": [{"input": "up up down down",
                           "effect": rng.choice(
                               ["Infinite Lives granted",
                                "debug mode"])}],
            })
        docs.append(doc)
    return docs


def config3_videogames():
    from searchlite.api.types import IndexOptions, StorageType
    from searchlite.index import Index
    from searchlite.index.manifest import Schema

    schema = json.load(open(f"{REF}/examples/video-games/schema.json"))
    schema["keyword_fields"] = [
        f for f in schema["keyword_fields"] if f["name"] != "doc_id"]
    t0 = time.perf_counter()
    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY),
        Schema.from_json(schema))
    writer = index.writer()
    writer.add_documents(_videogames_docs())
    writer.commit()
    ingest_s = time.perf_counter() - t0
    reader = index.reader()
    qdir = f"{REF}/examples/video-games/queries"
    requests = [json.load(open(f"{qdir}/{n}"))
                for n in sorted(os.listdir(qdir))]
    emit(bench="config3_videogames_canned_queries", unit="ms",
         value=time_queries(reader, requests),
         n_queries=len(requests), ingest_s=round(ingest_s, 2))


def main():
    if "--cpu" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
    if not os.path.isdir(REF):
        emit(error="reference fixtures not mounted")
        return
    config1_quickstart()
    config2_recipes()
    config3_videogames()


if __name__ == "__main__":
    main()
