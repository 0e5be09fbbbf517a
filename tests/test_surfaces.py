"""CLI and HTTP surface tests (parity: `searchlite-cli/src/main.rs:541-679`
and the searchlite-http README smoke flow)."""

import json
import os
import threading
import urllib.request

import pytest

from searchlite.cli import main as cli_main

SCHEMA = {
    "text_fields": [
        {"name": "body", "analyzer": "default", "stored": True,
         "indexed": True}],
    "keyword_fields": [
        {"name": "lang", "stored": True, "indexed": True, "fast": True}],
    "numeric_fields": [
        {"name": "year", "i64": True, "fast": True, "stored": True}],
}

DOCS = [
    {"_id": "doc-1", "body": "Rust is a systems programming language",
     "lang": "en", "year": 2023},
    {"_id": "doc-2", "body": "SQLite is a small database engine",
     "lang": "en", "year": 2020},
    {"_id": "doc-3", "body": "GPUs accelerate dense linear algebra",
     "lang": "en", "year": 2024},
]


@pytest.fixture
def index_dir(tmp_path):
    schema_path = tmp_path / "schema.json"
    schema_path.write_text(json.dumps(SCHEMA))
    docs_path = tmp_path / "docs.jsonl"
    docs_path.write_text("\n".join(json.dumps(d) for d in DOCS))
    return tmp_path


class TestCli:
    def run(self, *args):
        return cli_main([str(a) for a in args])

    def test_init_add_commit_search(self, index_dir, capsys):
        idx = index_dir / "idx"
        assert self.run("init", idx, index_dir / "schema.json") == 0
        assert self.run("add", idx, index_dir / "docs.jsonl") == 0
        assert self.run("commit", idx) == 0
        capsys.readouterr()
        assert self.run("search", idx, "-q", "rust language",
                        "--return-stored") == 0
        out = json.loads(capsys.readouterr().out)
        assert out["total_hits_estimate"] >= 1
        assert out["hits"][0]["doc_id"] == "doc-1"
        assert out["hits"][0]["fields"]["body"].startswith("Rust")

    def test_search_with_filter_request_file(self, index_dir, capsys, tmp_path):
        idx = index_dir / "idx"
        self.run("init", idx, index_dir / "schema.json")
        self.run("add", idx, index_dir / "docs.jsonl")
        self.run("commit", idx)
        request = {
            "query": {"type": "query_string", "query": "rust language",
                      "fields": ["body"]},
            "filter": {"And": [
                {"KeywordEq": {"field": "lang", "value": "en"}},
                {"I64Range": {"field": "year", "min": 2020, "max": 2025}},
            ]},
            "limit": 5,
            "return_stored": True,
        }
        req_path = tmp_path / "request.json"
        req_path.write_text(json.dumps(request))
        capsys.readouterr()
        assert self.run("search", idx, "--request", req_path) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["hits"][0]["doc_id"] == "doc-1"

    def test_delete_and_inspect_and_compact(self, index_dir, capsys,
                                            tmp_path):
        idx = index_dir / "idx"
        self.run("init", idx, index_dir / "schema.json")
        self.run("add", idx, index_dir / "docs.jsonl")
        self.run("commit", idx)
        ids = tmp_path / "ids.txt"
        ids.write_text("doc-2\n")
        self.run("delete", idx, ids)
        self.run("commit", idx)
        capsys.readouterr()
        self.run("inspect", idx)
        manifest = json.loads(capsys.readouterr().out)
        assert sum(len(s["deleted_docs"]) for s in manifest["segments"]) == 1
        self.run("compact", idx)
        capsys.readouterr()
        self.run("search", idx, "-q", "sqlite")
        out = json.loads(capsys.readouterr().out)
        assert out["total_hits_estimate"] == 0

    def test_search_batch_subcommand(self, index_dir, capsys, tmp_path):
        idx = index_dir / "idx"
        self.run("init", idx, index_dir / "schema.json")
        self.run("add", idx, index_dir / "docs.jsonl")
        self.run("commit", idx)
        qfile = tmp_path / "queries.txt"
        qfile.write_text("database\n")
        capsys.readouterr()
        assert self.run("search-batch", idx, "-q", "rust",
                        "--queries-file", qfile, "--limit", 3) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["results"][0][0]["doc_id"] == "doc-1"
        assert out["results"][1][0]["doc_id"] == "doc-2"

    def test_sort_and_aggs_flags(self, index_dir, capsys):
        idx = index_dir / "idx"
        self.run("init", idx, index_dir / "schema.json")
        self.run("add", idx, index_dir / "docs.jsonl")
        self.run("commit", idx)
        capsys.readouterr()
        self.run("search", idx, "-q", "body:is", "--sort", "year:desc",
                 "--aggs", json.dumps({"langs": {"type": "terms",
                                                 "field": "lang"}}))
        out = json.loads(capsys.readouterr().out)
        years = [h["doc_id"] for h in out["hits"]]
        assert years == ["doc-1", "doc-2"]
        assert out["aggregations"]["langs"]["buckets"][0]["key"] == "en"


class TestHttp:
    @pytest.fixture
    def server(self, tmp_path):
        from searchlite.http_server import make_server

        server = make_server(str(tmp_path / "idx"), bind="127.0.0.1:0")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        host, port = server.server_address
        yield f"http://{host}:{port}"
        server.shutdown()

    def call(self, base, method, path, payload=None, raw=None,
             content_type="application/json"):
        data = raw if raw is not None else (
            json.dumps(payload).encode() if payload is not None else None)
        req = urllib.request.Request(
            f"{base}{path}", data=data, method=method,
            headers={"content-type": content_type} if data else {})
        try:
            with urllib.request.urlopen(req) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def test_full_lifecycle(self, server):
        status, body = self.call(server, "GET", "/healthz")
        assert status == 200 and body["status"] == "ok"

        status, body = self.call(server, "POST", "/search",
                                 {"query": "x", "limit": 1})
        assert status == 404
        assert body["error"]["type"] == "index_missing"

        status, body = self.call(server, "POST", "/init",
                                 {"schema": SCHEMA})
        assert status == 200 and body["created"]

        status, body = self.call(server, "POST", "/init", {"schema": SCHEMA})
        assert status == 409

        ndjson = "\n".join(json.dumps(d) for d in DOCS).encode()
        status, body = self.call(server, "POST", "/add", raw=ndjson,
                                 content_type="application/x-ndjson")
        assert status == 200 and body["queued"] == 3

        status, body = self.call(server, "POST", "/commit")
        assert status == 200 and body["committed"]

        status, body = self.call(server, "POST", "/search",
                                 {"query": "rust", "limit": 5})
        assert status == 200
        assert body["total_hits_estimate"] == 1
        assert body["hits"][0]["doc_id"] == "doc-1"

        status, body = self.call(server, "POST", "/search_batch",
                                 {"queries": ["rust", "nosuchterm"],
                                  "limit": 5})
        assert status == 200
        assert body["results"][0][0]["doc_id"] == "doc-1"
        assert body["results"][1] == []
        status, body = self.call(server, "POST", "/search_batch",
                                 {"queries": "rust"})
        assert status == 400

        status, body = self.call(server, "GET", "/stats")
        assert status == 200 and body["documents"] == 3

        status, body = self.call(server, "POST", "/bulk", {"docs": [
            {"_id": "doc-4", "body": "more rust content", "lang": "en",
             "year": 2025}]})
        assert status == 200 and body["queued"] == 1
        self.call(server, "POST", "/commit")

        status, body = self.call(server, "POST", "/search",
                                 {"query": "rust", "limit": 5})
        assert body["total_hits_estimate"] == 2

        status, body = self.call(server, "POST", "/delete",
                                 {"ids": ["doc-4"]})
        assert status == 200 and body["queued"] == 1
        self.call(server, "POST", "/commit")
        status, body = self.call(server, "POST", "/compact")
        assert status == 200

        status, body = self.call(server, "GET", "/inspect")
        assert status == 200 and len(body["segments"]) == 1

        status, body = self.call(server, "POST", "/search",
                                 {"query": "rust", "limit": 5})
        assert body["total_hits_estimate"] == 1

    def test_body_limit_413(self, server, monkeypatch):
        self.call(server, "POST", "/init", {"schema": SCHEMA})
        big = b'{"_id": "x", "body": "' + b"a" * (51 * 1024 * 1024) + b'"}'
        status, body = self.call(server, "POST", "/add", raw=big,
                                 content_type="application/x-ndjson")
        assert status == 413
        assert body["error"]["type"] == "body_too_large"

    def test_concurrent_searches(self, server):
        import concurrent.futures

        self.call(server, "POST", "/init", {"schema": SCHEMA})
        ndjson = "\n".join(json.dumps(d) for d in DOCS).encode()
        self.call(server, "POST", "/add", raw=ndjson,
                  content_type="application/x-ndjson")
        self.call(server, "POST", "/commit")

        def one(_):
            return self.call(server, "POST", "/search",
                             {"query": "rust", "limit": 3})[0]

        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            statuses = list(pool.map(one, range(16)))
        assert statuses == [200] * 16

    def test_error_shapes(self, server):
        self.call(server, "POST", "/init", {"schema": SCHEMA})
        status, body = self.call(server, "POST", "/bulk", {"docs": []})
        assert status == 400
        assert body["error"]["type"] == "missing_documents"
        status, body = self.call(server, "POST", "/delete", {"ids": []})
        assert status == 400
        status, body = self.call(server, "POST", "/search",
                                 {"query": "x", "limit": 0})
        assert status == 400
        assert body["error"]["type"] == "search_failed"


def test_openapi_spec_parses_and_covers_routes():
    """openapi.yaml must stay valid YAML and document every HTTP route."""
    yaml = pytest.importorskip("yaml")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "openapi.yaml")) as fh:
        spec = yaml.safe_load(fh)
    documented = set(spec["paths"])
    for route in ("/healthz", "/init", "/add", "/bulk", "/delete",
                  "/commit", "/refresh", "/compact", "/merge",
                  "/search", "/search_batch", "/inspect", "/stats"):
        assert route in documented, route


class TestHttpConcurrency:
    def test_parallel_searches(self, tmp_path):
        """ThreadingHTTPServer serves concurrent searches; results must
        be correct and complete under parallel load (the reference uses
        a concurrency-limited tower stack; ours is a semaphore)."""
        import concurrent.futures

        from searchlite.http_server import make_server

        server = make_server(str(tmp_path / "idx"), bind="127.0.0.1:0")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        host, port = server.server_address
        base = f"http://{host}:{port}"
        call = TestHttp.call.__get__(TestHttp())
        try:
            assert call(base, "POST", "/init", {"schema": SCHEMA})[0] == 200
            ndjson = "\n".join(json.dumps(d) for d in DOCS).encode()
            call(base, "POST", "/add", raw=ndjson,
                 content_type="application/x-ndjson")
            call(base, "POST", "/commit")

            def one(i):
                q = ["rust", "database", "algebra"][i % 3]
                status, body = call(base, "POST", "/search",
                                    {"query": q, "limit": 5})
                return status, body["total_hits_estimate"]

            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                results = list(pool.map(one, range(48)))
            assert all(status == 200 for status, _ in results)
            assert all(total == 1 for _, total in results)
        finally:
            server.shutdown()


class TestStructuredBatch:
    """Structured batched queries across surfaces."""

    def _make_index(self, tmp_path):
        from searchlite.api.types import IndexOptions
        from searchlite.index import Index
        from searchlite.index.manifest import Schema as _S

        idx = Index.create(
            IndexOptions(path=str(tmp_path / "idx"),
                         create_if_missing=True),
            _S.from_json(SCHEMA))
        writer = idx.writer()
        writer.add_documents(DOCS)
        writer.commit()

    def test_http_structured_batch(self, tmp_path):
        import threading as _t
        import urllib.request as _u

        from searchlite.http_server import make_server

        self._make_index(tmp_path)
        server = make_server(str(tmp_path / "idx"), bind="127.0.0.1:0")
        thread = _t.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        host, port = server.server_address
        base = f"http://{host}:{port}"
        try:
            payload = {"queries": [
                "is",
                {"query": "is",
                 "filter": {"I64Range": {"field": "year",
                                         "min": 2021, "max": 2025}},
                 "limit": 1},
            ], "limit": 5}
            req = _u.Request(f"{base}/search_batch",
                             data=json.dumps(payload).encode(),
                             method="POST",
                             headers={"content-type": "application/json"})
            with _u.urlopen(req) as resp:
                body = json.loads(resp.read())
            assert len(body["results"][0]) == 2  # doc-1, doc-2 match "is"
            assert len(body["results"][1]) == 1
            assert body["results"][1][0]["doc_id"] == "doc-1"
        finally:
            server.shutdown()

    def test_cli_structured_batch(self, index_dir, capsys, tmp_path):
        idx = index_dir / "idx"
        assert cli_main(["init", str(idx),
                         str(index_dir / "schema.json")]) == 0
        assert cli_main(["add", str(idx),
                         str(index_dir / "docs.jsonl")]) == 0
        assert cli_main(["commit", str(idx)]) == 0
        qfile = tmp_path / "queries.jsonl"
        qfile.write_text(
            "is\n"
            + json.dumps({"query": "is",
                          "filter": {"I64Range": {"field": "year",
                                                  "min": 2021,
                                                  "max": 2025}},
                          "limit": 1}) + "\n")
        capsys.readouterr()
        assert cli_main(["search-batch", str(idx), "--queries-file",
                         str(qfile), "--limit", "5",
                         "--execution", "bmw"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert len(out["results"][0]) == 2
        assert [h["doc_id"] for h in out["results"][1]] == ["doc-1"]


class TestMeshSurfaces:
    """--mesh / SEARCHLITE_MESH: the CLI and HTTP surfaces run
    doc-sharded over a device mesh (tests force 8 virtual CPU devices
    via conftest) and must return exactly the single-chip results."""

    def _build(self, index_dir):
        idx = index_dir / "idx"
        assert cli_main(["init", str(idx),
                         str(index_dir / "schema.json")]) == 0
        assert cli_main(["add", str(idx),
                         str(index_dir / "docs.jsonl")]) == 0
        assert cli_main(["commit", str(idx)]) == 0
        return idx

    def test_cli_search_mesh(self, index_dir, capsys):
        idx = self._build(index_dir)
        outs = []
        for extra in ([], ["--mesh", "auto"], ["--mesh", "4"]):
            capsys.readouterr()
            assert cli_main(["search", str(idx), "-q", "is",
                             "--limit", "5", *extra]) == 0
            outs.append(json.loads(capsys.readouterr().out))
        assert outs[0] == outs[1] == outs[2]
        assert len(outs[0]["hits"]) == 2

    def test_cli_search_batch_mesh(self, index_dir, capsys):
        idx = self._build(index_dir)
        outs = []
        for extra in ([], ["--mesh", "auto"]):
            capsys.readouterr()
            assert cli_main(["search-batch", str(idx), "-q", "is",
                             "-q", "database", "--limit", "3",
                             *extra]) == 0
            outs.append(json.loads(capsys.readouterr().out))
        assert outs[0] == outs[1]
        assert [h["doc_id"] for h in outs[0]["results"][1]] == ["doc-2"]

    def test_http_mesh(self, tmp_path, index_dir):
        import urllib.request as _u

        from searchlite.http_server import make_server

        idx = self._build(index_dir)
        server = make_server(str(idx), bind="127.0.0.1:0", mesh="auto")
        threading.Thread(target=server.serve_forever,
                         daemon=True).start()
        host, port = server.server_address
        base = f"http://{host}:{port}"
        try:
            req = _u.Request(
                f"{base}/search",
                data=json.dumps({"query": "is", "limit": 5}).encode(),
                method="POST",
                headers={"content-type": "application/json"})
            with _u.urlopen(req) as resp:
                body = json.loads(resp.read())
            assert [h["doc_id"] for h in body["hits"]] == \
                ["doc-1", "doc-2"]
            req = _u.Request(
                f"{base}/search_batch",
                data=json.dumps({"queries": ["is", "gpus"],
                                 "limit": 3}).encode(),
                method="POST",
                headers={"content-type": "application/json"})
            with _u.urlopen(req) as resp:
                body = json.loads(resp.read())
            assert len(body["results"][0]) == 2
            assert body["results"][1][0]["doc_id"] == "doc-3"
        finally:
            server.shutdown()
