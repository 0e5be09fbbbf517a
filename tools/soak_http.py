"""HTTP soak: concurrent writers + readers against the real server.

Drives the production HTTP surface for N seconds with mixed traffic —
NDJSON /add batches (ASCII + unicode docs), /delete, periodic /commit,
constant /search + /search_batch with filters/aggs from reader threads
— then verifies the final state against a direct-API oracle: doc
count, per-tag terms-agg counts, and top-k results for a sample of
queries must match an independent reader opened on the same index
directory.

Usage: python tools/soak_http.py [seconds] [--port P]
Prints one JSON summary line; exit 1 on any invariant violation.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import threading
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"

SCHEMA = {
    "text_fields": [{"name": "body", "analyzer": "default",
                     "stored": False, "indexed": True}],
    "keyword_fields": [{"name": "tag", "stored": False,
                        "indexed": True, "fast": True}],
    "numeric_fields": [{"name": "price", "i64": False,
                        "stored": False, "fast": True}],
}

WORDS = ["alpha", "beta", "gamma", "delta", "omega", "zürich",
         "café", "search", "engine", "gpu", "sparse", "dense"]
TAGS = ["a", "b", "c", "d"]


def post(port, route, data: bytes, ctype="application/json",
         timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=data,
        headers={"content-type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        raise RuntimeError(
            f"{route} -> {e.code}: {e.read()[:300]!r}") from None


def get(port, route, timeout=60):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{route}", timeout=timeout) as r:
        return json.loads(r.read())


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    seconds = int(args[0]) if args else 120
    port = 8977
    if "--port" in sys.argv:
        port = int(sys.argv[sys.argv.index("--port") + 1])

    import tempfile

    idx_dir = tempfile.mkdtemp(prefix="soak_idx_")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    server = subprocess.Popen(
        [sys.executable, "-m", "searchlite.cli", "http",
         idx_dir, "--bind", f"127.0.0.1:{port}"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        for _ in range(400):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz",
                        timeout=10) as r:
                    json.load(r)
                break
            except Exception:
                if server.poll() is not None:
                    raise RuntimeError("server exited at startup")
                time.sleep(0.3)
        else:
            raise RuntimeError("server never became healthy")
        post(port, "/init", json.dumps({"schema": SCHEMA}).encode())

        stop = threading.Event()
        stats = {"added": 0, "deleted": 0, "commits": 0,
                 "searches": 0, "batches": 0, "errors": []}
        lock = threading.Lock()
        docs_alive: dict[str, dict] = {}
        committed_ids: set[str] = set()
        next_id = [0]

        def writer():
            rng = random.Random(1)
            while not stop.is_set():
                batch = []
                for _ in range(rng.randint(5, 80)):
                    did = str(next_id[0])
                    next_id[0] += 1
                    doc = {"_id": did,
                           "body": " ".join(rng.choices(
                               WORDS, k=rng.randint(1, 8))),
                           "tag": rng.choice(TAGS),
                           "price": round(rng.uniform(0, 99), 2)}
                    batch.append(doc)
                lines = "\n".join(json.dumps(d, ensure_ascii=False)
                                  for d in batch)
                try:
                    post(port, "/add", lines.encode(),
                         ctype="application/x-ndjson")
                    with lock:
                        for d in batch:
                            docs_alive[d["_id"]] = d
                        stats["added"] += len(batch)
                    if rng.random() < 0.2 and docs_alive:
                        with lock:
                            victims = rng.sample(
                                sorted(docs_alive),
                                k=min(5, len(docs_alive)))
                        post(port, "/delete", json.dumps(
                            {"ids": victims}).encode())
                        with lock:
                            for v in victims:
                                docs_alive.pop(v, None)
                            stats["deleted"] += len(victims)
                    post(port, "/commit", b"{}")
                    with lock:
                        stats["commits"] += 1
                        committed_ids.clear()
                        committed_ids.update(docs_alive)
                except Exception as e:  # noqa: BLE001
                    with lock:
                        stats["errors"].append(f"writer: {e}")
                time.sleep(0.01)

        def reader(seed):
            rng = random.Random(seed)
            while not stop.is_set():
                try:
                    q = " ".join(rng.choices(WORDS,
                                             k=rng.randint(1, 3)))
                    req = {"query": q, "limit": 10}
                    if rng.random() < 0.4:
                        req["filter"] = {"KeywordEq": {
                            "field": "tag",
                            "value": rng.choice(TAGS)}}
                    if rng.random() < 0.3:
                        req["aggs"] = {"tags": {"type": "terms",
                                                "field": "tag"}}
                    out = post(port, "/search",
                               json.dumps(req).encode())
                    assert "hits" in out, out
                    with lock:
                        stats["searches"] += 1
                    if rng.random() < 0.15:
                        out = post(port, "/search_batch", json.dumps(
                            {"queries": rng.choices(WORDS, k=4),
                             "limit": 5}).encode())
                        assert "results" in out, out
                        with lock:
                            stats["batches"] += 1
                except Exception as e:  # noqa: BLE001
                    with lock:
                        stats["errors"].append(f"reader: {e}")
                        if len(stats["errors"]) > 20:
                            stop.set()

        threads = [threading.Thread(target=writer, daemon=True)]
        threads += [threading.Thread(target=reader, args=(s,),
                                     daemon=True) for s in (2, 3)]
        for t in threads:
            t.start()
        deadline = time.time() + seconds
        while time.time() < deadline and not stop.is_set():
            time.sleep(1)
            with lock:
                print(f"t={seconds - int(deadline - time.time()):>4}s "
                      f"added={stats['added']} commits={stats['commits']} "
                      f"searches={stats['searches']} "
                      f"errors={len(stats['errors'])}",
                      file=sys.stderr, flush=True)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        print("threads joined; final commit + oracle check",
              file=sys.stderr, flush=True)

        # final commit of anything buffered, then oracle comparison
        post(port, "/commit", b"{}")
        with lock:
            committed_ids.clear()
            committed_ids.update(docs_alive)
        http_stats = get(port, "/stats")
        sample = random.Random(9).sample(WORDS, k=6)
        http_answers = {
            w: post(port, "/search", json.dumps(
                {"query": w, "limit": 20}).encode())
            for w in sample}
        http_tags = post(port, "/search", json.dumps(
            {"query": {"type": "match_all"}, "limit": 1,
             "aggs": {"tags": {"type": "terms", "field": "tag",
                               "size": 10}}}).encode())
    finally:
        server.terminate()
        server.wait(timeout=30)

    # direct-API oracle on the same directory
    from searchlite.api.types import IndexOptions
    from searchlite.index import Index

    idx = Index.open(IndexOptions(path=idx_dir,
                                  create_if_missing=False))
    reader_api = idx.reader()
    violations = []
    want_docs = len(committed_ids)
    got_docs = http_stats.get("documents")
    oracle_docs = sum(
        len(s.doc_ids) - len(s.meta.deleted_docs)
        for s in reader_api.segments)
    if not (want_docs == got_docs == oracle_docs):
        violations.append(
            f"doc counts differ: tracked={want_docs} "
            f"http={got_docs} oracle={oracle_docs}")
    for w, http_out in http_answers.items():
        mine = reader_api.search({"query": w, "limit": 20})
        got = [(h["doc_id"], round(h["score"], 4))
               for h in http_out["hits"]]
        want = [(h.doc_id, round(h.score, 4)) for h in mine.hits]
        if got != want:
            violations.append(f"query {w!r}: http != oracle")
    want_tags: dict[str, int] = {}
    for d in docs_alive.values():
        want_tags[d["tag"]] = want_tags.get(d["tag"], 0) + 1
    got_tags = {b["key"]: b["doc_count"]
                for b in http_tags["aggregations"]["tags"]["buckets"]}
    if got_tags != want_tags:
        violations.append(
            f"tag agg: http={got_tags} tracked={want_tags}")

    summary = {"bench": "soak_http", "seconds": seconds,
               **{k: v for k, v in stats.items() if k != "errors"},
               "segments": http_stats.get("segments"),
               "n_errors": len(stats["errors"]),
               "violations": violations}
    print(json.dumps(summary), flush=True)
    for e in stats["errors"][:10]:
        print("ERR:", e, file=sys.stderr)
    for v in violations:
        print("VIOLATION:", v, file=sys.stderr)
    sys.exit(1 if (violations or stats["errors"]) else 0)


if __name__ == "__main__":
    main()
