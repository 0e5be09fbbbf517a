"""Engine ingest throughput, generation excluded.

Measures the ENGINE side of ingest — ``add_documents`` (validate +
WAL buffer) plus ``commit`` (tokenize, postings, fast fields,
docstore, manifest) — on a synthetic Zipf corpus, with document
GENERATION excluded from the measured time (bench_scale.py's docs/s
includes generation, which understates the engine by ~2x at 500k
docs). The reference ingests through the same WAL-first pipeline
(`api/writer.rs:74-239`); this host is single-core, so the number is
a single-core rate.

Usage: python tools/bench_ingest.py [n_docs] [--positions] [--raw]

--raw measures the NDJSON serving path: documents arrive as raw JSON
line bytes (what HTTP /add and CLI add receive); parsing counts as
engine time, the WAL splices the raw bytes (no re-serialization).

Prints one JSON line:
  {"bench": "ingest_engine_docs_per_s", "value": N, "n_docs": ...,
   "buffer_s": ..., "commit_s": ..., "positions": ...}
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

import searchlite  # noqa: E402,F401 — hugepage-madvise opt-out
from searchlite.api.types import IndexOptions, StorageType  # noqa: E402
from searchlite.index import Index  # noqa: E402
from searchlite.index.manifest import Schema  # noqa: E402

VOCAB = 50_000
CHUNK = 100_000


def main() -> None:
    args = sys.argv[1:]
    n_docs = int(args[0]) if args and not args[0].startswith("-") \
        else 500_000
    positions = "--positions" in args
    raw_mode = "--raw" in args

    rng = np.random.default_rng(7)
    ranks = np.arange(1, VOCAB + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    vocab = [f"t{i}" for i in range(VOCAB)]

    index = Index.create(
        IndexOptions(path="", create_if_missing=True,
                     storage=StorageType.IN_MEMORY,
                     enable_positions=positions),
        Schema.from_json({
            "text_fields": [{"name": "body", "analyzer": "default",
                             "stored": False, "indexed": True}],
            "keyword_fields": [{"name": "cat", "stored": False,
                                "indexed": False, "fast": True}],
            "numeric_fields": [{"name": "price", "i64": False,
                                "stored": False, "fast": True}]}))
    writer = index.writer()
    buffer_s = 0.0
    done = 0
    while done < n_docs:
        n = min(CHUNK, n_docs - done)
        lens = rng.integers(20, 80, size=n)
        toks = rng.choice(VOCAB, size=int(lens.sum()), p=probs)
        docs = []
        c = 0
        for i in range(n):
            ln = int(lens[i])
            d = done + i
            docs.append({"_id": str(d),
                         "body": " ".join(vocab[t]
                                          for t in toks[c:c + ln]),
                         "cat": f"c{d % 37}", "price": float(d % 997)})
            c += ln
        if raw_mode:
            lines = [json.dumps(d, separators=(",", ":")).encode()
                     for d in docs]
            t0 = time.perf_counter()
            parsed = [json.loads(ln) for ln in lines]
            writer.add_documents(parsed, raws=lines)
            buffer_s += time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            writer.add_documents(docs)
            buffer_s += time.perf_counter() - t0
        done += n
    t0 = time.perf_counter()
    writer.commit()
    commit_s = time.perf_counter() - t0
    engine_s = buffer_s + commit_s
    print(json.dumps({
        "bench": "ingest_engine_docs_per_s",
        "value": round(n_docs / engine_s, 1),
        "unit": "docs/s",
        "n_docs": n_docs,
        "buffer_s": round(buffer_s, 1),
        "commit_s": round(commit_s, 1),
        "positions": positions,
        "raw_ndjson": raw_mode,
    }), flush=True)


if __name__ == "__main__":
    main()
