"""Plain numpy BM25 reference for gating what the engine returns.

It shares no scoring code with the engine: it imports numpy only and
reads a reader's segments through their host attributes (term
dictionary, unpadded postings, the ``_len:<field>`` length column,
tombstones, doc ids). Per segment it scores in f64 with the segment's
own statistics (df, live-doc count, average field length), exactly the
BM25 the engine defines (``models/bm25.py``).

Tolerances (``tolerance``) follow the engine's precision modes:

- default: rtol 1e-2, atol 1e-3. Device impacts are stored in bf16,
  whose rounding moves each stored impact by up to 2^-8 relative, and
  f32 dots may run as TF32, which rounds both inputs by up to 2^-11
  (at most 2^-10 per product). A score is then off by at most
  (2^-8 + 2^-10) of itself, and two docs the engine compares can trade
  places when their exact scores differ by up to twice that, 2^-7 +
  2^-9 ≈ 9.8e-3 (two impacts within one bf16 step round to the same
  value and tie, and ties go to the lower doc id);
- ``SEARCHLITE_PRECISION=f32_strict``: rtol 1e-6, atol 1e-4 (f32
  everywhere, full-precision dots);
- ``SEARCHLITE_PRECISION=bf16``: rtol 2e-2, atol 1e-3 (bf16 inputs as
  well as storage: up to 2^-7 per product, 2^-6 between two docs).

The gate accepts reordering within that tolerance: each returned score
must match the reference for that doc, and no doc left out may beat the
weakest returned doc by more than the tolerance.
"""

from __future__ import annotations

import os

import numpy as np

K1, B = 0.9, 0.4


def tolerance(mode: str | None = None) -> tuple[float, float]:
    """(rtol, atol) for a precision mode (default: the environment's)."""
    if mode is None:
        mode = os.environ.get("SEARCHLITE_PRECISION", "")
    if mode == "f32_strict":
        return 1e-6, 1e-4
    if mode == "bf16":
        return 2e-2, 1e-3
    return 1e-2, 1e-3


class Bm25Oracle:
    """Exact BM25 over every segment of ``reader`` for one text field."""

    def __init__(self, reader, field: str = "body", k1: float = K1,
                 b: float = B):
        self.field, self.k1, self.b = field, k1, b
        self.segments = []
        for seg in reader.segments:
            n = seg.doc_count
            doc_len = np.zeros(n, dtype=np.float64)
            col = seg.fast.column(f"_len:{field}")
            if col is not None:
                doc_len[col.row_ids] = col.values
            live = np.ones(n, dtype=bool)
            live[list(seg.deleted)] = False
            self.segments.append({
                "seg": seg, "n": n, "doc_len": doc_len, "live": live,
                "avg": float(seg.avg_field_length(field)),
                "n_live": float(n - len(seg.deleted))})
        self._where = None

    def scores(self, tokens) -> list[np.ndarray]:
        """Per segment, f64 [n_docs] summed BM25 of ``tokens`` (already
        analyzed terms of ``field``; a repeated token counts twice).
        Tombstoned docs score 0."""
        out = []
        for s in self.segments:
            seg, acc = s["seg"], np.zeros(s["n"], dtype=np.float64)
            for token in tokens:
                tid = seg.terms.get(f"{self.field}:{token}")
                if tid is None:
                    continue
                df = float(seg.postings.term_df[tid])
                ratio = (s["n_live"] - df + 0.5) / (df + 0.5)
                idf = (max(np.log(ratio), 0.0) if ratio > 0 else 0.0) + 1.0
                docs, tfs = seg.postings.term_postings(tid)
                tfs = tfs.astype(np.float64)
                norm = (s["doc_len"][docs] / s["avg"] if s["avg"] > 0
                        else np.ones_like(tfs))
                denom = np.maximum(tfs + self.k1 * (1 - self.b
                                                    + self.b * norm), 1e-6)
                acc += np.bincount(docs, idf * tfs * (self.k1 + 1) / denom,
                                   minlength=s["n"])
            acc[~s["live"]] = 0.0
            out.append(acc)
        return out

    def locate(self, doc_id: str) -> tuple[int, int]:
        """(segment, ordinal) of a doc id."""
        if self._where is None:
            self._where = {d: (si, o) for si, s in enumerate(self.segments)
                           for o, d in enumerate(s["seg"].doc_ids)}
        return self._where[doc_id]


class Reference:
    """Reference scores of one query over every segment, ready to gate
    the engine's top-``k``.

    ``scores`` is a list of per-segment score arrays (as from
    :meth:`Bm25Oracle.scores`, possibly masked or shifted by the
    caller); ``match`` the per-segment masks of matching docs (default:
    score > 0, which is BM25's match set)."""

    def __init__(self, scores: list[np.ndarray], k: int, match=None):
        self.scores, self.k = scores, k
        if match is None:
            match = [s > 0 for s in scores]
        self.match = match
        self.n_match = int(sum(int(m.sum()) for m in match))
        # the k+1 best matches: at most k docs are returned, so the best
        # doc left out is the first of these that was not returned
        top = []
        for si, (s, m) in enumerate(zip(scores, match)):
            idx = np.flatnonzero(m)
            if len(idx) > k + 1:
                part = np.argpartition(-s[idx], k)[:k + 1]
                idx = idx[part]
            top += [(float(s[o]), si, int(o)) for o in idx]
        top.sort(key=lambda t: -t[0])
        self.top = top[:k + 1]

    def check(self, hits, tol: tuple[float, float] | None = None
              ) -> str | None:
        """Gate one query's ``hits``, a list of ``(segment, ordinal,
        score)`` in the engine's order. Returns None when they are a
        top-``k`` of the reference under the tolerance, else the reason
        they are not."""
        rtol, atol = tol or tolerance()

        def slack(x):
            return atol + rtol * abs(x)

        want_n = min(self.k, self.n_match)
        if len(hits) != want_n:
            return f"{len(hits)} hits, want {want_n}"
        prev, seen, weakest = np.inf, set(), np.inf
        for si, o, s in hits:
            if not self.match[si][o]:
                return f"doc ({si}, {o}) does not match"
            want = float(self.scores[si][o])
            if not abs(s - want) <= slack(want):
                return f"doc ({si}, {o}) scored {s}, want {want}"
            if s > prev + slack(prev):
                return "hits are not in score order"
            if (si, o) in seen:
                return f"doc ({si}, {o}) returned twice"
            seen.add((si, o))
            prev, weakest = s, min(weakest, want)
        best_out = next((t[0] for t in self.top
                         if (t[1], t[2]) not in seen), None)
        if best_out is not None and hits \
                and best_out > weakest + slack(best_out):
            return f"left out a doc scoring {best_out} > {weakest}"
        return None
