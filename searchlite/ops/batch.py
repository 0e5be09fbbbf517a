"""Batched multi-query BM25 scoring + top-k.

Query batching is the data-parallel axis of the engine: one launch scores a whole batch of queries against the
HBM-resident postings blocks, amortizing dispatch and keeping the device
fed. This is the kernel behind the batched-QPS benchmark and the
building block the multi-chip path shards (see parallel/mesh.py).

Layout: each query gets ``T`` block slots, one posting block per slot
(``q_blk [Q, T]`` holds global block ids; weight/field are per slot with
the term's idf·boost pre-folded). This gathers exactly the blocks the
query needs — no per-term padding — so device work and memory traffic scale
with the true posting volume.

Returns exact top-k per query (ties = lowest doc ordinal), identical to
the single-query dense executor.
"""

from __future__ import annotations

from functools import partial

import numpy as np


def make_batched_scorer():
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("k",))
    def scorer(block_docs, block_tfs, doc_len, avgdl, deleted,
               q_blk, q_weight, q_field, q_valid, k1, b, *, k: int):
        n1 = doc_len.shape[1]
        n_docs = n1 - 1

        def score_one(blk, weights, fields, valid):
            docs = block_docs[blk]                  # [T, 128]
            tfs = block_tfs[blk]
            ok = valid[:, None] & (docs < n_docs)
            docs = jnp.where(ok, docs, n_docs)
            dl = doc_len[fields[:, None], docs]
            avg = avgdl[fields][:, None]
            norm = jnp.where(avg > 0, dl / jnp.where(avg > 0, avg, 1.0), 1.0)
            denom = jnp.maximum(tfs + k1 * (1.0 - b + b * norm), 1e-6)
            sc = weights[:, None] * tfs * (k1 + 1.0) / denom
            sc = jnp.where(ok, sc, 0.0)
            scores = jnp.zeros(n1, dtype=jnp.float32).at[
                docs.reshape(-1)].add(sc.reshape(-1))
            matched = jnp.zeros(n1, dtype=bool).at[
                docs.reshape(-1)].max(ok.reshape(-1))
            masked = jnp.where(matched & ~deleted, scores, -jnp.inf)
            return jax.lax.top_k(masked, k)

        return jax.vmap(score_one)(q_blk, q_weight, q_field, q_valid)

    return scorer
