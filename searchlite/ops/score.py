"""Compiled dense query execution: the device replacement for the WAND loop.

The reference's hottest loop is a doc-at-a-time heap walk over postings
(`query/wand.rs:659-903`). On the device we instead:

1. Gather the query terms' posting blocks ``[QB, 128]`` out of the
   segment's device-resident block arrays (one row = one block).
2. Score every posting with vectorized BM25 (idf and boosts pre-folded
   into one per-block weight).
3. Scatter-add into a dense ``[n_leaves, n_docs+1]`` per-leaf score
   matrix and scatter-max per-group match masks.
4. Evaluate the boolean matcher / score-expression / custom-scoring
   trees as elementwise array ops (traced once per plan shape).
5. ``lax.top_k`` over the masked scores — ties resolve to the lowest
   doc ordinal, reproducing the reference's (score desc, doc_id asc)
   order (`query/wand.rs:30-37`).

Exactness: nothing is pruned — every posting of every query term is
scored, so results are exact (the reference's ``bm25`` oracle strategy).
WAND/BMW strategies run the REAL doc-tile pruned execution in
``ops/tiles.py`` (routed by ``api/reader.py``); it returns identical
top-k (fuzzed in tests/test_pruning.py) while touching fewer postings.
This module remains the dense oracle path and the executor for the
full structured-query surface (matchers, score trees, sorts).

One ``CompiledQuery`` is built per query plan; its jitted executor is
shape-polymorphic, so segments of different sizes reuse the same trace
cache per padded shape bucket.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

from searchlite.errors import QueryError
from searchlite.query.planner import Matcher, QueryPlan, ScoreExpr, ScoreNode
from searchlite.query.score_functions import (
    apply_boost_mode_dense,
    combine_functions_dense,
    compile_functions,
    evaluate_function_dense,
)
from searchlite.query.script import compile_script


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class CompiledQuery:
    """Plan → dense executor. Host-side slots are assigned at compile
    time; per-segment filter masks / phrase masks / columns are computed
    by the reader and passed as dense inputs."""

    def __init__(self, plan: QueryPlan, schema, k1: float, b: float):
        from searchlite.ops.precision import apply_matmul_precision

        apply_matmul_precision()
        import jax  # noqa: PLC0415
        import jax.numpy as jnp  # noqa: PLC0415

        self._jax = jax
        self._jnp = jnp
        self.plan = plan
        self.schema = schema
        self.k1 = float(k1)
        self.b = float(b)
        self.n_groups = len(plan.term_groups)
        self.n_phrases = len(plan.phrase_specs)
        self.n_leaves = max(plan.leaf_count, 1)

        # Filter slots: each matcher bool-node's filter list gets one mask
        # slot; per-function filters get one slot each.
        self.filter_slots: list[Any] = []   # list of Filter-lists or Filter
        self._matcher_filter_slot: dict[int, int] = {}
        self._collect_matcher_slots(plan.matcher)

        self.needs_hook = plan.needs_score_hook()
        self._compiled_nodes: dict[int, dict] = {}
        self.columns: list[str] = []
        if self.needs_hook:
            self._compile_score_node(plan.score_tree)

        self._jit_cache: dict = {}

    # -- compile-time walks ---------------------------------------------------

    def _collect_matcher_slots(self, node: Matcher) -> None:
        if node.kind == "bool":
            filters = node.payload.get("filter", [])
            if filters:
                self._matcher_filter_slot[id(node)] = len(self.filter_slots)
                self.filter_slots.append(list(filters))
            for key in ("must", "should", "must_not"):
                for child in node.payload.get(key, []):
                    self._collect_matcher_slots(child)
        elif node.kind == "dis_max":
            for child in node.payload:
                self._collect_matcher_slots(child)

    def _need_column(self, field: str) -> int:
        if field not in self.columns:
            self.columns.append(field)
        return self.columns.index(field)

    def _compile_score_node(self, node: ScoreNode) -> None:
        info: dict[str, Any] = {}
        if node.kind == "constant":
            self._collect_matcher_slots(node.params["matcher"])
        elif node.kind == "function_score":
            self._collect_matcher_slots(node.params["matcher"])
            compiled = compile_functions(node.params["functions"], self.schema)
            fn_slots = []
            for func in compiled:
                if func.filter is not None:
                    fn_slots.append(len(self.filter_slots))
                    self.filter_slots.append([func.filter])
                else:
                    fn_slots.append(None)
                if func.kind in ("field_value_factor", "decay"):
                    self._need_column(func.params["field"])
            info["functions"] = compiled
            info["fn_slots"] = fn_slots
            self._compile_score_node(node.params["base"])
        elif node.kind == "rank_feature":
            self._collect_matcher_slots(node.params["matcher"])
            field = node.params["field"]
            missing = node.params.get("missing")
            if missing is not None and not math.isfinite(float(missing)):
                raise QueryError("rank_feature `missing` must be finite")
            meta = self.schema.field_meta(field)
            if meta is None or meta.kind != "numeric" or not meta.fast:
                raise QueryError(
                    f"rank_feature field `{field}` must be a numeric fast "
                    "field")
            self._need_column(field)
        elif node.kind == "script_score":
            self._collect_matcher_slots(node.params["matcher"])
            script = compile_script(node.params["script"],
                                    node.params.get("params"), self.schema)
            for field in script.fields:
                self._need_column(field)
            info["script"] = script
            self._compile_score_node(node.params["base"])
        for child in node.children:
            self._compile_score_node(child)
        if info:
            self._compiled_nodes[id(node)] = info

    # -- traced evaluation ----------------------------------------------------

    def _eval_matcher(self, node: Matcher, ctx: dict):
        xp = self._jnp
        if node.kind == "match_all":
            return ctx["ones"]
        if node.kind == "term":
            return ctx["group_match"][node.payload]
        if node.kind == "phrase":
            return ctx["phrase_masks"][node.payload]
        if node.kind == "query_string":
            p = node.payload
            if not p["term_groups"] and not p["phrase_groups"] \
                    and not p["not_term_groups"]:
                return ~ctx["ones"]
            mask = ctx["ones"]
            for idx in p["not_term_groups"]:
                mask = mask & ~ctx["group_match"][idx]
            for idx in p["phrase_groups"]:
                mask = mask & ctx["phrase_masks"][idx]
            if not p["term_groups"]:
                return mask
            counts = None
            for idx in p["term_groups"]:
                row = ctx["group_match"][idx].astype(xp.int32)
                counts = row if counts is None else counts + row
            required = p["minimum_should_match"]
            required = 1 if required is None else required
            return mask & (counts >= required)
        if node.kind == "dis_max":
            children = node.payload
            if not children:
                return ~ctx["ones"]
            mask = self._eval_matcher(children[0], ctx)
            for child in children[1:]:
                mask = mask | self._eval_matcher(child, ctx)
            return mask
        if node.kind == "bool":
            p = node.payload
            mask = ctx["ones"]
            for child in p["must"]:
                mask = mask & self._eval_matcher(child, ctx)
            for child in p["must_not"]:
                mask = mask & ~self._eval_matcher(child, ctx)
            slot = self._matcher_filter_slot.get(id(node))
            if slot is not None:
                mask = mask & ctx["filter_masks"][slot]
            should = p["should"]
            if should:
                xp32 = self._jnp.int32
                counts = None
                for child in should:
                    row = self._eval_matcher(child, ctx).astype(xp32)
                    counts = row if counts is None else counts + row
                min_should = p["minimum_should_match"]
                if min_should is None:
                    min_should = (1 if not p["must"] and not p["filter"]
                                  else 0)
                mask = mask & (counts >= min_should)
            elif p["minimum_should_match"] not in (None, 0):
                # explicit minimum_should_match with no should clauses can
                # never be satisfied (reference: 0 >= min_should)
                mask = mask & ~ctx["ones"]
            return mask
        raise QueryError(f"unknown matcher kind `{node.kind}`")

    def _eval_score_expr(self, expr: ScoreExpr, leaf_scores):
        xp = self._jnp
        if expr.kind == "leaf":
            return leaf_scores[expr.leaf]
        child_vals = [self._eval_score_expr(c, leaf_scores)
                      for c in expr.children]
        if expr.kind == "sum":
            acc = child_vals[0]
            for v in child_vals[1:]:
                acc = acc + v
            return acc
        # dis_max
        if not child_vals:
            return xp.zeros_like(leaf_scores[0])
        mx = child_vals[0]
        sm = child_vals[0]
        for v in child_vals[1:]:
            mx = xp.maximum(mx, v)
            sm = sm + v
        return mx + expr.tie_breaker * (sm - mx)

    def _eval_score_node(self, node: ScoreNode, ctx: dict):
        """Returns (score [N1], present [N1]) — present=False means the
        doc's score is dropped (reference `None`)."""
        xp = self._jnp
        ones_f = ctx["zeros"] + 1.0
        true_mask = ctx["ones"]
        if node.kind == "empty":
            return ones_f, true_mask
        if node.kind == "expr":
            return self._eval_score_expr(node.expr, ctx["leaf_scores"]), true_mask
        if node.kind == "sum":
            total = ctx["zeros"]
            any_present = ~true_mask if node.children else true_mask
            for child in node.children:
                v, p = self._eval_score_node(child, ctx)
                total = total + xp.where(p, v, 0.0)
                any_present = any_present | p
            return total, any_present
        if node.kind == "dis_max":
            if not node.children:
                return ctx["zeros"], true_mask
            mx = xp.full_like(ctx["zeros"], -xp.inf)
            sm = ctx["zeros"]
            any_present = ~true_mask
            for child in node.children:
                v, p = self._eval_score_node(child, ctx)
                mx = xp.maximum(mx, xp.where(p, v, -xp.inf))
                sm = sm + xp.where(p, v, 0.0)
                any_present = any_present | p
            score = mx + node.tie_breaker * (sm - mx)
            return xp.where(any_present, score, 0.0), any_present
        if node.kind == "constant":
            matched = self._eval_matcher(node.params["matcher"], ctx)
            return xp.where(matched, node.params["score"], 0.0), true_mask
        if node.kind == "function_score":
            return self._eval_function_score(node, ctx)
        if node.kind == "rank_feature":
            return self._eval_rank_feature(node, ctx)
        if node.kind == "script_score":
            return self._eval_script_score(node, ctx)
        raise QueryError(f"unknown score node `{node.kind}`")

    def _column_ctx(self, ctx: dict, field: str):
        idx = self.columns.index(field)
        return ctx["col_vals"][idx], ctx["col_has"][idx]

    def _eval_function_score(self, node: ScoreNode, ctx: dict):
        xp = self._jnp
        p = node.params
        info = self._compiled_nodes[id(node)]
        matched = self._eval_matcher(p["matcher"], ctx)
        base, base_present = self._eval_score_node(p["base"], ctx)
        n = base.shape[0]
        columns = {f: self._column_ctx(ctx, f) for f in self.columns}
        values, presents = [], []
        for func, slot in zip(info["functions"], info["fn_slots"]):
            fmask = (ctx["filter_masks"][slot] if slot is not None
                     else ctx["ones"])
            v, pr = evaluate_function_dense(xp, func, columns, fmask, n)
            values.append(v)
            presents.append(pr)
        combined_fn, any_fn = combine_functions_dense(
            xp, values, presents, p["score_mode"], n)
        eps = np.finfo(np.float32).eps
        effective_base = xp.where(
            (xp.abs(base) <= eps) & any_fn, 1.0, base)
        combined = xp.where(
            any_fn,
            apply_boost_mode_dense(xp, effective_base, combined_fn,
                                   p["boost_mode"]),
            effective_base)
        if p.get("max_boost") is not None:
            combined = xp.minimum(combined, float(p["max_boost"]))
        present = base_present
        if p.get("min_score") is not None:
            present = present & (combined >= float(p["min_score"]))
        combined = combined * float(p["boost"])
        # unmatched docs score 0.0 (still present)
        score = xp.where(matched, combined, 0.0)
        present = present | ~matched
        return score, present

    def _eval_rank_feature(self, node: ScoreNode, ctx: dict):
        xp = self._jnp
        p = node.params
        matched = self._eval_matcher(p["matcher"], ctx)
        vals, has = self._column_ctx(ctx, p["field"])
        missing = float(p.get("missing") or 0.0)
        raw = xp.where(has, vals, missing)
        modifier = p.get("modifier") or "none"
        if modifier == "none":
            modified = raw
        elif modifier == "log":
            modified = xp.where(raw <= 0.0, 0.0,
                                xp.log(xp.maximum(raw, 1e-30)))
        elif modifier == "log1p":
            modified = xp.where(raw <= -1.0, 0.0,
                                xp.log1p(xp.maximum(raw, -1.0 + 1e-30)))
        elif modifier == "sqrt":
            modified = xp.where(raw < 0.0, 0.0,
                                xp.sqrt(xp.maximum(raw, 0.0)))
        elif modifier == "reciprocal":
            modified = xp.where(raw == 0.0, 0.0,
                                1.0 / xp.where(raw == 0.0, 1.0, raw))
        else:
            raise QueryError(f"unknown rank_feature modifier `{modifier}`")
        score = modified * float(p["boost"])
        present = xp.isfinite(score) | ~matched
        return xp.where(matched, score, 0.0), present

    def _eval_script_score(self, node: ScoreNode, ctx: dict):
        xp = self._jnp
        p = node.params
        info = self._compiled_nodes[id(node)]
        matched = self._eval_matcher(p["matcher"], ctx)
        base, base_present = self._eval_score_node(p["base"], ctx)
        columns = {f: self._column_ctx(ctx, f) for f in self.columns}
        value, present = info["script"].evaluate_dense(xp, base, columns)
        score = value * float(p["boost"])
        present = (present & base_present & xp.isfinite(score)) | ~matched
        return xp.where(matched, score, 0.0), present

    # -- the jitted executor ----------------------------------------------------

    def _core(self, m, deleted, w_leaf, leaf_ind, group_ind,
              phrase_masks, filter_masks, col_vals, col_has, root_mask,
              has_scored_terms: bool, need_scores: bool):
        """Shared traced core: leaf scoring off a densified M (any doc
        width — full segment or compacted tile columns), matcher/score
        tree evaluation, final mask. Returns (final_mask, adjusted,
        matcher_mask, ones)."""
        jnp = self._jnp
        n1 = deleted.shape[0]
        ones = jnp.ones(n1, dtype=bool)
        zeros = jnp.zeros(n1, dtype=jnp.float32)

        m_pos = (m > 0).astype(jnp.float32)
        leaf_scores = jnp.dot(w_leaf, m,
                              preferred_element_type=jnp.float32)
        leaf_match = jnp.dot(leaf_ind, m_pos,
                             preferred_element_type=jnp.float32) > 0
        group_match = jnp.dot(group_ind, m_pos,
                              preferred_element_type=jnp.float32) > 0

        ctx = {
            "ones": ones,
            "zeros": zeros,
            "leaf_scores": leaf_scores,
            "group_match": group_match,
            "phrase_masks": phrase_masks,
            "filter_masks": filter_masks,
            "col_vals": col_vals,
            "col_has": col_has,
        }

        matcher_mask = self._eval_matcher(self.plan.matcher, ctx)
        if has_scored_terms:
            candidates = leaf_match.any(axis=0)
        else:
            candidates = ones
        if need_scores and self.plan.scorer is not None:
            base_score = self._eval_score_expr(self.plan.scorer,
                                               leaf_scores)
        else:
            base_score = zeros
        if need_scores and self.needs_hook:
            ctx_hook = dict(ctx)
            adjusted, present = self._eval_score_node(
                self.plan.score_tree, ctx_hook)
        else:
            adjusted, present = base_score, ones

        final_mask = candidates & matcher_mask & root_mask \
            & ~deleted & present
        return final_mask, adjusted, matcher_mask, ones

    def _build_executor(self):
        jnp = self._jnp
        jax = self._jax

        def run(block_docs, block_impacts, deleted,
                blk_idx, slot_row, w_leaf, leaf_ind, group_ind,
                phrase_masks, filter_masks, col_vals, col_has,
                root_mask, cursor_score, cursor_eq_mode, cursor_doc,
                *, k: int, s_pad: int, has_scored_terms: bool,
                need_scores: bool, use_cursor: bool):
            from searchlite.ops.impact import build_m_from_blocks

            n1 = deleted.shape[0]

            # --- densify the query's term slots, score as a matmul ---
            m = build_m_from_blocks(jnp, block_docs, block_impacts,
                                    blk_idx, slot_row, n1, s_pad)
            final_mask, adjusted, matcher_mask, _ones = self._core(
                m, deleted, w_leaf, leaf_ind, group_ind, phrase_masks,
                filter_masks, col_vals, col_has, root_mask,
                has_scored_terms, need_scores)

            # --- cursor skip (score-desc fast path only): keep docs whose
            # key is strictly after the cursor key ---
            cursor_seen = jnp.asarray(False)
            if use_cursor:
                doc_iota = jnp.arange(n1, dtype=jnp.int32)
                # eq_mode: 0 = exclude all equal-score docs (segment before
                # cursor's), 1 = exclude doc <= cursor_doc (same segment),
                # 2 = keep equal-score docs (segment after cursor's)
                eq_keep = jnp.where(
                    cursor_eq_mode == 0,
                    jnp.zeros(n1, dtype=bool),
                    jnp.where(cursor_eq_mode == 1,
                              doc_iota > cursor_doc,
                              jnp.ones(n1, dtype=bool)))
                cursor_seen = (
                    (cursor_eq_mode == 1)
                    & final_mask[cursor_doc]
                    & (adjusted[cursor_doc] == cursor_score))
                # score-desc order: "after cursor" = lower score, or equal
                # score with later (segment, doc)
                after = (adjusted < cursor_score) | (
                    (adjusted == cursor_score) & eq_keep)
                final_mask = final_mask & after

            match_count = final_mask.sum()

            # --- 5: top-k ---
            masked = jnp.where(final_mask, adjusted,
                               -jnp.inf).astype(jnp.float32)
            top_scores, top_idx = jax.lax.top_k(masked, k)
            # matcher-only mask (for vector-candidate text matching)
            text_mask = matcher_mask & ~deleted
            return (top_scores, top_idx, match_count, final_mask,
                    adjusted, cursor_seen, text_mask)

        return jax.jit(run, static_argnames=(
            "k", "s_pad", "has_scored_terms", "need_scores", "use_cursor"))

    def _build_tile_executor(self):
        """Executor over compacted tile columns (the doc-tile pruned
        path, ops/tiles.py): identical matcher/score-tree semantics, M
        built from posting RUNS restricted to the selected tiles, every
        doc-axis input pre-gathered to tile space by the host."""
        jnp = self._jnp
        jax = self._jax

        def run(docs_flat, impacts_flat, deleted_tiles, tiles, runs,
                w_leaf, leaf_ind, group_ind,
                phrase_masks, filter_masks, col_vals, col_has,
                root_mask,
                *, k: int, s_pad: int, n_cols: int, p_pad: int,
                has_scored_terms: bool, need_scores: bool,
                fmt: int = 3):
            from searchlite.ops.tiles import (
                build_m_from_runs,
                unpack_runs,
            )

            run_start, run_len, run_slot, run_off = unpack_runs(
                jax, runs, fmt)
            m = build_m_from_runs(jnp, docs_flat, impacts_flat,
                                  run_start, run_len, run_slot, run_off,
                                  n_cols, s_pad, p_pad)
            # tile-space deleted mask from the resident padded copy
            # (no per-launch host upload)
            deleted_cols = deleted_tiles[tiles].reshape(-1)
            final_mask, adjusted, _matcher_mask, _ones = self._core(
                m, deleted_cols, w_leaf, leaf_ind, group_ind,
                phrase_masks, filter_masks, col_vals, col_has,
                root_mask, has_scored_terms, need_scores)
            match_count = final_mask.sum()
            masked = jnp.where(final_mask, adjusted,
                               -jnp.inf).astype(jnp.float32)
            top_scores, top_idx = jax.lax.top_k(masked, k)
            return top_scores, top_idx, match_count

        return jax.jit(run, static_argnames=(
            "k", "s_pad", "n_cols", "p_pad", "has_scored_terms",
            "need_scores", "fmt"))

    def _build_tile_mask_executor(self):
        """Chunked full-width execution: same tile-column core but
        returning the dense per-column outputs (final_mask, adjusted,
        text_mask) instead of a top-k — the host stitches consecutive
        chunks back into doc space. This is how corpora whose S·n1
        dense M exceeds int32 indexing / the HBM budget execute: exact,
        bounded memory, no wall."""
        jnp = self._jnp
        jax = self._jax

        def run(docs_flat, impacts_flat, deleted_tiles, tiles, runs,
                w_leaf, leaf_ind, group_ind,
                phrase_masks, filter_masks, col_vals, col_has,
                root_mask,
                *, s_pad: int, n_cols: int, p_pad: int,
                has_scored_terms: bool, need_scores: bool,
                fmt: int = 3):
            from searchlite.ops.tiles import (
                build_m_from_runs,
                unpack_runs,
            )

            run_start, run_len, run_slot, run_off = unpack_runs(
                jax, runs, fmt)
            m = build_m_from_runs(jnp, docs_flat, impacts_flat,
                                  run_start, run_len, run_slot, run_off,
                                  n_cols, s_pad, p_pad)
            deleted_cols = deleted_tiles[tiles].reshape(-1)
            final_mask, adjusted, matcher_mask, _ones = self._core(
                m, deleted_cols, w_leaf, leaf_ind, group_ind,
                phrase_masks, filter_masks, col_vals, col_has,
                root_mask, has_scored_terms, need_scores)
            text_mask = matcher_mask & ~deleted_cols
            return final_mask, adjusted, text_mask

        return jax.jit(run, static_argnames=(
            "s_pad", "n_cols", "p_pad", "has_scored_terms",
            "need_scores", "fmt"))

    def executor(self):
        if "run" not in self._jit_cache:
            self._jit_cache["run"] = self._build_executor()
        return self._jit_cache["run"]

    def tile_mask_executor(self):
        if "tile_mask" not in self._jit_cache:
            self._jit_cache["tile_mask"] = self._build_tile_mask_executor()
        return self._jit_cache["tile_mask"]

    def tile_executor(self):
        if "tile_run" not in self._jit_cache:
            self._jit_cache["tile_run"] = self._build_tile_executor()
        return self._jit_cache["tile_run"]
