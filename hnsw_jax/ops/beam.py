"""Fixed-width batched best-first beam search — the accelerator replacement
for faiss's ``search_from_candidates`` + ``MinimaxHeap`` (SURVEY.md §2b C5).

Design (BASELINE.json:5): all dynamic structures become masked fixed-width
arrays so XLA compiles ONE executable:

  * candidate/result priority queues  -> one sorted (ascending) top-ef buffer
    per query with an "expanded" flag per slot. The nearest unexpanded entry
    is always in the buffer (anything farther than the worst buffer entry is
    dropped, which is exactly faiss's check_relative_distance pruning), so
    best-first order and termination semantics are preserved.
  * VisitedTable -> by default, *buffer membership* ("buffer" mode): a new
    candidate is fresh iff its id is not already in the top-ef buffer. This
    is outcome-equivalent to a visited set: (a) anything in the buffer is
    caught by the membership compare; (b) a node displaced from the buffer
    is by definition worse than the buffer's worst, so a re-encounter is
    rejected by the merge and can never be (re-)expanded. The only cost is
    occasionally recomputing a distance for a re-encountered dropped node,
    in exchange for a dense [Q, K, ef] membership compare instead of a
    per-hop scatter into a [Q, ceil(cap/32)] bitmap. The exact-bitmap
    variant is kept as visited_mode="bitmap" for A/B and debugging.
  * per-query termination -> convergence mask inside one lax.while_loop; the
    batch loops until every query converged (or the hop cap).

Queries are data-parallel along axis 0 throughout — the accelerator analogue
of faiss's OpenMP query loop (C13).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

INF = jnp.inf


class BeamState(NamedTuple):
    buf_ids: jax.Array   # int32 [Q, ef]  (sorted ascending by buf_dist; -1 empty)
    buf_dist: jax.Array  # f32   [Q, ef]  (+inf for empty slots)
    buf_exp: jax.Array   # bool  [Q, ef]  (True == expanded OR empty)
    visited: jax.Array   # uint32 [Q, W]
    hops: jax.Array      # int32 []       total loop iterations
    ndis: jax.Array      # int32 [Q]      distances computed (faiss hnsw_stats)
    # filtered search (faiss IDSelector parity): traversal uses the
    # unfiltered buffer above; allowed candidates additionally compete for
    # this separate result top-k. None when no filter is active.
    res_ids: jax.Array | None = None   # int32 [Q, k]
    res_dist: jax.Array | None = None  # f32   [Q, k]


def init_visited(q: int, capacity: int) -> jax.Array:
    return jnp.zeros((q, (capacity + 31) // 32), jnp.uint32)


def mark_visited(visited: jax.Array, ids: jax.Array,
                 mask: jax.Array) -> jax.Array:
    """Set bits for ids [Q, K] where mask; ids must be unique within a row."""
    ids_safe = jnp.where(mask, ids, 0)
    word = ids_safe >> 5
    bit = (ids_safe & 31).astype(jnp.uint32)
    add = jnp.where(mask, jnp.uint32(1) << bit, jnp.uint32(0))
    qidx = jax.lax.broadcasted_iota(jnp.int32, ids.shape, 0)
    return visited.at[qidx, word].add(add, mode="drop")


def test_visited(visited: jax.Array, ids: jax.Array,
                 mask: jax.Array) -> jax.Array:
    """Returns bool [Q, K]: True where id already visited (or masked off)."""
    ids_safe = jnp.where(mask, ids, 0)
    word = ids_safe >> 5
    bit = (ids_safe & 31).astype(jnp.uint32)
    w = jnp.take_along_axis(visited, word, axis=1)
    seen = ((w >> bit) & 1).astype(jnp.bool_)
    return jnp.where(mask, seen, True)


def init_beam(entry_ids: jax.Array, entry_dists: jax.Array, ef: int,
              capacity: int, active: jax.Array | None = None,
              visited_mode: str = "buffer",
              key_dtype=jnp.float32) -> BeamState:
    """Seed the beam with one entry point per query (already visited).

    ``active`` (bool [Q], optional): inactive queries start fully expanded,
    so the while-loop never does work for them (used by the builder to mask
    batch points not present at a given level).

    ``key_dtype``: dtype of the buffer distances — the per-hop merge is a
    two-operand lax.sort whose cost is keyed by this dtype. The QUERY path
    may use bf16 where routing is already quantized (routing-grade: the
    extraction rerank restores exact distances for every mode); the
    BUILDER keeps f32 — its buffer distances feed the select-neighbors
    pruning directly."""
    qn = entry_ids.shape[0]
    if active is None:
        active = jnp.ones((qn,), jnp.bool_)
    buf_ids = jnp.full((qn, ef), -1, jnp.int32).at[:, 0].set(
        jnp.where(active, entry_ids, -1))
    buf_dist = jnp.full((qn, ef), INF, key_dtype).at[:, 0].set(
        jnp.where(active, entry_dists, INF).astype(key_dtype))
    buf_exp = jnp.ones((qn, ef), jnp.bool_).at[:, 0].set(~active)
    if visited_mode == "bitmap":
        visited = init_visited(qn, capacity)
        visited = mark_visited(visited, entry_ids[:, None], active[:, None])
    else:
        visited = jnp.zeros((qn, 1), jnp.uint32)  # placeholder leaf
    return BeamState(buf_ids, buf_dist, buf_exp, visited,
                     jnp.asarray(0, jnp.int32), jnp.zeros((qn,), jnp.int32))


def attach_result_buffer(state: BeamState, k: int, allowed: jax.Array
                         ) -> BeamState:
    """Enable filtered search: a separate [Q, k] result top-k collects only
    ids with allowed[id] True (the entry point included when allowed)."""
    qn, _ = state.buf_ids.shape
    e_id = state.buf_ids[:, 0]
    ok = (e_id >= 0) & allowed[jnp.maximum(e_id, 0)]
    res_ids = jnp.full((qn, k), -1, jnp.int32).at[:, 0].set(
        jnp.where(ok, e_id, -1))
    # the result buffer keeps f32 keys even when the main buffer merges in
    # bf16: it is only k wide (its sort is cheap) and it SELECTS the final
    # k — bf16 keys here would let boundary near-ties diverge from the
    # exactly-reranked unfiltered result set
    res_dist = jnp.full((qn, k), INF, jnp.float32).at[:, 0].set(
        jnp.where(ok, state.buf_dist[:, 0].astype(jnp.float32), INF))
    return state._replace(res_ids=res_ids, res_dist=res_dist)


def beam_search(
    state: BeamState,
    gather_neighbors: Callable[[jax.Array], jax.Array],
    distance_to: Callable[[jax.Array, jax.Array], jax.Array],
    max_hops: int,
    n_expand: int = 1,
    visited_mode: str = "buffer",
    allowed: jax.Array | None = None,
    ef_live: jax.Array | None = None,
    hop_limit: jax.Array | None = None,
    expand: Callable | None = None,
) -> BeamState:
    """Run best-first expansion until every query's buffer is fully expanded.

    gather_neighbors: ids [Q] (or [Q, T]) -> neighbor ids [Q, K] int32,
        -1-padded; MUST be duplicate-free per source node (graph invariant).
    distance_to: (ids [Q, K], valid mask) -> dists [Q, K] (smaller = closer).
    n_expand: candidates expanded per hop per query (T). 1 == faiss-exact
        best-first order; >1 trades extra distance computations for fewer,
        fatter hops (larger gathers and contractions per hop, same or
        better recall).
    visited_mode: "buffer" (membership dedup, fast; see module docstring) or
        "bitmap" (exact visited set, costs a per-hop scatter).
    ef_live: optional traced scalar <= buffer width: after each merge, slots
        at positions >= ef_live are killed ((inf, -1, expanded)), which is
        bit-equivalent to running an ef_live-wide buffer. This makes efSearch
        a RUNTIME knob within one compiled program (faiss mutable efSearch
        without recompile): programs are compiled per power-of-two bucket
        and the true ef masks the tail.
    hop_limit: optional traced scalar — stop after this many hops even if
        unexpanded entries remain. The convergence tail is long and serves
        few queries, so bounding it is the cheapest QPS lever; being traced,
        the cap
        changes per call with no recompile. None == run to convergence
        (faiss check_relative_distance-exact termination).
    expand: optional fused expansion (ops/packed.py): (cur [Q, T], step_ok
        [Q, T]) -> (nbrs [Q, T, K], dist [Q, T*K]). When given it replaces
        gather_neighbors + distance_to: the expanded node's one packed code
        row yields both adjacency and ALL candidate distances (~3 HBM
        transactions per node instead of ~1 + K). Distances for non-fresh
        candidates are computed anyway (free — the row is already fetched)
        and masked after.
    """
    ef = state.buf_ids.shape[1]
    pos = jnp.arange(ef, dtype=jnp.int32)[None, :]

    def cond(s: BeamState):
        more = (s.hops < max_hops) & jnp.any(~s.buf_exp)
        if hop_limit is not None:
            more = more & (s.hops < hop_limit)
        return more

    def body(s: BeamState):
        with jax.named_scope("select"):
            # -- select the T nearest unexpanded buffer entries per query
            key = jnp.where(s.buf_exp, INF, s.buf_dist)
            if n_expand == 1:
                j = jnp.argmin(key, axis=1)[:, None]  # [Q, 1]
                sel_dist = jnp.take_along_axis(key, j, axis=1)
            else:
                neg, j = jax.lax.top_k(-key, n_expand)  # [Q, T]
                sel_dist = -neg
            step_ok = sel_dist < INF  # [Q, T]
            cur = jnp.take_along_axis(s.buf_ids, j, axis=1)  # [Q, T]
            cur_safe = jnp.where(step_ok, cur, 0)

  # -- mark them expanded (one-hot scatter keeps this a pure vector op)
            slot = jax.lax.broadcasted_iota(jnp.int32, (1, ef, 1), 1)
            hit = jnp.any((slot == j[:, None, :]) & step_ok[:, None, :],
                          axis=2)
            buf_exp = s.buf_exp | hit

        with jax.named_scope("neighbors"):
            # -- expand: gather adjacency rows, flatten T into the key axis
            if expand is not None:
                nbrs, pre_dist = expand(cur_safe, step_ok)  # packed
            else:
                nbrs = gather_neighbors(cur_safe)  # [Q, T, K]
                pre_dist = None
            qn = nbrs.shape[0]
            nbrs = nbrs.reshape(qn, -1)  # [Q, T*K]
            valid = (nbrs >= 0) & jnp.repeat(
                step_ok, nbrs.shape[1] // n_expand, axis=1)
        with jax.named_scope("dedup"):
            if visited_mode == "bitmap":
                # exact visited set: test + insert-time marking
                fresh = valid & ~test_visited(s.visited, nbrs, valid)
                visited = s.visited  # marked below, after hop-local dedup
            else:
                # buffer membership: fresh iff not already in the top-ef buffer
                member = jnp.any(nbrs[:, :, None] == s.buf_ids[:, None, :],
                                 axis=2)
                fresh = valid & ~member
                visited = s.visited
            # with n_expand > 1 the same id can appear under two parents in one
  # hop. In "buffer" mode we deliberately DON'T dedup here: the O(K^2)
            # first-occurrence mask costs more than the duplicate does. Both
            # copies get identical distances, sort adjacent in the buffer, and
            # are collapsed by dedup_sorted_buffer() at extraction; a duplicate
            # occasionally wastes one buffer slot / expansion, which is cheaper
  # than masking every hop. The bitmap path must stay exact (scatter-add
            # of a repeated bit would corrupt neighboring bits).
            if n_expand > 1 and visited_mode == "bitmap":
                nbrs_safe0 = jnp.where(fresh, nbrs, -1)
                first = _first_occurrence_mask(nbrs_safe0)
                fresh = fresh & first
            if visited_mode == "bitmap":
                visited = mark_visited(s.visited, nbrs, fresh)

        with jax.named_scope("distances"):
            dist = jnp.where(
                fresh,
                pre_dist if pre_dist is not None else distance_to(nbrs, fresh),
                INF)
            ndis = s.ndis + jnp.sum(fresh, axis=1, dtype=jnp.int32)
        with jax.named_scope("merge"):
            # main-buffer merge keys in the buffer's dtype (bf16 on quantized
            # query paths: a cheaper merge sort — see init_beam); the f32
            # `dist` stays live for the result buffer's exact selection
            dist_key = dist.astype(s.buf_dist.dtype)

  # -- merge into the sorted top-ef buffer. One multi-operand lax.sort
            # with (id, exp) packed into a single payload replaces top_k plus a
            # take_along_axis gather per operand.
            all_d = jnp.concatenate([s.buf_dist, dist_key], axis=1)
            payload = jnp.concatenate(
                [(s.buf_ids << 1) | buf_exp.astype(jnp.int32),
                 (jnp.where(fresh, nbrs, -1) << 1)
                 | (~fresh).astype(jnp.int32)],
                axis=1)
            sd, sp = jax.lax.sort((all_d, payload), num_keys=1)
            buf_dist = sd[:, :ef]
            buf_ids = sp[:, :ef] >> 1
            buf_exp2 = (sp[:, :ef] & 1).astype(jnp.bool_)
            if ef_live is not None:  # emulate an ef_live-wide buffer (see doc)
                dead = pos >= ef_live
                buf_dist = jnp.where(dead, INF, buf_dist)
                buf_ids = jnp.where(dead, -1, buf_ids)
                buf_exp2 = buf_exp2 | dead

        res_ids, res_dist = s.res_ids, s.res_dist
        if allowed is not None:
            # filtered result top-k: only selector-approved candidates.
            # Dedup BEFORE the merge: in buffer visited-mode a node displaced
            # from the beam can be re-encountered, and without this mask its
            # duplicate copy would permanently evict a genuine rank-k entry
            # from the fixed [Q, k] result buffer.
            res_ok = fresh & allowed[jnp.where(fresh, nbrs, 0)]
            in_res = jnp.any(nbrs[:, :, None] == res_ids[:, None, :], axis=2)
            res_ok = res_ok & ~in_res
            if n_expand > 1:  # same id under two parents within one hop
                res_ok = res_ok & _first_occurrence_mask(
                    jnp.where(res_ok, nbrs, -1))
            rd = jnp.concatenate(
                [res_dist, jnp.where(res_ok, dist, INF)], axis=1)
            ri = jnp.concatenate(
                [res_ids, jnp.where(res_ok, nbrs, -1)], axis=1)
            srd, sri = jax.lax.sort((rd, ri), num_keys=1)
            k = res_ids.shape[1]
            res_dist, res_ids = srd[:, :k], sri[:, :k]

        return BeamState(buf_ids, buf_dist, buf_exp2, visited,
                         s.hops + 1, ndis, res_ids, res_dist)

    return jax.lax.while_loop(cond, body, state)


def dedup_sorted_buffer(buf_ids: jax.Array, buf_dist: jax.Array):
    """Collapse duplicate ids in a distance-sorted buffer (n_expand > 1 can
    insert the same node twice with bit-identical distances). A (dist, id)
    two-key sort makes duplicates strictly adjacent even among equal
    distances; dups are then masked and pushed to the end as (-1, inf)."""
    sd0, si0 = jax.lax.sort((buf_dist, buf_ids), num_keys=2)
    prev = jnp.concatenate(
        [jnp.full_like(si0[:, :1], -2), si0[:, :-1]], axis=1)
    dup = (si0 == prev) & (si0 >= 0)
    d = jnp.where(dup, jnp.inf, sd0)
    i = jnp.where(dup, -1, si0)
    sd, si = jax.lax.sort((d, i), num_keys=1)
    return si, sd


def _first_occurrence_mask(ids: jax.Array) -> jax.Array:
    """bool [Q, K]: True at the first occurrence of each non-negative id in
    its row. O(K^2) pairwise compare — K is small (n_expand * m0)."""
    eq = ids[:, :, None] == ids[:, None, :]
    kidx = jax.lax.broadcasted_iota(jnp.int32, eq.shape, 2)
    jidx = jax.lax.broadcasted_iota(jnp.int32, eq.shape, 1)
    earlier = jnp.any(eq & (kidx < jidx), axis=2)
    return (ids >= 0) & ~earlier
