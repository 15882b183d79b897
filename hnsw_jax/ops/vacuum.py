"""Graph vacuum: physically remove tombstoned nodes from routing.

``HnswIndex.remove_ids`` tombstones (filters results, keeps routing) —
cheap, but every query still pays hops and distance computations through
dead nodes, and result filtering forces full-convergence beams. ``vacuum``
finishes the job on-device: every link INTO a dead node is removed and the
hole is patched with candidates inherited from the dead node's own
neighbor list (re-pruned with the select-neighbors heuristic, so graph
quality is preserved — the same repair rule hnswlib's deletion patch
applies), dead nodes' own rows are cleared, and the entry point moves to a
live node. Ids stay stable (slots are not renumbered or reused; faiss
remove_ids renumbers — ``HnswIndex.compacted`` is the renumbering path).

No upstream faiss equivalent: faiss IndexHNSW has no deletion at all
(reference is the 2-line README naming faiss-HNSW as the capability spec,
/root/reference/README.md:2); hnswlib's repair is the behavioral model.

Device realization: one donated jitted program per table; the level-0 pass
streams the adjacency in row chunks through a fori_loop. Per chunk: mask
dead neighbors, gather the dead neighbors' rows ([C, m0, m0] — dead rows
are never written by this pass, so inheritance always reads pre-vacuum
lists), compact the first live inherited ids (one-hot matmul, no scatter),
dedup the pool, and re-prune to m0 with ops.prune.select_neighbors. Rows
with no dead neighbor are kept BIT-IDENTICAL (the heuristic could legally
choose a different list; a no-op vacuum must be a no-op).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import L2
from .beam import _first_occurrence_mask
from .prune import compact_append, select_neighbors


def _read_rows(raw, dequant=None, pq=None):
    """Stored rows -> f32 vectors (x̂ for codecs) — build.py read_rows."""
    if pq is not None:
        from .pq import _decode_onehot
        return _decode_onehot(raw, pq, jnp.float32,
                              jax.lax.Precision.HIGHEST)
    v = raw.astype(jnp.float32)
    if dequant is not None:
        v = dequant[0] + dequant[1] * v
    return v


def _vacuum_level0_impl(neighbors0: jax.Array, vectors: jax.Array,
                        dead: jax.Array, *, metric: str = L2,
                        chunk: int = 4096, dequant=None, pq=None
                        ) -> jax.Array:
    """Patch + purge the level-0 adjacency. dead: bool [capacity].

    Returns the new adjacency (donated in). For every live row with >= 1
    dead neighbor: candidates = live neighbors ∪ first 2*m0 live ids
    inherited from dead neighbors' lists, deduped, re-pruned to m0 by the
    select-neighbors heuristic on true distances to the row's own vector.
    Dead rows are cleared to -1 afterwards."""
    cap, m0 = neighbors0.shape
    n_chunks = (cap + chunk - 1) // chunk
    pad = n_chunks * chunk - cap
    adj = jnp.pad(neighbors0, ((0, pad), (0, 0)),
                  constant_values=-1) if pad else neighbors0

    def body(i, adj):
        rows = jax.lax.dynamic_slice(adj, (i * chunk, 0), (chunk, m0))
        ids_u = i * chunk + jnp.arange(chunk, dtype=jnp.int32)
        valid = rows >= 0
        safe = jnp.maximum(rows, 0)
        nbr_dead = valid & dead[safe]
        had_dead = jnp.any(nbr_dead, axis=1) & ~dead[
            jnp.minimum(ids_u, dead.shape[0] - 1)] & (ids_u < cap)
        live_n = jnp.where(valid & ~nbr_dead, rows, -1)

        # inherited candidates: the dead neighbors' own lists (read-only
        # rows — this pass never writes a dead row), live ids only, not u
        dn = jnp.where(nbr_dead, rows, 0)
        inh = adj[dn]                                    # [C, m0, m0]
        inh_ok = nbr_dead[:, :, None] & (inh >= 0)
        inh_ok = inh_ok & ~dead[jnp.maximum(inh, 0)] \
            & (inh != ids_u[:, None, None])
        inh = jnp.where(inh_ok, inh, -1).reshape(chunk, m0 * m0)
        inh = compact_append(inh, 2 * m0)                # [C, 2*m0]

        pool = jnp.concatenate([live_n, inh], axis=1)    # [C, 3*m0]
        pool = jnp.where(_first_occurrence_mask(pool), pool, -1)

        # true-metric distances u -> pool for the pruning heuristic
        vu = _read_rows(vectors[jnp.minimum(ids_u, cap - 1)], dequant, pq)
        vc = _read_rows(vectors[jnp.maximum(pool, 0)], dequant, pq)
        dots = jnp.einsum("cd,ckd->ck", vu, vc,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        if metric == L2:
            sq = jnp.einsum("ckd,ckd->ck", vc, vc,
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
            usq = jnp.sum(vu * vu, axis=1, keepdims=True)
            dist = usq + sq - 2.0 * dots
        else:
            dist = -dots
        kept, _ = select_neighbors(pool, dist, vc, m=m0, metric=metric)

        new_rows = jnp.where(had_dead[:, None], kept, rows)
        return jax.lax.dynamic_update_slice(adj, new_rows, (i * chunk, 0))

    adj = jax.lax.fori_loop(0, n_chunks, body, adj)
    if pad:
        adj = adj[:cap]
    # clear dead nodes' own rows (after patching: inheritance reads them)
    return jnp.where(dead[:, None], -1, adj)


def _vacuum_upper_impl(upper_neighbors: jax.Array, upper_node: jax.Array,
                       upper_slot: jax.Array, levels: jax.Array,
                       vectors: jax.Array, dead: jax.Array, *,
                       metric: str = L2, dequant=None, pq=None) -> jax.Array:
    """Same treatment for every upper level (tables are ~capacity/m rows —
    one unchunked pass per level). Slot/level maps are untouched: dead
    nodes keep their slots (never reused), only links change."""
    U, L, m = upper_neighbors.shape
    nodes = upper_node                                    # [U]
    node_ok = nodes >= 0
    nsafe = jnp.maximum(nodes, 0)
    row_dead = node_ok & dead[nsafe]
    vu = _read_rows(vectors[nsafe], dequant, pq)          # [U, d]
    usq = jnp.sum(vu * vu, axis=1, keepdims=True)

    def level_pass(l, upper):
        lvl_tab = jax.lax.dynamic_index_in_dim(
            upper, l, axis=1, keepdims=False)             # [U, m]
        rows = lvl_tab
        valid = rows >= 0
        safe = jnp.maximum(rows, 0)
        nbr_dead = valid & dead[safe]
        had_dead = jnp.any(nbr_dead, axis=1) & node_ok & ~row_dead
        live_n = jnp.where(valid & ~nbr_dead, rows, -1)

        dslot = jnp.maximum(upper_slot[safe], 0)
        inh = lvl_tab[dslot]                              # [U, m, m]
        inh_ok = nbr_dead[:, :, None] & (inh >= 0)
        inh_ok = inh_ok & ~dead[jnp.maximum(inh, 0)] \
            & (inh != nodes[:, None, None])
        inh = jnp.where(inh_ok, inh, -1).reshape(U, m * m)
        inh = compact_append(inh, 2 * m)

        pool = jnp.concatenate([live_n, inh], axis=1)     # [U, 3*m]
        pool = jnp.where(_first_occurrence_mask(pool), pool, -1)
        vc = _read_rows(vectors[jnp.maximum(pool, 0)], dequant, pq)
        dots = jnp.einsum("cd,ckd->ck", vu, vc,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        if metric == L2:
            sq = jnp.einsum("ckd,ckd->ck", vc, vc,
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
            dist = usq + sq - 2.0 * dots
        else:
            dist = -dots
        kept, _ = select_neighbors(pool, dist, vc, m=m, metric=metric)
        new_rows = jnp.where(had_dead[:, None], kept, rows)
        new_rows = jnp.where(row_dead[:, None], -1, new_rows)
        return jax.lax.dynamic_update_slice_in_dim(
            upper, new_rows[:, None, :], l, axis=1)

    return jax.lax.fori_loop(0, L, level_pass, upper_neighbors)


# jitted single-index entry points (donated in-place updates); the raw
# _impl functions above are what ShardedHnswIndex.vacuum composes under
# shard_map (per-shard, no collectives)
vacuum_level0 = functools.partial(jax.jit, donate_argnums=(0,),
                                  static_argnames=("metric", "chunk")
                                  )(_vacuum_level0_impl)
vacuum_upper = functools.partial(jax.jit, donate_argnums=(0,),
                                 static_argnames=("metric",)
                                 )(_vacuum_upper_impl)


@jax.jit
def live_entry_point(levels: jax.Array, dead: jax.Array):
    """(entry_point, max_level) over live nodes only; (-1, -1) if none."""
    live_lv = jnp.where((levels >= 0) & ~dead, levels, -1)
    mx = jnp.max(live_lv)
    ep = jnp.argmax(live_lv).astype(jnp.int32)
    return jnp.where(mx >= 0, ep, -1), mx
