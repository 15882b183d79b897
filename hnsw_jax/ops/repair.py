"""Batched reciprocal-link (back-link) application — the lock-free device
replacement for faiss ``add_with_locks``'s per-node-locked back-link writes
(SURVEY.md §2b C7/C8, §5 race detection).

faiss, per inserted point p and kept neighbor t: append p to t's list under
t's lock; if the list overflows its capacity, re-prune it with the
select-neighbors heuristic. Races are prevented by locks.

Here the whole insert batch's (t, p) pairs are applied in ONE deterministic
data-parallel pass, so there is nothing to race on:

  1. sort all pairs by destination t               (one jnp.argsort)
  2. each destination's incoming sources are now a contiguous window; the
     first occurrence of each t owns its group
  3. per owning row: gather t's current adjacency row + up to R windowed
     incoming sources, dedupe, then append (if it fits) or heuristic-prune
     (faiss shrink semantics: prune only on overflow)
  4. scatter the new rows back — one writer per destination, by construction

Incoming sources beyond the R-window are dropped for this batch (they simply
lose one back-link, exactly as faiss's heuristic would likely prune a
64-fan-in hub anyway); R is sized so this is rare at sane batch sizes — and
the drop count is RETURNED so callers can observe rather than trust that
claim: DeviceBuilder accumulates it per build and logs it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import L2
from .prune import compact_append, select_neighbors


@functools.partial(jax.jit, static_argnames=("r_window", "metric"))
def apply_backlinks(
    adj: jax.Array,       # int32 [n_rows, W] adjacency table for ONE level
    dst_rows: jax.Array,  # int32 [P] row index into adj per pair
    dst_ids: jax.Array,   # int32 [P] destination node id (for distances)
    src_ids: jax.Array,   # int32 [P] source node id to back-link
    valid: jax.Array,     # bool  [P]
    vectors: jax.Array,   # [capacity, d] vector storage (codes for sq8/pq)
    dequant=None,         # optional (offset [d], scale [d]) for sq8 storage
    pq_cb=None,           # optional codebooks [m_sub, ksub, dsub] for pq
    *,
    r_window: int = 16,
    metric: str = L2,
):
    """Returns (updated adjacency table, n_dropped) where n_dropped counts
    valid pairs beyond the R-window of their destination group — back-links
    silently lost this batch (pairs that were window-reachable but
    duplicate-suppressed are NOT drops)."""
    P = dst_rows.shape[0]
    W = adj.shape[1]
    n_rows = adj.shape[0]
    R = min(r_window, P)

    big = jnp.int32(2**31 - 1)
    key = jnp.where(valid, dst_rows, big)
    order = jnp.argsort(key)
    sdst_row = key[order]                       # [P] sorted, invalid at end
    sdst_id = jnp.where(valid, dst_ids, -1)[order]
    ssrc = jnp.where(valid, src_ids, -1)[order]

    pos = jnp.arange(P, dtype=jnp.int32)
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), sdst_row[:-1]])
    svalid = sdst_row < big
    first = svalid & (sdst_row != prev)

    # drop observability: a pair whose rank within its destination group is
    # >= R never enters any window below
    group_start = jax.lax.cummax(jnp.where(first, pos, -1))
    n_dropped = jnp.sum(svalid & (pos - group_start >= R),
                        dtype=jnp.int32)

    # windowed incoming sources per first-occurrence row
    raw = pos[:, None] + jnp.arange(R, dtype=jnp.int32)[None, :]  # [P, R]
    in_bound = raw < P  # must mask BEFORE clipping, else the tail group
    widx = jnp.minimum(raw, P - 1)  # would see its last source duplicated
    inc_src = ssrc[widx]                                        # [P, R]
    inc_ok = in_bound & (sdst_row[widx] == sdst_row[:, None]) & \
        svalid[:, None] & (inc_src >= 0)

    # current adjacency rows of the destinations
    row_idx_safe = jnp.where(svalid, sdst_row, 0)
    rows = adj[row_idx_safe]                                    # [P, W]
    # dedupe: drop incoming already present in the row (happens for in-batch
    # destinations whose fresh forward row already contains the source)
    dup = jnp.any(inc_src[:, :, None] == rows[:, None, :], axis=2)
    inc_ok = inc_ok & ~dup
    inc_src = jnp.where(inc_ok, inc_src, -1)

    cand_ids = jnp.concatenate([rows, inc_src], axis=1)         # [P, W+R]
    cand_valid = cand_ids >= 0
    count = jnp.sum(cand_valid, axis=1)                         # [P]

    # ---- append path (no overflow): compact valid candidates in order.
    # One-hot matmul, not a [P, W] scatter (dense work instead of
    # serialized writes).
    appended = compact_append(cand_ids, W)

    # ---- overflow path: heuristic prune to W w.r.t. the destination vector.
    # The candidate-vector gather is [P, W+R, d] — at P = B*m0 and d in the
    # hundreds that transient alone can exceed HBM (e.g. 20 GB for GIST's
    # d=960), so the prune streams over row chunks via lax.map.
    d_model = vectors.shape[1] if pq_cb is None else \
        pq_cb.shape[0] * pq_cb.shape[2]  # decoded width for PQ codes
    row_bytes = (W + R) * d_model * 4
    chunk = max(256, min(P, (1 << 29) // max(row_bytes, 1)))
    chunk = 1 << (chunk.bit_length() - 1)  # power of two
    n_chunks = -(-P // chunk)
    pad = n_chunks * chunk - P

    def pad_p(a, fill):
        return jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                       constant_values=fill)

    c_dst = pad_p(jnp.where(svalid, sdst_id, 0), 0).reshape(n_chunks, chunk)
    c_ids = pad_p(jnp.where(cand_valid, cand_ids, -1), -1).reshape(
        n_chunks, chunk, W + R)

    def prune_chunk(args):
        dst_c, ids_c = args
        dvec = vectors[dst_c]                                   # [C, d]
        cvec = vectors[jnp.maximum(ids_c, 0)]
        if pq_cb is not None:    # pq storage: decode to x̂
            from .pq import decode_pq
            dvec = decode_pq(dvec, pq_cb)
            cvec = decode_pq(cvec, pq_cb)
        else:
            dvec = dvec.astype(jnp.float32)
            cvec = cvec.astype(jnp.float32)
            if dequant is not None:  # sq8 storage: distances against x̂
                dvec = dequant[0] + dequant[1] * dvec
                cvec = dequant[0] + dequant[1] * cvec
        dots = jnp.einsum("pd,pcd->pc", dvec, cvec,
                          preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
        if metric == L2:
            dsq = jnp.sum(dvec * dvec, axis=1, keepdims=True)
            csq = jnp.einsum("pcd,pcd->pc", cvec, cvec,
                             preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
            cd = dsq + csq - 2.0 * dots
        else:
            cd = -dots
        pruned_c, _ = select_neighbors(ids_c, cd, cvec, m=W, metric=metric)
        return pruned_c

    pruned = jax.lax.map(prune_chunk, (c_dst, c_ids)).reshape(-1, W)[:P]

    new_rows = jnp.where((count <= W)[:, None], appended, pruned)

    # ---- scatter back: only the first occurrence of each destination writes
    scat_idx = jnp.where(first, sdst_row, n_rows)  # n_rows == OOB -> dropped
    return adj.at[scat_idx].set(new_rows, mode="drop"), n_dropped
