"""Vectorized select-neighbors heuristic (SURVEY.md §2b C9).

The quality-critical HNSW pruning rule (paper Alg. 4 / faiss
``shrink_neighbor_list``): scanning candidates by increasing distance to the
query, keep candidate c only if c is closer to the query than to every
already-kept neighbor. The rule is sequential in the scan position but fully
data-parallel across the batch.

Device realization: the scan order is NOT obtained by sorting. Instead of a
row-wise argsort + take_along_axis of the [B, C, d] candidate vectors (a
sort and a gather per row), we compute counting ranks (one [B, C, C]
comparison + row-sum, elementwise) and apply the permutation as a one-hot
MATMUL — exact for f32 payloads, and dense work only. The final compaction
scatter is a one-hot matmul for the same reason.

Numeric contract: candidate ids must be < 2^24 (exact in f32; capacity-
checked in HnswConfig) and distances < 1e30 (BIG sentinel).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import IP, L2

BIG = 1e30  # finite +inf stand-in: rides through one-hot matmuls NaN-free


def pairwise_candidate_distances(vecs: jax.Array, metric: str) -> jax.Array:
    """[B, C, d] -> [B, C, C] true metric distances between candidates."""
    v = vecs.astype(jnp.float32)
    dots = jnp.einsum("bid,bjd->bij", v, v, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    if metric == IP:
        return -dots
    sq = jnp.einsum("bid,bid->bi", v, v, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    return sq[:, :, None] + sq[:, None, :] - 2.0 * dots


def counting_rank(key: jax.Array) -> jax.Array:
    """Stable ascending rank per row without a sort: rank[b, j] =
    #{i : key[b,i] < key[b,j] or (key[b,i] == key[b,j] and i < j)}."""
    C = key.shape[-1]
    idx = jnp.arange(C, dtype=jnp.int32)
    less = key[:, None, :] < key[:, :, None]               # [B, j, i]
    tie = (key[:, None, :] == key[:, :, None]) & \
        (idx[None, None, :] < idx[None, :, None])
    return jnp.sum(less | tie, axis=2, dtype=jnp.int32)    # [B, C]


def permutation_onehot(rank: jax.Array, n_out: int) -> jax.Array:
    """O[b, r, j] = 1.0 where rank[b, j] == r; f32 [B, n_out, C]."""
    r_iota = jnp.arange(n_out, dtype=jnp.int32)
    return (rank[:, None, :] == r_iota[None, :, None]).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("m", "metric"))
def select_neighbors(
    cand_ids: jax.Array,    # int32 [B, C], -1 == invalid slot
    cand_dists: jax.Array,  # f32   [B, C], TRUE metric distance to the query
    cand_vecs: jax.Array,   # f32   [B, C, d] candidate vectors
    *,
    m: int,
    metric: str = L2,
) -> tuple[jax.Array, jax.Array]:
    """Prune candidate sets to <= m diversified neighbors.

    Returns (kept_ids [B, m] int32 -1-padded in scan order, kept_mask [B, C]).
    Candidates need not be pre-sorted; duplicates (same id twice in a row)
    must not occur (graph invariant).
    """
    B, C = cand_ids.shape
    key = jnp.where(cand_ids >= 0, jnp.minimum(cand_dists, BIG / 2), BIG)

    # --- scan order via counting ranks + one-hot matmul permutation
    rank = counting_rank(key)                               # [B, C]
    O = permutation_onehot(rank, C)                         # [B, C, C] f32
    ids_f = cand_ids.astype(jnp.float32)                    # exact: id < 2^24
    ids_s = jnp.einsum("brj,bj->br", O, ids_f,
                       preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    dist_s = jnp.einsum("brj,bj->br", O, key,
                        preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    vecs_s = jnp.einsum("brj,bjd->brd", O, cand_vecs.astype(jnp.float32),
                        preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)

    pair = pairwise_candidate_distances(vecs_s, metric)     # [B, C, C]
    valid_s = dist_s < BIG / 2

    kept = jnp.zeros((B, C), jnp.bool_)
    count = jnp.zeros((B,), jnp.int32)

    def body(j, state):
        kept, count = state
        dj = dist_s[:, j]                                   # [B]
        # conflict: some already-kept i has dist(c_j, c_i) < dist(c_j, q)
        conflict = jnp.any(kept & (pair[:, j, :] < dj[:, None]), axis=1)
        take = valid_s[:, j] & ~conflict & (count < m)
        kept = kept.at[:, j].set(take)
        return kept, count + take.astype(jnp.int32)

    kept, count = jax.lax.fori_loop(0, C, body, (kept, count))

    # --- compact kept ids (scan order) into m slots: one-hot matmul, not a
    # scatter (a dense product instead of serialized writes)
    rank2 = jnp.cumsum(kept.astype(jnp.int32), axis=1) - 1  # [B, C]
    comp = permutation_onehot(jnp.where(kept, rank2, -1), m)  # [B, m, C]
    out_f = jnp.einsum("bsr,br->bs", comp, ids_s,
                       preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    has = jnp.einsum("bsr,br->bs", comp, kept.astype(jnp.float32),
                     preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST) > 0.5
    out = jnp.where(has, out_f.astype(jnp.int32), -1)

    # --- un-sort kept back to the caller's candidate order (matmul again)
    kept_orig = jnp.einsum("brj,br->bj", O, kept.astype(jnp.float32),
                           preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST) > 0.5
    return out, kept_orig


def compact_append(cand_ids: jax.Array, width: int) -> jax.Array:
    """Compact each row's valid (>= 0) ids into the first slots, preserving
    order; rows wider than ``width`` are truncated. One-hot matmul instead of
    a scatter (same rationale as above). [B, C] -> [B, width]."""
    cv = cand_ids >= 0
    rank = jnp.cumsum(cv.astype(jnp.int32), axis=1) - 1
    one = permutation_onehot(jnp.where(cv, rank, -1), width)  # [B, width, C]
    out_f = jnp.einsum("bwc,bc->bw", one, cand_ids.astype(jnp.float32),
                       preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    has = jnp.einsum("bwc,bc->bw", one, cv.astype(jnp.float32),
                     preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST) > 0.5
    return jnp.where(has, out_f.astype(jnp.int32), -1)
