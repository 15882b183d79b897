"""Batched distance computation + exact brute-force top-k (the oracle).

Capability parity: faiss's SIMD distance layer (``fvec_L2sqr`` /
``fvec_inner_product``) and ``IndexFlat`` exact search (SURVEY.md §2b C3/C16).
Device realization: distances are expressed as one big matmul so they run
as a dense matrix product; the database is streamed in static tiles with a
running top-k merge so arbitrarily large N fits in device memory.

Distance conventions (smaller == closer, everywhere in this package):
  * l2: squared L2  ||q - x||^2
  * ip: negated inner product  -<q, x>   (so argmin == max inner product)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import IP, L2


def pairwise_distances(queries: jax.Array, base: jax.Array, metric: str,
                       base_sqnorms: jax.Array | None = None) -> jax.Array:
    """[Q, d] x [N, d] -> [Q, N] distance matrix (convention above).

    The q·x term is a single matrix product for both metrics. For L2 the
    query-norm term is omitted: it is constant per query, so ranking,
    top-k and beam-search decisions are unaffected (callers that need true
    squared L2 values add ||q||^2 back — see `true_l2`).
    """
    dots = jax.lax.dot_general(
        queries, base,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    if metric == IP:
        return -dots
    if base_sqnorms is None:
        base_sqnorms = jnp.sum(base.astype(jnp.float32) ** 2, axis=-1)
    return base_sqnorms[None, :] - 2.0 * dots


def true_l2(ranked_dist: jax.Array, queries: jax.Array) -> jax.Array:
    """Convert the rank-equivalent L2 surrogate (||x||^2 - 2 q·x) back to
    actual squared L2 by adding ||q||^2."""
    qn = jnp.sum(queries.astype(jnp.float32) ** 2, axis=-1, keepdims=True)
    return ranked_dist + qn


def _merge_topk(dist_a, idx_a, dist_b, idx_b, k):
    """Merge two (dist, idx) top-k sets -> best k. Shapes [..., ka], [..., kb]."""
    d = jnp.concatenate([dist_a, dist_b], axis=-1)
    i = jnp.concatenate([idx_a, idx_b], axis=-1)
    neg_top, pos = jax.lax.top_k(-d, k)
    return -neg_top, jnp.take_along_axis(i, pos, axis=-1)


@functools.partial(jax.jit, static_argnames=("k", "metric", "tile_n", "tile_q"))
def brute_force_topk(
    queries: jax.Array,
    base: jax.Array,
    k: int,
    metric: str = L2,
    tile_n: int = 65536,
    tile_q: int = 0,
    base_sqnorms: jax.Array | None = None,
    n_valid: jax.Array | int | None = None,
    dequant=None,
    pq=None,
):
    """Exact k-NN: returns (dists [Q, k], ids [Q, k]) sorted ascending.

    Streams the database in `tile_n`-row tiles through a lax.scan with a
    running top-k merge, so N is bounded only by HBM. Matches faiss
    IndexFlat search semantics (SURVEY.md C16); also the recall oracle.

    ``n_valid``: rows >= n_valid are excluded (traced scalar — lets callers
    pass a partially-filled capacity-sized array directly; an eager
    ``base[:n]`` slice would materialize a full copy, multi-GB at scale).

    ``dequant``: (offset [d], scale [d]) when ``base`` holds sq8 codes —
    tiles are dequantized in-register (never materializing an f32 copy of
    the table), making this the exact oracle over x̂ for sq8 indexes.

    ``pq``: codebooks [m_sub, ksub, dsub] when ``base`` holds PQ codes —
    tiles are decoded per scan step (same no-f32-copy property), making
    this the exact ADC oracle over x̂ for pq indexes.
    """
    q = queries.shape[0]
    n = base.shape[0]
    if n_valid is None:
        n_valid = n
    queries = queries.astype(jnp.float32)
    d = base.shape[1]  # tile width in STORED columns (m_sub for pq codes)

    def read_tile(t):  # stored rows -> f32 vectors (x̂ for codecs)
        if pq is not None:
            from .pq import decode_pq
            return decode_pq(t, pq)
        t = t.astype(jnp.float32)
        if dequant is not None:
            t = dequant[0] + dequant[1] * t
        return t

    if pq is not None and base_sqnorms is None:
        from .pq import pq_sqnorms
        base_sqnorms = pq_sqnorms(base, pq)
    elif dequant is not None and base_sqnorms is None:
        base_sqnorms = jnp.sum(
            (dequant[0] + dequant[1] * base.astype(jnp.float32)) ** 2,
            axis=-1)

    def finalize(dist, idx):
        # slots that only ever saw masked (+inf) rows are not real results
        idx = jnp.where(jnp.isposinf(dist), -1, idx)
        # internal ranking uses the ||x||^2 - 2 q·x surrogate; report true
        # squared L2 (consistent with HnswIndex.search)
        if metric == L2:
            dist = jnp.where(idx >= 0, true_l2(dist, queries), dist)
        return dist, idx

    if tile_q and q > tile_q:
        # secondary tiling over queries to bound the [tile_q, tile_n] buffer
        pads = (-q) % tile_q
        qp = jnp.pad(queries, ((0, pads), (0, 0)))
        fn = lambda qt: brute_force_topk(qt, base, k, metric, tile_n, 0,
                                         base_sqnorms, n_valid, dequant, pq)
        dist, idx = jax.lax.map(fn, qp.reshape(-1, tile_q, queries.shape[1]))
        return dist.reshape(-1, k)[:q], idx.reshape(-1, k)[:q]

    if n <= tile_n:
        bset = base if (dequant is None and pq is None) else read_tile(base)
        dm = pairwise_distances(queries, bset, metric, base_sqnorms)
        col = jax.lax.broadcasted_iota(jnp.int32, dm.shape, 1)
        dm = jnp.where(col < n_valid, dm, jnp.inf)
        neg_top, idx = jax.lax.top_k(-dm, min(k, n))
        if k > n:  # degenerate tiny-db case: pad
            padk = k - n
            neg_top = jnp.pad(neg_top, ((0, 0), (0, padk)), constant_values=-jnp.inf)
            idx = jnp.pad(idx, ((0, 0), (0, padk)), constant_values=-1)
        return finalize(-neg_top, idx)

    pad = (-n) % tile_n
    base_p = jnp.pad(base, ((0, pad), (0, 0)))
    sq = (jnp.sum(base_p.astype(jnp.float32) ** 2, axis=-1)
          if base_sqnorms is None else jnp.pad(base_sqnorms, (0, pad)))
    n_tiles = base_p.shape[0] // tile_n
    tiles = base_p.reshape(n_tiles, tile_n, d)
    sq_tiles = sq.reshape(n_tiles, tile_n)

    init = (jnp.full((q, k), jnp.inf, jnp.float32), jnp.full((q, k), -1, jnp.int32))

    def step(carry, inp):
        t_idx, tile, tile_sq = inp
        best_d, best_i = carry
        if dequant is not None or pq is not None:  # codes -> x̂ per tile
            tile = read_tile(tile)
        dm = pairwise_distances(queries, tile, metric, tile_sq)
        # mask padded rows of the final tile
        col = jax.lax.broadcasted_iota(jnp.int32, dm.shape, 1)
        gid = col + t_idx * tile_n
        dm = jnp.where(gid < jnp.minimum(n, n_valid), dm, jnp.inf)
        neg_top, pos = jax.lax.top_k(-dm, k)
        cand_i = jnp.take_along_axis(gid, pos, axis=-1)
        return _merge_topk(best_d, best_i, -neg_top, cand_i, k), None

    (best_d, best_i), _ = jax.lax.scan(
        step, init, (jnp.arange(n_tiles, dtype=jnp.int32), tiles, sq_tiles)
    )
    return finalize(best_d, best_i)
