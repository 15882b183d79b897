"""Batched HNSW query pipeline (SURVEY.md §3.1, the hot path).

Reproduces the faiss call stack ``IndexHNSW::search -> greedy_update_nearest
(levels L..1) -> search_from_candidates (level 0) -> top-k`` as ONE jitted XLA
program per query batch: exactly two host/device boundaries (queries in,
(D, I) out). Queries are batched along axis 0; per-query data-dependent
termination becomes convergence masks inside lax.while_loop.

Distances use the rank-equivalent L2 surrogate ||x||^2 - 2 q·x everywhere in
the loop (saves recomputing the constant ||q||^2 per hop); true squared-L2 is
restored on the final top-k only.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import IP, L2
from .graph import GraphArrays
from .ops import beam as beam_ops
from .ops.packed import (PackedNeighbors, PackedPQ, make_packed_expand,
                         make_packed_pq_expand)


class SearchStats(NamedTuple):
    hops: jax.Array  # int32 []  level-0 loop iterations for the batch
    ndis: jax.Array  # int32 [Q] distance computations per query (hnsw_stats.ndis)


class Engine(NamedTuple):
    hop: str            # "xla": gather + reduce hop distances, sort merge
    packed_layout: str  # layout that enable_packed(layout="auto") builds


def search_engine(platform: str | None = None) -> Engine:
    """The one platform decision: which engine computes the level-0 hop,
    and which packed-table layout ``enable_packed(layout="auto")`` builds.

    Every supported platform ("cpu", "gpu") runs the XLA engine: the row
    gather and distance contraction of ``_make_distance_fn`` and the
    sort-based merge of ``ops/beam.py``, over "bytes" packed tables.
    ``platform`` defaults to JAX's default backend. An unknown platform is
    an error, never a silent fallback, and no engine runs a Pallas kernel
    in interpret mode (only tests do)."""
    platform = platform or jax.default_backend()
    if platform not in ("cpu", "gpu"):
        raise ValueError(f"no search engine for platform {platform!r} "
                         f"(supported: cpu, gpu)")
    return Engine(hop="xla", packed_layout="bytes")


def _make_distance_fn(vectors: jax.Array, sqnorms: jax.Array, queries: jax.Array,
                      metric: str, dequant=None, pq=None):
    """Returns distance_to(ids [Q, K], mask) -> [Q, K] surrogate distances.

    The gather + dot is the bandwidth-critical op (SURVEY.md §7 hard-part 3):
    neighbor vectors are gathered from device memory and contracted against
    the queries as a [Q, K, d] x [Q, d] batched matvec at HIGHEST precision
    (full f32: on the GPU the default would be TF32). XLA:GPU fuses the row
    gather into the reduction, so the [Q, K, d] rows are never written out;
    a hand-written Triton kernel for this op did not beat that fusion across
    widths (PERF.md).

    ``dequant``: optional (offset [d], scale [d]) for scalar-quantized
    storage (cfg.dtype == "sq8"): gathered uint8 code rows are affinely
    dequantized in-register (x̂ = offset + scale·u, fused into the
    contraction by XLA) so every distance is against x̂ — faiss
    IndexHNSWSQ DistanceComputer semantics, at 1/4 the gather bandwidth
    of f32 storage.

    ``pq``: codebooks f32 [m_sub, ksub, dsub] when ``vectors`` holds PQ
    codes (cfg.dtype == "pq"): routing distances are ADC computed by the
    one-hot-matmul decode formulation (ops/pq.py adc_decode_distance,
    which avoids per-element LUT lookups); the per-candidate fetch is
    m_sub BYTES, the lowest-bandwidth routing mode here. Routing decode
    runs in bf16; the extraction rerank restores exact ADC values (faiss
    IndexHNSWPQ DistanceComputer semantics).
    """
    qf = queries.astype(jnp.float32)

    if pq is not None:
        from .ops.pq import adc_decode_distance

        def distance_to(ids: jax.Array, mask: jax.Array) -> jax.Array:
            ids_safe = jnp.where(mask, ids, 0)
            codes = vectors[ids_safe]                      # [Q, K, m_sub] u8
            return adc_decode_distance(pq, qf, codes, metric)

        return distance_to

    del sqnorms  # ||x||^2 is recomputed from the gathered rows: a reduction
    # over data already loaded is cheaper than a second [Q, K] scattered
    # gather

    def distance_to(ids: jax.Array, mask: jax.Array) -> jax.Array:
        ids_safe = jnp.where(mask, ids, 0)
        with jax.named_scope("row_gather"):
            rows = vectors[ids_safe]                       # [Q, K, d]
        with jax.named_scope("contract"):
            return gathered_distances(rows, qf, metric, dequant)

    return distance_to


def gathered_distances(vecs: jax.Array, queries: jax.Array, metric: str,
                       dequant=None) -> jax.Array:
    """Surrogate distances [Q, K] from gathered storage rows vecs [Q, K, d]
    to f32 queries [Q, d]: ``||x||² - 2 q·x`` (L2) or ``-q·x`` (IP), with
    x = offset + scale·u for sq8 codes. Both contractions run at HIGHEST
    precision: these are the exact distances the beam keeps and the
    extraction rerank returns."""
    v = vecs.astype(jnp.float32)
    if dequant is not None:
        v = dequant[0] + dequant[1] * v
    dots = jnp.einsum("qd,qkd->qk", queries, v,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    if metric == IP:
        return -dots
    sq = jnp.einsum("qkd,qkd->qk", v, v,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    return sq - 2.0 * dots


def greedy_descend(graph: GraphArrays, distance_to, entry: jax.Array,
                   entry_dist: jax.Array, to_level: jax.Array,
                   max_level_cap: int):
    """Batched faiss ``greedy_update_nearest``: ef=1 walk per level from the
    graph's max level down to (exclusive) per-query ``to_level``.

    entry/entry_dist: [Q]; to_level: [Q] int32. Returns (node [Q], dist [Q]).
    ONE while_loop with a scalar level counter (instead of a statically
    unrolled loop per level) keeps the compiled program small. The level
    index is kept scalar — a per-query level would turn the adjacency
    fetch into an irregular 2-axis gather instead of slice + row-gather.
    """
    lvl = jnp.clip(graph.max_level, 0, max_level_cap)

    def cond(state):
        return state[0] > 0

    def body(state):
        l, c, d, moved = state
        act = (l > to_level) & moved                         # [Q]
        adj_l = jax.lax.dynamic_index_in_dim(
            graph.upper_neighbors, jnp.maximum(l - 1, 0), axis=1,
            keepdims=False)                                  # [U, m]
        slot = jnp.maximum(graph.upper_slot[c], 0)
        nbrs = adj_l[slot]                                   # [Q, m]
        valid = (nbrs >= 0) & act[:, None]
        dn = distance_to(nbrs, valid)
        dn = jnp.where(valid, dn, jnp.inf)
        mini = jnp.argmin(dn, axis=1)
        mind = jnp.take_along_axis(dn, mini[:, None], axis=1)[:, 0]
        better = mind < d
        c2 = jnp.where(better, jnp.take_along_axis(
            nbrs, mini[:, None], axis=1)[:, 0], c)
        d2 = jnp.where(better, mind, d)
        # whole batch steps down one level once no query improves at it
        any_better = jnp.any(better)
        l2 = jnp.where(any_better, l, l - 1)
        moved2 = jnp.where(any_better, better,
                           jnp.ones_like(moved))
        return l2, c2, d2, moved2

    _, cur, curd, _ = jax.lax.while_loop(
        cond, body, (lvl, entry, entry_dist,
                     jnp.ones_like(entry, jnp.bool_)))
    return cur, curd


def _sample_seeds(graph: GraphArrays, vectors: jax.Array, queries: jax.Array,
                  metric: str, dequant, *, n_sample: int, n_seeds: int,
                  chunk: int = 4096):
    """Entry-seed selection as dense matrix products over a strided sample
    of the live prefix — the replacement for the greedy upper-level
    descent (faiss ``greedy_update_nearest``, SURVEY.md §3.1 hot loop #1).

    The descent is pointer-chasing: each of its ~40+ iterations at 1M
    gathers [Q, m] scattered vector rows in a dependent chain. Scoring a
    strided sample of S = capacity/M ids is one [Q, d] x [d, S] matrix
    product per chunk, and lands an entry of the same quality class: the
    expected true rank of
    nearest-in-sample is ~ntotal/S ≈ M, the same order as the descent's
    level-1 local minimum (level-1 nodes are themselves a random 1/M
    subset — level assignment is independent of position, C2).

    The sample is split into ``n_seeds`` equal contiguous strata and the
    per-stratum argmin is returned — [Q, n_seeds] int32, column j the best
    sampled id of stratum j, -1 where a stratum had no live candidate.
    n_seeds=1 degenerates to the global argmin (entry_mode="sample");
    larger values are re-scored exactly by the caller, which starts the
    beam from the best of them (entry_mode="seed"). Stratified argmins
    come at the SAME
    cost as the global one (the per-chunk reduction just keeps g partial
    minima instead of 1) and are spatially diverse by construction: each
    stratum is an independent uniform sample of the live set.

    Sampled ids are masked to inserted (``levels >= 0``), NON-ISOLATED
    nodes (first level-0 slot >= 0): post-``vacuum()`` dead nodes keep
    their level but have cleared adjacency rows — starting a beam there
    would strand the query — while pre-vacuum tombstones still route
    legally and are filtered at extraction.

    Distances here are routing-grade: a default-precision matrix product,
    which is TF32 on the GPU (no looser than the single bf16 pass it was
    first tuned with); callers
    re-score the returned ids exactly (and merge in the global entry point
    as a fallback column, so the result is never worse than where the
    descent starts even if every sampled id is masked).
    """
    qf = queries.astype(jnp.float32)
    nt = jnp.maximum(graph.ntotal, 1)
    a = jnp.arange(n_sample, dtype=jnp.int32)
    step = nt // n_sample
    rem = nt - step * n_sample
    # evenly strided over [0, ntotal): a*step + floor(a*rem/S). All int32:
    # a*rem < S^2 <= 2^30 at the S=32768 cap.
    ids = jnp.minimum(a * step + (a * rem) // n_sample, nt - 1)
    ok = (graph.levels[ids] >= 0) & (graph.neighbors0[ids, 0] >= 0)
    sv = vectors[ids].astype(jnp.float32)                   # [S, d]
    if dequant is not None:
        sv = dequant[0] + dequant[1] * sv
    svsq = jnp.sum(sv * sv, axis=1)                         # [S]
    cb = min(chunk, n_sample)
    nc = n_sample // cb
    # g strata per scan chunk (all pow2, n_seeds >= nc enforced by callers
    # via entry_sample_size / _seed_count)
    assert n_seeds % nc == 0 and cb % (n_seeds // nc) == 0, \
        (n_seeds, nc, cb)
    g = n_seeds // nc
    ss = cb // g

    def body(_, xs):
        c, csq, cid, cok = xs
        dots = jnp.einsum("qd,sd->qs", qf, c,
                          preferred_element_type=jnp.float32)
        dist = -dots if metric == IP else csq[None, :] - 2.0 * dots
        dist = jnp.where(cok[None, :], dist, jnp.inf)
        dist = dist.reshape(-1, g, ss)                      # [Q, g, ss]
        j = jnp.argmin(dist, axis=2)                        # [Q, g]
        cd = jnp.take_along_axis(dist, j[:, :, None], axis=2)[..., 0]
        ci = jnp.take_along_axis(
            jnp.broadcast_to(cid.reshape(1, g, ss), dist.shape),
            j[:, :, None], axis=2)[..., 0]
        return None, (cd, jnp.where(jnp.isfinite(cd), ci, -1))

    _, (cds, cis) = jax.lax.scan(
        body, None,
        (sv.reshape(nc, cb, -1), svsq.reshape(nc, cb),
         ids.reshape(nc, cb), ok.reshape(nc, cb)))
    # ys stacked [nc, Q, g] -> [Q, nc*g] = [Q, n_seeds]
    return jnp.transpose(cis, (1, 0, 2)).reshape(queries.shape[0], n_seeds)


def entry_sample_size(capacity: int) -> int:
    """Static sample width for entry_mode="sample": the largest power of
    two <= capacity/32 clamped to [128, 32768] — matching the ~1/M density
    of the level-1 node set the greedy descent would have converged on."""
    return min(32768, max(128, 1 << max(capacity // 32, 1).bit_length() - 1))


def ef_bucket(ef: int) -> int:
    """Compiled beam-buffer width for a requested efSearch: the next power of
    two >= ef (min 32). efSearch is a RUNTIME scalar within a bucket — faiss
    mutable ``efSearch`` semantics with no recompile (one program per bucket,
    position-masked tail; see ops/beam.py ef_live)."""
    return max(32, 1 << (int(ef) - 1).bit_length())


def hnsw_search(
    graph: GraphArrays,
    vectors: jax.Array,
    sqnorms: jax.Array,
    queries: jax.Array,
    *,
    k: int,
    ef_search: int,
    metric: str = L2,
    max_level_cap: int = 6,
    max_hops: int = 0,
    n_expand: int = 1,
    with_stats: bool = False,
    visited_mode: str = "buffer",
    allowed: jax.Array | None = None,
    packed: PackedNeighbors | None = None,
    dequant=None,
    pq=None,
    beam_keys: str = "auto",
    entry_mode: str = "auto",
):
    """Batched k-NN query. Returns (dists [Q, k], ids [Q, k]) sorted
    ascending; ids are -1 (dist inf) past the reachable set. With
    ``with_stats`` also returns SearchStats (faiss hnsw_stats parity).

    ``beam_keys``: dtype of the beam's merge-sort keys (the merge sort's
    cost is keyed by the key dtype). "auto" (default) = bf16 where routing is
    already quantized (packed rows / PQ ADC — rounding far below the
    codes' noise), f32 for exact-storage routing (bf16 buckets near-ties
    and can evict a true top-k member from the buffer). "bf16" forces the
    fast keys for exact modes too — a documented speed/recall knob; the
    extraction rerank keeps returned distances exact either way.

    ``packed`` (ops/packed.py): optional packed neighbor-code tables. The
    level-0 beam then routes on quantized distances read from one fat row
    per expanded node (~3 row fetches per hop instead of ~1 + K) and the
    final ef buffer is re-ranked with exact f32 distances.

    ``allowed`` (bool [capacity], optional) enables filtered search — faiss
    SearchParametersHNSW/IDSelector parity: the graph is traversed
    unfiltered (disallowed nodes still route), but only selector-approved
    ids are returned. At high filter rates raise ef_search to keep k results
    (same guidance as faiss).

    ``ef_search`` is a runtime knob: programs compile per power-of-two
    bucket (ef_bucket), so sweeping ef or changing it per call in serving
    does not recompile within a bucket.

    ``max_hops`` (runtime, no recompile): 0 (default) bounds the level-0
    loop at ef + 8 hops — the batched loop otherwise runs until its SLOWEST
    query converges, a long tail of hops that serves few queries (see
    ops/beam.py hop_limit). > 0 sets an
    explicit hop cap; < 0 runs to full convergence (faiss-exact
    check_relative_distance termination semantics). FILTERED searches
    (``allowed`` set) default to full convergence instead: with aggressive
    filters the result buffer fills from traversal leftovers, where a
    truncated tail costs real recall."""
    ef = max(int(ef_search), k)
    if max_hops == 0:
        hop_limit = (ef + 8) if allowed is None else (1 << 30)
    elif max_hops > 0:
        hop_limit = max_hops
    else:
        hop_limit = 1 << 30  # converge: never binds before max_hops
    if beam_keys not in ("auto", "bf16", "f32"):
        raise ValueError(f"beam_keys must be auto|bf16|f32, got {beam_keys!r}")
    if entry_mode not in ("auto", "sample", "seed", "descend"):
        raise ValueError(
            f"entry_mode must be auto|sample|seed|descend, got {entry_mode!r}")
    if entry_mode == "auto":
        # PQ storage keeps the descent: dense one-hot ADC decode over the
        # whole sample would cost more than the descent it replaces
        entry_mode = "descend" if pq is not None else "sample"
    ef_buf = ef_bucket(ef)
    entry_sample = entry_sample_size(vectors.shape[0])
    # stratified seed count (static): "seed" fills ef_buf/2 buffer rows
    # (<= 16); "sample" keeps one per scan chunk — the per-chunk argmins
    # are free, and the exact rescore picks the global best among them
    if entry_mode == "seed":
        entry_seeds = min(16, ef_buf // 2)
    else:
        entry_seeds = max(1, entry_sample // 4096)
    search_engine()  # validates the platform; one engine everywhere
    return _hnsw_search(
        graph, vectors, sqnorms, queries, jnp.asarray(ef, jnp.int32),
        jnp.asarray(hop_limit, jnp.int32), allowed, packed, dequant, pq,
        k=k, ef_buf=ef_buf, metric=metric,
        max_level_cap=max_level_cap, n_expand=n_expand,
        with_stats=with_stats, visited_mode=visited_mode,
        beam_keys=beam_keys, entry_mode=entry_mode,
        entry_sample=entry_sample, entry_seeds=entry_seeds)


def _hnsw_search_impl(
    graph: GraphArrays,
    vectors: jax.Array,
    sqnorms: jax.Array,
    queries: jax.Array,
    ef_live: jax.Array,
    hop_limit: jax.Array,
    allowed: jax.Array | None = None,
    packed: PackedNeighbors | None = None,
    dequant=None,
    pq=None,
    *,
    k: int,
    ef_buf: int,
    metric: str = L2,
    max_level_cap: int = 6,
    n_expand: int = 1,
    with_stats: bool = False,
    visited_mode: str = "buffer",
    beam_keys: str = "auto",
    entry_mode: str = "descend",
    entry_sample: int = 0,
    entry_seeds: int = 1,
):
    ef = ef_buf
    # static loop bound: every hop expands >=1 buffer entry; entries only
    # leave the buffer by being displaced, so 4*ef + 16 comfortably
    # over-covers convergence (validated against unbounded runs in tests).
    # The effective per-call cap is the TRACED hop_limit (see hnsw_search).
    max_hops = 4 * ef + 16
    qn = queries.shape[0]
    capacity = vectors.shape[0]
    queries = queries.astype(jnp.float32)

    distance_to = _make_distance_fn(vectors, sqnorms, queries, metric,
                                    dequant=dequant, pq=pq)

    # --- entry selection: sampled dense scan (default; _sample_seeds) or
    # the faiss-style greedy upper-level descent from the global entry.
    # ep0/ep0_dist are [Q, E]: E = 1 for sample/descend; for entry_mode
    # "seed", E = entry_seeds + 1 distance-sorted stratified seeds, of which
    # the beam starts from the first.
    ep = jnp.broadcast_to(graph.entry_point, (qn,))
    if entry_mode in ("sample", "seed") and pq is None and entry_sample > 0:
        seeds = _sample_seeds(graph, vectors, queries, metric, dequant,
                              n_sample=entry_sample, n_seeds=entry_seeds)
        # seeds + the global entry point (fallback when every sampled id
        # is masked), re-scored exactly: the beam's initial buffer keys
        # must be on the same (HIGHEST-precision) scale as everything else
        # drop seeds equal to ep (the buffer must not start with duplicate
        # ids — a dup would be expanded twice, wasting a hop)
        seeds = jnp.where(seeds == ep[:, None], -1, seeds)
        cand = jnp.concatenate([seeds, ep[:, None]], axis=1)  # [Q, E+1]
        valid = cand >= 0
        cd = distance_to(jnp.where(valid, cand, 0), valid)
        cd = jnp.where(valid, cd, jnp.inf)
        ep0_dist, ep0 = jax.lax.sort((cd, cand), num_keys=1)
        # adjacent-dup mask (same trick as dedup_sorted_buffer): when
        # ntotal < n_sample the stratified sample repeats ids, and two
        # strata can argmin the same node — a dup seed would pre-fill two
        # buffer slots and waste a re-expansion hop
        dup = jnp.concatenate(
            [jnp.zeros((qn, 1), bool),
             ep0[:, 1:] == ep0[:, :-1]], axis=1) & (ep0 >= 0)
        if ep0.shape[1] > 2:  # E+1 <= 2 cannot hold a post-sort dup pair
            ep0 = jnp.where(dup, -1, ep0)
            ep0_dist = jnp.where(dup, jnp.inf, ep0_dist)
            # restore ascending order (masked slots sink to the tail)
            ep0_dist, ep0 = jax.lax.sort((ep0_dist, ep0), num_keys=1)
        if entry_mode == "sample":
            ep0, ep0_dist = ep0[:, :1], ep0_dist[:, :1]
    else:
        ep_dist = distance_to(ep[:, None], jnp.ones((qn, 1), jnp.bool_))[:, 0]
        ep0, ep0_dist = greedy_descend(
            graph, distance_to, ep, ep_dist,
            jnp.zeros((qn,), jnp.int32), max_level_cap)
        ep0, ep0_dist = ep0[:, None], ep0_dist[:, None]

    # --- level-0 beam search
    expand = None
    if isinstance(packed, PackedPQ):
        # PQ-coded packed rows: the beam routes on ADC distances computed
        # from one code row per expanded node; ADC is already on the full
        # surrogate scale (shift == 0), exact rerank restores precision
        expand, scale_shift = make_packed_pq_expand(
            packed, graph.neighbors0, queries, metric)
        ep0_dist = ep0_dist + jnp.expand_dims(jnp.asarray(scale_shift), -1)
    elif packed is not None:
        # packed serving mode: beam routes on quantized code-row distances;
        # the exactly-scored entry point is shifted onto the same scale
        # (ops/packed.py module docstring), exact rerank restores precision
        expand, scale_shift = make_packed_expand(
            packed, graph.neighbors0, queries, metric)
        ep0_dist = ep0_dist + jnp.expand_dims(jnp.asarray(scale_shift), -1)
    # bf16 beam keys: the per-hop merge sort is a large share of the hop
    # and its cost is keyed by the key dtype (ops/beam.py init_beam) — but
    # bf16 buckets near-ties, and a true top-k member can be evicted from
    # the buffer inside a tie bucket. Used ONLY where routing is already
    # quantized (packed sq rows / PQ ADC: bf16 rounding is far below the
    # codes' own noise, and extraction reranks exactly); exact-storage
    # routing keeps f32 keys so buffer retention is exact.
    if beam_keys == "auto":
        key_dtype = (jnp.bfloat16 if (packed is not None or pq is not None)
                     else jnp.float32)
    else:
        key_dtype = jnp.bfloat16 if beam_keys == "bf16" else jnp.float32
    # the beam starts from the single best entry
    state = beam_ops.init_beam(ep0[:, 0], ep0_dist[:, 0], ef, capacity,
                               visited_mode=visited_mode,
                               key_dtype=key_dtype)
    if allowed is not None:
        state = beam_ops.attach_result_buffer(state, k, allowed)

    def gather_l0(ids):  # [Q, T] -> [Q, T, m0]
        return graph.neighbors0[ids]

    state = beam_ops.beam_search(state, gather_l0, distance_to,
                                 max_hops=max_hops, n_expand=n_expand,
                                 visited_mode=visited_mode,
                                 allowed=allowed,
                                 ef_live=ef_live, hop_limit=hop_limit,
                                 expand=expand)

    # --- top-k extraction: exact rerank of the final buffer for EVERY mode.
    # The beam ranks on routing-grade keys (bf16 merge sort; quantized code
    # rows in packed mode; bf16-decoded ADC for pq), so one [Q, ef] gather
    # (the cost of a single hop, once per batch) recomputes storage-grade
    # surrogate distances — returned (D, I) are exact regardless of how the
    # routing approximated. The two-key dedup sort also collapses any
    # duplicates (filtered re-encounters, n_expand > 1 double-parents).
    src_ids = state.res_ids if allowed is not None else state.buf_ids
    safe = jnp.maximum(src_ids, 0)
    if pq is not None:
        # exact ADC over x̂ (f32 one-hot decode, HIGHEST contractions) —
        # faiss IndexHNSWPQ returns exactly these values
        from .ops.pq import adc_decode_distance
        ex = adc_decode_distance(pq, queries, vectors[safe], metric,
                                 exact=True)
    else:
        ex = gathered_distances(vectors[safe], queries, metric, dequant)
    ex = jnp.where(src_ids >= 0, ex, jnp.inf)
    buf_ids, buf_dist = beam_ops.dedup_sorted_buffer(src_ids, ex)
    out_d = buf_dist[:, :k]
    out_i = buf_ids[:, :k]
    if metric == L2:  # restore true squared L2 (surrogate dropped ||q||^2)
        qn2 = jnp.sum(queries * queries, axis=1, keepdims=True)
        out_d = out_d + qn2
    # invalid slots -> +inf for BOTH metrics: under IP an id=-1 slot can
    # otherwise carry a finite score (e.g. an empty shard's entry point vs
    # the zero vector) and win a sharded global top-k merge
    out_d = jnp.where(out_i >= 0, out_d, jnp.inf)
    if with_stats:
        return out_d, out_i, SearchStats(state.hops, state.ndis)
    return out_d, out_i


_hnsw_search = jax.jit(
    _hnsw_search_impl,
    static_argnames=("k", "ef_buf", "metric", "max_level_cap", "n_expand",
                     "with_stats", "visited_mode", "beam_keys", "entry_mode",
                     "entry_sample", "entry_seeds"))


def compute_sqnorms(vectors: jax.Array, dequant=None) -> jax.Array:
    """||x||² per row; with ``dequant`` = (offset, scale), ||x̂||² of the
    dequantized codes (XLA fuses the affine into the reduction — no
    materialized f32 copy of a uint8 table)."""
    v = vectors.astype(jnp.float32)
    if dequant is not None:
        v = dequant[0] + dequant[1] * v
    return jnp.sum(v ** 2, axis=-1)
