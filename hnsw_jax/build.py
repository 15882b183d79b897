"""On-device batched HNSW construction (SURVEY.md §2b C7/C8, §3.2).

faiss builds serially: per point, greedy-descend, beam-search each level with
efConstruction, heuristic-prune to M, write links + locked back-links
(``hnsw_add_vertices`` / ``add_with_locks``). The device realization batches
B inserts into ONE jitted program per batch:

  1. storage writes (vectors, levels, upper-slot maps) — scatters
  2. batched greedy descent to each point's level      (shared with query)
  3. per level (static loop, masked): batched beam search with
     efConstruction -> vectorized select-neighbors prune -> forward-link
     scatter -> deterministic back-link repair pass (ops/repair.py)
  4. level 0 additionally merges brute-force intra-batch candidates (one
     [B, B] matrix product), since batch members are invisible to each other in
     the not-yet-updated graph — this recovers the links a serial build would
     have formed between them.

Race freedom is by construction (SURVEY.md §5): forward writes touch one
fresh row per new node; back-link writes are grouped per destination with a
single writer each. Everything is deterministic given the seed, a capability
the OpenMP reference lacks.

The host loop only draws levels (seeded), schedules batch sizes (graph-size
bounded growth so early inserts see a sufficiently dense graph); the
entry-point scalars are updated on device between batches.
"""

from __future__ import annotations

import functools
import logging
import time

import numpy as np
import jax
import jax.numpy as jnp

logger = logging.getLogger("hnsw_jax.build")

from .config import IP, L2, HnswConfig
from .graph import GraphArrays
from .ops import beam as beam_ops
from .ops.prune import select_neighbors
from .ops.repair import apply_backlinks
from .search import _make_distance_fn, greedy_descend


def upper_batch_cap(batch_size: int, m: int) -> int:
    """Static number of leading batch slots reserved for level>=1 points.
    E[#points with level>=1] = batch/m; 4x margin makes overflow vanishingly
    rare (the host spills the batch tail if it ever happens)."""
    return max(32, min(batch_size, 4 * batch_size // m))


def order_batch_by_level(lv: np.ndarray, n0: int):
    """Stable level-descending permutation for a batch.

    The insert program processes upper levels only on the first
    upper_batch_cap slots, so level>=1 points must come first. User-facing
    ids stay insertion order: position j carries id n0 + original_index."""
    perm = np.argsort(-lv, kind="stable")
    ids = (n0 + np.arange(len(lv), dtype=np.int32))[perm]
    return perm, ids


def _insert_batch(
    graph: GraphArrays,
    vectors: jax.Array,
    sqnorms: jax.Array,
    xb: jax.Array,      # f32 [B, d] new vectors (pad rows arbitrary)
    ids: jax.Array,     # int32 [B]; pad == capacity (scatters drop)
    levels: jax.Array,  # int32 [B]; -1 == pad
    slots: jax.Array,   # int32 [B]; upper slot for level>=1 nodes, else -1
    *,
    cfg: HnswConfig,
    ef_construction: int,
    intra_k: int,
    r_window: int,
    n_expand: int = 4,
    hop_cap: int = 0,
    sq_params=None,
    pq_cb=None,
):
    B = xb.shape[0]
    capacity = cfg.capacity
    metric = cfg.metric
    efc = ef_construction
    valid_p = levels >= 0
    ids_safe = jnp.minimum(ids, capacity - 1)

    # ---- 1. storage + level-table writes (adjacency still untouched, so the
    # beams below see exactly the pre-batch graph)
    # sq8 storage (faiss IndexHNSWSQ parity): xb arrives as the DEQUANTIZED
    # x̂ (HnswIndex quantizes at the API boundary so the whole build sees
    # exactly the values a post-add faiss SQ index would); the write encodes
    # back to codes and every stored-vector gather dequantizes in-register.
    # pq storage (faiss IndexHNSWPQ parity) works the same way: xb is the
    # PQ reconstruction x̂; the write re-encodes (encode(decode(c)) == c up
    # to duplicate centroids, which decode identically), and stored-vector
    # reads decode against the codebooks.
    xf = xb.astype(jnp.float32)
    if sq_params is not None:
        from .ops.packed import quantize_codes
        stored = quantize_codes(xf, sq_params[0], sq_params[1], 8)
    elif pq_cb is not None:
        from .ops.pq import encode_pq
        stored = encode_pq(xf, pq_cb)
    else:
        stored = xb.astype(vectors.dtype)

    def read_rows(raw):  # gathered storage rows -> f32 vectors (x̂ for codecs)
        if pq_cb is not None:
            from .ops.pq import decode_pq
            return decode_pq(raw, pq_cb)
        v = raw.astype(jnp.float32)
        if sq_params is not None:
            v = sq_params[0] + sq_params[1] * v
        return v
    vectors = vectors.at[ids].set(stored, mode="drop")
    sqnorms = sqnorms.at[ids].set(jnp.sum(xf * xf, axis=1), mode="drop")
    new_levels = graph.levels.at[ids].set(levels, mode="drop")
    new_uslot = graph.upper_slot.at[ids].set(slots, mode="drop")
    slot_idx = jnp.where(slots >= 0, slots, graph.upper_node.shape[0])
    new_unode = graph.upper_node.at[slot_idx].set(
        jnp.where(slots >= 0, ids, -1), mode="drop")
    graph = graph._replace(levels=new_levels, upper_slot=new_uslot,
                           upper_node=new_unode)

    distance_to = _make_distance_fn(vectors, sqnorms, xf, metric,
                                    dequant=sq_params, pq=pq_cb)
    qsq = jnp.sum(xf * xf, axis=1, keepdims=True)  # for surrogate -> true L2

    def to_true(d):
        return d + qsq if metric == L2 else d

    # ---- 2. greedy descent to each point's level
    ep = jnp.broadcast_to(graph.entry_point, (B,))
    ep_d = distance_to(ep[:, None], jnp.ones((B, 1), jnp.bool_))[:, 0]
    to_level = jnp.where(valid_p,
                         jnp.clip(levels, 0, jnp.maximum(graph.max_level, 0)),
                         cfg.max_level_cap)
    e, e_d = greedy_descend(graph, distance_to, ep, ep_d, to_level,
                            cfg.max_level_cap)

    # insert beams have the same long convergence tail as queries (see
    # ops/beam.py hop_limit): the tail hops refine efConstruction candidates
    # that the select-neighbors prune mostly discards anyway. hop_cap:
    # 0 = auto (~efc/(2*n_expand) + 12 fat hops — at 1M x 128 M=32/efC=100
    # the whole recall frontier stays within 0.0005 of converged insert
    # beams);
    # > 0 = explicit cap; < 0 = run insert beams to full convergence.
    if hop_cap == 0:
        max_hops = max(16, (efc // max(n_expand, 1)) // 2 + 12)
    elif hop_cap > 0:
        max_hops = hop_cap
    else:
        max_hops = 4 * efc + 16
    neighbors0 = graph.neighbors0

    # ---- 3. upper levels, top down. Three cost controls:
    #   * ONE traced level-step (lax.fori_loop + dynamic level index) instead
    #     of max_level_cap unrolled copies — compile time
    #   * only the first B_UP batch slots participate: the host sorts each
    #     batch by level (descending), and E[#points with level>=1] = B/m,
    #     so a static B/8 slice covers upper levels with huge margin while
    #     shrinking every upper-level beam/prune/repair shape 8x
    #   * lax.cond skips a level's whole body when no batch point reaches it
    #     (true for levels >= 2 in almost every batch)
    b_up = upper_batch_cap(B, cfg.m)
    xf_up = xf[:b_up]
    dist_up = _make_distance_fn(vectors, sqnorms, xf_up, metric,
                                dequant=sq_params, pq=pq_cb)
    qsq_up = qsq[:b_up]
    slots_up = slots[:b_up]
    ids_safe_up = ids_safe[:b_up]
    levels_up = levels[:b_up]

    def level_step(i, carry):
        upper_adj, e_up, e_d_up, drops = carry
        level = cfg.max_level_cap - i          # L_cap .. 1
        lidx = level - 1
        active = (levels_up >= 0) & (level <= levels_up) & \
            (level <= graph.max_level)

        def work(operands):
            upper_adj, e_up, e_d_up, drops = operands
            adj_l = jax.lax.dynamic_index_in_dim(upper_adj, lidx, axis=1,
                                                 keepdims=False)  # [U, m]

            def gather_upper(node_ids):
                slot = jnp.maximum(graph.upper_slot[node_ids], 0)
                return adj_l[slot]

            state = beam_ops.init_beam(e_up, e_d_up, efc, capacity,
                                       active=active)
            state = beam_ops.beam_search(state, gather_upper, dist_up,
                                         max_hops=max_hops,
                                         n_expand=n_expand,
                                         visited_mode="buffer")
            buf_ids_d, buf_dist_d = beam_ops.dedup_sorted_buffer(
                state.buf_ids, state.buf_dist)
            cand_ids = jnp.where(active[:, None], buf_ids_d, -1)
            cand_true = buf_dist_d + qsq_up if metric == L2 else buf_dist_d
            cand_vecs = read_rows(vectors[jnp.maximum(cand_ids, 0)])
            kept, _ = select_neighbors(cand_ids, cand_true, cand_vecs,
                                       m=cfg.m, metric=metric)

            # forward links: one fresh row per new node at this level
            row = jnp.where(active & (slots_up >= 0), slots_up,
                            adj_l.shape[0])
            adj_l = adj_l.at[row].set(kept, mode="drop")

            # back-links (dst row == dst's upper slot at this level)
            dst = kept.reshape(-1)
            src = jnp.broadcast_to(ids_safe_up[:, None],
                                   kept.shape).reshape(-1)
            pair_ok = (dst >= 0) & jnp.broadcast_to(
                active[:, None], kept.shape).reshape(-1)
            dst_rows = jnp.where(pair_ok, new_uslot[jnp.maximum(dst, 0)], -1)
            adj_l, ndrop = apply_backlinks(
                adj_l, jnp.maximum(dst_rows, 0), dst, src,
                pair_ok & (dst_rows >= 0), vectors, sq_params, pq_cb,
                r_window=r_window, metric=metric)
            upper_adj2 = jax.lax.dynamic_update_index_in_dim(
                upper_adj, adj_l, lidx, axis=1)

            # entries for the next level: nearest candidate found here
            e2 = jnp.where(active, buf_ids_d[:, 0], e_up)
            e_d2 = jnp.where(active, buf_dist_d[:, 0], e_d_up)
            return upper_adj2, e2, e_d2, drops + ndrop

        return jax.lax.cond(jnp.any(active), work,
                            lambda o: o,
                            (upper_adj, e_up, e_d_up, drops))

    upper_adj, e_up, e_d_up, bl_dropped = jax.lax.fori_loop(
        0, cfg.max_level_cap, level_step,
        (graph.upper_neighbors, e[:b_up], e_d[:b_up],
         jnp.asarray(0, jnp.int32)))
    e = jnp.concatenate([e_up, e[b_up:]])
    e_d = jnp.concatenate([e_d_up, e_d[b_up:]])

    # ---- 4. level 0
    state = beam_ops.init_beam(e, e_d, efc, capacity, active=valid_p)

    def gather_l0(node_ids):
        return neighbors0[node_ids]

    state = beam_ops.beam_search(state, gather_l0, distance_to,
                                 max_hops=max_hops, n_expand=n_expand,
                                 visited_mode="buffer")

    # intra-batch candidates: batch members can't be found via the old graph
    T = min(intra_k, B)
    bsq = jnp.sum(xf * xf, axis=1)
    dots = jnp.dot(xf, xf.T, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    intra = -dots if metric == IP else bsq[None, :] - 2.0 * dots
    eye = jnp.eye(B, dtype=jnp.bool_)
    ok = (~eye) & valid_p[None, :] & valid_p[:, None]
    intra = jnp.where(ok, intra, jnp.inf)
    neg, pos = jax.lax.top_k(-intra, T)
    intra_ids = jnp.where(neg > -jnp.inf, ids_safe[pos], -1)
    intra_d = -neg

    buf_ids_d, buf_dist_d = beam_ops.dedup_sorted_buffer(
        state.buf_ids, state.buf_dist)
    cand_ids = jnp.concatenate(
        [jnp.where(valid_p[:, None], buf_ids_d, -1), intra_ids], axis=1)
    cand_true = jnp.concatenate(
        [to_true(buf_dist_d), to_true(intra_d)], axis=1)
    cand_vecs = read_rows(vectors[jnp.maximum(cand_ids, 0)])
    # faiss parity: a new node gets M forward links at level 0 (the m0 = 2M
    # row width is headroom for back-link growth, not the insert fanout —
    # faiss add_links_starting_from shrinks to M). Also halves the back-link
    # pair count below.
    kept0, _ = select_neighbors(cand_ids, cand_true, cand_vecs,
                                m=cfg.m, metric=metric)

    kept0_row = jnp.pad(kept0, ((0, 0), (0, cfg.m0 - cfg.m)),
                        constant_values=-1)
    neighbors0 = neighbors0.at[ids].set(kept0_row, mode="drop")
    dst = kept0.reshape(-1)
    src = jnp.broadcast_to(ids_safe[:, None], kept0.shape).reshape(-1)
    pair_ok = (dst >= 0) & jnp.broadcast_to(valid_p[:, None],
                                            kept0.shape).reshape(-1)
    neighbors0, ndrop0 = apply_backlinks(
        neighbors0, jnp.maximum(dst, 0), dst, src, pair_ok, vectors,
        sq_params, pq_cb, r_window=r_window, metric=metric)
    bl_dropped = bl_dropped + ndrop0

    graph = graph._replace(neighbors0=neighbors0, upper_neighbors=upper_adj)
    return graph, vectors, sqnorms, bl_dropped


def _insert_batch_staged(
    graph: GraphArrays,
    vectors: jax.Array,
    sqnorms: jax.Array,
    xs: jax.Array,      # f32 [Ns, d]  staged vectors, batch order
    ids_s: jax.Array,   # int32 [Ns]   staged ids
    lv_s: jax.Array,    # int32 [Ns]   staged levels
    sl_s: jax.Array,    # int32 [Ns]   staged upper slots
    offset: jax.Array,  # int32 []     batch start in the staged arrays
    take: jax.Array,    # int32 []     valid rows (rest masked as pads)
    *,
    size: int,
    cfg: HnswConfig,
    ef_construction: int,
    intra_k: int,
    r_window: int,
    n_expand: int = 4,
    hop_cap: int = 0,
    sq_params=None,
    pq_cb=None,
):
    """One insert batch sliced out of device-staged arrays + on-device scalar
    (entry point / max level / counters) updates.

    This is the transfer-free batch step: the host stages the whole insert
    schedule once (one host-to-device copy), then each batch is (offset,
    take) scalars, so no batch waits on a transfer."""
    xb = jax.lax.dynamic_slice_in_dim(xs, offset, size, axis=0)
    ids = jax.lax.dynamic_slice_in_dim(ids_s, offset, size, axis=0)
    levels = jax.lax.dynamic_slice_in_dim(lv_s, offset, size, axis=0)
    slots = jax.lax.dynamic_slice_in_dim(sl_s, offset, size, axis=0)
    live = jnp.arange(size, dtype=jnp.int32) < take
    ids = jnp.where(live, ids, cfg.capacity)   # pad id == capacity (dropped)
    levels = jnp.where(live, levels, -1)
    slots = jnp.where(live, slots, -1)

    graph, vectors, sqnorms, bl_dropped = _insert_batch(
        graph, vectors, sqnorms, xb, ids, levels, slots, cfg=cfg,
        ef_construction=ef_construction, intra_k=intra_k,
        r_window=r_window, n_expand=n_expand, hop_cap=hop_cap,
        sq_params=sq_params, pq_cb=pq_cb)

    # scalar bookkeeping on device (no host round-trip between batches)
    batch_max = jnp.max(levels)                       # -1 when take == 0
    winner = ids[jnp.argmax(levels)]
    new_entry = jnp.where(batch_max > graph.max_level, winner,
                          graph.entry_point)
    new_max = jnp.maximum(graph.max_level, batch_max)
    new_ntotal = graph.ntotal + take
    new_nupper = graph.n_upper + jnp.sum(slots >= 0, dtype=jnp.int32)
    graph = graph._replace(entry_point=new_entry.astype(jnp.int32),
                           max_level=new_max.astype(jnp.int32),
                           ntotal=new_ntotal.astype(jnp.int32),
                           n_upper=new_nupper.astype(jnp.int32))
    return graph, vectors, sqnorms, bl_dropped


class DeviceBuilder:
    """Host orchestration for batched on-device construction.

    Owns the level RNG (seeded => deterministic builds, SURVEY.md §4 item 6)
    and the batch-growth schedule. ``min_batch``/``max_batch`` bound the
    padded batch shapes so only a handful of XLA programs are compiled.
    """

    BATCH_SIZES = (32, 128, 512, 1024)

    @property
    def _sizes(self) -> tuple:
        """Padded batch shapes in use: BATCH_SIZES clipped to max_batch, plus
        max_batch itself when it exceeds the largest preset (so
        DeviceBuilder(max_batch=2048) actually builds 2048-wide batches)."""
        sizes = [s for s in self.BATCH_SIZES if s <= self.max_batch]
        if not sizes:
            sizes = [self.max_batch]
        if self.max_batch > sizes[-1]:
            sizes.append(self.max_batch)
        return tuple(sizes)

    def __init__(self, cfg: HnswConfig, *, max_batch: int = 2048,
                 intra_k: int = 32, r_window: int = 16, n_expand: int = 4,
                 hop_cap: int = 0, sq_params=None, pq_cb=None):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.max_batch = max_batch
        self.intra_k = intra_k
        self.r_window = r_window
        self.n_expand = n_expand
        self.hop_cap = hop_cap
        # sq8 storage: (offset [d], scale [d]) as NUMPY arrays — they close
        # over the insert programs as trace-time constants (d floats each),
        # so the staged-step signatures stay unchanged. Per-index builders
        # make this safe: params are fixed once trained, before any program
        # compiles (programs cached in self._steps would go stale otherwise).
        self.sq_params = None
        if sq_params is not None:
            self.sq_params = (np.asarray(sq_params[0], np.float32),
                              np.asarray(sq_params[1], np.float32))
        # pq codebooks (faiss IndexHNSWPQ): f32 [m_sub, ksub, dsub] trace
        # constants, same lifecycle rationale as sq_params above
        self.pq_cb = None
        if pq_cb is not None:
            self.pq_cb = np.asarray(pq_cb, np.float32)
        self._steps: dict = {}
        # back-link pairs beyond the repair R-window, lost per add() call /
        # lifetime (observability for ops/repair.py's "rare" claim)
        self.last_backlink_dropped = 0
        self.backlink_dropped_total = 0

    def _draw_levels(self, n: int) -> np.ndarray:
        u = self.rng.random(n)
        lv = np.floor(-np.log(np.maximum(u, 1e-12)) *
                      self.cfg.level_mult).astype(np.int32)
        return np.minimum(lv, self.cfg.max_level_cap)

    SCAN_CHUNK = 32  # full-size batches folded into ONE lax.scan dispatch

    def _get_step(self, ef_construction: int, size: int):
        """Single staged batch as one dispatch (growth phase / leftovers)."""
        key = ("one", ef_construction, size)
        if key not in self._steps:
            self._steps[key] = jax.jit(
                functools.partial(_insert_batch_staged, size=size,
                                  cfg=self.cfg,
                                  ef_construction=ef_construction,
                                  intra_k=self.intra_k,
                                  r_window=self.r_window,
                                  n_expand=self.n_expand,
                                  hop_cap=self.hop_cap,
                                  sq_params=self.sq_params,
                                  pq_cb=self.pq_cb),
                donate_argnums=(0, 1, 2),
            )
        return self._steps[key]

    def _get_scan(self, ef_construction: int, size: int):
        """SCAN_CHUNK consecutive staged batches as ONE dispatch: the
        steady-state build is a lax.scan over minibatches (a 'training
        loop' in one executable — per-batch dispatch overhead vanishes)."""
        key = ("scan", ef_construction, size)
        if key not in self._steps:
            body = functools.partial(_insert_batch_staged, size=size,
                                     cfg=self.cfg,
                                     ef_construction=ef_construction,
                                     intra_k=self.intra_k,
                                     r_window=self.r_window,
                                     n_expand=self.n_expand,
                                     hop_cap=self.hop_cap,
                                     sq_params=self.sq_params,
                                     pq_cb=self.pq_cb)

            def chunk(graph, vectors, sqnorms, xs, ids_s, lv_s, sl_s,
                      offsets, takes):
                def step(carry, ot):
                    g, v, sq = carry
                    g, v, sq, nd = body(g, v, sq, xs, ids_s, lv_s, sl_s,
                                        ot[0], ot[1])
                    return (g, v, sq), nd

                (graph, vectors, sqnorms), nds = jax.lax.scan(
                    step, (graph, vectors, sqnorms),
                    jnp.stack([offsets, takes], axis=1))
                return graph, vectors, sqnorms, jnp.sum(nds)

            self._steps[key] = jax.jit(chunk, donate_argnums=(0, 1, 2))
        return self._steps[key]

    def _seed_first(self, graph: GraphArrays, vectors, sqnorms,
                    x0: np.ndarray, level: int):
        """Insert the very first point (no search needed). One jitted donated
        program: EAGER .at[].set on a capacity-sized array materializes a
        full copy of a capacity-sized array, which donation avoids."""
        i32 = jnp.int32
        sq_params = self.sq_params
        pq_cb = self.pq_cb

        @functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4))
        def seed(vectors, sqnorms, levels, upper_slot, upper_node, x0):
            if sq_params is not None:  # x0 is x̂0 — encode back to codes
                from .ops.packed import quantize_codes
                stored0 = quantize_codes(x0[None], sq_params[0],
                                         sq_params[1], 8)[0]
            elif pq_cb is not None:    # x0 is the PQ x̂0 — re-encode
                from .ops.pq import encode_pq
                stored0 = encode_pq(x0[None], pq_cb)[0]
            else:
                stored0 = x0.astype(vectors.dtype)
            return (vectors.at[0].set(stored0),
                    sqnorms.at[0].set(jnp.sum(x0.astype(jnp.float32) ** 2)),
                    levels.at[0].set(level),
                    upper_slot.at[0].set(0 if level >= 1 else -1),
                    upper_node.at[0].set(0) if level >= 1 else upper_node)

        vectors, sqnorms, lv, uslot, unode = seed(
            vectors, sqnorms, graph.levels, graph.upper_slot,
            graph.upper_node, jnp.asarray(x0))
        graph = graph._replace(
            levels=lv,
            upper_slot=uslot,
            upper_node=unode,
            entry_point=jnp.asarray(0, i32),
            max_level=jnp.asarray(level, i32),
            ntotal=jnp.asarray(1, i32),
        )
        if level >= 1:
            graph = graph._replace(n_upper=jnp.asarray(1, i32))
        return graph, vectors, sqnorms

    def _plan(self, n0: int, n_upper: int, x: np.ndarray,
              all_levels: np.ndarray):
        """Precompute the ENTIRE insert schedule host-side: staged arrays in
        batch order (level-sorted per batch, pads resolved) + per-batch
        (offset, take, size). Deterministic given the seed — the device
        recomputes the same entry/counter updates batch by batch."""
        cfg = self.cfg
        n = len(x)
        # bucket-pad the staged length so repeated similar-size adds reuse
        # compiled programs (jit keys on the staged shape)
        n_staged = -(-(n + self.max_batch) // 16384) * 16384
        x_sched = np.zeros((n_staged, x.shape[1]), np.float32)
        ids_sched = np.full((n_staged,), cfg.capacity, np.int32)
        lv_sched = np.full((n_staged,), -1, np.int32)
        sl_sched = np.full((n_staged,), -1, np.int32)
        batches = []  # (offset, take, size)
        i = 0
        while i < n:
            # graph-size-bounded growth: batch never exceeds the current
            # graph size class (early inserts need a dense-enough graph)
            sizes = self._sizes
            allowed = max(sizes[0], n0)
            size = max(s for s in sizes if s <= max(allowed, sizes[0]))
            take = min(n - i, size)
            lv = all_levels[i:i + take]
            # keep #upper points within the program's static slice (see
            # upper_batch_cap): spill the batch tail in the freak case
            cap_up = upper_batch_cap(size, cfg.m)
            n_ups = np.cumsum(lv >= 1)
            if take and n_ups[take - 1] > cap_up:
                take = int(np.searchsorted(n_ups, cap_up, side="right"))
                lv = lv[:take]
            perm, pids = order_batch_by_level(lv, n0)
            x_sched[i:i + take] = x[i:i + take][perm]
            ids_sched[i:i + take] = pids
            lv_sched[i:i + take] = lv[perm]
            ups = np.flatnonzero(lv_sched[i:i + take] >= 1)
            if n_upper + len(ups) > cfg.upper_capacity:
                raise ValueError("upper_capacity exceeded; raise it in "
                                 "HnswConfig")
            sl_sched[i + ups] = np.arange(n_upper, n_upper + len(ups),
                                          dtype=np.int32)
            n_upper += len(ups)
            batches.append((i, take, size))
            n0 += take
            i += take
        return x_sched, ids_sched, lv_sched, sl_sched, batches

    def add(self, graph: GraphArrays, vectors, sqnorms, x: np.ndarray,
            *, ef_construction: int | None = None):
        cfg = self.cfg
        efc = int(ef_construction or cfg.ef_construction)
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        n0 = int(graph.ntotal)
        n_upper = int(graph.n_upper)

        all_levels = self._draw_levels(len(x))
        i = 0
        if n0 == 0 and len(x):
            graph, vectors, sqnorms = self._seed_first(
                graph, vectors, sqnorms, x[0], int(all_levels[0]))
            n0 = 1
            if all_levels[0] >= 1:
                n_upper = 1
            i = 1

        # ---- plan on host, stage ONCE on device (a single H2D transfer; the
        # per-batch loop then ships two int32 scalars per dispatch)
        xs_np, ids_np, lv_np, sl_np, batches = self._plan(
            n0, n_upper, x[i:], all_levels[i:])
        if not batches:
            jax.block_until_ready(graph.neighbors0)
            return graph, vectors, sqnorms
        xs = jnp.asarray(xs_np)
        ids_s = jnp.asarray(ids_np)
        lv_s = jnp.asarray(lv_np)
        sl_s = jnp.asarray(sl_np)

        t_start = time.time()
        last_log = t_start
        done = 0
        drops_dev = jnp.asarray(0, jnp.int32)  # back-link window drops

        def log_progress():
            nonlocal last_log
            if time.time() - last_log > 15:
                rate = done / max(time.time() - t_start, 1e-9)
                logger.info("build progress: %d/%d inserted (%.0f/s)",
                            done, len(x), rate)
                last_log = time.time()

        # the lax.scan chunking double-buffers the carried graph arrays (the
        # donated entry buffers cannot alias the loop carry), so it costs a
        # second copy of the graph and vectors in device memory. Past ~3 GB
        # of persistent graph+vector bytes, take the per-batch dispatch
        # overhead instead of that extra memory.
        big_bytes = (self.cfg.capacity *
                     (self.cfg.m0 + max(self.cfg.dim, 128)) * 4)
        allow_scan = big_bytes < (3 << 30)

        # ---- growth phase + any non-full batches: one dispatch each
        bi = 0
        while bi < len(batches):
            off, take, size = batches[bi]
            if allow_scan and size == self.max_batch and take == size and \
                    len(batches) - bi >= self.SCAN_CHUNK and \
                    all(b[2] == size and b[1] == size for b in
                        batches[bi:bi + self.SCAN_CHUNK]):
                # ---- steady state: SCAN_CHUNK batches in ONE dispatch
                chunk = batches[bi:bi + self.SCAN_CHUNK]
                offs = jnp.asarray([b[0] for b in chunk], jnp.int32)
                takes = jnp.asarray([b[1] for b in chunk], jnp.int32)
                graph, vectors, sqnorms, nd = self._get_scan(efc, size)(
                    graph, vectors, sqnorms, xs, ids_s, lv_s, sl_s,
                    offs, takes)
                drops_dev = drops_dev + nd
                done += sum(b[1] for b in chunk)
                bi += self.SCAN_CHUNK
            else:
                graph, vectors, sqnorms, nd = self._get_step(efc, size)(
                    graph, vectors, sqnorms, xs, ids_s, lv_s, sl_s,
                    np.int32(off), np.int32(take))
                drops_dev = drops_dev + nd
                done += take
                bi += 1
            log_progress()
        # jax dispatch is async: without this, add() returns while batches
        # are still executing and wall-clock accounting lands on the next
        # device sync instead (e.g. inside save or search)
        jax.block_until_ready(graph.neighbors0)
        self.last_backlink_dropped = int(drops_dev)
        self.backlink_dropped_total += self.last_backlink_dropped
        if self.last_backlink_dropped:
            logger.info(
                "back-link repair: %d pairs beyond the r_window=%d cap were "
                "dropped this add() (%.4f%% of ~%d forward links)",
                self.last_backlink_dropped, self.r_window,
                100.0 * self.last_backlink_dropped / max(len(x) * cfg.m, 1),
                len(x) * cfg.m)
        return graph, vectors, sqnorms
