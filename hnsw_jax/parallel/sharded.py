"""Sharded HNSW over a device mesh (SURVEY.md §2b C14, §3.5) — scale past
one card's memory.

No upstream equivalent exists (faiss-HNSW is single-process OpenMP); this is
first-class here. Design:

  * the dataset is round-robin sharded over mesh axis ``"shard"``; each shard
    owns an independent sub-index (graph + vectors stacked with a leading
    shard dim, sharded arrays via NamedSharding)
  * **build**: one jitted ``shard_map`` step per batch — each device runs the
    single-chip batched insert program (hnsw_jax.build) on its local shard;
    zero cross-device traffic (inserts are shard-local by construction)
  * **query fan-out**: queries ride mesh axis ``"q"`` (data parallelism);
    every q-block searches its local sub-index, then one
    ``all_gather(axis="shard")`` + local top-k merges per-shard results —
    the single cross-device boundary (NVLink on a multi-GPU host)
  * user-facing ids are insertion order (faiss parity): a per-shard
    ``global_ids`` table maps local rows back before the merge

Parallelism-axis map (SURVEY.md §2b): "shard" = dataset sharding, "q" =
query data-parallelism. TP/PP/EP/etc. have no ANN meaning — documented there.

Multi-host: build the mesh from ``jax.distributed.initialize``'d devices and
everything below works unchanged (XLA collectives cross hosts) — exercised
by tests/test_multihost.py: two distributed processes x 4 virtual CPU
devices run build, fan-out search, and degraded serving over the spanning
8-device mesh (Gloo collectives standing in for the cross-host network).
"""

from __future__ import annotations

import json

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import L2, HnswConfig
from ..graph import GraphArrays, empty_graph
from ..build import (DeviceBuilder, _insert_batch,
                     order_batch_by_level, upper_batch_cap)
from ..models.hnsw import _jsonify
from ..search import hnsw_search

SHARD_AXIS = "shard"
QUERY_AXIS = "q"


def make_mesh(n_shards: int | None = None, q_parallel: int = 1,
              devices=None) -> Mesh:
    """Default mesh: all devices on the 'shard' axis (optionally folding a
    'q' axis for query data-parallelism)."""
    devices = devices if devices is not None else jax.devices()
    if n_shards is None:
        n_shards = max(1, len(devices) // q_parallel)
    dev = np.asarray(devices[: n_shards * q_parallel]).reshape(
        n_shards, q_parallel)
    # classic (Auto-mode) Mesh: jax.make_mesh in jax>=0.9 defaults to
    # Explicit axis types, which would force every op under jax.set_mesh
    return Mesh(dev, (SHARD_AXIS, QUERY_AXIS))


def _local(tree):
    """Inside shard_map every leading shard dim is 1: drop it."""
    return jax.tree.map(lambda a: a[0], tree)


def _relift(tree):
    return jax.tree.map(lambda a: a[None], tree)


class ShardedHnswIndex:
    """Dataset-sharded HNSW: per-shard sub-index, fan-out query, global
    top-k merge. API mirrors HnswIndex (add / search / ntotal)."""

    def __init__(self, dim: int | None = None, m: int = 32, metric: str = L2,
                 *, mesh: Mesh | None = None, capacity_per_shard: int = 250_000,
                 config: HnswConfig | None = None, **kw):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.shape[SHARD_AXIS]
        if config is None:
            config = HnswConfig(dim=dim, m=m, metric=metric,
                                capacity=capacity_per_shard, **kw)
        self.config = config
        self.ef_search = config.ef_search
        self.ef_construction = config.ef_construction

        S, cfg = self.n_shards, self.config
        shard_spec = P(SHARD_AXIS)
        self._sh = NamedSharding(self.mesh, shard_spec)

        # every per-shard array is created directly in its sharded layout:
        # each device allocates only its own shard, none holds the whole
        def create():
            g = GraphArrays(*[jnp.broadcast_to(a[None], (S,) + a.shape)
                              for a in empty_graph(cfg)])
            vectors = jnp.zeros((S, cfg.capacity, cfg.dim),
                                jnp.dtype(cfg.storage_dtype))
            sqnorms = jnp.zeros((S, cfg.capacity), jnp.float32)
            # local row -> user id (insertion order), -1 unused
            gids = jnp.full((S, cfg.capacity), -1, jnp.int32)
            return g, vectors, sqnorms, gids

        (self._graph, self._vectors, self._sqnorms,
         self._global_ids) = jax.jit(create, out_shardings=self._sh)()

        # per-shard host-side builder state
        self._builders = [DeviceBuilder(cfg.replace(seed=cfg.seed + s))
                          for s in range(S)]
        self._counts = np.zeros(S, np.int64)
        self._ntotal = 0
        self._steps: dict = {}
        self._searches: dict = {}
        # tombstones over USER ids (filtering composes in search; routing is
        # untouched, same semantics as HnswIndex.remove_ids). None == none.
        self._removed: np.ndarray | None = None
        self._routing_clean = True  # False after remove_ids until vacuum()
        # failure detection / elastic serving (SURVEY.md §5): per-shard
        # health flags. A failed shard is masked out of the fan-out merge so
        # queries keep serving over the survivors (degraded coverage) until
        # restore_shards() reloads it from a checkpoint.
        self._shard_ok = np.ones(self.n_shards, bool)
        # sq8 storage (models/hnsw.py semantics, ONE quantizer shared by all
        # shards): per-dim affine params, set by train() before any add()
        self._sq_np: tuple | None = None
        self.is_trained = not self.config.is_sq
        # per-shard packed serving tables (enable_packed): a PackedNeighbors
        # pytree with a leading shard dim. None == unpacked serving.
        self._packed = None

    @property
    def ntotal(self) -> int:
        return self._ntotal

    @property
    def d(self) -> int:  # faiss naming; lets wrappers (PreTransformIndex,
        return self.config.dim  # IdMapIndex, Searcher) compose with shards

    # ------------------------------------------------------------------ add
    def train(self, x: np.ndarray) -> None:
        """No-op for flat storage; for sq8, trains the shared per-dim
        ScalarQuantizer range (models/hnsw.py semantics — one quantizer for
        every shard, so user-id semantics and save/load stay uniform)."""
        if not self.config.is_sq:
            return
        if self._ntotal:
            raise RuntimeError("train() after add(): stored codes would "
                               "decode under different params")
        from ..ops.packed import quantization_params
        x = np.asarray(x, np.float32)
        off, sc = quantization_params(
            jnp.asarray(x), jnp.ones((len(x),), jnp.bool_), 8)
        self._sq_np = (np.asarray(off, np.float32),
                       np.asarray(sc, np.float32))
        self.is_trained = True

    def _sq_encode(self, x: np.ndarray) -> np.ndarray:
        off, sc = self._sq_np
        u = np.clip(np.round((x - off) / sc), 0, 255).astype(np.float32)
        return off + sc * u

    def _get_step(self, efc: int):
        if efc not in self._steps:
            cfg = self.config
            sq_params = self._sq_np

            def sharded_step(graph, vectors, sqnorms, gids, xb, ids, levels,
                             slots, user_ids):
                g, v, sq, _bl_drops = _insert_batch(
                    _local(graph), _local(vectors), _local(sqnorms),
                    xb[0], ids[0], levels[0], slots[0],
                    cfg=cfg, ef_construction=efc, intra_k=32, r_window=16,
                    sq_params=sq_params)
                gi = gids[0].at[ids[0]].set(user_ids[0], mode="drop")
                return _relift(g), v[None], sq[None], gi[None]

            spec = P(SHARD_AXIS)
            self._steps[efc] = jax.jit(
                jax.shard_map(
                    sharded_step, mesh=self.mesh,
                    in_specs=(spec,) * 9, out_specs=(spec,) * 4,
                    check_vma=False),
                donate_argnums=(0, 1, 2, 3))
        return self._steps[efc]

    def add(self, x: np.ndarray) -> None:
        """Round-robin shard assignment; user ids are insertion order."""
        cfg = self.config
        if self._packed is not None:
            import logging
            logging.getLogger("hnsw_jax").warning(
                "add() on a packed sharded index drops the packed tables "
                "(sharded incremental maintenance is future work) — call "
                "enable_packed() again after adding")
            self.disable_packed()
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        if x.ndim != 2 or x.shape[1] != cfg.dim:
            raise ValueError(f"expected [n, {cfg.dim}], got {x.shape}")
        if not self.is_trained:
            raise RuntimeError("sq8 storage: call train(x) before add()")
        if cfg.is_sq:  # the whole build sees x̂, storage writes re-encode
            x = self._sq_encode(x)
        S = self.n_shards
        user_ids = np.arange(self._ntotal, self._ntotal + len(x))
        shard_of = user_ids % S
        per_shard = [np.flatnonzero(shard_of == s) for s in range(S)]
        if max(self._counts[s] + len(per_shard[s]) for s in range(S)) > \
                cfg.capacity:
            raise ValueError("capacity_per_shard exceeded")

        # every shard sees the SAME batch schedule (lockstep shard_map steps)
        offs = np.zeros(S, np.int64)
        remaining = max(len(p) for p in per_shard)
        efc = int(self.ef_construction)
        step = self._get_step(efc)
        sizes = DeviceBuilder.BATCH_SIZES
        while remaining > 0:
            n0_min = max(1, int(self._counts.min()))
            allowed = max(sizes[0], n0_min)
            size = max(s for s in sizes if s <= max(allowed, sizes[0]))
            xb = np.zeros((S, size, cfg.dim), np.float32)
            ids = np.full((S, size), cfg.capacity, np.int32)
            levels = np.full((S, size), -1, np.int32)
            slots = np.full((S, size), -1, np.int32)
            uids = np.full((S, size), -1, np.int32)
            post = []  # entry/max_level updates applied AFTER the step: the
            # in-step searches must run against the pre-batch entry point
            for s in range(S):
                rows = per_shard[s][offs[s]: offs[s] + size]
                b = self._builders[s]
                take = len(rows)
                if take == 0:
                    continue
                seeded = 0
                # first point of an empty shard is seeded host-side
                if self._counts[s] == 0:
                    self._graph_seed(s, x[rows[0]],
                                     int(b._draw_levels(1)[0]))
                    uid0 = int(user_ids[rows[0]])
                    self._global_ids = self._global_ids.at[s, 0].set(uid0)
                    self._counts[s] = 1
                    seeded = 1
                    rows = rows[1:]
                    take -= 1
                    if take == 0:
                        offs[s] += 1
                        continue
                lv = b._draw_levels(take)
                cap_up = upper_batch_cap(size, cfg.m)
                n_ups = np.cumsum(lv >= 1)
                if take and n_ups[-1] > cap_up:  # spill tail (see build.py)
                    take = int(np.searchsorted(n_ups, cap_up, side="right"))
                    lv = lv[:take]
                    rows = rows[:take]
                perm, pids = order_batch_by_level(lv, self._counts[s])
                xb[s, :take] = x[rows][perm]
                ids[s, :take] = pids
                levels[s, :take] = lv[perm]
                uids[s, :take] = user_ids[rows][perm]
                ups = np.flatnonzero(levels[s, :take] >= 1)
                nu = self._host_n_upper(s)
                if nu + len(ups) > cfg.upper_capacity:
                    raise ValueError("upper_capacity exceeded")
                slots[s, ups] = np.arange(nu, nu + len(ups), dtype=np.int32)
                post.append((s, ids[s, :take].copy(),
                             levels[s, :take].copy(), nu + len(ups)))
                self._counts[s] += take
                offs[s] += take + seeded

            self._flush_scalars()  # pre-batch entries (incl. fresh seeds)
            self._graph, self._vectors, self._sqnorms, self._global_ids = \
                step(self._graph, self._vectors, self._sqnorms,
                     self._global_ids,
                     *jax.device_put((xb, ids, levels, slots, uids),
                                     self._sh))
            for s, bids, lv, nu in post:
                self._post_batch(s, bids, lv, nu)
            self._flush_scalars()
            remaining = max(len(per_shard[s]) - offs[s] for s in range(S))
        self._ntotal += len(x)

    # per-shard scalar bookkeeping (host mirrors, flushed after each step)
    def _host_scalars(self):
        if not hasattr(self, "_scal"):
            self._scal = {"entry": np.full(self.n_shards, -1, np.int64),
                          "max_level": np.full(self.n_shards, -1, np.int64),
                          "n_upper": np.zeros(self.n_shards, np.int64)}
        return self._scal

    def _host_n_upper(self, s):
        return int(self._host_scalars()["n_upper"][s])

    def _graph_seed(self, s: int, x0: np.ndarray, level: int):
        sc = self._host_scalars()
        g, v, sq = self._graph, self._vectors, self._sqnorms
        if self.config.is_sq:  # x0 is x̂ — encode back to the stored code
            off, scale = self._sq_np
            x0_store = np.clip(np.round((x0 - off) / scale), 0,
                               255).astype(np.uint8)
        else:
            x0_store = x0
        v = v.at[s, 0].set(jnp.asarray(x0_store, v.dtype))
        sq = sq.at[s, 0].set(float((x0.astype(np.float64) ** 2).sum()))
        g = g._replace(levels=g.levels.at[s, 0].set(level))
        if level >= 1:
            g = g._replace(upper_slot=g.upper_slot.at[s, 0].set(0),
                           upper_node=g.upper_node.at[s, 0].set(0))
            sc["n_upper"][s] = 1
        sc["entry"][s] = 0
        sc["max_level"][s] = level
        self._graph, self._vectors, self._sqnorms = g, v, sq

    def _post_batch(self, s, ids, levels, n_upper_new):
        sc = self._host_scalars()
        sc["n_upper"][s] = n_upper_new
        if len(levels) and levels.max() > sc["max_level"][s]:
            sc["entry"][s] = int(ids[int(np.argmax(levels))])
            sc["max_level"][s] = int(levels.max())

    def _flush_scalars(self):
        sc = self._host_scalars()
        i32 = jnp.int32
        self._graph = self._graph._replace(
            entry_point=jax.device_put(
                jnp.asarray(sc["entry"], i32), self._sh),
            max_level=jax.device_put(
                jnp.asarray(sc["max_level"], i32), self._sh),
            ntotal=jax.device_put(
                jnp.asarray(self._counts, i32), self._sh),
            n_upper=jax.device_put(
                jnp.asarray(sc["n_upper"], i32), self._sh),
        )

    # ------------------------------------------------- packed serving mode
    @property
    def packed_enabled(self) -> bool:
        return self._packed is not None

    def enable_packed(self, bits: int = 8, *, layout: str = "auto") -> int:
        """Per-shard packed neighbor-code rows (HnswIndex.enable_packed
        parity; ops/packed.py) built as ONE shard_map program — each shard
        assembles its own table from its local graph + vectors, zero
        collectives. This is the Deep10M-at-scale serving configuration:
        per-shard tables fit each card's memory where a monolithic table
        cannot (10M x 96 at 8-bit = 61 GB monolithic, 15.4 GB per shard on
        four cards).

        v1 scope: sq-bit rows over flat/sq8 storage; ``add()`` and
        ``vacuum()`` after enabling DROP the tables (re-enable after —
        incremental sharded maintenance is future work, unlike the
        single-chip index which maintains rows across add()).
        ``layout``: 'bytes' | 'words' | 'auto' (HnswIndex.enable_packed
        semantics: 'auto' is the platform's choice, hnsw_jax.search
        search_engine).
        Returns total packed bytes across shards."""
        from ..ops.packed import (PackedNeighbors, _assemble_payload_rows,
                                  _pack_nibbles, pack_words,
                                  quantization_params, quantize_codes)
        cfg = self.config
        if cfg.is_pq:
            raise ValueError("sharded packed serving supports flat/sq8 "
                             "storage (pq storage is single-chip only)")
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        if layout not in ("auto", "bytes", "words"):
            raise ValueError(f"layout must be 'auto', 'bytes' or 'words', "
                             f"got {layout!r}")
        if self._ntotal == 0:
            raise ValueError("enable_packed() on an empty index")
        if layout == "auto":
            from ..search import search_engine
            layout = search_engine(self.mesh.devices.flat[0].platform
                                   ).packed_layout
        # one STATIC row count for every shard (shard_map outputs must be
        # shape-uniform; round-robin keeps counts within 1 of each other)
        n_rows = max(1, int(self._counts.max()))
        chunk = min(1 << 16, n_rows)
        dq = None if self._sq_np is None else \
            (jnp.asarray(self._sq_np[0]), jnp.asarray(self._sq_np[1]))

        def shard_pack(graph, vectors):
            g = _local(graph)
            v = _local(vectors)
            live = g.levels >= 0
            if dq is not None and bits == 8:
                # sq8 storage at 8 bits: stored codes ARE the routing codes
                offset, scale = dq
                codes_all = v
            else:
                vf = v.astype(jnp.float32)
                if dq is not None:
                    vf = dq[0] + dq[1] * vf
                offset, scale = quantization_params(vf, live, bits)
                codes_all = quantize_codes(vf, offset, scale, bits)
            xhat_sq = jnp.sum(
                (offset + scale * codes_all.astype(jnp.float32)) ** 2,
                axis=1)
            if layout == "words":
                payload = pack_words(codes_all, bits)
            elif bits == 4:
                payload = _pack_nibbles(codes_all)
            else:
                payload = codes_all
            nbr_codes, nbr_sq = _assemble_payload_rows(
                g.neighbors0, payload, xhat_sq, chunk=chunk, n_rows=n_rows)
            return _relift(PackedNeighbors(nbr_codes, nbr_sq,
                                           scale=scale, offset=offset))

        spec = P(SHARD_AXIS)
        fn = jax.jit(jax.shard_map(
            shard_pack, mesh=self.mesh, in_specs=(spec, spec),
            out_specs=spec, check_vma=False))
        self._packed = fn(self._graph, self._vectors)
        return int(self._packed.nbytes)

    def disable_packed(self) -> None:
        self._packed = None
        # drop packed-keyed search programs (they hold table references)
        self._searches = {k: v for k, v in self._searches.items()
                          if not (isinstance(k, tuple) and len(k) == 5
                                  and k[4] is not None)}

    # ---------------------------------------------------------------- search
    def _get_search(self, k: int, ef: int, filtered: bool = False,
                    degraded: bool = False):
        packed = self._packed
        pkey = None if packed is None else \
            (packed.nbr_codes.shape, str(packed.nbr_codes.dtype))
        key = (k, ef, filtered, degraded, pkey)
        if key not in self._searches:
            cfg = self.config
            # sq8: (offset, scale) close over the program as trace-time
            # constants (d floats; params are frozen by train-before-add)
            dq = None if self._sq_np is None else \
                (jnp.asarray(self._sq_np[0]), jnp.asarray(self._sq_np[1]))

            def fanout(graph, vectors, sqnorms, gids, queries, *rest):
                rest = list(rest)
                pk = rest.pop(0) if packed is not None else None
                allowed_loc = None
                if filtered:
                    # permit rides REPLICATED in user-id space; remap to a
                    # local-row mask through this shard's global_ids table
                    permit = rest.pop(0)
                    g0 = gids[0]
                    allowed_loc = (g0 >= 0) & permit[jnp.maximum(g0, 0)]
                d, i = hnsw_search(
                    _local(graph), vectors[0], sqnorms[0], queries,
                    k=k, ef_search=ef, metric=cfg.metric,
                    max_level_cap=cfg.max_level_cap, allowed=allowed_loc,
                    packed=None if pk is None else _local(pk), dequant=dq)
                # local rows -> user ids before leaving the shard
                gi = jnp.where(i >= 0, gids[0][jnp.maximum(i, 0)], -1)
                if degraded:
                    # elastic serving: a failed shard contributes nothing to
                    # the merge (its candidates ride as +inf/-1), so queries
                    # keep answering over the survivors
                    ok = rest.pop(0)[jax.lax.axis_index(SHARD_AXIS)]
                    d = jnp.where(ok, d, jnp.inf)
                    gi = jnp.where(ok, gi, -1)
                # the one cross-device boundary: gather per-shard top-k
                all_d = jax.lax.all_gather(d, SHARD_AXIS)   # [S, Q, k]
                all_i = jax.lax.all_gather(gi, SHARD_AXIS)
                S = all_d.shape[0]
                qn = all_d.shape[1]
                flat_d = jnp.moveaxis(all_d, 0, 1).reshape(qn, S * k)
                flat_i = jnp.moveaxis(all_i, 0, 1).reshape(qn, S * k)
                neg, pos = jax.lax.top_k(-flat_d, k)
                return -neg, jnp.take_along_axis(flat_i, pos, axis=1)

            spec = P(SHARD_AXIS)
            qspec = P(QUERY_AXIS)
            in_specs = (spec, spec, spec, spec, qspec) + \
                ((spec,) if packed is not None else ()) + \
                ((P(),) if filtered else ()) + ((P(),) if degraded else ())
            sm = jax.shard_map(fanout, mesh=self.mesh, in_specs=in_specs,
                               out_specs=(qspec, qspec), check_vma=False)
            self._searches[key] = jax.jit(sm)
        return self._searches[key]

    # --------------------------------------- failure detection / elasticity
    #
    # SURVEY.md §5 failure-detection row. Fault model: on a single-host
    # mesh a *device* failure kills the process (XLA offers no partial-
    # failure semantics), so the recoverable unit is per-shard STATE —
    # corruption (bad scalars, NaN/garbage rows after a partial restore or a
    # software bug) or an operator-declared outage. In multi-host
    # deployments the natural failure unit is a host's shard set; the same
    # detect -> serve-degraded -> restore_shards() flow applies once the
    # mesh is rebuilt over the survivors (jax.distributed re-init).
    @property
    def failed_shards(self) -> list[int]:
        return [int(s) for s in np.flatnonzero(~self._shard_ok)]

    def mark_shard_failed(self, s: int) -> None:
        """Operator-declared failure: shard ``s`` stops contributing to
        query merges immediately (no recompile of its sub-index needed)."""
        self._shard_ok[s] = False

    def mark_shard_ok(self, s: int) -> None:
        self._shard_ok[s] = True

    def health_check(self, *, auto_mark: bool = True) -> list[dict]:
        """Cheap per-shard liveness probe: host-side scalar sanity (entry
        point in range, level/count consistency) + an on-device self-query
        of each shard's local row 0 through the real search program (a
        corrupt graph or NaN'd vector table fails to return itself at
        distance ~0). Returns one dict per shard; with ``auto_mark``,
        newly failing shards are marked out of the serving merge."""
        sc = self._host_scalars()
        probe_hit, probe_d = self._probe()
        out = []
        for s in range(self.n_shards):
            errors = []
            cnt = int(self._counts[s])
            if cnt > 0:
                ent = int(sc["entry"][s])
                if not 0 <= ent < cnt:
                    errors.append(f"entry_point {ent} outside [0, {cnt})")
                if int(sc["max_level"][s]) < 0:
                    errors.append("max_level < 0 with live points")
                if not bool(probe_hit[s]):
                    errors.append(
                        f"self-query probe missed (d={float(probe_d[s]):.3g})")
            if cnt > self.config.capacity:
                errors.append("count exceeds capacity")
            ok = not errors
            if auto_mark and not ok:
                self._shard_ok[s] = False
            out.append({"shard": s, "ok": ok, "count": cnt,
                        "errors": errors})
        return out

    def _probe(self):
        """[S] self-query hit flags + distances (device, one shard_map)."""
        if "probe" not in self._searches:
            cfg = self.config
            dq = None if self._sq_np is None else \
                (jnp.asarray(self._sq_np[0]), jnp.asarray(self._sq_np[1]))

            def probe(graph, vectors, sqnorms):
                q = vectors[0, 0:1].astype(jnp.float32)
                if dq is not None:  # stored codes -> x̂ for the probe query
                    q = dq[0] + dq[1] * q
                d, i = hnsw_search(
                    _local(graph), vectors[0], sqnorms[0], q, k=1,
                    ef_search=8, metric=cfg.metric,
                    max_level_cap=cfg.max_level_cap, dequant=dq)
                hit = (i[0, 0] == 0) & jnp.isfinite(d[0, 0])
                return hit[None], d[0, 0][None]

            spec = P(SHARD_AXIS)
            self._searches["probe"] = jax.jit(jax.shard_map(
                probe, mesh=self.mesh, in_specs=(spec, spec, spec),
                out_specs=(spec, spec), check_vma=False))
        hit, d = self._searches["probe"](self._graph, self._vectors,
                                         self._sqnorms)
        return np.asarray(hit), np.asarray(d)

    def restore_shards(self, path: str, shards: list[int] | None = None):
        """Reload the given shards (default: every currently-failed one)
        from a checkpoint written by ``save()``, leaving healthy shards'
        live state untouched, then return them to the serving merge. The
        elastic-recovery counterpart of mark/health_check."""
        shards = self.failed_shards if shards is None else list(shards)
        if not shards:
            return []
        with np.load(path, allow_pickle=False) as z:
            cfg = HnswConfig.from_json(bytes(z["config_json"].item()).decode())
            if cfg.to_json() != self.config.to_json():
                raise ValueError("checkpoint config differs from live index")
            if len(z["counts"]) != self.n_shards:
                raise ValueError(
                    f"checkpoint has {len(z['counts'])} shards; index has "
                    f"{self.n_shards}")
            sc = self._host_scalars()
            g = self._graph
            for s in shards:
                for k in GraphArrays._fields:
                    g = g._replace(**{k: getattr(g, k).at[s].set(
                        jnp.asarray(z[f"graph_{k}"][s]))})
                vec = jnp.asarray(z["vectors"][s])
                self._vectors = self._vectors.at[s].set(vec)
                vf = vec.astype(jnp.float32)
                if self._sq_np is not None:
                    vf = self._sq_np[0] + self._sq_np[1] * vf
                self._sqnorms = self._sqnorms.at[s].set(
                    jnp.sum(vf ** 2, axis=-1))
                self._global_ids = self._global_ids.at[s].set(
                    jnp.asarray(z["global_ids"][s]))
                self._counts[s] = z["counts"][s]
                sc["entry"][s] = z["entry"][s]
                sc["max_level"][s] = z["max_level"][s]
                sc["n_upper"][s] = z["n_upper"][s]
                states = json.loads(bytes(z["rng_states"].item()).decode())
                self._builders[s].rng.bit_generator.state = states[s]
                self._shard_ok[s] = True
            self._graph = g
        self._flush_scalars()
        return shards

    # ------------------------------------------------- deletion / filtering
    @property
    def n_deleted(self) -> int:
        return 0 if self._removed is None else \
            int(self._removed[: self._ntotal].sum())

    def remove_ids(self, ids: np.ndarray) -> int:
        """Tombstone USER ids (HnswIndex.remove_ids parity): removed ids stop
        appearing in results immediately but keep routing; ids never
        renumber. Returns the number of newly removed ids."""
        ids = np.asarray(ids).reshape(-1)
        if ((ids < 0) | (ids >= self._ntotal)).any():
            raise IndexError("remove_ids: id out of range")
        if self._removed is None:
            self._removed = np.zeros(
                self.n_shards * self.config.capacity, bool)
        before = int(self._removed.sum())
        self._removed[ids] = True
        self._routing_clean = False  # until vacuum()
        return int(self._removed.sum()) - before

    def vacuum(self) -> int:
        """Physically remove tombstoned ids from every shard's routing —
        HnswIndex.vacuum parity, run as ONE shard_map program (per-shard
        graph surgery is purely local, no collectives): links into dead
        nodes are re-pruned away, dead rows cleared, per-shard entry points
        moved to live nodes. Afterwards searches skip the tombstone filter.
        Returns the number of nodes vacuumed."""
        if self._removed is None or self.n_deleted == 0:
            self._routing_clean = True
            return 0
        from ..ops.vacuum import (_vacuum_level0_impl, _vacuum_upper_impl,
                                  live_entry_point)
        cfg = self.config
        n_dead = self.n_deleted
        dq = None
        if self._sq_np is not None:
            dq = (jnp.asarray(self._sq_np[0]), jnp.asarray(self._sq_np[1]))
        removed_dev = jnp.asarray(self._removed)

        def shard_vacuum(graph, vectors, gids, removed):
            g = _local(graph)
            v = _local(vectors)
            gi = gids[0]
            dead = (gi >= 0) & removed[jnp.maximum(gi, 0)]
            nb0 = _vacuum_level0_impl(g.neighbors0, v, dead,
                                      metric=cfg.metric, dequant=dq)
            up = _vacuum_upper_impl(g.upper_neighbors, g.upper_node,
                                    g.upper_slot, g.levels, v, dead,
                                    metric=cfg.metric, dequant=dq)
            ep, mx = live_entry_point(g.levels, dead)
            return _relift(g._replace(neighbors0=nb0, upper_neighbors=up,
                                      entry_point=ep, max_level=mx))

        spec = P(SHARD_AXIS)
        fn = jax.jit(
            jax.shard_map(shard_vacuum, mesh=self.mesh,
                          in_specs=(spec, spec, spec, P()),
                          out_specs=spec, check_vma=False),
            donate_argnums=(0,))
        self._graph = fn(self._graph, self._vectors, self._global_ids,
                         removed_dev)
        self._routing_clean = True
        if self._packed is not None:  # rows bake the OLD adjacency
            self.disable_packed()
        return int(n_dead)

    def _normalize_allowed(self, allowed) -> np.ndarray:
        """User id filter -> bool mask over the user-id space
        [n_shards * capacity_per_shard] (ids are insertion order, so the
        space is bounded by total capacity). Accepts a bool mask or an int
        id-whitelist (HnswIndex parity)."""
        u_cap = self.n_shards * self.config.capacity
        a = np.asarray(allowed)
        if a.dtype == np.bool_:
            if a.ndim != 1 or len(a) > u_cap:
                raise ValueError(
                    f"allowed bool mask must be 1-d with length <= "
                    f"{u_cap}, got shape {a.shape}")
            mask = np.zeros(u_cap, np.bool_)
            mask[: len(a)] = a
            return mask
        if np.issubdtype(a.dtype, np.integer):
            mask = np.zeros(u_cap, np.bool_)
            mask[a.reshape(-1)] = True  # raises on out-of-range, on purpose
            return mask
        raise TypeError(
            f"allowed: expected bool mask or int id list, got dtype "
            f"{a.dtype}")

    # -------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """One .npz holding the stacked (per-shard) arrays + config + host
        bookkeeping. Loadable onto a mesh of the same shard count."""
        sc = self._host_scalars()
        arrs = {f"graph_{k}": np.asarray(v)
                for k, v in self._graph._asdict().items()}
        np.savez_compressed(
            path, vectors=np.asarray(self._vectors),
            global_ids=np.asarray(self._global_ids),
            counts=self._counts, ntotal=np.int64(self._ntotal),
            entry=sc["entry"], max_level=sc["max_level"],
            n_upper=sc["n_upper"],
            rng_states=np.bytes_(json.dumps(
                [_jsonify(b.rng.bit_generator.state)
                 for b in self._builders]).encode()),
            removed=(self._removed if self._removed is not None
                     else np.zeros(0, bool)),
            routing_clean=np.bool_(self._routing_clean),
            shard_ok=self._shard_ok,
            config_json=np.bytes_(self.config.to_json()),
            **({"sq_offset": self._sq_np[0], "sq_scale": self._sq_np[1]}
               if self._sq_np is not None else {}),
            **arrs)

    @classmethod
    def load(cls, path: str, *, mesh: Mesh | None = None):
        from ..config import HnswConfig as _C
        with np.load(path, allow_pickle=False) as z:
            cfg = _C.from_json(bytes(z["config_json"].item()).decode())
            counts = z["counts"]
            idx = cls(config=cfg, mesh=mesh)
            if idx.n_shards != len(counts):
                raise ValueError(
                    f"index was saved with {len(counts)} shards; mesh has "
                    f"{idx.n_shards}")
            # host arrays go straight to their shards (no whole-array copy
            # on any one device)
            idx._graph = GraphArrays(**{
                k: jax.device_put(z[f"graph_{k}"], idx._sh)
                for k in GraphArrays._fields})
            if "sq_offset" in z.files:
                idx._sq_np = (z["sq_offset"].copy(), z["sq_scale"].copy())
                idx.is_trained = True
            idx._vectors = jax.device_put(z["vectors"], idx._sh)
            sq = idx._sq_np

            def sqnorms(v):
                vf = v.astype(jnp.float32)
                if sq is not None:
                    vf = sq[0] + sq[1] * vf
                return jnp.sum(vf ** 2, axis=-1)

            idx._sqnorms = jax.jit(sqnorms, out_shardings=idx._sh)(
                idx._vectors)
            idx._global_ids = jax.device_put(z["global_ids"], idx._sh)
            idx._counts = counts.copy()
            idx._ntotal = int(z["ntotal"])
            sc = idx._host_scalars()
            sc["entry"] = z["entry"].copy()
            sc["max_level"] = z["max_level"].copy()
            sc["n_upper"] = z["n_upper"].copy()
            states = json.loads(bytes(z["rng_states"].item()).decode())
            for b, st in zip(idx._builders, states):
                b.rng.bit_generator.state = st
            if "removed" in z.files and z["removed"].size:
                idx._removed = z["removed"].copy()
                # pre-vacuum tombstones must keep filtering after a reload
                idx._routing_clean = bool(z["routing_clean"]) \
                    if "routing_clean" in z.files else False
            if "shard_ok" in z.files:
                idx._shard_ok = z["shard_ok"].copy()
        return idx

    def check(self, strict: bool = True) -> list[dict]:
        """Per-shard structural invariants (debug). Tombstoned ids are
        exempt from liveness invariants (HnswIndex.check parity)."""
        from ..graph import check_invariants
        gids = (np.asarray(self._global_ids)
                if self._removed is not None else None)
        out = []
        for s in range(self.n_shards):
            g = GraphArrays(*[jnp.asarray(np.asarray(a)[s])
                              for a in self._graph])
            alive = None
            if gids is not None:
                gs = gids[s]
                alive = ~((gs >= 0) & self._removed[np.maximum(gs, 0)])
            out.append(check_invariants(g, self.config, strict=strict,
                                        alive=alive))
        return out

    def search(self, x: np.ndarray, k: int, *, ef_search: int | None = None,
               allowed: np.ndarray | None = None):
        """Fan-out k-NN over the mesh. ``allowed``: optional USER-id filter
        (bool mask or int whitelist, HnswIndex parity); composes with
        tombstones from remove_ids. Raise ef_search when filtering
        aggressively — per-shard traversal is unfiltered."""
        if self._ntotal == 0:
            n = len(x)
            return (np.full((n, k), np.inf, np.float32),
                    np.full((n, k), -1, np.int64))
        permit = None
        if allowed is not None:
            permit = self._normalize_allowed(allowed)
        if self._removed is not None and not self._routing_clean:
            # post-vacuum, dead ids are unreachable by routing — no filter
            alive = ~self._removed
            permit = alive if permit is None else (permit & alive)
        ef = int(ef_search or self.ef_search)
        x = np.asarray(x, np.float32)
        qp = self.mesh.shape[QUERY_AXIS]
        pad = (-len(x)) % qp
        xq = np.pad(x, ((0, pad), (0, 0)))
        degraded = not self._shard_ok.all()
        fn = self._get_search(k, max(ef, k), filtered=permit is not None,
                              degraded=degraded)
        args = (self._graph, self._vectors, self._sqnorms,
                self._global_ids, jnp.asarray(xq))
        if self._packed is not None:
            args += (self._packed,)
        if permit is not None:
            args += (jnp.asarray(permit),)
        if degraded:
            args += (jnp.asarray(self._shard_ok),)
        d, i = fn(*args)
        return (np.asarray(d)[: len(x)],
                np.asarray(i, np.int64)[: len(x)])
