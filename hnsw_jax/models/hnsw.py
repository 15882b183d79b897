"""``HnswIndex`` — the faiss ``IndexHNSWFlat``-parity user API (SURVEY.md C10).

Surface parity with faiss:
  * ``HnswIndex(d, M, metric)`` construct; train-free (``is_trained`` True)
  * ``add(x)`` / ``search(x, k)`` / ``ntotal`` / ``reconstruct(i)``
  * mutable ``ef_search`` / ``ef_construction`` attributes (faiss
    ``index.hnsw.efSearch`` / ``efConstruction``)
  * ``save(path)`` / ``HnswIndex.load(path)`` (faiss write_index/read_index)

Device-native semantics: vectors + graph live as device arrays; ``search`` runs
the jitted batched pipeline of ``hnsw_jax.search``; construction runs either
on-device (batched level-parallel inserts, ``build="device"``, default) or via
the serial NumPy reference builder (``build="host"``, the faiss-faithful
oracle path).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import L2, HnswConfig
from ..graph import GraphArrays, check_invariants, empty_graph, load_graph, save_graph
from ..reference_impl import NumpyHnsw
from ..search import compute_sqnorms, hnsw_search


class HnswIndex:
    def __init__(self, dim: int | None = None, m: int = 32, metric: str = L2,
                 *, config: HnswConfig | None = None, capacity: int | None = None,
                 build: str = "device", _alloc: bool = True, **kw):
        if config is None:
            if dim is None:
                raise ValueError("dim or config required")
            config = HnswConfig(dim=dim, m=m, metric=metric,
                                capacity=capacity or 1_000_000, **kw)
        self.config = config
        self.ef_search = config.ef_search
        self.ef_construction = config.ef_construction
        if build not in ("device", "host"):
            raise ValueError(f"build must be 'device' or 'host', got {build!r}")
        self.build_mode = build
        self.is_trained = True  # HNSWFlat is train-free (faiss parity)
        self.n_expand = 1
        self.beam_keys = "auto"  # default merge-key dtype (see search())
        self.entry_mode = "auto"  # default entry selection (see search())
        # back-link repair window (build.py DeviceBuilder): pairs beyond it
        # are dropped (~0.014% of forward links at 1M with the default 16);
        # set before the first add() — the builder is created lazily there
        self.r_window = 16

        self._graph = self._vectors = self._sqnorms = None
        if _alloc:
            self._graph = empty_graph(config)
            self._vectors = jnp.zeros(
                (config.capacity, config.storage_width),
                jnp.dtype(config.storage_dtype))
            self._sqnorms = jnp.zeros((config.capacity,), jnp.float32)
        self._host: NumpyHnsw | None = None
        self._builder = None  # lazily constructed device builder
        self._alive = None    # tombstone mask [capacity]; None == no removals
        self._routing_clean = True  # False after remove_ids until vacuum():
        #                             dead ids are reachable and must be
        #                             filtered out of results
        self._packed = None   # packed neighbor-code tables (enable_packed)
        self._route = None    # (cb, codes): PQ ROUTING codec for packed-pq
        #                       rows over non-pq storage (enable_packed
        #                       mode="pq"); independent of the storage codec
        # sq8 storage (faiss IndexHNSWSQ parity): per-dim affine params,
        # None until train(); kept as device pair (for search programs) and
        # numpy pair (builder trace-time constants + host encode)
        self._sq = None
        self._sq_np = None
        # pq storage (faiss IndexHNSWPQ parity): per-subspace codebooks,
        # None until train(); device copy (search programs) + numpy copy
        # (builder trace-time constants + host encode/decode)
        self._pq = None
        self._pq_np = None
        if config.is_sq or config.is_pq:
            self.is_trained = False  # faiss SQ/PQ require train() before add()
            if build == "host":
                raise ValueError("sq8/pq storage requires build='device' "
                                 "(the NumPy reference builder is f32-only)")

    # -- properties ----------------------------------------------------------
    @property
    def ntotal(self) -> int:
        """Slots used, INCLUDING tombstoned ids (ids are stable here; faiss
        remove_ids compacts and renumbers, we deliberately do not)."""
        return int(self._graph.ntotal)

    @property
    def n_deleted(self) -> int:
        if self._alive is None:
            return 0
        return int(self.ntotal - np.asarray(
            self._alive[: self.ntotal]).sum())

    @property
    def d(self) -> int:  # faiss naming
        return self.config.dim

    @property
    def graph(self) -> GraphArrays:
        return self._graph

    @property
    def vectors(self) -> jax.Array:
        return self._vectors

    # -- construction ---------------------------------------------------------
    def train(self, x: np.ndarray) -> None:
        """faiss parity: a no-op for flat storage (HNSWFlat is train-free);
        for sq8 storage, trains the per-dim ScalarQuantizer [min, max] range
        on ``x`` (faiss ``ScalarQuantizer::train`` QT_8bit semantics); for
        pq storage, k-means the per-subspace codebooks (faiss
        ``ProductQuantizer::train``, ops/pq.py). Must be called before the
        first ``add()``; retraining after adds would desynchronize stored
        codes and is rejected."""
        if not (self.config.is_sq or self.config.is_pq):
            return
        if self.ntotal:
            raise RuntimeError("train() after add(): stored codes would "
                               "decode under different params; build a new "
                               "index instead")
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.config.dim:
            raise ValueError(f"expected [n, {self.config.dim}], got {x.shape}")
        if self.config.is_pq:
            from ..ops.pq import train_pq
            cb = train_pq(x, self.config.pq_m, ksub=self.config.pq_ksub,
                          seed=self.config.seed)
            self._pq_np = cb
            self._pq = jnp.asarray(cb)
        else:
            from ..ops.packed import quantization_params
            off, sc = quantization_params(
                jnp.asarray(x), jnp.ones((len(x),), jnp.bool_), 8)
            self._sq = (off, sc)
            self._sq_np = (np.asarray(off), np.asarray(sc))
        self.is_trained = True

    def _sq_encode(self, x: np.ndarray) -> np.ndarray:
        """f32 -> x̂ (the dequantized value of the stored code). The builder
        receives x̂ so every build-time distance equals what a post-add
        faiss SQ index would compute; the device write re-encodes exactly."""
        off, sc = self._sq_np
        u = np.clip(np.round((x - off) / sc), 0, 255).astype(np.float32)
        return off + sc * u

    def _pq_encode_decode(self, x: np.ndarray) -> np.ndarray:
        """f32 -> PQ reconstruction x̂ (same rationale as ``_sq_encode``:
        the builder sees the exact values search-time ADC will measure
        against; the device write re-encodes to the same codes)."""
        from ..ops.pq import decode_pq, encode_pq
        codes = encode_pq(jnp.asarray(x), jnp.asarray(self._pq_np))
        return np.asarray(decode_pq(codes, jnp.asarray(self._pq_np)))

    def add(self, x: np.ndarray) -> None:
        """Append vectors; ids are assigned sequentially (faiss parity)."""
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        if x.ndim != 2 or x.shape[1] != self.config.dim:
            raise ValueError(f"expected [n, {self.config.dim}], got {x.shape}")
        if not self.is_trained:
            raise RuntimeError("sq8/pq storage: call train(x) before add() "
                               "(faiss IndexHNSWSQ/IndexHNSWPQ parity)")
        if self.config.is_sq:
            x = self._sq_encode(x)
        elif self.config.is_pq:
            x = self._pq_encode_decode(x)
        if self.ntotal + len(x) > self.config.capacity:
            raise ValueError("capacity exceeded; create the index with a "
                             "larger `capacity` (device arrays are "
                             "preallocated, SURVEY.md §7 hard-part 5)")
        # packed serving tables: maintained INCREMENTALLY across device
        # adds (ROADMAP item 7) — adjacency-row fingerprints taken before
        # the build identify exactly the rows to re-pack afterwards. Note
        # the tables stay HBM-resident during the build; memory-constrained
        # callers should disable_packed() first.
        packed_was, fp_old, old_ntotal = self._packed, None, self.ntotal
        if packed_was is not None and self.build_mode == "device":
            from ..ops.packed import row_fingerprints
            fp_old = row_fingerprints(self._graph.neighbors0)
        self._packed = None  # invalidated unless the refresh below succeeds
        if self.build_mode == "host":
            self._add_host(x)
        else:
            self._add_device(x)
            if fp_old is not None:
                self._refresh_packed(packed_was, fp_old, old_ntotal)

    def _add_host(self, x: np.ndarray) -> None:
        if self._host is None:
            cfg = self.config.replace(ef_construction=self.ef_construction)
            self._host = NumpyHnsw(cfg)
        self._host.cfg = self._host.cfg.replace(
            ef_construction=self.ef_construction)
        self._host.add(x)
        self._sync_from_host()

    def _sync_from_host(self) -> None:
        h = self._host
        self._graph = h.to_graph_arrays()
        self._vectors = jnp.asarray(h.vectors, dtype=jnp.dtype(self.config.dtype))
        self._sqnorms = compute_sqnorms(self._vectors)

    def _add_device(self, x: np.ndarray) -> None:
        from ..build import DeviceBuilder  # local import: build pulls in more
        if self._builder is None:
            self._builder = DeviceBuilder(self.config,
                                          sq_params=self._sq_np,
                                          pq_cb=self._pq_np,
                                          r_window=self.r_window)
        # hand over our array references for the duration of the call: the
        # builder donates them into its programs; a second live reference
        # here would keep a second copy of each capacity-sized buffer alive
        g, v, s = self._graph, self._vectors, self._sqnorms
        self._graph = self._vectors = self._sqnorms = None
        try:
            g, v, s = self._builder.add(
                g, v, s, x, ef_construction=self.ef_construction)
        finally:
            self._graph, self._vectors, self._sqnorms = g, v, s

    def grow(self, capacity: int, *, upper_capacity: int = -1) -> None:
        """Raise the preallocated ``capacity`` in place.

        Device arrays are fixed-shape (SURVEY.md §7 hard-part 5: no realloc
        on device) — this is the managed escape hatch: every capacity-sized
        array is padded to the new size one at a time (transient device
        memory = one array's old+new, not a second index), and the
        builder's compiled programs are dropped (they are
        shape-specialized). Contents, tombstones and
        the level RNG are preserved: a grown index searches bit-identically
        and continues building deterministically.

        faiss note: faiss's storage grows transparently per add(); here
        growth is an explicit O(capacity) operation by design —
        preallocation is what lets one XLA executable serve the index for
        its whole life."""
        from ..config import NO_NEIGHBOR
        cfg = self.config
        if capacity <= cfg.capacity:
            raise ValueError(f"grow() needs capacity > current "
                             f"({capacity} <= {cfg.capacity})")
        new_cfg = cfg.replace(capacity=capacity,
                              upper_capacity=upper_capacity)
        if new_cfg.upper_capacity < cfg.upper_capacity:
            new_cfg = cfg.replace(capacity=capacity,
                                  upper_capacity=cfg.upper_capacity)

        def pad_rows(arr, rows, fill):
            extra = rows - arr.shape[0]
            if extra <= 0:
                return arr
            tail = [s for s in arr.shape[1:]]
            fn = jax.jit(lambda a: jnp.concatenate(
                [a, jnp.full((extra, *tail), fill, a.dtype)], 0))
            return fn(arr)

        c, u = capacity, new_cfg.upper_capacity
        g = self._graph
        g = g._replace(neighbors0=pad_rows(g.neighbors0, c, NO_NEIGHBOR))
        g = g._replace(levels=pad_rows(g.levels, c, NO_NEIGHBOR),
                       upper_slot=pad_rows(g.upper_slot, c, NO_NEIGHBOR))
        g = g._replace(upper_node=pad_rows(g.upper_node, u, NO_NEIGHBOR),
                       upper_neighbors=pad_rows(g.upper_neighbors, u,
                                                NO_NEIGHBOR))
        self._graph = g
        self._vectors = pad_rows(self._vectors, c, 0)
        self._sqnorms = pad_rows(self._sqnorms, c, 0.0)
        if self._alive is not None:
            self._alive = pad_rows(self._alive, c, True)
        if self._host is not None:           # build="host": numpy arrays
            h = self._host
            h.cfg = h.cfg.replace(capacity=capacity,
                                  upper_capacity=new_cfg.upper_capacity)
            pc, pu = c - len(h.levels), u - len(h.upper_node)
            h.vectors = np.pad(h.vectors, ((0, pc), (0, 0)))
            h.neighbors0 = np.pad(h.neighbors0, ((0, pc), (0, 0)),
                                  constant_values=NO_NEIGHBOR)
            h.levels = np.pad(h.levels, (0, pc),
                              constant_values=NO_NEIGHBOR)
            h.upper_slot = np.pad(h.upper_slot, (0, pc),
                                  constant_values=NO_NEIGHBOR)
            h.upper_node = np.pad(h.upper_node, (0, pu),
                                  constant_values=NO_NEIGHBOR)
            h.upper_neighbors = np.pad(
                h.upper_neighbors, ((0, pu), (0, 0), (0, 0)),
                constant_values=NO_NEIGHBOR)
        self.config = new_cfg
        if self._builder is not None:
            # keep the level RNG (determinism across grow); drop the
            # capacity-shape-specialized programs
            self._builder.cfg = new_cfg
            self._builder._steps.clear()
        # packed tables are ntotal-sized and content-derived from rows
        # < ntotal, which a grow leaves untouched — they stay valid

    # -- packed serving mode (ops/packed.py) ----------------------------------
    def enable_packed(self, bits: int = 8, *, mode: str | None = None,
                      layout: str = "auto",
                      pq_m: int | None = None, pq_bits: int = 8,
                      train_x: np.ndarray | None = None,
                      max_bytes: int | None = None,
                      reserve: int = 0, chunk: int = 1 << 16) -> int:
        """Build packed neighbor-code tables: the level-0 beam then routes on
        quantized distances read from ONE fat row per expanded node (~3 row
        fetches per hop instead of ~1 + M_max0), with an exact rerank of
        the final ef buffer. Returns the packed table size in bytes.

        Two row codecs (``mode``):
          * ``"sq"`` (default for flat/sq8/bf16 storage): each neighbor
            contributes d scalar-quantized dims — costs
            ntotal * m0 * d * bits/8 bytes (``bits``: 8 or 4).
          * ``"pq"`` (default — and the only codec — for pq storage): each
            neighbor contributes ``pq_m`` PQ sub-codes — costs
            ntotal * m0 * pq_m * pq_bits/8 bytes, 8-16x smaller than sq
            rows; the configuration that fits 10M-scale packed serving on
            one chip. For pq storage the stored codes/codebooks are reused
            directly; for flat/sq8 storage ROUTING-only codebooks are
            trained (``pq_m`` required; ``pq_bits`` 8 or 4; pass
            ``train_x`` — host training vectors — to avoid pulling a
            sample through the slow device->host path).

        ``layout`` ("sq" rows only): "bytes" (uint8 rows), "words" (int32
        word-packed rows holding the same bit pattern, unpacked in XLA), or
        "auto" (default): the platform's choice (hnsw_jax.search
        search_engine), which is "bytes" on every supported platform.

        Routing is approximate either way; the final ef buffer is re-ranked
        with storage-grade distances (exact f32 / sq8 x̂ / exact ADC), so
        returned (D, I) keep full precision.

        Subsequent device-mode ``add()`` calls MAINTAIN the tables
        incrementally (only rows whose adjacency changed are re-packed, see
        ``_refresh_packed``) as long as the new total fits the table's row
        headroom — ``reserve`` provisions extra rows for exactly that
        (beyond the free headroom from ``chunk``-alignment); past it, adds
        fall back to a full re-pack. Tombstoned ids keep working: deletion
        filters results, not routing."""
        if mode is None:
            mode = "pq" if self.config.is_pq else "sq"
        if mode not in ("sq", "pq"):
            raise ValueError(f"mode must be 'sq' or 'pq', got {mode!r}")
        n_rows = min(self.config.capacity,
                     max(self.ntotal, 1) + max(reserve, 0))
        if mode == "sq":
            if self.config.is_pq:
                raise ValueError(
                    "sq packed rows need scalar storage; pq storage packs "
                    "its own codes — use enable_packed(mode='pq')")
            from ..ops.packed import pack_neighbors
            if layout not in ("auto", "bytes", "words"):
                raise ValueError(f"layout must be 'auto', 'bytes' or "
                                 f"'words', got {layout!r}")
            if layout == "auto":
                from ..search import search_engine
                layout = search_engine().packed_layout
            self._packed = pack_neighbors(
                self._graph.neighbors0, self._vectors, self._graph.levels,
                bits=bits, max_bytes=max_bytes, n_rows=n_rows, chunk=chunk,
                dequant=self._sq, layout=layout)
        else:
            from ..ops.packed import pack_pq_neighbors
            cb, codes, pq_bits = self._route_codebooks(
                pq_m, pq_bits, train_x)
            self._packed = pack_pq_neighbors(
                self._graph.neighbors0, codes, cb, pq_bits=pq_bits,
                max_bytes=max_bytes, n_rows=n_rows, chunk=chunk)
        # remembered for incremental-era full rebuilds (_refresh_packed);
        # layout is the RESOLVED one (auto decided above) so a rebuild
        # reproduces the same table format
        self._packed_opts = dict(bits=bits, mode=mode, layout=layout,
                                 pq_m=pq_m, pq_bits=pq_bits,
                                 max_bytes=max_bytes, reserve=reserve,
                                 chunk=chunk)
        return self._packed.nbytes

    def _route_codebooks(self, pq_m, pq_bits, train_x):
        """(cb, codes [capacity, pq_m], pq_bits) for PQ-coded packed rows.

        pq storage reuses its stored codebooks/codes; other storage trains
        ROUTING-only codebooks once (kept across re-packs and incremental
        maintenance in ``self._route`` — retraining after adds would
        desynchronize the packed rows the way retraining storage codecs
        would the stored codes)."""
        if self.config.is_pq:
            return self._pq, self._vectors, self.config.pq_bits
        if self._route is not None:
            cb, codes = self._route
            if pq_m not in (None, cb.shape[0]):
                raise ValueError(
                    f"routing codebooks already trained with pq_m="
                    f"{cb.shape[0]}; call disable_packed(reset_routing="
                    f"True) to retrain with pq_m={pq_m}")
            return cb, codes, (4 if cb.shape[1] <= 16 else 8)
        from ..ops.pq import encode_pq, train_pq
        if pq_m is None or pq_m <= 0 or self.config.dim % pq_m:
            raise ValueError(
                f"mode='pq' on {self.config.dtype} storage needs pq_m > 0 "
                f"dividing dim={self.config.dim} (got {pq_m})")
        if train_x is not None:
            xs = np.asarray(train_x, np.float32)
        else:
            import logging
            logging.getLogger("hnsw_jax").warning(
                "enable_packed(mode='pq'): no train_x given — pulling a "
                "training sample device->host; pass the original vectors "
                "to skip this copy")
            xs = self.reconstruct_n(0, min(self.ntotal, 65536))
        cb = jnp.asarray(train_pq(xs, pq_m, ksub=1 << pq_bits,
                                  seed=self.config.seed))
        codes = encode_pq(self._vectors, cb, dequant=self._sq)
        self._route = (cb, codes)
        return cb, codes, pq_bits

    def _refresh_packed(self, packed, fp_old, old_ntotal: int) -> None:
        """Post-add() packed-table maintenance: re-pack exactly the rows the
        build modified (fingerprint diff + the new ids), falling back to a
        full re-pack when that's cheaper or the table ran out of padded
        rows. Leaves the index unpacked only if re-packing itself fails."""
        import logging
        from ..ops.packed import (PackedNeighbors, PackedPQ,
                                  row_fingerprints, update_packed_pq_rows,
                                  update_packed_rows)
        log = logging.getLogger("hnsw_jax")
        is_pq_rows = isinstance(packed, PackedPQ)
        opts = getattr(self, "_packed_opts", None)
        if opts is None:
            opts = dict(bits=(8 if is_pq_rows else
                              packed.bits_for(self.config.dim,
                                              self.config.m0)),
                        mode=("pq" if is_pq_rows else "sq"),
                        layout=("auto" if is_pq_rows else packed.layout),
                        pq_m=None, pq_bits=8, max_bytes=None, reserve=0,
                        chunk=1 << 16)
        n = self.ntotal
        try:
            # routing codes of the NEW vectors (pq rows over non-pq
            # storage): encode before any row assembly reads them
            if is_pq_rows and not self.config.is_pq and n > old_ntotal:
                from ..ops.pq import encode_pq
                cb_r, codes_r = self._route
                new = encode_pq(self._vectors[old_ntotal:n], cb_r,
                                dequant=self._sq)
                self._route = (cb_r, codes_r.at[old_ntotal:n].set(new))
            pad_cap = (packed.nbr_codes if is_pq_rows
                       else packed.nbr_sq).shape[0]
            rebuild = n > pad_cap
            ids = None
            if not rebuild:
                fp_new = row_fingerprints(self._graph.neighbors0)
                changed = jnp.any(fp_old != fp_new, axis=1)
                # np.array (copy): asarray views jax buffers READ-ONLY and
                # the in-place marking below would raise
                changed = np.array(changed[:n])
                changed[old_ntotal:] = True        # new rows always re-pack
                ids = np.flatnonzero(changed).astype(np.int32)
                rebuild = len(ids) > max(n // 4, 50_000)
            if rebuild:
                packed = None  # free the old table BEFORE building anew
                self.enable_packed(**opts)
                log.info("packed tables fully re-packed after add() "
                         "(incremental not worthwhile)")
                return
            if is_pq_rows:
                codes, cb = packed.nbr_codes, packed.cb
                route_codes = (self._vectors if self.config.is_pq
                               else self._route[1])
                pq_bits = packed.pq_bits_for(self.config.m0)
            else:
                codes, sq = packed.nbr_codes, packed.nbr_sq
                offset, scale = packed.offset, packed.scale
            packed = None  # donation below deletes the table buffers
            CH = 4096
            for i in range(0, len(ids), CH):
                batch = np.full((CH,), -1, np.int32)
                part = ids[i:i + CH]
                batch[:len(part)] = part
                if is_pq_rows:
                    codes = update_packed_pq_rows(
                        codes, self._graph.neighbors0, route_codes,
                        jnp.asarray(batch), pq_bits=pq_bits)
                else:
                    codes, sq = update_packed_rows(
                        codes, sq, self._graph.neighbors0, self._vectors,
                        offset, scale, jnp.asarray(batch),
                        bits=opts["bits"], dequant=self._sq)
            if is_pq_rows:
                self._packed = PackedPQ(codes, cb)
            else:
                self._packed = PackedNeighbors(codes, sq, scale=scale,
                                               offset=offset)
            log.info("packed tables incrementally updated after add(): "
                     "%d rows re-packed", len(ids))
        except Exception as e:  # noqa: BLE001 — serving must not lose adds
            log.warning("packed-table refresh failed (%r); packed mode "
                        "disabled — call enable_packed() to restore", e)
            self._packed = None

    def disable_packed(self, *, reset_routing: bool = False) -> None:
        """Drop the packed tables (and with ``reset_routing`` also the
        trained routing codebooks, so the next enable_packed(mode='pq')
        retrains with possibly different pq_m/pq_bits)."""
        self._packed = None
        if reset_routing:
            self._route = None

    @property
    def packed_enabled(self) -> bool:
        return self._packed is not None

    # -- query ----------------------------------------------------------------
    def search(self, x: np.ndarray, k: int, *, ef_search: int | None = None,
               with_stats: bool = False, allowed: np.ndarray | None = None,
               device_out: bool = False, max_hops: int = 0,
               use_packed: bool | None = None, beam_keys: str | None = None,
               entry_mode: str | None = None):
        """Batched k-NN. Returns (D [n, k] float32, I [n, k] int64) like
        faiss; I == -1 where fewer than k reachable. ``device_out=True``
        returns device arrays (D f32, I int32) without the D2H transfer —
        use when chaining on-device work or timing compute honestly.

        ``allowed``: optional id filter (faiss IDSelector parity) — either a
        bool mask over ids or an int array of permitted ids. Traversal is
        unfiltered; only permitted ids are returned. Raise ef_search when
        filtering aggressively.

        ``max_hops``: level-0 hop budget, a runtime knob (no recompile).
        0 (default) = auto cap at ef_search + 8 (cuts the convergence
        tail that serves few queries — see hnsw_jax.search) for
        unfiltered searches; filtered searches (``allowed``/tombstones)
        default to full convergence, where truncation costs real recall.
        < 0 = run to convergence (faiss-exact termination); > 0 = explicit
        cap (applies to filtered searches too).

        ``use_packed``: None (default) routes via the packed neighbor-code
        tables when ``enable_packed()`` has been called; False bypasses them
        for this call; True requires them (raises if not enabled).

        ``beam_keys``: "auto" (bf16 merge keys where routing is already
        quantized, f32 otherwise) | "bf16" (force the cheaper bf16 merge;
        near-tie buffer retention becomes approximate — returned distances
        stay exact via the rerank) | "f32". None (default) uses the
        index-level ``self.beam_keys`` attribute ("auto").

        ``entry_mode``: "sample" (default via "auto": entry selected by a
        dense scan over a strided sample of the live set, which replaces
        the descent's dependent chain of gathers with matrix products at
        the same entry quality class; hnsw_jax.search._sample_seeds) |
        "seed" (same scan, up to 16 per-stratum argmins re-scored exactly;
        the beam starts from the best of them — an ablation knob) |
        "descend" (the faiss greedy upper-level walk) | "auto" (sample,
        except PQ storage which keeps the descent). None uses
        ``self.entry_mode`` ("auto")."""
        if use_packed is None:
            packed = self._packed
        elif use_packed:
            if self._packed is None:
                raise ValueError("use_packed=True but enable_packed() was "
                                 "not called (or add() invalidated it)")
            packed = self._packed
        else:
            packed = None
        if self.ntotal == 0 or (self._alive is not None
                                and self.n_deleted >= self.ntotal):
            n = len(x)
            return (np.full((n, k), np.inf, np.float32),
                    np.full((n, k), -1, np.int64))
        # jax arrays pass through untouched — callers doing repeated searches
        # should stage queries on device once (jnp.asarray) and reuse
        if not isinstance(x, jax.Array):
            x = jnp.asarray(np.asarray(x, np.float32))
        if allowed is not None:
            allowed = self._normalize_allowed(allowed)
        if self._alive is not None and not self._routing_clean:
            # tombstones compose with user filters; after vacuum() dead ids
            # are unreachable by routing, so no filter (or its forced
            # full-convergence beam) is needed
            allowed = self._alive if allowed is None else \
                (allowed & self._alive)
        ef = int(ef_search or self.ef_search)
        out = hnsw_search(
            self._graph, self._vectors, self._sqnorms, x,
            k=k, ef_search=ef, metric=self.config.metric,
            max_level_cap=self.config.max_level_cap, max_hops=max_hops,
            n_expand=self.n_expand, with_stats=with_stats, allowed=allowed,
            packed=packed, dequant=self._sq, pq=self._pq,
            beam_keys=beam_keys or self.beam_keys,
            entry_mode=entry_mode or self.entry_mode)
        if with_stats:
            d, i, stats = out
            if device_out:
                return d, i, stats
            return np.asarray(d), np.asarray(i, np.int64), stats
        d, i = out
        if device_out:
            return d, i
        return np.asarray(d), np.asarray(i, np.int64)

    def tune_ef_search(self, x: np.ndarray, target_recall: float = 0.95,
                       *, k: int = 10, set_default: bool = True,
                       ef_grid=(16, 24, 32, 48, 64, 96, 128, 192, 256,
                                384, 512)) -> int:
        """faiss AutoTune analogue: find the smallest efSearch whose
        recall@k on ``x`` (vs this index's own exact oracle, computed with
        the brute-force kernel over the stored vectors) reaches
        ``target_recall``. Cheap here because ef is a runtime scalar — no
        recompile between grid points beyond the pow-2 buffer buckets.
        Returns the chosen ef (the largest grid point if the target is
        never reached) and, with ``set_default``, installs it as
        ``self.ef_search``."""
        from ..ops.distances import brute_force_topk
        from ..utils.recall import recall_at_k
        x = jnp.asarray(np.asarray(x, np.float32))
        # exact oracle over the stored vectors (x̂ for sq8 — the same values
        # every search distance sees)
        _, gt = brute_force_topk(x, self._vectors, k=k,
                                 metric=self.config.metric,
                                 n_valid=self.ntotal, dequant=self._sq,
                                 pq=self._pq)
        gt = np.asarray(gt)
        chosen = ef_grid[-1]
        for ef in ef_grid:
            if ef < k:
                continue
            _, ii = self.search(x, k=k, ef_search=ef)
            if recall_at_k(np.asarray(ii), gt, k) >= target_recall:
                chosen = ef
                break
        if set_default:
            self.ef_search = int(chosen)
        return int(chosen)

    def tune_operating_point(self, x: np.ndarray, target_recall: float = 0.95,
                             *, k: int = 10, set_default: bool = True,
                             ef_grid=(16, 24, 32, 40, 48, 56, 64, 80, 96,
                                      128, 192, 256, 384, 512)) -> tuple:
        """Find the cheapest (ef_search, max_hops) pair reaching
        ``target_recall`` — the 2-D refinement of ``tune_ef_search``
        (faiss AutoTune / OperatingPoints analogue).

        Both knobs are runtime scalars (no recompiles inside a pow-2 ef
        bucket), and cost is monotone in each: the tuner takes the smallest
        grid ef that reaches the target at the auto hop cap, then
        binary-searches the smallest hop cap that still reaches it.
        Returns
        (ef, max_hops); with ``set_default`` installs ``self.ef_search``
        (pass the returned max_hops per search call)."""
        from ..ops.distances import brute_force_topk
        from ..utils.recall import recall_at_k
        x = jnp.asarray(np.asarray(x, np.float32))
        _, gt = brute_force_topk(x, self._vectors, k=k,
                                 metric=self.config.metric,
                                 n_valid=self.ntotal, dequant=self._sq,
                                 pq=self._pq)
        gt = np.asarray(gt)

        def recall_at(ef, hops):
            _, ii = self.search(x, k=k, ef_search=ef, max_hops=hops)
            return recall_at_k(np.asarray(ii), gt, k)

        chosen_ef = ef_grid[-1]
        for ef in ef_grid:
            if ef < k:
                continue
            if recall_at(ef, 0) >= target_recall:
                chosen_ef = int(ef)
                break
        # smallest hop cap keeping the target: recall is nondecreasing in
        # the cap, fewer hops is strictly cheaper -> binary search
        lo, hi = 16, chosen_ef + 8
        best = hi
        while lo <= hi:
            mid = (lo + hi) // 2
            if recall_at(chosen_ef, mid) >= target_recall:
                best = mid
                hi = mid - 1
            else:
                lo = mid + 1
        if set_default:
            self.ef_search = chosen_ef
        return chosen_ef, int(best)

    def range_search(self, x: np.ndarray, radius: float, *,
                     ef_search: int | None = None, **kw):
        """faiss ``IndexHNSW.range_search`` semantics: L2 keeps squared
        distance < radius, IP keeps dot > radius; returns (lims [nq+1], D,
        I) in faiss's CSR layout, per-query best-first. Like faiss's, the
        result is bounded by the beam traversal: at most ``ef_search``
        candidates per query are examined for the radius test — raise it to
        widen coverage (FlatIndex.range_search is the exact oracle)."""
        ef = int(ef_search or self.ef_search)
        d, i = self.search(x, k=ef, ef_search=ef, **kw)
        d = np.asarray(d)
        i = np.asarray(i, np.int64)
        if self.config.metric == L2:
            keep = (i >= 0) & (d < radius)
        else:
            d = -d  # engine returns -dot ascending; faiss reports the dot
            keep = (i >= 0) & (d > radius)
        lims = np.zeros(len(d) + 1, np.int64)
        np.cumsum(keep.sum(1), out=lims[1:])
        # rows are already sorted best-first by the engine; IP rows are
        # ascending in -dot == descending in dot, which is best-first too
        return lims, d[keep], i[keep]

    def _normalize_allowed(self, allowed) -> jax.Array:
        """Normalize a user id filter to a bool [capacity] mask, by dtype and
        shape — NOT by host/device residency. Accepts an int id-whitelist or
        a bool mask, as numpy or as a device array (device int whitelists are
        scattered on device; no host round-trip)."""
        cap = self.config.capacity
        if isinstance(allowed, jax.Array):
            if jnp.issubdtype(allowed.dtype, jnp.integer):
                return jnp.zeros((cap,), jnp.bool_).at[
                    allowed.reshape(-1)].set(True, mode="drop")
            if allowed.dtype != jnp.bool_:
                raise TypeError(
                    f"allowed: expected bool mask or int id list, got dtype "
                    f"{allowed.dtype}")
            if allowed.ndim != 1 or allowed.shape[0] > cap:
                raise ValueError(
                    f"allowed bool mask must be 1-d with length <= capacity "
                    f"({cap}), got shape {allowed.shape}")
            if allowed.shape[0] == cap:
                return allowed
            return jnp.zeros((cap,), jnp.bool_).at[
                : allowed.shape[0]].set(allowed)
        a = np.asarray(allowed)
        if a.dtype == np.bool_:
            if a.ndim != 1 or len(a) > cap:
                raise ValueError(
                    f"allowed bool mask must be 1-d with length <= capacity "
                    f"({cap}), got shape {a.shape}")
            if len(a) != cap:
                mask = np.zeros(cap, np.bool_)
                mask[: len(a)] = a
                a = mask
            return jnp.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            mask = np.zeros(cap, np.bool_)
            mask[a.reshape(-1)] = True  # raises on out-of-range, on purpose
            return jnp.asarray(mask)
        raise TypeError(
            f"allowed: expected bool mask or int id list, got dtype {a.dtype}")

    def reconstruct(self, i: int) -> np.ndarray:
        if not 0 <= i < self.ntotal:
            raise IndexError(i)
        return self.reconstruct_n(i, 1)[0]

    def reconstruct_n(self, i0: int, n: int) -> np.ndarray:
        if self.config.is_pq:  # decode codes -> x̂ (faiss PQ reconstruct)
            from ..ops.pq import decode_pq
            return np.asarray(decode_pq(self._vectors[i0:i0 + n],
                                        jnp.asarray(self._pq_np)), np.float32)
        v = np.asarray(self._vectors[i0:i0 + n], np.float32)
        if self.config.is_sq:  # decode codes -> x̂ (faiss SQ reconstruct)
            off, sc = self._sq_np
            v = off + sc * v
        return v

    def reconstruct_batch(self, ids: np.ndarray) -> np.ndarray:
        """Decode arbitrary (possibly non-contiguous) ids — faiss
        ``reconstruct_batch``. One device gather + one decode; ids may
        repeat. Entries of -1 decode to zero rows
        (``search_and_reconstruct`` remaps those to NaN for faiss parity).
        """
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ((ids < -1) | (ids >= self.ntotal)).any():
            raise IndexError("reconstruct_batch: id out of range")
        rows = self._vectors[jnp.asarray(np.maximum(ids, 0), jnp.int32)]
        if self.config.is_pq:
            from ..ops.pq import decode_pq
            v = np.asarray(decode_pq(rows, jnp.asarray(self._pq_np)),
                           np.float32)
        else:
            v = np.asarray(rows, np.float32)
            if self.config.is_sq:
                off, sc = self._sq_np
                v = off + sc * v
        if (ids < 0).any():
            v = np.array(v)  # np.asarray views of device arrays are read-only
            v[ids < 0] = 0.0
        return v

    def search_and_reconstruct(self, x: np.ndarray, k: int, **kw):
        """faiss ``search_and_reconstruct``: returns (D [n,k] f32,
        I [n,k] i64, R [n,k,d] f32) where R[i,j] is the stored (decoded)
        vector of result I[i,j], NaN rows where I == -1 (faiss memsets
        missing rows to 0xff = NaN; a zero row would be ambiguous with a
        genuinely stored zero vector). Keyword args pass through to
        :meth:`search`; with ``with_stats=True`` returns (D, I, R, stats).
        """
        out = self.search(x, k, **kw)
        d, i = out[0], out[1]
        r = self.reconstruct_batch(i).reshape(len(i), k, self.config.dim)
        missing = np.asarray(i) < 0
        if missing.any():
            r = np.array(r)  # reconstruct_batch may return a shared buffer
            r[missing] = np.nan
        return (d, i, r, *out[2:])

    def merge_from(self, other: "HnswIndex") -> int:
        """Absorb another index's live vectors into this one (faiss
        ``Index::merge_from``; upstream IndexHNSW itself refuses it — here
        it is a batched re-insert, so graph quality equals a fresh add()).
        Tombstoned ids in ``other`` are skipped; ``other`` is unchanged.
        Ids of the merged vectors are assigned contiguously from
        ``self.ntotal``. Returns the number of vectors merged."""
        if other.config.dim != self.config.dim:
            raise ValueError(
                f"merge_from: dim mismatch {other.config.dim} != "
                f"{self.config.dim}")
        if other.config.metric != self.config.metric:
            raise ValueError("merge_from: metric mismatch")
        if other.ntotal == 0:
            return 0
        x = other.reconstruct_n(0, other.ntotal)
        if other._alive is not None:
            x = x[np.asarray(other._alive[:other.ntotal])]
        if len(x):
            self.add(x)
        return len(x)

    # -- deletion (tombstones; a capability faiss-HNSW lacks entirely) --------
    def remove_ids(self, ids: np.ndarray) -> int:
        """Tombstone ids: they stop appearing in results immediately but keep
        routing queries through the graph (standard HNSW tombstoning — the
        graph is never broken). Slots are not reused; remaining ids are
        unchanged (unlike faiss remove_ids, which renumbers). Returns the
        number of newly removed ids."""
        ids = np.asarray(ids).reshape(-1)
        if ((ids < 0) | (ids >= self.ntotal)).any():
            raise IndexError("remove_ids: id out of range")
        if self._alive is None:
            self._alive = jnp.ones((self.config.capacity,), jnp.bool_)
        before = self.n_deleted
        self._alive = self._alive.at[jnp.asarray(ids, jnp.int32)].set(False)
        self._routing_clean = False  # until vacuum() re-patches routing
        return self.n_deleted - before

    def vacuum(self) -> int:
        """Physically remove tombstoned nodes from routing (ops/vacuum.py).

        After ``remove_ids``, dead nodes still route queries (tombstoning
        filters results only) and result filtering forces full-convergence
        beams. ``vacuum()`` deletes every link into dead nodes, patches the
        holes with candidates inherited from the dead nodes' own lists
        (re-pruned by the select-neighbors heuristic — hnswlib's deletion
        repair rule), clears dead rows, and moves the entry point to a live
        node — after which unfiltered searches can never reach a dead id,
        so they run at full (hop-capped) speed again. Ids stay stable and
        slots are not reused (``compacted()`` is the renumbering path).
        Packed tables are invalidated (adjacency changed wholesale) — call
        ``enable_packed()`` again. Returns the number of nodes vacuumed."""
        if self._alive is None or self.n_deleted == 0:
            self._routing_clean = True
            return 0
        from ..ops.vacuum import live_entry_point, vacuum_level0, vacuum_upper
        n_dead = self.n_deleted
        dead = (~self._alive) & (self._graph.levels >= 0)
        self._packed = None  # rows reference pre-vacuum adjacency
        g = self._graph
        nb0, upper = g.neighbors0, g.upper_neighbors
        self._graph = None  # sole-reference discipline: both get donated
        try:
            nb0 = vacuum_level0(nb0, self._vectors, dead,
                                metric=self.config.metric,
                                dequant=self._sq, pq=self._pq)
            upper = vacuum_upper(upper, g.upper_node, g.upper_slot,
                                 g.levels, self._vectors, dead,
                                 metric=self.config.metric,
                                 dequant=self._sq, pq=self._pq)
            ep, mx = live_entry_point(g.levels, dead)
        finally:
            self._graph = g._replace(neighbors0=nb0, upper_neighbors=upper)
        self._graph = self._graph._replace(entry_point=ep, max_level=mx)
        self._routing_clean = True
        return int(n_dead)

    def compacted(self, x: np.ndarray | None = None) -> tuple[
            "HnswIndex", np.ndarray]:
        """Rebuild WITHOUT tombstoned ids, renumbering like faiss
        ``remove_ids``. Returns (new_index, old_ids) where ``old_ids[j]``
        is the original id of the new index's id j.

        ``x``: the original f32 vectors [ntotal, d] (host). If omitted they
        are pulled device->host via ``reconstruct_n``."""
        n = self.ntotal
        if x is None:
            x = self.reconstruct_n(0, n)
        x = np.asarray(x, np.float32)
        if x.shape[0] != n:
            raise ValueError(f"expected all {n} original vectors, "
                             f"got {x.shape[0]}")
        alive = (np.ones(n, bool) if self._alive is None
                 else np.asarray(self._alive[:n]))
        old_ids = np.flatnonzero(alive)
        cfg = self.config
        out = HnswIndex(config=cfg, build=self.build_mode)
        out.ef_construction = self.ef_construction
        out.ef_search = self.ef_search
        if cfg.is_sq or cfg.is_pq:
            out._sq, out._sq_np = self._sq, self._sq_np
            out._pq, out._pq_np = self._pq, self._pq_np
            out.is_trained = True
        if len(old_ids):
            out.add(x[old_ids])
        return out, old_ids

    # -- maintenance ------------------------------------------------------------
    def check(self, strict: bool = True) -> dict:
        """Structural invariant check (debug; SURVEY.md §5 race-detection
        analogue). Tombstoned nodes (``remove_ids``) are exempt from the
        liveness invariants (isolation; post-vacuum they are isolated by
        design)."""
        return check_invariants(self._graph, self.config, strict=strict,
                                alive=self._alive)

    # -- persistence (faiss write_index/read_index parity, C12) ---------------
    def save(self, path: str) -> None:
        """Usable at any time, including mid-build: the graph arrays ARE the
        full builder state, and the level-RNG state rides along so a resumed
        build is bit-identical to an uninterrupted one (SURVEY.md §5)."""
        extra = {"routing_clean": bool(self._routing_clean)}
        if self._builder is not None:
            extra["builder_rng_state"] = _jsonify(
                self._builder.rng.bit_generator.state)
        xarr = {}
        if self._alive is not None:
            xarr["alive"] = np.asarray(self._alive)
        if self._sq_np is not None:
            xarr["sq_offset"], xarr["sq_scale"] = self._sq_np
        if self._pq_np is not None:
            xarr["pq_codebooks"] = self._pq_np
        save_graph(path, self._graph, self._vectors, self.config, extra,
                   extra_arrays=xarr)

    def to_bytes(self) -> bytes:
        """faiss ``serialize_index``: the full index (graph + vectors +
        config + RNG/tombstone state) as one bytes blob — same format as
        :meth:`save` (a compressed npz), so blobs and files interchange."""
        import io
        buf = io.BytesIO()
        self.save(buf)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "HnswIndex":
        """faiss ``deserialize_index``."""
        import io
        return cls.load(io.BytesIO(data))

    @classmethod
    def load(cls, path: str) -> "HnswIndex":
        # host-side load, then one transfer per array — ctor allocation is
        # skipped, so peak device memory is one copy of the index
        graph, vectors, cfg, extra, xarr = load_graph(path, as_numpy=True)
        idx = cls(config=cfg, _alloc=False)
        idx._graph = GraphArrays(
            **{k: jnp.asarray(getattr(graph, k)) for k in GraphArrays._fields})
        idx._vectors = jnp.asarray(vectors)
        if "sq_offset" in xarr:
            idx._sq_np = (np.asarray(xarr["sq_offset"], np.float32),
                          np.asarray(xarr["sq_scale"], np.float32))
            idx._sq = (jnp.asarray(idx._sq_np[0]), jnp.asarray(idx._sq_np[1]))
            idx.is_trained = True
        if "pq_codebooks" in xarr:
            idx._pq_np = np.asarray(xarr["pq_codebooks"], np.float32)
            idx._pq = jnp.asarray(idx._pq_np)
            idx.is_trained = True
        if cfg.is_pq:
            from ..ops.pq import pq_sqnorms
            idx._sqnorms = pq_sqnorms(idx._vectors, idx._pq)
        else:
            idx._sqnorms = compute_sqnorms(idx._vectors, dequant=idx._sq)
        if "alive" in xarr:
            idx._alive = jnp.asarray(xarr["alive"])
            # pre-vacuum tombstones must keep filtering after a reload
            idx._routing_clean = bool(extra.get("routing_clean", False))
        if "builder_rng_state" in extra:
            from ..build import DeviceBuilder
            idx._builder = DeviceBuilder(cfg, sq_params=idx._sq_np,
                                         pq_cb=idx._pq_np,
                                         r_window=idx.r_window)
            idx._builder.rng.bit_generator.state = \
                extra["builder_rng_state"]
        return idx


def _jsonify(obj):
    """numpy scalars inside np.random state dicts -> plain python."""
    import numpy as _np
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (_np.integer,)):
        return int(obj)
    if isinstance(obj, (_np.floating,)):
        return float(obj)
    return obj
