"""Host-side NumPy reference HNSW (textbook implementation).

Role (SURVEY.md §7 stage 2): a second oracle. It is a from-scratch, literal
implementation of the HNSW algorithm (Malkov & Yashunin, TPAMI 2018) with
faiss ``IndexHNSWFlat`` semantics — serial inserts, true priority queues,
select-neighbors heuristic — used to (a) produce known-good graphs for testing
the device query engine in isolation, and (b) cross-check the vectorized on-device
builder's recall. Slow by design; never on the hot path.
"""

from __future__ import annotations

import heapq

import numpy as np

from .config import IP, NO_NEIGHBOR, HnswConfig
from .graph import GraphArrays


class NumpyHnsw:
    def __init__(self, cfg: HnswConfig):
        self.cfg = cfg
        c, u, L = cfg.capacity, cfg.upper_capacity, cfg.max_level_cap
        self.vectors = np.zeros((c, cfg.dim), np.float32)
        self.neighbors0 = np.full((c, cfg.m0), NO_NEIGHBOR, np.int32)
        self.levels = np.full((c,), NO_NEIGHBOR, np.int32)
        self.upper_slot = np.full((c,), NO_NEIGHBOR, np.int32)
        self.upper_node = np.full((u,), NO_NEIGHBOR, np.int32)
        self.upper_neighbors = np.full((u, L, cfg.m), NO_NEIGHBOR, np.int32)
        self.entry_point = NO_NEIGHBOR
        self.max_level = NO_NEIGHBOR
        self.ntotal = 0
        self.n_upper = 0
        self.rng = np.random.default_rng(cfg.seed)

    # -- primitives ---------------------------------------------------------
    def _dist(self, q: np.ndarray, ids) -> np.ndarray:
        x = self.vectors[ids]
        if self.cfg.metric == IP:
            return -(x @ q)
        diff = x - q
        return np.einsum("nd,nd->n", diff, diff)

    def draw_level(self) -> int:
        u = self.rng.random()
        lvl = int(-np.log(max(u, 1e-12)) * self.cfg.level_mult)
        return min(lvl, self.cfg.max_level_cap)

    def _nbrs(self, node: int, level: int) -> np.ndarray:
        if level == 0:
            lst = self.neighbors0[node]
        else:
            lst = self.upper_neighbors[self.upper_slot[node], level - 1]
        return lst[lst >= 0]

    # -- search (paper Alg. 2: SEARCH-LAYER) --------------------------------
    def _search_layer(self, q: np.ndarray, entries: list[int], ef: int,
                      level: int) -> list[tuple[float, int]]:
        """Best-first beam search; returns [(dist, id)] sorted ascending,
        length <= ef."""
        visited = set(entries)
        dists = self._dist(q, np.array(entries))
        cand = [(float(d), e) for d, e in zip(dists, entries)]  # min-heap
        heapq.heapify(cand)
        result = [(-d, e) for d, e in cand]  # max-heap via negation
        heapq.heapify(result)
        while len(result) > ef:
            heapq.heappop(result)
        while cand:
            d_c, c = heapq.heappop(cand)
            if d_c > -result[0][0] and len(result) >= ef:
                break
            nbrs = [int(x) for x in self._nbrs(c, level) if int(x) not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            for d_n, nbr in zip(self._dist(q, np.array(nbrs)), nbrs):
                d_n = float(d_n)
                if len(result) < ef or d_n < -result[0][0]:
                    heapq.heappush(cand, (d_n, nbr))
                    heapq.heappush(result, (-d_n, nbr))
                    if len(result) > ef:
                        heapq.heappop(result)
        return sorted((-nd, e) for nd, e in result)

    def _greedy_descend(self, q: np.ndarray, node: int, from_level: int,
                        to_level: int) -> int:
        """ef=1 walk from `from_level` down to (exclusive) `to_level`
        (faiss greedy_update_nearest)."""
        d = float(self._dist(q, np.array([node]))[0])
        for level in range(from_level, to_level, -1):
            improved = True
            while improved:
                improved = False
                nbrs = self._nbrs(node, level)
                if len(nbrs) == 0:
                    continue
                dn = self._dist(q, nbrs)
                j = int(np.argmin(dn))
                if dn[j] < d:
                    d = float(dn[j])
                    node = int(nbrs[j])
                    improved = True
        return node

    # -- neighbor selection (paper Alg. 4 / faiss shrink_neighbor_list) -----
    def select_neighbors(self, q: np.ndarray, cand: list[tuple[float, int]],
                         m: int) -> list[int]:
        """Keep candidate c only if it is closer to q than to every already
        kept neighbor (diversity rule). cand: [(dist_to_q, id)] ascending."""
        kept: list[int] = []
        for d_cq, c in sorted(cand):
            if len(kept) >= m:
                break
            cv = self.vectors[c]
            ok = True
            for k in kept:
                if self.cfg.metric == IP:
                    d_ck = -float(self.vectors[k] @ cv)
                else:
                    diff = self.vectors[k] - cv
                    d_ck = float(diff @ diff)
                if d_ck < d_cq:
                    ok = False
                    break
            if ok:
                kept.append(int(c))
        return kept

    # -- insertion (paper Alg. 1 / faiss add_with_locks) --------------------
    def _set_links(self, node: int, level: int, ids: list[int]) -> None:
        width = self.cfg.m0 if level == 0 else self.cfg.m
        row = np.full((width,), NO_NEIGHBOR, np.int32)
        row[: len(ids)] = ids
        if level == 0:
            self.neighbors0[node] = row
        else:
            self.upper_neighbors[self.upper_slot[node], level - 1] = row

    def _add_backlink(self, dst: int, src: int, level: int) -> None:
        """Append src to dst's list at `level`; if full, re-prune with the
        heuristic (faiss shrink semantics: capacity m0 at level 0, m above)."""
        lst = self._nbrs(dst, level)
        if src in lst:
            return
        cap = self.cfg.m0 if level == 0 else self.cfg.m
        if len(lst) < cap:
            self._set_links(dst, level, list(lst) + [src])
            return
        cand_ids = np.append(lst, src)
        d = self._dist(self.vectors[dst], cand_ids)
        kept = self.select_neighbors(self.vectors[dst],
                                     list(zip(d.tolist(), cand_ids.tolist())), cap)
        self._set_links(dst, level, kept)

    def add(self, xs: np.ndarray) -> None:
        xs = np.asarray(xs, np.float32)
        for x in xs:
            self._insert_one(x)

    def _insert_one(self, x: np.ndarray) -> None:
        cfg = self.cfg
        i = self.ntotal
        if i >= cfg.capacity:
            raise ValueError("capacity exceeded")
        self.vectors[i] = x
        lvl = self.draw_level()
        self.levels[i] = lvl
        if lvl >= 1:
            if self.n_upper >= cfg.upper_capacity:
                raise ValueError("upper_capacity exceeded")
            self.upper_slot[i] = self.n_upper
            self.upper_node[self.n_upper] = i
            self.n_upper += 1
        self.ntotal += 1

        if self.entry_point < 0:
            self.entry_point, self.max_level = i, lvl
            return

        ep = self._greedy_descend(x, self.entry_point, self.max_level, lvl)
        entries = [ep]
        for level in range(min(lvl, self.max_level), -1, -1):
            cand = self._search_layer(x, entries, cfg.ef_construction, level)
            kept = self.select_neighbors(x, cand, cfg.m)
            self._set_links(i, level, kept)
            for nbr in kept:
                self._add_backlink(nbr, i, level)
            entries = [e for _, e in cand]
        if lvl > self.max_level:
            self.entry_point, self.max_level = i, lvl

    # -- query --------------------------------------------------------------
    def search(self, queries: np.ndarray, k: int, ef_search: int | None = None):
        ef = max(ef_search or self.cfg.ef_search, k)
        out_d = np.full((len(queries), k), np.inf, np.float32)
        out_i = np.full((len(queries), k), -1, np.int64)
        for qi, q in enumerate(np.asarray(queries, np.float32)):
            ep = self._greedy_descend(q, self.entry_point, self.max_level, 0)
            res = self._search_layer(q, [ep], ef, 0)[:k]
            for j, (d, node) in enumerate(res):
                out_d[qi, j], out_i[qi, j] = d, node
        return out_d, out_i

    # -- export to device graph ---------------------------------------------
    def to_graph_arrays(self) -> GraphArrays:
        import jax.numpy as jnp
        return GraphArrays(
            neighbors0=jnp.asarray(self.neighbors0),
            levels=jnp.asarray(self.levels),
            upper_slot=jnp.asarray(self.upper_slot),
            upper_node=jnp.asarray(self.upper_node),
            upper_neighbors=jnp.asarray(self.upper_neighbors),
            entry_point=jnp.asarray(self.entry_point, jnp.int32),
            max_level=jnp.asarray(self.max_level, jnp.int32),
            ntotal=jnp.asarray(self.ntotal, jnp.int32),
            n_upper=jnp.asarray(self.n_upper, jnp.int32),
        )
