"""Graph storage: the HNSW multi-level graph as flat device arrays.

Capability parity: faiss ``struct HNSW`` fields ``levels[] / offsets[] /
neighbors[] / entry_point / max_level`` (SURVEY.md §2b C1). Device realization:
the graph is *data, not pointers* — fixed-shape int32 arrays preallocated to
``capacity`` so one XLA executable serves the index for its whole life:

  * ``neighbors0``      int32[capacity, m0]        level-0 adjacency, -1 padded
  * ``levels``          int32[capacity]            level of node i, -1 unused
  * ``upper_slot``      int32[capacity]            node -> row in upper tables
  * ``upper_node``      int32[upper_capacity]      row -> node (inverse map)
  * ``upper_neighbors`` int32[upper_cap, L, m]     adjacency at level l (row l-1)

Only ~capacity/m nodes have level >= 1 (P(level>=l) = m^-l), so the upper
adjacency is stored compacted through the slot indirection instead of wasting
capacity * L * m ints.

Scalars (entry_point, max_level, ntotal, n_upper) ride along as 0-d arrays so
the whole graph is a single pytree usable inside jit.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import NO_NEIGHBOR, HnswConfig


class GraphArrays(NamedTuple):
    """Device-resident HNSW graph (a jit-friendly pytree)."""

    neighbors0: jax.Array       # int32 [capacity, m0]
    levels: jax.Array           # int32 [capacity]
    upper_slot: jax.Array       # int32 [capacity]
    upper_node: jax.Array       # int32 [upper_capacity]
    upper_neighbors: jax.Array  # int32 [upper_capacity, max_level_cap, m]
    entry_point: jax.Array      # int32 []
    max_level: jax.Array        # int32 []  (-1 == empty graph)
    ntotal: jax.Array           # int32 []
    n_upper: jax.Array          # int32 []  (next free upper slot)


def empty_graph(cfg: HnswConfig) -> GraphArrays:
    c, u, L = cfg.capacity, cfg.upper_capacity, cfg.max_level_cap
    i32 = jnp.int32
    return GraphArrays(
        neighbors0=jnp.full((c, cfg.m0), NO_NEIGHBOR, i32),
        levels=jnp.full((c,), NO_NEIGHBOR, i32),
        upper_slot=jnp.full((c,), NO_NEIGHBOR, i32),
        upper_node=jnp.full((u,), NO_NEIGHBOR, i32),
        upper_neighbors=jnp.full((u, L, cfg.m), NO_NEIGHBOR, i32),
        entry_point=jnp.asarray(NO_NEIGHBOR, i32),
        max_level=jnp.asarray(NO_NEIGHBOR, i32),
        ntotal=jnp.asarray(0, i32),
        n_upper=jnp.asarray(0, i32),
    )


# ---------------------------------------------------------------------------
# Serialization (capability parity: faiss write_index/read_index, C12).
# One .npz holds the graph arrays + vectors + the config as JSON; loading an
# index and searching must be bit-identical to the pre-save index (tested).
# ---------------------------------------------------------------------------

def save_graph(path: str, graph: GraphArrays, vectors: jax.Array,
               cfg: HnswConfig, extra: dict | None = None,
               extra_arrays: dict | None = None) -> None:
    """``extra`` (JSON-serializable) carries auxiliary state — e.g. the
    builder RNG for exact mid-build checkpoint/resume (SURVEY.md §5);
    ``extra_arrays`` carries auxiliary numpy arrays (e.g. tombstones)."""
    arrs = {f"graph_{k}": np.asarray(v) for k, v in graph._asdict().items()}
    for k, v in (extra_arrays or {}).items():
        arrs[f"xarr_{k}"] = np.asarray(v)
    np.savez_compressed(path, vectors=np.asarray(vectors),
                        config_json=np.bytes_(cfg.to_json()),
                        extra_json=np.bytes_(json.dumps(extra or {})),
                        **arrs)


def load_graph(path: str, as_numpy: bool = False):
    """Returns (graph, vectors, config, extra, extra_arrays).

    ``as_numpy=True`` keeps graph/vector arrays host-side, so the caller
    transfers each to the device once."""
    conv = np.asarray if as_numpy else jnp.asarray
    with np.load(path, allow_pickle=False) as z:
        cfg = HnswConfig.from_json(bytes(z["config_json"].item()).decode())
        graph = GraphArrays(**{
            k: conv(z[f"graph_{k}"]) for k in GraphArrays._fields
        })
        vectors = conv(z["vectors"])
        extra = {}
        if "extra_json" in z:
            extra = json.loads(bytes(z["extra_json"].item()).decode())
        extra_arrays = {k[5:]: z[k] for k in z.files if k.startswith("xarr_")}
    return graph, vectors, cfg, extra, extra_arrays


# ---------------------------------------------------------------------------
# Invariant checker — the race-detection analogue for the lock-free batched
# build (SURVEY.md §5): since batched inserts are race-free by construction,
# graph health is validated structurally after each build phase in debug mode.
# ---------------------------------------------------------------------------

def check_invariants(graph: GraphArrays, cfg: HnswConfig,
                     strict: bool = True, alive=None) -> dict:
    """Validate structural invariants; returns stats. Raises on violation when
    strict. Host-side (numpy) — debug/test path, not the hot path.

    ``alive`` (bool [capacity], optional): tombstone mask. Dead nodes are
    exempt from liveness invariants — post-vacuum they are isolated with
    cleared rows BY DESIGN — and ``links_to_dead`` (live rows still
    referencing dead ids; nonzero before vacuum, must be 0 after) is
    reported as a stat."""
    g = {k: np.asarray(v) for k, v in graph._asdict().items()}
    n = int(g["ntotal"])
    errors: list[str] = []
    stats: dict = {"ntotal": n, "max_level": int(g["max_level"])}
    live = (np.ones(n, bool) if alive is None
            else np.asarray(alive)[:n].astype(bool))

    nbr0 = g["neighbors0"][:n]
    valid0 = nbr0 >= 0
    if n:
        if (g["levels"][:n] < 0).any():
            errors.append("unassigned level among first ntotal nodes")
        if (nbr0 >= n).any():
            errors.append("level-0 neighbor id out of range (dangling)")
        self0 = valid0 & (nbr0 == np.arange(n)[:, None])
        if self0.any():
            errors.append("self-link at level 0")
        # duplicate neighbors within a list
        srt = np.sort(np.where(valid0, nbr0, np.iinfo(np.int32).max), axis=1)
        if ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != np.iinfo(np.int32).max)).any():
            errors.append("duplicate neighbor within a level-0 list")
        deg0 = valid0.sum(1)
        stats["deg0_mean"] = float(deg0.mean())
        stats["deg0_max"] = int(deg0.max())
        stats["isolated0"] = int(((deg0 == 0) & live).sum())
        if live.sum() > 1 and stats["isolated0"] > 0:
            errors.append(f"{stats['isolated0']} isolated nodes at level 0")
        if alive is not None:
            stats["links_to_dead"] = int(
                (valid0 & live[:, None]
                 & ~live[np.maximum(nbr0, 0)]).sum())
        # reciprocity rate (diagnostic, not an error: the heuristic legally
        # prunes one direction, same as faiss shrink_neighbor_list).
        # Vectorized: sorted int64 edge keys +
        # searchsorted membership — runs at 1M x 64 in seconds, so the check
        # is usable as a post-build canary at bench scale.
        src = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None],
                              nbr0.shape)[valid0]
        dstv = nbr0[valid0].astype(np.int64)
        keys = np.sort(src * n + dstv)
        # sort the reverse keys too: sorted-query searchsorted is ~10x
        # faster than random-order (cache locality), and the rate is
        # order-invariant
        rev = np.sort(dstv * n + src)
        pos = np.searchsorted(keys, rev)
        found = (pos < len(keys)) & \
            (keys[np.minimum(pos, max(len(keys) - 1, 0))] == rev)
        stats["reciprocity0"] = float(found.mean()) if len(keys) else 1.0

        ep = int(g["entry_point"])
        if not (0 <= ep < n):
            if live.any():  # all-deleted graphs legally have ep == -1
                errors.append(f"entry point {ep} out of range")
        elif g["levels"][ep] != g["max_level"]:
            errors.append("entry point level != max_level")

        # upper-level tables
        nu = int(g["n_upper"])
        up_nodes = g["upper_node"][:nu]
        if (up_nodes < 0).any() or (up_nodes >= n).any():
            errors.append("upper_node table has invalid node id")
        else:
            if not (g["upper_slot"][up_nodes] == np.arange(nu)).all():
                errors.append("upper_slot/upper_node maps are not inverse")
            has_upper = g["levels"][:n] >= 1
            if int(has_upper.sum()) != nu:
                errors.append("n_upper != #nodes with level>=1")
        # upper-level adjacency, vectorized per level (<= max_level_cap
        # iterations regardless of graph size)
        if nu and not (up_nodes < 0).any() and not (up_nodes >= n).any():
            node_lv = g["levels"][np.clip(up_nodes, 0, n - 1)]
            for l in range(1, cfg.max_level_cap + 1):
                act = node_lv >= l                      # [nu] rows live at l
                if not act.any():
                    continue
                rows = g["upper_neighbors"][:nu, l - 1][act]   # [A, m]
                own = up_nodes[act][:, None]
                v = rows >= 0
                if (rows[v] >= n).any():
                    bad = up_nodes[act][np.any(v & (rows >= n), axis=1)]
                    errors.append(
                        f"dangling upper neighbor at lvl {l} "
                        f"(e.g. node {int(bad[0])})")
                    continue
                if (g["levels"][rows[v]] < l).any():
                    bad = up_nodes[act][np.any(
                        v & (g["levels"][np.maximum(rows, 0)] < l), axis=1)]
                    errors.append(
                        f"upper neighbor below its level at lvl {l} "
                        f"(e.g. node {int(bad[0])})")
                    continue
                if (v & (rows == own)).any():
                    bad = up_nodes[act][np.any(v & (rows == own), axis=1)]
                    errors.append(
                        f"self-link at lvl {l} (e.g. node {int(bad[0])})")

    stats["errors"] = errors
    if strict and errors:
        raise AssertionError("graph invariant violations: " + "; ".join(errors))
    return stats
