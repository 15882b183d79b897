"""The lax.scan'd steady-state build phase must produce the SAME graph as
dispatching the identical batch schedule one step at a time (build.py
_get_scan vs _get_step — the math is one deterministic sequence either way).
"""

import numpy as np
import jax.numpy as jnp

from hnsw_jax import HnswConfig
from hnsw_jax.build import DeviceBuilder
from hnsw_jax.graph import empty_graph


def _build(n_points, scan_chunk):
    cfg = HnswConfig(dim=16, m=8, capacity=8192, ef_construction=40, seed=9)
    b = DeviceBuilder(cfg, max_batch=128)
    b.SCAN_CHUNK = scan_chunk
    g = empty_graph(cfg)
    vec = jnp.zeros((cfg.capacity, 16), jnp.float32)
    sq = jnp.zeros((cfg.capacity,), jnp.float32)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n_points, 16)).astype(np.float32)
    g, vec, sq = b.add(g, vec, sq, x)
    return g, vec


def test_scan_path_matches_stepwise():
    n = 1200  # > 4 full 128-batches beyond the growth phase
    g1, v1 = _build(n, scan_chunk=4)       # scan path engaged
    g2, v2 = _build(n, scan_chunk=10**9)   # never engages: stepwise
    assert int(g1.ntotal) == int(g2.ntotal) == n
    for f in g1._fields:
        a1, a2 = np.asarray(getattr(g1, f)), np.asarray(getattr(g2, f))
        assert np.array_equal(a1, a2), f"graph field {f} diverged"
    assert np.array_equal(np.asarray(v1), np.asarray(v2))


def test_incremental_adds_match_single_add():
    """Splitting one add() into several must not change counters/invariants
    (the staged planner runs per call)."""
    from hnsw_jax import HnswIndex
    rng = np.random.default_rng(4)
    x = rng.normal(size=(900, 16)).astype(np.float32)
    a = HnswIndex(16, 8, capacity=2048, ef_construction=40, seed=2)
    a.add(x)
    b = HnswIndex(16, 8, capacity=2048, ef_construction=40, seed=2)
    b.add(x[:500])
    b.add(x[500:])
    assert a.ntotal == b.ntotal == 900
    a.check(strict=True)
    b.check(strict=True)
    q = rng.normal(size=(32, 16)).astype(np.float32)
    da, ia = a.search(q, k=5, ef_search=48)
    db, ib = b.search(q, k=5, ef_search=48)
    # graphs may differ (batch boundaries differ) but recall must be close:
    # both must find the true NN most of the time
    from conftest import exact_knn
    _, gt = exact_knn(x, q, 5, "l2")
    from hnsw_jax.utils.recall import recall_at_k
    assert recall_at_k(ia, gt, 5) > 0.9
    assert recall_at_k(ib, gt, 5) > 0.9
