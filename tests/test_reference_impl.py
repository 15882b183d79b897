import numpy as np

from hnsw_jax import HnswConfig, NumpyHnsw, check_invariants
from hnsw_jax.utils.recall import recall_at_k

from conftest import exact_knn


def test_level_distribution():
    cfg = HnswConfig(dim=4, m=16, capacity=50_000, seed=0)
    idx = NumpyHnsw(cfg)
    levels = np.array([idx.draw_level() for _ in range(50_000)])
    # P(level >= 1) = 1/m
    frac = (levels >= 1).mean()
    assert abs(frac - 1 / 16) < 0.01
    frac2 = (levels >= 2).mean()
    assert abs(frac2 - 1 / 256) < 0.005


def test_select_neighbors_heuristic_diversity():
    """The kept set must satisfy: each kept c is closer to q than to any
    earlier-kept neighbor (faiss shrink_neighbor_list rule)."""
    cfg = HnswConfig(dim=2, m=4, capacity=64, seed=1)
    idx = NumpyHnsw(cfg)
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(20, 2)).astype(np.float32)
    idx.vectors[:20] = pts
    q = np.zeros(2, np.float32)
    d = ((pts - q) ** 2).sum(1)
    cand = sorted(zip(d.tolist(), range(20)))
    kept = idx.select_neighbors(q, cand, m=4)
    assert len(kept) <= 4
    for pos, c in enumerate(kept):
        d_cq = ((pts[c] - q) ** 2).sum()
        for k2 in kept[:pos]:
            d_ck = ((pts[c] - pts[k2]) ** 2).sum()
            assert d_ck >= d_cq  # otherwise it should have been pruned


def test_recall_vs_brute_force(host_index, small_workload):
    wl = small_workload
    d, i = host_index.search(wl.queries, k=10, ef_search=64)
    _, ti = exact_knn(wl.base, wl.queries, 10, "l2")
    r = recall_at_k(i, ti, 10)
    assert r >= 0.95, f"reference recall@10 {r}"


def test_invariants(host_index):
    stats = check_invariants(host_index.to_graph_arrays(), host_index.cfg)
    assert stats["errors"] == []
    assert stats["deg0_max"] <= host_index.cfg.m0


def test_self_query(host_index, small_workload):
    """Query == database point must return that point at distance ~0."""
    base = small_workload.base
    d, i = host_index.search(base[:20], k=1, ef_search=32)
    assert (i[:, 0] == np.arange(20)).mean() > 0.9
    assert (d[i[:, 0] == np.arange(20), 0] < 1e-4).all()


def test_ip_metric(host_ip_index, small_ip_workload):
    wl = small_ip_workload
    _, i = host_ip_index.search(wl.queries, k=10, ef_search=64)
    _, ti = exact_knn(wl.base, wl.queries, 10, "ip")
    assert recall_at_k(i, ti, 10) >= 0.9


def test_determinism(small_workload):
    cfg = HnswConfig(dim=32, m=8, capacity=512, ef_construction=40, seed=9)
    a = NumpyHnsw(cfg)
    b = NumpyHnsw(cfg)
    a.add(small_workload.base[:300])
    b.add(small_workload.base[:300])
    assert (a.neighbors0 == b.neighbors0).all()
    assert (a.levels == b.levels).all()
