"""On-device batched construction (C7/C8): quality, invariants, determinism,
incrementality (SURVEY.md §4 items 1/2/6)."""

import numpy as np
import pytest

from hnsw_jax import HnswIndex, check_invariants
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k

from conftest import exact_knn


@pytest.fixture(scope="module")
def built():
    wl = synthetic_workload(2500, 24, n_queries=150, metric="l2", seed=21)
    idx = HnswIndex(24, 8, "l2", capacity=4096, build="device",
                    ef_construction=80, seed=13)
    idx.add(wl.base)
    return idx, wl


def test_invariants(built):
    idx, _ = built
    stats = idx.check()
    assert stats["errors"] == []
    assert stats["deg0_max"] <= idx.config.m0
    assert stats["isolated0"] == 0
    # back-link repair should give high (not necessarily perfect) reciprocity
    assert stats["reciprocity0"] > 0.6


def test_recall_vs_brute_force(built):
    idx, wl = built
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    _, i = idx.search(wl.queries, k=10, ef_search=64)
    r = recall_at_k(i, gt, 10)
    assert r >= 0.93, r


def test_recall_parity_with_serial_reference(built, host_index,
                                             small_workload):
    """Batched build must land in the same recall class as the serial
    textbook build at equal hyperparameters (different data sizes, so compare
    each against its own ground truth)."""
    idx, wl = built
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    _, i = idx.search(wl.queries, k=10, ef_search=48)
    r_dev = recall_at_k(i, gt, 10)

    _, gt_h = exact_knn(small_workload.base, small_workload.queries, 10, "l2")
    _, i_h = host_index.search(small_workload.queries, k=10, ef_search=48)
    r_host = recall_at_k(i_h, gt_h, 10)
    assert r_dev >= r_host - 0.05, (r_dev, r_host)


def test_determinism():
    wl = synthetic_workload(600, 16, n_queries=10, seed=3)
    graphs = []
    for _ in range(2):
        idx = HnswIndex(16, 8, capacity=1024, build="device",
                        ef_construction=40, seed=99)
        idx.add(wl.base)
        graphs.append(idx.graph)
    a, b = graphs
    assert (np.asarray(a.neighbors0) == np.asarray(b.neighbors0)).all()
    assert (np.asarray(a.upper_neighbors) == np.asarray(b.upper_neighbors)).all()
    assert int(a.entry_point) == int(b.entry_point)


def test_incremental_add():
    wl = synthetic_workload(1200, 16, n_queries=60, seed=5)
    idx = HnswIndex(16, 8, capacity=2048, build="device", ef_construction=60)
    idx.add(wl.base[:700])
    assert idx.ntotal == 700
    idx.add(wl.base[700:])
    assert idx.ntotal == 1200
    assert idx.check()["errors"] == []
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    _, i = idx.search(wl.queries, k=10, ef_search=64)
    assert recall_at_k(i, gt, 10) >= 0.92


def test_ip_metric_build():
    wl = synthetic_workload(1000, 16, n_queries=60, metric="ip", seed=8)
    idx = HnswIndex(16, 8, "ip", capacity=2048, build="device",
                    ef_construction=60)
    idx.add(wl.base)
    assert idx.check()["errors"] == []
    _, gt = exact_knn(wl.base, wl.queries, 10, "ip")
    _, i = idx.search(wl.queries, k=10, ef_search=64)
    assert recall_at_k(i, gt, 10) >= 0.92


def test_single_point_and_tiny():
    idx = HnswIndex(8, 4, capacity=64, build="device", ef_construction=20)
    x = np.random.default_rng(0).normal(size=(1, 8)).astype(np.float32)
    idx.add(x)
    assert idx.ntotal == 1
    d, i = idx.search(x, k=1)
    assert i[0, 0] == 0
    idx.add(np.random.default_rng(1).normal(size=(5, 8)).astype(np.float32))
    assert idx.ntotal == 6
    assert idx.check()["errors"] == []
    d, i = idx.search(x, k=6)
    assert set(i[0].tolist()) == set(range(6))
