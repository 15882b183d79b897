"""Bundled C++ single-core baseline engine (bench vs_baseline denominator)."""

import numpy as np
import pytest

from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k

from conftest import exact_knn

cpu_baseline = pytest.importorskip("hnsw_jax.native.cpu_baseline")


def test_cpu_engine_recall():
    wl = synthetic_workload(3000, 24, n_queries=150, seed=6)
    eng = cpu_baseline.CpuHnsw(24, 12)
    eng.add(wl.base, ef_construction=80)
    assert eng.ntotal == 3000
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    ids = eng.search(wl.queries, 10, ef_search=64)
    assert recall_at_k(ids, gt, 10) >= 0.95


def test_cpu_engine_ip():
    wl = synthetic_workload(2000, 16, n_queries=100, metric="ip", seed=7)
    eng = cpu_baseline.CpuHnsw(16, 12, metric="ip")
    eng.add(wl.base, ef_construction=80)
    _, gt = exact_knn(wl.base, wl.queries, 10, "ip")
    ids = eng.search(wl.queries, 10, ef_search=64)
    assert recall_at_k(ids, gt, 10) >= 0.93


def test_cpu_engine_self_and_dists():
    wl = synthetic_workload(500, 8, n_queries=1, seed=8)
    eng = cpu_baseline.CpuHnsw(8, 8)
    eng.add(wl.base, ef_construction=60)
    ids, d = eng.search(wl.base[:20], 1, ef_search=32, return_dists=True)
    assert (ids[:, 0] == np.arange(20)).all()
    assert (d[:, 0] < 1e-5).all()
