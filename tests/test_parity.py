"""Recall/ef frontier parity vs a faiss-class serial CPU HNSW (SURVEY.md §4
item 3): graph *structure* differs (batched inserts), parity is judged on
the recall-vs-efSearch frontier at equal hyperparameters."""

import numpy as np
import pytest

from hnsw_jax import HnswIndex
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k

from conftest import exact_knn

cpu_baseline = pytest.importorskip("hnsw_jax.native.cpu_baseline")


def test_recall_frontier_parity():
    wl = synthetic_workload(3000, 24, n_queries=200, seed=33)
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")

    dev = HnswIndex(24, 8, "l2", capacity=4096, build="device",
                    ef_construction=80, seed=1)
    dev.add(wl.base)

    cpu = cpu_baseline.CpuHnsw(24, 8, seed=1)
    cpu.add(wl.base, ef_construction=80)

    for ef in (16, 32, 64):
        _, i_dev = dev.search(wl.queries, k=10, ef_search=ef)
        i_cpu = cpu.search(wl.queries, 10, ef_search=ef)
        r_dev = recall_at_k(i_dev, gt, 10)
        r_cpu = recall_at_k(i_cpu, gt, 10)
        # batched build must land within tolerance of the serial build
        assert r_dev >= r_cpu - 0.03, (ef, r_dev, r_cpu)
