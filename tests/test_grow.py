"""HnswIndex.grow(): in-place capacity growth (the managed escape hatch for
SURVEY.md §7 hard-part 5's preallocation limit)."""

import numpy as np
import pytest

from hnsw_jax import HnswIndex
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k


def test_grow_preserves_search_bit_identical():
    wl = synthetic_workload(1000, 16, n_queries=32, metric="l2", seed=31)
    idx = HnswIndex(16, 8, "l2", capacity=1024, ef_construction=60)
    idx.add(np.asarray(wl.base))
    d1, i1 = idx.search(np.asarray(wl.queries), 10, ef_search=64)
    idx.grow(4096)
    assert idx.config.capacity == 4096
    d2, i2 = idx.search(np.asarray(wl.queries), 10, ef_search=64)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


def test_grow_then_add_matches_oneshot_build():
    """Level RNG and batch schedule carry across grow(): the grown build
    equals the build that had the capacity from the start."""
    wl = synthetic_workload(3000, 16, n_queries=64, metric="l2", seed=32)
    base = np.asarray(wl.base)

    grown = HnswIndex(16, 8, "l2", capacity=1200, ef_construction=60)
    grown.add(base[:1000])
    with pytest.raises(ValueError):
        grown.add(base[1000:])          # over capacity
    grown.grow(4096)
    grown.add(base[1000:])
    assert grown.ntotal == 3000

    oneshot = HnswIndex(16, 8, "l2", capacity=4096, ef_construction=60)
    oneshot.add(base[:1000])            # same add() call boundaries
    oneshot.add(base[1000:])

    ga, gb = grown.graph, oneshot.graph
    np.testing.assert_array_equal(np.asarray(ga.neighbors0)[:3000],
                                  np.asarray(gb.neighbors0)[:3000])
    np.testing.assert_array_equal(np.asarray(ga.levels)[:3000],
                                  np.asarray(gb.levels)[:3000])
    assert int(ga.entry_point) == int(gb.entry_point)

    _, i = grown.search(np.asarray(wl.queries), 10, ef_search=96)
    gt = np.argsort(((np.asarray(wl.queries)[:, None] - base[None]) ** 2)
                    .sum(-1), 1)[:, :10]
    assert recall_at_k(np.asarray(i), gt, 10) >= 0.9


def test_grow_validation_and_tombstones():
    wl = synthetic_workload(600, 16, n_queries=16, metric="l2", seed=33)
    idx = HnswIndex(16, 8, "l2", capacity=1024, ef_construction=40)
    idx.add(np.asarray(wl.base))
    with pytest.raises(ValueError):
        idx.grow(1024)                   # must strictly grow
    idx.remove_ids(np.arange(0, 600, 3))
    n_del = idx.n_deleted
    idx.grow(2048)
    assert idx.n_deleted == n_del        # tombstones survive the pad
    _, i = idx.search(np.asarray(wl.queries), 5, ef_search=48)
    i = np.asarray(i)
    assert (i[i >= 0] % 3 != 0).all()


def test_grow_host_build_mode():
    wl = synthetic_workload(400, 16, n_queries=16, metric="l2", seed=34)
    base = np.asarray(wl.base)
    idx = HnswIndex(16, 8, "l2", capacity=512, ef_construction=40,
                    build="host")
    idx.add(base[:300])
    idx.grow(1024)
    idx.add(base[300:])
    assert idx.ntotal == 400
    _, i = idx.search(np.asarray(wl.queries), 5, ef_search=48)
    gt = np.argsort(((np.asarray(wl.queries)[:, None] - base[None]) ** 2)
                    .sum(-1), 1)[:, :5]
    assert recall_at_k(np.asarray(i), gt, 5) >= 0.9


def test_grow_save_load(tmp_path):
    wl = synthetic_workload(500, 16, n_queries=8, metric="l2", seed=35)
    idx = HnswIndex(16, 8, "l2", capacity=512, ef_construction=40)
    idx.add(np.asarray(wl.base))
    idx.grow(2048)
    p = str(tmp_path / "g.npz")
    idx.save(p)
    idx2 = HnswIndex.load(p)
    assert idx2.config.capacity == 2048
    d1, i1 = idx.search(np.asarray(wl.queries), 5, ef_search=48)
    d2, i2 = idx2.search(np.asarray(wl.queries), 5, ef_search=48)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
