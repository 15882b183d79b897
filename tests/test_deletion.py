"""Tombstone deletions — beyond-faiss capability (faiss IndexHNSW cannot
remove; we tombstone without breaking the graph)."""

import numpy as np
import pytest

from hnsw_jax import HnswIndex
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k

from conftest import exact_knn


@pytest.fixture(scope="module")
def didx():
    wl = synthetic_workload(2000, 16, n_queries=100, seed=61)
    idx = HnswIndex(16, 8, capacity=2048, build="device", ef_construction=60,
                    seed=4)
    idx.add(wl.base)
    return idx, wl


def test_removed_ids_never_returned(didx):
    idx, wl = didx
    removed = np.arange(0, 2000, 4)
    n = idx.remove_ids(removed)
    assert n == len(removed)
    assert idx.n_deleted == len(removed)
    d, i = idx.search(wl.queries, k=10, ef_search=96)
    got = i[i >= 0]
    assert not np.isin(got, removed).any()
    # removing again is a no-op
    assert idx.remove_ids(removed[:10]) == 0


def test_recall_on_survivors(didx):
    idx, wl = didx
    alive = np.ones(2000, bool)
    alive[np.arange(0, 2000, 4)] = False
    sub = np.flatnonzero(alive)
    _, gt_sub = exact_knn(wl.base[sub], wl.queries, 10, "l2")
    gt = sub[gt_sub]
    d, i = idx.search(wl.queries, k=10, ef_search=128)
    assert recall_at_k(i, gt, 10) >= 0.85


def test_composes_with_user_filter(didx):
    idx, wl = didx
    user = np.zeros(2000, bool)
    user[:1000] = True
    d, i = idx.search(wl.queries[:20], k=5, ef_search=96, allowed=user)
    got = i[i >= 0]
    assert (got < 1000).all()
    assert (got % 4 != 0).all()  # tombstones still excluded


def test_deletion_survives_save_load(didx, tmp_path):
    idx, wl = didx
    p = str(tmp_path / "del.npz")
    idx.save(p)
    idx2 = HnswIndex.load(p)
    assert idx2.n_deleted == idx.n_deleted
    d, i = idx2.search(wl.queries[:20], k=5, ef_search=96)
    got = i[i >= 0]
    assert (got % 4 != 0).all()


def test_remove_out_of_range(didx):
    idx, _ = didx
    with pytest.raises(IndexError):
        idx.remove_ids([99999])
