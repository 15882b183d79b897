"""IdMapIndex — faiss IndexIDMap capability parity (user-chosen int64 ids
over any wrapped index; upstream faiss/IndexIDMap.h, not in snapshot)."""

import numpy as np
import pytest

import hnsw_jax
from hnsw_jax import IdMapIndex, index_factory
from hnsw_jax.utils.datasets import synthetic_workload


@pytest.fixture(scope="module")
def built():
    wl = synthetic_workload(1500, 16, n_queries=32, metric="l2", seed=87)
    inner = hnsw_jax.HnswIndex(16, 8, "l2", capacity=2048,
                               ef_construction=60)
    idx = IdMapIndex(inner)
    ids = 10_000_000_000 + np.arange(1500, dtype=np.int64) * 7
    idx.add_with_ids(np.asarray(wl.base), ids)
    return idx, wl, ids


def test_search_returns_user_ids(built):
    idx, wl, ids = built
    assert idx.ntotal == 1500
    d, i = idx.search(np.asarray(wl.base[:16], np.float32), 1, ef_search=64)
    np.testing.assert_array_equal(i[:, 0], ids[:16])
    np.testing.assert_allclose(d[:, 0], 0, atol=1e-4)


def test_add_requires_ids(built):
    idx, wl, _ = built
    with pytest.raises(RuntimeError, match="add_with_ids"):
        idx.add(np.asarray(wl.base[:4]))
    with pytest.raises(ValueError, match="ids"):
        idx.add_with_ids(np.asarray(wl.base[:4]), np.arange(3))


def test_remove_and_reconstruct_by_user_id(built):
    idx, wl, ids = built
    x5 = idx.reconstruct(int(ids[5]))
    np.testing.assert_allclose(x5, np.asarray(wl.base[5], np.float32),
                               atol=1e-6)
    with pytest.raises(KeyError):
        idx.reconstruct(123)

    n = idx.remove_ids(np.asarray([ids[5]]))
    assert n == 1
    _, i = idx.search(np.asarray(wl.base[5:6], np.float32), 5, ef_search=64)
    assert ids[5] not in i


def test_factory_and_save_load(tmp_path):
    wl = synthetic_workload(600, 12, n_queries=8, metric="l2", seed=88)
    idx = index_factory(12, "IDMap,HNSW8", capacity=1024,
                        ef_construction=60)
    assert isinstance(idx, IdMapIndex)
    ids = np.arange(600, dtype=np.int64) * 3 + 1
    idx.add_with_ids(np.asarray(wl.base), ids)
    p = str(tmp_path / "idmap.npz")
    idx.save(p)
    idx2 = IdMapIndex.load(p)
    d1, i1 = idx.search(np.asarray(wl.queries), 5, ef_search=64)
    d2, i2 = idx2.search(np.asarray(wl.queries), 5, ef_search=64)
    np.testing.assert_array_equal(i1, i2)
    with pytest.raises(ValueError, match="IDMap"):
        index_factory(12, "IDMap")
