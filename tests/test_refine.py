"""RefineFlatIndex (faiss IndexRefineFlat parity): exact-f32 rerank over a
quantized inner index recovers recall the codes lose."""

import numpy as np
import pytest

from hnsw_jax import FlatIndex, RefineFlatIndex, index_factory
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k


def _gt(base, queries, k, metric="l2"):
    f = FlatIndex(base.shape[1], metric)
    f.add(base)
    _, i = f.search(queries, k)
    return np.asarray(i)


def test_refine_recovers_sq8_recall():
    wl = synthetic_workload(3000, 32, n_queries=64, metric="l2", seed=21)
    base, queries = np.asarray(wl.base), np.asarray(wl.queries)
    gt = _gt(base, queries, 10)

    inner = index_factory(32, "HNSW16,SQ8", capacity=4096,
                          ef_construction=60)
    idx = RefineFlatIndex(inner, k_factor=4.0)
    idx.train(base)
    idx.add(base)
    assert idx.ntotal == 3000
    d, i = idx.search(queries, 10, ef_search=96)
    r_refined = recall_at_k(i, gt, 10)
    assert r_refined >= 0.95, r_refined
    # distances are TRUE f32 L2² (not code-space): cross-check a few
    row = i[0, 0]
    true = ((queries[0] - base[row]) ** 2).sum()
    np.testing.assert_allclose(d[0, 0], true, rtol=1e-4)
    # sorted ascending, no holes at this k
    assert (np.diff(d, axis=1) >= -1e-6).all()


def test_refine_factory_and_k_factor():
    wl = synthetic_workload(2000, 16, n_queries=32, metric="l2", seed=22)
    base, queries = np.asarray(wl.base), np.asarray(wl.queries)
    idx = index_factory(16, "HNSW16,SQ8,RFlat", capacity=2048,
                        ef_construction=60, k_factor=1.0)
    assert isinstance(idx, RefineFlatIndex)
    idx.train(base)
    idx.add(base)
    gt = _gt(base, queries, 10)
    _, i1 = idx.search(queries, 10, ef_search=96)
    r1 = recall_at_k(i1, gt, 10)
    idx.k_factor = 8.0          # mutable, faiss parity
    _, i8 = idx.search(queries, 10, ef_search=96)
    r8 = recall_at_k(i8, gt, 10)
    assert r8 >= r1
    with pytest.raises(ValueError):
        index_factory(16, "RFlat")


def test_refine_ip_metric():
    rng = np.random.default_rng(3)
    base = rng.standard_normal((2000, 16)).astype(np.float32)
    queries = rng.standard_normal((32, 16)).astype(np.float32)
    idx = index_factory(16, "HNSW16,SQ8,RFlat", metric="ip",
                        capacity=2048, ef_construction=60)
    idx.train(base)
    idx.add(base)
    d, i = idx.search(queries, 5, ef_search=64)
    gt = np.argsort(-(queries @ base.T), axis=1)[:, :5]
    assert recall_at_k(i, gt, 5) >= 0.9
    # IP scores descend and are true dots
    assert (np.diff(d, axis=1) <= 1e-6).all()
    np.testing.assert_allclose(d[0, 0], queries[0] @ base[i[0, 0]],
                               rtol=1e-4)


def test_refine_save_load(tmp_path):
    wl = synthetic_workload(1000, 16, n_queries=16, metric="l2", seed=24)
    base = np.asarray(wl.base)
    idx = index_factory(16, "HNSW8,SQ8,RFlat", capacity=1024,
                        ef_construction=40)
    idx.train(base)
    idx.add(base)
    d1, i1 = idx.search(np.asarray(wl.queries), 5, ef_search=48)
    p = str(tmp_path / "rf.npz")
    idx.save(p)
    idx2 = RefineFlatIndex.load(p)
    assert idx2.k_factor == idx.k_factor
    d2, i2 = idx2.search(np.asarray(wl.queries), 5, ef_search=48)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)


def test_refine_small_index_edge():
    """kk > ntotal clamps; holes (−1) stay holes with +inf/-inf dists."""
    base = np.random.default_rng(0).standard_normal((8, 16)) \
        .astype(np.float32)
    inner = index_factory(16, "HNSW8,Flat", capacity=64, ef_construction=20)
    idx = RefineFlatIndex(inner, k_factor=16.0)
    idx.add(base)
    d, i = idx.search(base[:2], 12, ef_search=32)
    assert (i[:, :8] >= 0).all()
    assert (i[:, 8:] == -1).all()
    assert np.isinf(d[:, 8:]).all()
    # self-queries hit themselves first at distance ~0
    assert i[0, 0] == 0 and d[0, 0] < 1e-5
