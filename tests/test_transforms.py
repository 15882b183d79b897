"""VectorTransform family + PreTransformIndex (faiss VectorTransform /
IndexPreTransform parity; SURVEY.md §1b index-wrappers layer)."""

import numpy as np
import pytest

from hnsw_jax import index_factory
from hnsw_jax.models.pretransform import PreTransformIndex
from hnsw_jax.ops.transforms import (NormalizationTransform, OPQMatrix,
                                     PCAMatrix, RandomRotation)
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k


def _aniso(n, d, seed=0):
    """Correlated, anisotropic data — the regime PCA/OPQ exist for."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d, d)) * np.linspace(2.0, 0.05, d)[None, :]
    return (rng.standard_normal((n, d)) @ w.T).astype(np.float32)


def test_random_rotation_orthonormal():
    t = RandomRotation(32, seed=7)
    np.testing.assert_allclose(t.a @ t.a.T, np.eye(32), atol=1e-5)
    x = np.random.default_rng(0).standard_normal((64, 32)).astype(np.float32)
    y = t.apply(x)
    # rotation preserves norms and pairwise distances
    np.testing.assert_allclose(np.linalg.norm(y, axis=1),
                               np.linalg.norm(x, axis=1), rtol=1e-4)
    np.testing.assert_allclose(t.reverse_transform(y), x, atol=1e-4)
    # deterministic across constructions
    np.testing.assert_array_equal(t.a, RandomRotation(32, seed=7).a)


def test_random_rotation_projection():
    t = RandomRotation(32, 16, seed=3)
    np.testing.assert_allclose(t.a @ t.a.T, np.eye(16), atol=1e-5)
    assert t.apply(np.zeros((4, 32), np.float32)).shape == (4, 16)


def test_l2norm():
    t = NormalizationTransform(8)
    x = np.random.default_rng(1).standard_normal((100, 8)).astype(np.float32)
    y = t.apply(x)
    np.testing.assert_allclose(np.linalg.norm(y, axis=1), 1.0, rtol=1e-5)
    t.apply(np.zeros((3, 8), np.float32))  # zero rows don't NaN


def test_pca_matches_numpy():
    x = _aniso(4096, 24, seed=2)
    t = PCAMatrix(24, 8)
    t.train(x)
    y = t.apply(x)
    # projected data is centered and decorrelated, variances = eigenvalues
    np.testing.assert_allclose(y.mean(0), 0.0, atol=1e-2)
    cov = np.cov(y.T)
    np.testing.assert_allclose(cov, np.diag(np.diag(cov)),
                               atol=np.diag(cov).max() * 1e-3)
    ref_ev = np.linalg.eigvalsh(np.cov(x.T))[::-1][:8]
    np.testing.assert_allclose(np.sort(np.diag(cov))[::-1], ref_ev,
                               rtol=5e-3)
    # PCA-8 keeps more variance than a random 8-dim projection
    rr = RandomRotation(24, 8, seed=0)
    assert (y ** 2).sum() > (rr.apply(x - x.mean(0)) ** 2).sum()


def test_pca_whitening():
    x = _aniso(4096, 16, seed=4)
    t = PCAMatrix(16, 8, eigen_power=-0.5)
    t.train(x)
    y = t.apply(x)
    np.testing.assert_allclose(np.var(y, axis=0), 1.0, rtol=5e-2)


def test_pca_random_rotation_flag():
    x = _aniso(2048, 16, seed=5)
    t = PCAMatrix(16, 16, random_rotation=True)
    t.train(x)
    # still orthonormal (rotation of an orthonormal basis)
    np.testing.assert_allclose(t.a @ t.a.T, np.eye(16), atol=1e-4)


def test_opq_beats_plain_pq():
    from hnsw_jax.ops.pq import decode_pq, encode_pq, train_pq
    import jax.numpy as jnp

    x = _aniso(8192, 32, seed=6)
    m = 4

    def pq_err(xt):
        cb = jnp.asarray(train_pq(xt, m, ksub=64, iters=10, seed=0))
        xh = np.asarray(decode_pq(encode_pq(jnp.asarray(xt), cb), cb))
        return float(((xt - xh) ** 2).sum())

    t = OPQMatrix(32, m, ksub=64, niter=8, seed=0)
    t.train(x)
    np.testing.assert_allclose(t.a @ t.a.T, np.eye(32), atol=1e-4)
    err_plain, err_opq = pq_err(x), pq_err(t.apply(x))
    assert err_opq < 0.9 * err_plain, (err_opq, err_plain)


def test_factory_transform_specs():
    idx = index_factory(32, "PCA16,HNSW8,Flat")
    assert isinstance(idx, PreTransformIndex)
    assert idx.d == 32 and idx.index.d == 16
    assert not idx.is_trained
    with pytest.raises(ValueError):
        index_factory(32, "PCA16")           # transform with no index
    with pytest.raises(ValueError):
        index_factory(32, "OPQ5,HNSW8,Flat")  # 5 doesn't divide 32
    chain = index_factory(32, "PCA16,RR8,HNSW8,Flat")
    assert [t.d_out for t in chain.transforms] == [16, 8]
    opq = index_factory(32, "OPQ4_16,HNSW8,PQ4")
    assert opq.index.config.is_pq and opq.index.d == 16


def test_pretransform_end_to_end():
    wl = synthetic_workload(3000, 32, n_queries=64, metric="l2", seed=9)
    base, queries = np.asarray(wl.base), np.asarray(wl.queries)
    idx = index_factory(32, "PCA16,HNSW16,Flat", capacity=4096,
                        ef_construction=60)
    idx.train(base)
    assert idx.is_trained
    idx.add(base)
    assert idx.ntotal == 3000
    _, i = idx.search(queries, 10, ef_search=64)
    # GT in the transformed space (that's the metric the index serves —
    # same contract as faiss IndexPreTransform)
    t = idx.transforms[0]
    tb, tq = t.apply(base), t.apply(queries)
    gt = np.argsort(((tq[:, None] - tb[None]) ** 2).sum(-1), 1)[:, :10]
    assert recall_at_k(np.asarray(i), gt, 10) >= 0.9
    # reconstruct returns to INPUT space, near the original
    r = idx.reconstruct(5)
    assert r.shape == (32,)


def test_l2norm_cosine_search():
    """L2norm,HNSW,ip == cosine similarity search (the faiss recipe)."""
    rng = np.random.default_rng(11)
    base = rng.standard_normal((2000, 16)).astype(np.float32) * \
        rng.uniform(0.1, 10.0, (2000, 1)).astype(np.float32)
    queries = rng.standard_normal((32, 16)).astype(np.float32)
    idx = index_factory(16, "L2norm,HNSW16,Flat", metric="ip",
                        capacity=2048, ef_construction=60)
    idx.train(base)
    idx.add(base)
    _, i = idx.search(queries, 10, ef_search=96)
    cos = (queries / np.linalg.norm(queries, axis=1, keepdims=True)) @ \
        (base / np.linalg.norm(base, axis=1, keepdims=True)).T
    gt = np.argsort(-cos, axis=1)[:, :10]
    assert recall_at_k(np.asarray(i), gt, 10) >= 0.9


def test_pretransform_save_load(tmp_path):
    wl = synthetic_workload(1500, 24, n_queries=16, metric="l2", seed=13)
    base = np.asarray(wl.base)
    idx = index_factory(24, "OPQ4_8,HNSW8,PQ4", capacity=2048,
                        ef_construction=40, seed=1)
    idx.train(base)
    idx.add(base)
    d1, i1 = idx.search(np.asarray(wl.queries), 5, ef_search=48)
    p = str(tmp_path / "pt.npz")
    idx.save(p)
    idx2 = PreTransformIndex.load(p)
    assert len(idx2.transforms) == 1
    np.testing.assert_array_equal(idx2.transforms[0].a, idx.transforms[0].a)
    d2, i2 = idx2.search(np.asarray(wl.queries), 5, ef_search=48)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-6)
