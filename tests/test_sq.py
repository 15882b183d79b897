"""sq8 scalar-quantized vector storage — faiss ``IndexHNSWSQ`` /
``ScalarQuantizer.QT_8bit`` capability parity (SURVEY.md §1b storage-codec
layer; upstream ``faiss/IndexHNSW.h`` IndexHNSWSQ, not in snapshot).

Semantics under test: vectors live as uint8 codes + per-dim affine
(offset, scale); train() is required before add(); every distance (build
and query) is computed against the dequantized x̂; reconstruct returns x̂.
"""

import numpy as np
import pytest

import hnsw_jax
from hnsw_jax import index_factory
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k

from conftest import exact_knn


def _sq_index(n=3000, d=24, m=8, metric="l2", seed=13, **kw):
    wl = synthetic_workload(n, d, n_queries=128, metric=metric, seed=seed)
    idx = hnsw_jax.HnswIndex(d, m, metric, capacity=n + 1024, dtype="sq8",
                             ef_construction=80, **kw)
    idx.train(wl.base)
    idx.add(wl.base)
    return idx, wl


def test_train_required_and_storage_dtype():
    idx = hnsw_jax.HnswIndex(8, 4, "l2", capacity=64, dtype="sq8")
    assert not idx.is_trained
    assert idx._vectors.dtype == np.uint8
    with pytest.raises(RuntimeError, match="train"):
        idx.add(np.zeros((4, 8), np.float32))
    idx.train(np.random.default_rng(0).normal(size=(32, 8)).astype(np.float32))
    assert idx.is_trained
    # retraining after adds is rejected (codes would decode wrongly)
    idx.add(np.zeros((2, 8), np.float32))
    with pytest.raises(RuntimeError, match="train"):
        idx.train(np.zeros((4, 8), np.float32))


def test_reconstruct_is_dequantized_with_bounded_error():
    idx, wl = _sq_index(n=500)
    got = idx.reconstruct_n(0, 500)
    scale = idx._sq_np[1]
    err = np.abs(got - np.asarray(wl.base[:500], np.float32))
    assert (err <= scale[None, :] * 0.5 + 1e-5).all()
    np.testing.assert_allclose(idx.reconstruct(7), got[7])


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_sq_recall_vs_true_groundtruth(metric):
    """The sq engine's recall ceiling is set by the CODES, not the search:
    it must match exact (brute-force) search over the dequantized x̂ —
    faiss IndexHNSWSQ has the same contract, its DistanceComputer also
    only ever sees decoded values. Recall vs the TRUE f32 ground truth is
    then whatever 8-bit codes allow on the dataset (tight on this d=24
    synthetic: IP margins between rank-10 neighbors sit inside the
    quantization noise, so even the x̂ ORACLE loses a few % — verified
    identical to the index's loss in round-3 analysis)."""
    idx, wl = _sq_index(n=3000, metric=metric)
    _, gt = exact_knn(wl.base, wl.queries, 10, metric)
    xhat = idx.reconstruct_n(0, 3000)
    _, gt_hat = exact_knn(xhat, wl.queries, 10, metric)
    _, i_sq = idx.search(wl.queries, 10, ef_search=64)
    r_vs_hat = recall_at_k(i_sq, gt_hat, 10)
    r_vs_true = recall_at_k(i_sq, gt, 10)
    r_ceiling = recall_at_k(gt_hat, gt, 10)
    assert r_vs_hat >= 0.97, r_vs_hat          # search quality on x̂
    assert r_vs_true >= r_ceiling - 0.03, (r_vs_true, r_ceiling)
    assert r_vs_true >= 0.9, r_vs_true


def test_sq_self_query_and_distances_are_xhat_exact():
    idx, wl = _sq_index(n=1200)
    q = np.asarray(wl.base[:32], np.float32)
    d, i = idx.search(q, 1, ef_search=64)
    assert (i[:, 0] == np.arange(32)).all()
    # returned distance == ||q - x̂||^2 exactly (the engine's exactness
    # contract shifts from x to x̂ under SQ storage)
    xhat = idx.reconstruct_n(0, 32)
    want = ((q - xhat) ** 2).sum(1)
    np.testing.assert_allclose(d[:, 0], want, rtol=1e-4, atol=1e-4)


def test_sq_save_load_roundtrip(tmp_path):
    idx, wl = _sq_index(n=800)
    d1, i1 = idx.search(wl.queries[:32], 5, ef_search=64)
    p = str(tmp_path / "sq.npz")
    idx.save(p)
    idx2 = hnsw_jax.HnswIndex.load(p)
    assert idx2.config.is_sq and idx2.is_trained
    assert idx2._vectors.dtype == np.uint8
    d2, i2 = idx2.search(wl.queries[:32], 5, ef_search=64)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)
    # resumed adds keep working and stay searchable
    idx2.add(np.asarray(wl.base[:8], np.float32))
    assert idx2.ntotal == idx.ntotal + 8


def test_sq_composes_with_packed_serving():
    """bits=8 packed tables on sq8 storage reuse the STORED codes and
    params outright (zero requantization) — routing and storage share one
    quantization, and recall matches the unpacked sq path."""
    idx, wl = _sq_index(n=2000)
    nbytes = idx.enable_packed(bits=8, reserve=256)
    assert nbytes > 0
    pk = idx._packed
    np.testing.assert_array_equal(np.asarray(pk.offset), idx._sq_np[0])
    np.testing.assert_array_equal(np.asarray(pk.scale), idx._sq_np[1])
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    _, ip_ = idx.search(wl.queries, 10, ef_search=64, use_packed=True)
    _, iu = idx.search(wl.queries, 10, ef_search=64, use_packed=False)
    r_p = recall_at_k(ip_, gt, 10)
    r_u = recall_at_k(iu, gt, 10)
    assert r_p >= r_u - 0.02, (r_p, r_u)
    # incremental maintenance across add() (shares the same params)
    idx.add(np.asarray(wl.base[:16], np.float32))
    assert idx.packed_enabled
    _, ii = idx.search(np.asarray(wl.base[:8]), 1, ef_search=64,
                       use_packed=True)
    ok = (ii[:, 0] == np.arange(8)) | (ii[:, 0] == 2000 + np.arange(8))
    assert ok.all(), ii[:, 0]


def test_sq_factory_and_filters():
    wl = synthetic_workload(1000, 16, n_queries=32, metric="l2", seed=3)
    idx = index_factory(16, "HNSW8,SQ8", capacity=1200, ef_construction=60)
    assert idx.config.is_sq and not idx.is_trained
    idx.train(wl.base)
    idx.add(wl.base)
    # filters + deletion compose with sq storage
    idx.remove_ids(np.asarray([5]))
    allowed = np.zeros(1200, bool)
    allowed[:200] = True
    allowed[5] = True
    _, i = idx.search(wl.queries, 5, ef_search=128, allowed=allowed)
    v = i[i >= 0]
    assert (v < 200).all() and not (v == 5).any()


def test_sq_memory_is_quarter_of_flat():
    cfg = hnsw_jax.HnswConfig(dim=32, m=8, capacity=1024, dtype="sq8")
    assert cfg.storage_dtype == "uint8"
    idx = hnsw_jax.HnswIndex(config=cfg)
    assert idx._vectors.dtype == np.uint8
    assert idx._vectors.size * idx._vectors.dtype.itemsize == 1024 * 32


def test_sq_rejects_host_build():
    with pytest.raises(ValueError, match="device"):
        hnsw_jax.HnswIndex(8, 4, capacity=64, dtype="sq8", build="host")


def test_sq_reconstruct_batch_and_search_and_reconstruct():
    idx, wl = _sq_index()
    ids = np.array([0, 2999, 17, 17, -1], np.int64)
    r = idx.reconstruct_batch(ids)
    # decode matches reconstruct_n's dequantization exactly
    np.testing.assert_array_equal(r[0], idx.reconstruct(0))
    np.testing.assert_array_equal(r[1], idx.reconstruct(2999))
    np.testing.assert_array_equal(r[2], r[3])
    assert (r[4] == 0).all()
    # bounded sq8 error vs the true vectors
    assert np.abs(r[:4] - wl.base[ids[:4]]).max() < 0.05 * np.ptp(wl.base)

    d, i, rv = idx.search_and_reconstruct(wl.queries[:16], 5, ef_search=64)
    valid = i >= 0
    np.testing.assert_array_equal(rv[valid], idx.reconstruct_batch(
        i[valid]))
