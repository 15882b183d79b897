"""Product-quantized vector storage — faiss ``IndexHNSWPQ`` /
``ProductQuantizer`` capability parity (SURVEY.md §1b storage-codec layer;
upstream ``faiss/impl/ProductQuantizer.cpp`` + ``IndexHNSW.h`` IndexHNSWPQ,
not in snapshot).

Semantics under test: vectors live as uint8 codes [n, pq_m] + per-subspace
k-means codebooks; train() is required before add(); every distance (build
and query) is the ADC value — exact against the reconstruction x̂;
reconstruct returns x̂.
"""

import numpy as np
import pytest

import hnsw_jax
from hnsw_jax import index_factory
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k

from conftest import exact_knn


def _pq_index(n=3000, d=24, m=8, pq_m=8, metric="l2", seed=13, **kw):
    # ONE capacity for every pq test: the jitted build/search programs are
    # shape-specialized on capacity, so a shared value lets all tests in
    # this module (and warm CI runs, via the persistent cache) reuse one
    # compile set instead of one per distinct n
    wl = synthetic_workload(n, d, n_queries=128, metric=metric, seed=seed)
    idx = hnsw_jax.HnswIndex(d, m, metric, capacity=4096, dtype="pq",
                             pq_m=pq_m, ef_construction=80, **kw)
    idx.train(wl.base)
    idx.add(wl.base)
    return idx, wl


def test_config_validation():
    with pytest.raises(ValueError, match="pq_m"):
        hnsw_jax.HnswConfig(dim=24, pq_m=7, dtype="pq")     # 7 ∤ 24
    with pytest.raises(ValueError, match="pq_m"):
        hnsw_jax.HnswConfig(dim=24, dtype="pq")             # missing pq_m
    with pytest.raises(ValueError, match="pq_m"):
        hnsw_jax.HnswConfig(dim=24, pq_m=8)                 # pq_m w/o pq
    cfg = hnsw_jax.HnswConfig(dim=24, pq_m=8, dtype="pq", capacity=512)
    assert cfg.is_pq and cfg.storage_dtype == "uint8"
    assert cfg.storage_width == 8
    cfg2 = hnsw_jax.HnswConfig.from_json(cfg.to_json())
    assert cfg2 == cfg


def test_train_required_and_storage_shape():
    idx = hnsw_jax.HnswIndex(8, 4, "l2", capacity=64, dtype="pq", pq_m=4)
    assert not idx.is_trained
    assert idx._vectors.dtype == np.uint8
    assert idx._vectors.shape == (64, 4)  # codes, not dims
    with pytest.raises(RuntimeError, match="train"):
        idx.add(np.zeros((4, 8), np.float32))
    idx.train(np.random.default_rng(0).normal(size=(512, 8)).astype(np.float32))
    assert idx.is_trained
    idx.add(np.zeros((2, 8), np.float32))
    with pytest.raises(RuntimeError, match="train"):
        idx.train(np.zeros((512, 8), np.float32))


def test_train_floor_and_divisibility():
    from hnsw_jax.ops.pq import train_pq
    x = np.random.default_rng(0).normal(size=(100, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="256"):
        train_pq(x, 4)  # fewer points than centroids
    with pytest.raises(ValueError, match="divide"):
        train_pq(np.zeros((300, 16), np.float32), 5)


def test_kmeans_codec_roundtrip_quality():
    """encode/decode must reconstruct better than a random codebook and
    SSE must not increase across Lloyd iterations (k-means contract)."""
    from hnsw_jax.ops.pq import decode_pq, encode_pq, train_pq
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2000, 16)).astype(np.float32)
    cb1 = train_pq(x, 4, iters=1, seed=7)
    cb25 = train_pq(x, 4, iters=25, seed=7)

    def sse(cb):
        xr = np.asarray(decode_pq(encode_pq(x, cb), cb))
        return float(((x - xr) ** 2).sum())

    assert sse(cb25) <= sse(cb1) + 1e-3
    # codebook entries are their own nearest centroid: encode(decode) == id
    codes = encode_pq(x[:64], cb25)
    xr = decode_pq(codes, cb25)
    codes2 = encode_pq(xr, cb25)
    np.testing.assert_array_equal(
        np.asarray(decode_pq(codes2, cb25)), np.asarray(xr))


def test_adc_equals_l2_to_reconstruction():
    """The ADC LUT surrogate, plus ||q||², must equal ||q - x̂||² exactly
    (the distance identity the whole pq path rests on)."""
    import jax.numpy as jnp
    from hnsw_jax.ops.pq import (adc_distance, decode_pq, encode_pq, pq_lut,
                                 train_pq)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1500, 24)).astype(np.float32)
    q = rng.normal(size=(16, 24)).astype(np.float32)
    cb = train_pq(x, 6, iters=10, seed=3)
    codes = encode_pq(x[:200], cb)
    xr = np.asarray(decode_pq(codes, cb))
    lut = pq_lut(jnp.asarray(q), jnp.asarray(cb), "l2")
    ids = np.broadcast_to(np.arange(200), (16, 200))
    d_adc = np.asarray(adc_distance(lut, jnp.asarray(codes)[ids]))
    want = ((q[:, None, :] - xr[None]) ** 2).sum(-1)
    np.testing.assert_allclose(d_adc + (q ** 2).sum(1)[:, None], want,
                               rtol=1e-4, atol=1e-4)
    # IP surrogate: -q·x̂
    lut_ip = pq_lut(jnp.asarray(q), jnp.asarray(cb), "ip")
    d_ip = np.asarray(adc_distance(lut_ip, jnp.asarray(codes)[ids]))
    np.testing.assert_allclose(d_ip, -(q @ xr.T), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_pq_recall_vs_xhat_oracle(metric):
    """Like faiss IndexHNSWPQ, the engine is exact over x̂: recall vs the
    brute-force oracle on the RECONSTRUCTIONS must be high; recall vs the
    true f32 ground truth is whatever the codes allow (same contract as
    sq8, test_sq.py)."""
    idx, wl = _pq_index(n=2000, metric=metric)
    xhat = idx.reconstruct_n(0, 2000)
    _, gt_hat = exact_knn(xhat, wl.queries, 10, metric)
    _, i_pq = idx.search(wl.queries, 10, ef_search=96)
    r_vs_hat = recall_at_k(i_pq, gt_hat, 10)
    assert r_vs_hat >= 0.95, r_vs_hat


def test_pq_self_query_and_distances_are_xhat_exact():
    idx, wl = _pq_index(n=1200)
    q = np.asarray(wl.base[:32], np.float32)
    d, i = idx.search(q, 3, ef_search=64)
    xhat = idx.reconstruct_n(0, 1200)
    # the returned distance must be ||q - x̂_i||² for the returned id —
    # ADC exactness (the top hit may be a different point whose x̂ is
    # closer to q than q's own reconstruction; that is correct ADC)
    want = ((q[:, None, :] - xhat[np.maximum(i, 0)]) ** 2).sum(-1)
    ok = i >= 0
    np.testing.assert_allclose(d[ok], want[ok], rtol=1e-3, atol=1e-3)


def test_pq_save_load_roundtrip(tmp_path):
    idx, wl = _pq_index(n=800)
    d1, i1 = idx.search(wl.queries[:32], 5, ef_search=64)
    p = str(tmp_path / "pq.npz")
    idx.save(p)
    idx2 = hnsw_jax.HnswIndex.load(p)
    assert idx2.config.is_pq and idx2.is_trained
    assert idx2._vectors.dtype == np.uint8
    np.testing.assert_array_equal(idx2._pq_np, idx._pq_np)
    d2, i2 = idx2.search(wl.queries[:32], 5, ef_search=64)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)
    # resumed adds keep working and stay searchable
    idx2.add(np.asarray(wl.base[:8], np.float32))
    assert idx2.ntotal == idx.ntotal + 8


@pytest.mark.slow  # compile-heavy standalone build; path covered by the fast representatives + dryrun
def test_pq_factory_filters_deletion_and_tune():
    wl = synthetic_workload(1200, 16, n_queries=32, metric="l2", seed=3)
    idx = index_factory(16, "HNSW8,PQ4", capacity=2048, ef_construction=60)
    assert idx.config.is_pq and idx.config.pq_m == 4 and not idx.is_trained
    idx.train(wl.base)
    idx.add(wl.base)
    # filters + deletion compose with pq storage
    idx.remove_ids(np.asarray([5]))
    allowed = np.zeros(2048, bool)
    allowed[:200] = True
    allowed[5] = True
    _, i = idx.search(wl.queries, 5, ef_search=128, allowed=allowed)
    v = i[i >= 0]
    assert (v < 200).all() and not (v == 5).any()
    # tune_ef_search runs against the pq-aware exact oracle
    ef = idx.tune_ef_search(np.asarray(wl.queries[:16]), 0.9, k=5)
    assert ef in (16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)
    # sq packed rows are refused on pq storage (pq packs its own codes)
    with pytest.raises(ValueError, match="mode='pq'"):
        idx.enable_packed(mode="sq")


@pytest.mark.slow  # compile-heavy standalone build; path covered by the fast representatives + dryrun
def test_pq_packed_rows_parity():
    """enable_packed() on pq storage: PQ-coded packed rows (PackedPQ).
    Routing reads one row per expanded node; ADC values are identical to
    the unpacked path, so results must match (both exactly reranked)."""
    idx, wl = _pq_index(n=2500, d=24, pq_m=8)
    d0, i0 = idx.search(wl.queries, 10, ef_search=96)
    nb = idx.enable_packed()
    assert idx.packed_enabled
    # row width: m0 * pq_m bytes — 8-16x smaller than sq rows (m0 * d)
    from hnsw_jax.ops.packed import PackedPQ
    assert isinstance(idx._packed, PackedPQ)
    assert idx._packed.nbr_codes.shape[1] == idx.config.m0 * 8
    assert nb >= idx._packed.nbr_codes.size
    d1, i1 = idx.search(wl.queries, 10, ef_search=96)
    r0 = recall_at_k(i1, i0, 10)
    assert r0 >= 0.99, r0
    match = i0 == i1
    np.testing.assert_allclose(d0[match], d1[match], rtol=1e-4, atol=1e-4)


@pytest.mark.slow  # compile-heavy standalone build; path covered by the fast representatives + dryrun
def test_pq_4bit_end_to_end():
    """pq_bits=4 (faiss PQx4 fast-scan geometry): ksub=16 codebooks,
    nibble-packed rows, same exact-over-x̂ contract."""
    wl = synthetic_workload(2000, 16, n_queries=64, metric="l2", seed=5)
    idx = index_factory(16, "HNSW8,PQ8x4", capacity=2048,
                        ef_construction=60)
    assert idx.config.pq_bits == 4 and idx.config.pq_ksub == 16
    idx.train(wl.base)
    idx.add(wl.base)
    assert int(np.asarray(idx._vectors[: idx.ntotal]).max()) < 16
    xhat = idx.reconstruct_n(0, 2000)
    _, gt_hat = exact_knn(xhat, wl.queries, 10, "l2")
    _, i_pq = idx.search(wl.queries, 10, ef_search=96)
    assert recall_at_k(i_pq, gt_hat, 10) >= 0.95
    # packed rows are nibble-packed: bpn = pq_m / 2
    idx.enable_packed()
    assert idx._packed.nbr_codes.shape[1] == idx.config.m0 * 4
    _, i_p = idx.search(wl.queries, 10, ef_search=96)
    assert recall_at_k(i_p, gt_hat, 10) >= 0.95


@pytest.mark.slow  # compile-heavy standalone build; path covered by the fast representatives + dryrun
def test_pq_routing_rows_on_flat_storage():
    """enable_packed(mode='pq') on FLAT storage: routing-only codebooks,
    ADC routing + exact f32 rerank — the low-memory packed configuration
    (m0 * pq_m bytes/row instead of m0 * d)."""
    wl = synthetic_workload(2500, 24, n_queries=96, metric="l2", seed=11)
    idx = hnsw_jax.HnswIndex(24, 8, "l2", capacity=4096,
                             ef_construction=80)
    idx.add(wl.base)
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    _, i0 = idx.search(wl.queries, 10, ef_search=96)
    r_un = recall_at_k(i0, gt, 10)
    with pytest.raises(ValueError, match="pq_m"):
        idx.enable_packed(mode="pq")          # pq_m required
    idx.enable_packed(mode="pq", pq_m=8, train_x=wl.base)
    from hnsw_jax.ops.packed import PackedPQ
    assert isinstance(idx._packed, PackedPQ)
    d1, i1 = idx.search(wl.queries, 10, ef_search=96)
    r_pk = recall_at_k(i1, gt, 10)
    assert r_pk >= r_un - 0.02, (r_pk, r_un)
    # rerank is exact f32: distances of agreeing ids match the oracle
    d_gt, _ = exact_knn(wl.base, wl.queries, 10, "l2")
    match = i1 == gt
    np.testing.assert_allclose(d1[match], d_gt[match], rtol=1e-4, atol=1e-4)
    # retraining with a different pq_m requires an explicit reset
    with pytest.raises(ValueError, match="reset_routing"):
        idx.enable_packed(mode="pq", pq_m=12, train_x=wl.base)
    idx.disable_packed(reset_routing=True)
    # 4-bit routing codes: nibble-packed rows, coarser routing absorbed by ef
    idx.enable_packed(mode="pq", pq_m=8, pq_bits=4, train_x=wl.base)
    assert idx._packed.nbr_codes.shape[1] == idx.config.m0 * 4
    _, i2 = idx.search(wl.queries, 10, ef_search=192)
    assert recall_at_k(i2, gt, 10) >= r_un - 0.05


@pytest.mark.slow  # compile-heavy standalone build; path covered by the fast representatives + dryrun
def test_pq_packed_incremental_add():
    """add() after enable_packed() on pq storage maintains the PackedPQ
    rows incrementally; post-add packed search equals a fresh re-pack."""
    idx, wl = _pq_index(n=1500, d=24, pq_m=8)
    idx.enable_packed(reserve=256)
    extra = wl.base[:128] + 0.01
    idx.add(np.asarray(extra, np.float32))
    assert idx.packed_enabled, "incremental refresh dropped packed mode"
    d1, i1 = idx.search(wl.queries, 10, ef_search=96)
    idx.disable_packed()
    idx.enable_packed(reserve=0)
    d2, i2 = idx.search(wl.queries, 10, ef_search=96)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)


def test_pq_memory_is_codes_only():
    cfg = hnsw_jax.HnswConfig(dim=32, m=8, capacity=1024, dtype="pq", pq_m=8)
    idx = hnsw_jax.HnswIndex(config=cfg)
    assert idx._vectors.size * idx._vectors.dtype.itemsize == 1024 * 8


def test_pq_rejects_host_build():
    with pytest.raises(ValueError, match="device"):
        hnsw_jax.HnswIndex(8, 4, capacity=64, dtype="pq", pq_m=4,
                           build="host")


def test_pq_reconstruct_batch_matches_xhat():
    idx, wl = _pq_index()
    ids = np.array([0, 2999, 5, 5, -1], np.int64)
    r = idx.reconstruct_batch(ids)
    np.testing.assert_array_equal(r[0], idx.reconstruct(0))
    np.testing.assert_array_equal(r[1], idx.reconstruct(2999))
    np.testing.assert_array_equal(r[2], r[3])
    assert (r[4] == 0).all()
    d, i, rv = idx.search_and_reconstruct(wl.queries[:8], 5, ef_search=64)
    valid = i >= 0
    np.testing.assert_array_equal(rv[valid], idx.reconstruct_batch(i[valid]))
