import numpy as np
import pytest

from hnsw_jax import FlatIndex, HnswIndex
from hnsw_jax.utils.recall import recall_at_k

from conftest import exact_knn


def test_faiss_parity_surface(small_workload):
    wl = small_workload
    idx = HnswIndex(32, 8, "l2", capacity=2048, build="host",
                    ef_construction=80, seed=3)
    assert idx.is_trained  # train-free
    assert idx.d == 32
    assert idx.ntotal == 0
    idx.add(wl.base[:500])
    idx.add(wl.base[500:1000])  # incremental add
    assert idx.ntotal == 1000

    idx.ef_search = 64  # mutable knob, faiss index.hnsw.efSearch
    d, i = idx.search(wl.queries, k=10)
    assert d.shape == (len(wl.queries), 10) and i.dtype == np.int64
    _, ti = exact_knn(wl.base[:1000], wl.queries, 10, "l2")
    assert recall_at_k(i, ti, 10) >= 0.93

    # reconstruct parity
    np.testing.assert_allclose(idx.reconstruct(3), wl.base[3], rtol=1e-6)
    np.testing.assert_allclose(idx.reconstruct_n(10, 5), wl.base[10:15],
                               rtol=1e-6)
    assert idx.check()["errors"] == []


def test_capacity_guard():
    idx = HnswIndex(4, 4, capacity=10, build="host")
    with pytest.raises(ValueError, match="capacity"):
        idx.add(np.zeros((11, 4), np.float32))


def test_empty_index_search():
    idx = HnswIndex(4, 4, capacity=10, build="host")
    d, i = idx.search(np.zeros((3, 4), np.float32), k=2)
    assert (i == -1).all() and np.isinf(d).all()


def test_dim_guard():
    idx = HnswIndex(4, 4, capacity=10, build="host")
    with pytest.raises(ValueError, match="expected"):
        idx.add(np.zeros((2, 5), np.float32))


def test_flat_index(small_workload):
    wl = small_workload
    flat = FlatIndex(32)
    flat.add(wl.base[:300])
    flat.add(wl.base[300:600])
    assert flat.ntotal == 600
    d, i = flat.search(wl.queries[:20], k=5)
    _, ti = exact_knn(wl.base[:600], wl.queries[:20], 5, "l2")
    assert (i == ti).mean() > 0.99


def test_bf16_storage(small_workload):
    wl = small_workload
    idx = HnswIndex(32, 8, capacity=2048, build="host", dtype="bfloat16",
                    ef_construction=80)
    idx.add(wl.base[:800])
    _, i = idx.search(wl.queries, k=10, ef_search=64)
    _, ti = exact_knn(wl.base[:800], wl.queries, 10, "l2")
    assert recall_at_k(i, ti, 10) >= 0.85  # bf16 storage costs a little recall


def test_tune_ef_search():
    """faiss AutoTune analogue: the smallest grid ef reaching the target
    recall on a held-out query set, installed as the default."""
    import hnsw_jax
    from hnsw_jax.utils.datasets import synthetic_workload

    wl = synthetic_workload(2000, 16, n_queries=64, metric="l2", seed=95)
    idx = hnsw_jax.HnswIndex(16, 8, "l2", capacity=2048, ef_construction=80)
    idx.add(wl.base)
    ef = idx.tune_ef_search(wl.queries, target_recall=0.95, k=10)
    assert ef in (16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)
    assert idx.ef_search == ef
    # the chosen ef genuinely reaches the target vs the exact oracle
    from conftest import exact_knn
    from hnsw_jax.utils.recall import recall_at_k
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    _, i = idx.search(wl.queries, 10)
    assert recall_at_k(i, gt, 10) >= 0.95
    # unreachable target falls back to the largest grid point
    ef_hi = idx.tune_ef_search(wl.queries, target_recall=1.01,
                               set_default=False, ef_grid=(16, 32))
    assert ef_hi == 32 and idx.ef_search == ef


def test_beam_keys_knob():
    """beam_keys='bf16' forces the cheap merge keys on exact storage:
    recall stays high (near-tie retention only) and returned distances are
    still exact (the extraction rerank)."""
    import hnsw_jax
    from hnsw_jax.utils.datasets import synthetic_workload
    from conftest import exact_knn
    from hnsw_jax.utils.recall import recall_at_k

    wl = synthetic_workload(2000, 16, n_queries=64, metric="l2", seed=21)
    idx = hnsw_jax.HnswIndex(16, 8, "l2", capacity=2048, ef_construction=80)
    idx.add(wl.base)
    gtd, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    d, i = idx.search(wl.queries, 10, ef_search=96, beam_keys="bf16")
    assert recall_at_k(i, gt, 10) >= 0.9
    hit = i == gt
    np.testing.assert_allclose(d[hit], gtd[hit], rtol=1e-4, atol=1e-4)
    import pytest as _pytest
    with _pytest.raises(ValueError, match="beam_keys"):
        idx.search(wl.queries, 10, beam_keys="f16")


def test_tune_operating_point():
    """2-D refinement: smallest ef then smallest hop cap reaching the
    target — the chosen pair must genuinely reach it vs the exact oracle,
    and the cap must be a real bound (<= auto cap ef + 8)."""
    import hnsw_jax
    from hnsw_jax.utils.datasets import synthetic_workload
    from conftest import exact_knn
    from hnsw_jax.utils.recall import recall_at_k

    wl = synthetic_workload(2000, 16, n_queries=64, metric="l2", seed=95)
    idx = hnsw_jax.HnswIndex(16, 8, "l2", capacity=2048, ef_construction=80)
    idx.add(wl.base)
    ef, hops = idx.tune_operating_point(wl.queries, target_recall=0.95,
                                        k=10)
    assert idx.ef_search == ef and 16 <= hops <= ef + 8
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    _, i = idx.search(wl.queries, 10, ef_search=ef, max_hops=hops)
    assert recall_at_k(i, gt, 10) >= 0.95


def test_reconstruct_batch_and_search_and_reconstruct(small_workload):
    wl = small_workload
    idx = HnswIndex(32, 8, "l2", capacity=2048, build="host",
                    ef_construction=80, seed=3)
    idx.add(wl.base[:800])

    # arbitrary (repeating, unsorted) ids decode to the stored rows
    ids = np.array([7, 3, 3, 799, 0, -1], np.int64)
    r = idx.reconstruct_batch(ids)
    np.testing.assert_allclose(r[:5], wl.base[ids[:5]], rtol=1e-6)
    assert (r[5] == 0).all()  # -1 decodes to a zero row
    with pytest.raises(IndexError):
        idx.reconstruct_batch(np.array([800]))

    d, i, r = idx.search_and_reconstruct(wl.queries[:20], k=5, ef_search=64)
    assert r.shape == (20, 5, 32)
    valid = i >= 0
    np.testing.assert_allclose(r[valid], wl.base[i[valid]], rtol=1e-6)
    assert np.isnan(r[~valid]).all()  # faiss fills missing rows with NaN
    # returned distances are the true metric to the reconstructed rows
    q = np.repeat(wl.queries[:20, None, :], 5, axis=1)
    np.testing.assert_allclose(
        d[valid], ((q[valid] - r[valid]) ** 2).sum(-1), rtol=1e-3, atol=1e-2)

    # with_stats flows through **kw: 4-tuple, same (D, I, R)
    d2, i2, r2, stats = idx.search_and_reconstruct(
        wl.queries[:20], k=5, ef_search=64, with_stats=True)
    np.testing.assert_array_equal(i2, i)
    np.testing.assert_allclose(d2, d, rtol=1e-6)
    assert (np.asarray(stats.ndis) > 0).all()

    # k > reachable: missing rows come back NaN, not ambiguous zeros
    tiny = HnswIndex(32, 8, "l2", capacity=64, build="host", seed=3)
    tiny.add(wl.base[:3])
    _, it, rt = tiny.search_and_reconstruct(wl.queries[:4], k=5,
                                            ef_search=16)
    assert (it == -1).any()
    assert np.isnan(rt[it == -1]).all()
    np.testing.assert_allclose(rt[it >= 0],
                               wl.base[it[it >= 0]], rtol=1e-6)


def test_merge_from(small_workload):
    wl = small_workload
    a = HnswIndex(32, 8, "l2", capacity=2048, build="host",
                  ef_construction=80, seed=3)
    a.add(wl.base[:600])
    b = HnswIndex(32, 8, "l2", capacity=1024, build="host",
                  ef_construction=80, seed=5)
    b.add(wl.base[600:1000])
    b.remove_ids(np.arange(10))  # tombstoned rows must not be merged

    assert a.merge_from(b) == 390
    assert a.ntotal == 990
    assert b.ntotal == 400  # other unchanged
    # merged rows are searchable at normal quality
    keep = np.r_[wl.base[:600], wl.base[610:1000]]
    d, i = a.search(wl.queries, k=10, ef_search=64)
    _, ti = exact_knn(keep, wl.queries, 10, "l2")
    assert recall_at_k(i, ti, 10) >= 0.90

    with pytest.raises(ValueError, match="dim"):
        a.merge_from(HnswIndex(16, 8, "l2", capacity=64, build="host"))
    with pytest.raises(ValueError, match="metric"):
        a.merge_from(HnswIndex(32, 8, "ip", capacity=64, build="host"))
