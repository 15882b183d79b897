"""Serving micro-batcher (hnsw_jax/serving.py): bucket padding, request
coalescing, handle bookkeeping."""

import numpy as np

from hnsw_jax import HnswIndex
from hnsw_jax.serving import Searcher, size_bucket
from hnsw_jax.utils.datasets import synthetic_workload

from conftest import exact_knn


def test_size_bucket():
    assert size_bucket(1) == 64
    assert size_bucket(64) == 64
    assert size_bucket(65) == 128
    assert size_bucket(8192) == 8192
    assert size_bucket(100_000) == 8192   # clamped; search() chunks


def _index():
    wl = synthetic_workload(2000, 16, n_queries=200, metric="l2", seed=41)
    idx = HnswIndex(16, 8, "l2", capacity=2048, ef_construction=60)
    idx.add(np.asarray(wl.base))
    return idx, wl


def test_direct_search_any_size():
    idx, wl = _index()
    s = Searcher(idx, k=10, ef_search=96, min_bucket=64, max_bucket=128)
    q = np.asarray(wl.queries)
    _, gt = exact_knn(np.asarray(wl.base), q, 10, "l2")
    # 1-D single query, odd sizes, and chunked >max_bucket all work
    d1, i1 = s.search(q[0])
    assert i1.shape == (1, 10)
    d, i = s.search(q[:77])
    assert i.shape == (77, 10)
    dall, iall = s.search(q)             # 200 > max_bucket=128 -> 2 chunks
    assert iall.shape == (200, 10)
    hits = (iall[:, :, None] == gt[:, None, :]).any(-1).mean()
    assert hits >= 0.9
    # padding never leaks: row r of a padded batch equals a solo search
    d_solo, i_solo = s.search(q[76])
    np.testing.assert_array_equal(i_solo[0], i[76])
    assert s.stats["launches"] >= 4
    assert s.stats["queries_served"] == 1 + 77 + 200 + 1


def test_coalescing_handles():
    idx, wl = _index()
    s = Searcher(idx, k=5, ef_search=64, min_bucket=64, max_bucket=8192)
    q = np.asarray(wl.queries)
    h1 = s.submit(q[:3])
    h2 = s.submit(q[3:10])
    h3 = s.submit(q[10])
    assert s.stats["launches"] == 0      # nothing launched yet
    d1, i1 = s.result(h1)                # triggers one flush for all three
    assert s.stats["launches"] == 1
    d2, i2 = s.result(h2)
    d3, i3 = s.result(h3)
    assert i1.shape == (3, 5) and i2.shape == (7, 5) and i3.shape == (1, 5)
    # coalesced results equal direct per-request searches
    dd, ii = s.search(q[:10])
    np.testing.assert_array_equal(np.concatenate([i1, i2]), ii)
    np.testing.assert_array_equal(i3[0], s.search(q[10])[1][0])


def test_device_out_fallback():
    """Indexes whose search() rejects device_out (ShardedHnswIndex-style)
    fall back to per-chunk materialization — same results, one downgrade."""
    idx, wl = _index()

    class NoDeviceOut:
        def search(self, x, k, *, ef_search=None):
            return idx.search(x, k, ef_search=ef_search)

    q = np.asarray(wl.queries)
    s = Searcher(NoDeviceOut(), k=10, ef_search=96,
                 min_bucket=64, max_bucket=128)
    d, i = s.search(q)                    # 200 -> 2 chunks, both fall back
    assert not s._device_out              # downgrade latched after chunk 1
    d_ref, i_ref = Searcher(idx, k=10, ef_search=96, min_bucket=64,
                            max_bucket=128).search(q)
    np.testing.assert_array_equal(i, i_ref)


def test_auto_flush_at_max_bucket():
    idx, wl = _index()
    s = Searcher(idx, k=5, ef_search=64, min_bucket=64, max_bucket=64)
    q = np.asarray(wl.queries)
    hs = [s.submit(q[i * 16:(i + 1) * 16]) for i in range(4)]
    assert s.stats["launches"] == 1      # 64 rows hit the bucket -> flushed
    for h in hs:
        d, i = s.result(h)
        assert i.shape == (16, 5)
