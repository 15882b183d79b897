"""Filtered search (faiss SearchParametersHNSW / IDSelector parity)."""

import numpy as np
import pytest

from hnsw_jax import HnswIndex
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k

from conftest import exact_knn


@pytest.fixture(scope="module")
def fidx():
    wl = synthetic_workload(2000, 16, n_queries=100, seed=51)
    idx = HnswIndex(16, 8, capacity=2048, build="device", ef_construction=60,
                    seed=2)
    idx.add(wl.base)
    return idx, wl


def test_only_allowed_ids_returned(fidx):
    idx, wl = fidx
    rng = np.random.default_rng(0)
    mask = rng.random(2000) < 0.5
    d, i = idx.search(wl.queries, k=10, ef_search=96, allowed=mask)
    got = i[i >= 0]
    assert mask[got].all()


def test_filtered_recall(fidx):
    idx, wl = fidx
    rng = np.random.default_rng(1)
    mask = rng.random(2000) < 0.5
    sub = np.flatnonzero(mask)
    _, gt_sub = exact_knn(wl.base[sub], wl.queries, 10, "l2")
    gt = sub[gt_sub]
    d, i = idx.search(wl.queries, k=10, ef_search=128, allowed=mask)
    r = recall_at_k(i, gt, 10)
    assert r >= 0.85, r


def test_id_whitelist_form(fidx):
    idx, wl = fidx
    ids = np.arange(0, 2000, 2)  # even ids only
    d, i = idx.search(wl.queries[:20], k=5, ef_search=64, allowed=ids)
    got = i[i >= 0]
    assert (got % 2 == 0).all()


def test_no_duplicates_in_filtered_results(fidx):
    idx, wl = fidx
    mask = np.zeros(2000, bool)
    mask[:100] = True  # aggressive filter forces re-encounters
    d, i = idx.search(wl.queries, k=10, ef_search=128, allowed=mask)
    for row in i:
        vals = row[row >= 0]
        assert len(set(vals.tolist())) == len(vals)


def test_unfiltered_unchanged(fidx):
    idx, wl = fidx
    d1, i1 = idx.search(wl.queries[:32], k=10, ef_search=64)
    mask = np.ones(2000, bool)
    d2, i2 = idx.search(wl.queries[:32], k=10, ef_search=64, allowed=mask)
    # all-true selector must match the unfiltered result set exactly
    # (row-wise as sets: equal-distance ties may order differently)
    for r1, r2, dd1, dd2 in zip(i1, i2, d1, d2):
        assert set(r1.tolist()) == set(r2.tolist())
        # rtol 1e-5: both paths rerank exactly, but over different buffer
        # widths (ef vs k) — summation order wiggles the last ulps
        np.testing.assert_allclose(np.sort(dd1), np.sort(dd2), rtol=1e-5)


def test_device_array_filters(fidx):
    """Device-resident filters must behave identically to host ones
    (a device int whitelist used to be misread as a bool mask)."""
    import jax.numpy as jnp
    idx, wl = fidx
    ids = np.arange(0, 2000, 3)
    d1, i1 = idx.search(wl.queries[:16], k=5, ef_search=64, allowed=ids)
    d2, i2 = idx.search(wl.queries[:16], k=5, ef_search=64,
                        allowed=jnp.asarray(ids))
    assert np.array_equal(i1, i2)
    mask = np.zeros(2000, bool)
    mask[ids] = True
    d3, i3 = idx.search(wl.queries[:16], k=5, ef_search=64,
                        allowed=jnp.asarray(mask))
    assert np.array_equal(i1, i3)
    got = i2[i2 >= 0]
    assert (got % 3 == 0).all()


def test_allowed_rejects_bad_inputs(fidx):
    idx, wl = fidx
    q = wl.queries[:4]
    with np.testing.assert_raises(TypeError):
        idx.search(q, k=5, allowed=np.zeros(2048, np.float32))
    with np.testing.assert_raises(ValueError):
        idx.search(q, k=5, allowed=np.ones((4, 512), bool))
