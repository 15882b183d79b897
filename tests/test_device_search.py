"""The device query engine (hnsw_search) over a known-good host-built graph —
isolates C3-C6/C13 from construction (SURVEY.md §7 stage 3)."""

import numpy as np
import jax.numpy as jnp
import pytest

from hnsw_jax.search import compute_sqnorms, hnsw_search
from hnsw_jax.utils.recall import recall_at_k

from conftest import exact_knn


def _device_search(host_idx, queries, k, ef, **kw):
    graph = host_idx.to_graph_arrays()
    vectors = jnp.asarray(host_idx.vectors)
    sq = compute_sqnorms(vectors)
    return hnsw_search(graph, vectors, sq, jnp.asarray(queries), k=k,
                       ef_search=ef, metric=host_idx.cfg.metric,
                       max_level_cap=host_idx.cfg.max_level_cap, **kw)


def test_recall_matches_reference(host_index, small_workload):
    wl = small_workload
    d, i = _device_search(host_index, wl.queries, 10, 64)
    _, ti = exact_knn(wl.base, wl.queries, 10, "l2")
    r_dev = recall_at_k(np.asarray(i), ti, 10)
    _, i_ref = host_index.search(wl.queries, k=10, ef_search=64)
    r_ref = recall_at_k(i_ref, ti, 10)
    # same graph, same ef: the fixed-width beam must not lose recall
    assert r_dev >= r_ref - 0.01, (r_dev, r_ref)
    assert r_dev >= 0.95


def test_exact_same_buffer_semantics(host_index, small_workload):
    """With a large ef (beam covers everything reachable) device results must
    equal the reference's ids almost exactly."""
    wl = small_workload
    _, i_dev = _device_search(host_index, wl.queries[:32], 5, 128)
    _, i_ref = host_index.search(wl.queries[:32], k=5, ef_search=128)
    agree = (np.asarray(i_dev) == i_ref).mean()
    assert agree > 0.98, agree


def test_true_l2_distances(host_index, small_workload):
    wl = small_workload
    d, i = _device_search(host_index, wl.queries[:16], 3, 64)
    d, i = np.asarray(d), np.asarray(i)
    for qi in range(16):
        for j in range(3):
            if i[qi, j] >= 0:
                expect = ((wl.base[i[qi, j]] - wl.queries[qi]) ** 2).sum()
                np.testing.assert_allclose(d[qi, j], expect, rtol=1e-3,
                                           atol=1e-3)


def test_ip_device(host_ip_index, small_ip_workload):
    wl = small_ip_workload
    _, i = _device_search(host_ip_index, wl.queries, 10, 64)
    _, ti = exact_knn(wl.base, wl.queries, 10, "ip")
    assert recall_at_k(np.asarray(i), ti, 10) >= 0.9


@pytest.mark.parametrize("n_expand", [2, 4])
def test_n_expand_recall(host_index, small_workload, n_expand):
    """Multi-expansion per hop must not lose recall (it strictly widens the
    explored frontier)."""
    wl = small_workload
    _, ti = exact_knn(wl.base, wl.queries, 10, "l2")
    _, i1 = _device_search(host_index, wl.queries, 10, 64, n_expand=1)
    _, iN = _device_search(host_index, wl.queries, 10, 64, n_expand=n_expand)
    r1 = recall_at_k(np.asarray(i1), ti, 10)
    rN = recall_at_k(np.asarray(iN), ti, 10)
    assert rN >= r1 - 0.02, (r1, rN)


def test_stats(host_index, small_workload):
    wl = small_workload
    d, i, stats = _device_search(host_index, wl.queries[:8], 5, 32,
                                 with_stats=True)
    assert int(stats.hops) > 0
    assert (np.asarray(stats.ndis) > 0).all()


def test_hop_cap_is_generous(host_index, small_workload):
    """The default hop cap must not be what terminates typical searches."""
    wl = small_workload
    _, _, stats = _device_search(host_index, wl.queries, 10, 64,
                                 with_stats=True)
    assert int(stats.hops) < 4 * 64 + 16  # converged before the cap


def test_ef_bucket_width_independence(host_index, small_workload):
    """efSearch is a runtime scalar: the same ef must give identical results
    regardless of which (larger) compiled bucket width runs it."""
    import jax.numpy as jnp
    from hnsw_jax.search import _hnsw_search, compute_sqnorms

    g = host_index.to_graph_arrays()
    v = jnp.asarray(host_index.vectors)
    sq = compute_sqnorms(v)
    q = jnp.asarray(small_workload.queries[:32])
    ef = jnp.asarray(48, jnp.int32)
    hl = jnp.asarray(48 + 8, jnp.int32)
    d1, i1 = _hnsw_search(g, v, sq, q, ef, hl, k=10, ef_buf=64, metric="l2",
                          max_level_cap=6)
    d2, i2 = _hnsw_search(g, v, sq, q, ef, hl, k=10, ef_buf=128, metric="l2",
                          max_level_cap=6)
    assert np.array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-6)
