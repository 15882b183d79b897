import numpy as np
import jax.numpy as jnp
import pytest

from hnsw_jax.ops.distances import brute_force_topk, pairwise_distances, true_l2

from conftest import exact_knn


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_brute_force_matches_numpy(metric):
    rng = np.random.default_rng(0)
    base = rng.normal(size=(500, 24)).astype(np.float32)
    q = rng.normal(size=(40, 24)).astype(np.float32)
    d, i = brute_force_topk(jnp.asarray(q), jnp.asarray(base), k=10,
                            metric=metric)
    td, ti = exact_knn(base, q, 10, metric)
    # float32 near-ties may permute ids; compare as sets + by distance value
    from hnsw_jax.utils.recall import recall_at_k
    assert recall_at_k(np.asarray(i), ti, 10) >= 0.98
    # ||x||^2 - 2 q·x in f32 carries ~1e-3 relative cancellation error
    np.testing.assert_allclose(np.asarray(d), td, rtol=5e-3, atol=5e-3)


def test_tiled_matches_untiled():
    rng = np.random.default_rng(1)
    base = rng.normal(size=(1000, 16)).astype(np.float32)
    q = rng.normal(size=(30, 16)).astype(np.float32)
    d1, i1 = brute_force_topk(jnp.asarray(q), jnp.asarray(base), k=7,
                              metric="l2", tile_n=128)
    d2, i2 = brute_force_topk(jnp.asarray(q), jnp.asarray(base), k=7,
                              metric="l2", tile_n=100000)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-5)
    assert (np.asarray(i1) == np.asarray(i2)).all()


def test_query_tiling():
    rng = np.random.default_rng(2)
    base = rng.normal(size=(300, 8)).astype(np.float32)
    q = rng.normal(size=(50, 8)).astype(np.float32)
    d1, i1 = brute_force_topk(jnp.asarray(q), jnp.asarray(base), k=5,
                              metric="l2", tile_q=16, tile_n=64)
    d2, i2 = brute_force_topk(jnp.asarray(q), jnp.asarray(base), k=5,
                              metric="l2")
    assert (np.asarray(i1) == np.asarray(i2)).all()


def test_l2_surrogate_plus_qnorm_is_true_l2():
    rng = np.random.default_rng(3)
    base = rng.normal(size=(64, 12)).astype(np.float32)
    q = rng.normal(size=(9, 12)).astype(np.float32)
    surro = pairwise_distances(jnp.asarray(q), jnp.asarray(base), "l2")
    full = true_l2(surro, jnp.asarray(q))
    expect = ((q[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(np.asarray(full), expect, rtol=2e-4, atol=2e-4)


def test_k_larger_than_n_pads():
    base = np.eye(4, dtype=np.float32)
    q = np.zeros((2, 4), np.float32)
    d, i = brute_force_topk(jnp.asarray(q), jnp.asarray(base), k=6, metric="l2")
    assert np.asarray(i).shape == (2, 6)
    assert (np.asarray(i)[:, 4:] == -1).all()


def test_brute_force_n_valid_masks_tail():
    import jax.numpy as jnp
    from hnsw_jax.ops.distances import brute_force_topk
    rng = np.random.default_rng(5)
    base = rng.normal(size=(500, 16)).astype(np.float32)
    cap = np.zeros((800, 16), np.float32)
    cap[:500] = base
    cap[500:] = 100.0  # decoys beyond n_valid (would win if unmasked: ip)
    q = rng.normal(size=(7, 16)).astype(np.float32)
    for metric in ("l2", "ip"):
        d_ref, i_ref = brute_force_topk(jnp.asarray(q), jnp.asarray(base),
                                        k=5, metric=metric)
        d_nv, i_nv = brute_force_topk(jnp.asarray(q), jnp.asarray(cap),
                                      k=5, metric=metric, n_valid=500)
        np.testing.assert_array_equal(np.asarray(i_ref), np.asarray(i_nv))
        np.testing.assert_allclose(np.asarray(d_ref), np.asarray(d_nv),
                                   rtol=1e-6)
    # tiled path (tile_n < n) with n_valid
    d_t, i_t = brute_force_topk(jnp.asarray(q), jnp.asarray(cap), k=5,
                                metric="l2", tile_n=128, n_valid=500)
    d_ref, i_ref = brute_force_topk(jnp.asarray(q), jnp.asarray(base), k=5,
                                    metric="l2")
    np.testing.assert_array_equal(np.asarray(i_ref), np.asarray(i_t))
