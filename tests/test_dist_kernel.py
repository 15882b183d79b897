"""Exact-storage hop distances — the XLA gather + reduce the engine runs
(search.py ``gathered_distances`` / ``_make_distance_fn``) — against a
float64 NumPy oracle, at widths that are not powers of two (d = 96, 100)
and with the sq8 dequant affine."""

import numpy as np
import jax.numpy as jnp
import pytest

from hnsw_jax.search import _make_distance_fn, gathered_distances


def _oracle(qs, vecs, metric):
    """float64 surrogate distances [Q, K] from gathered rows [Q, K, d]."""
    q = qs.astype(np.float64)
    v = vecs.astype(np.float64)
    dots = np.einsum("qd,qkd->qk", q, v)
    if metric == "ip":
        return -dots
    return np.einsum("qkd,qkd->qk", v, v) - 2.0 * dots


def _table(d, n=300, q=32, k=16, seed=0, sq8=False):
    rng = np.random.default_rng(seed + d)
    if sq8:
        vec = rng.integers(0, 256, size=(n, d), dtype=np.uint8)
    else:
        vec = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(0, n, size=(q, k)).astype(np.int32)
    qs = rng.normal(size=(q, d)).astype(np.float32)
    off = rng.normal(size=(d,)).astype(np.float32)
    sc = rng.uniform(0.01, 0.1, size=(d,)).astype(np.float32)
    return vec, ids, qs, (off, sc)


# float32 sums in another order than the float64 oracle: relative error
# ~1e-6 per term, so the tolerance sits well above it and far below any
# real error (a wrong or missing dim moves the value by O(1))
RTOL, ATOL = 1e-4, 1e-3


def _via_distance_fn(vec, ids, qs, metric, dequant=None):
    """Distances through the engine's own closure (gather + reduce)."""
    fn = _make_distance_fn(jnp.asarray(vec), None, jnp.asarray(qs), metric,
                           dequant=dequant)
    return np.asarray(fn(jnp.asarray(ids), jnp.ones(ids.shape, bool)))


@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gathered_vec_dist(d, metric):
    vec, ids, qs, _ = _table(d)
    np.testing.assert_allclose(_via_distance_fn(vec, ids, qs, metric),
                               _oracle(qs, vec[ids], metric),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [96, 128])
def test_gathered_vec_dist_sq8_dequant(d):
    """uint8 codes dequantized in the fusion (x̂ = offset + scale·u)."""
    vec, ids, qs, (off, sc) = _table(d, sq8=True)
    out = _via_distance_fn(vec, ids, qs, "l2",
                           (jnp.asarray(off), jnp.asarray(sc)))
    vhat = off + sc * vec[ids].astype(np.float32)
    np.testing.assert_allclose(out, _oracle(qs, vhat, "l2"),
                               rtol=RTOL, atol=ATOL)


def test_gathered_vec_dist_odd_shapes():
    """K and Q that are not powers of two (K=13, Q=30) at d=100."""
    vec, ids, qs, _ = _table(100, q=30, k=13)
    out = _via_distance_fn(vec, ids, qs, "l2")
    assert out.shape == (30, 13)
    np.testing.assert_allclose(out, _oracle(qs, vec[ids], "l2"),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d", [96, 100, 128])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gathered_distances_xla(d, metric):
    """The plain XLA version the engine runs: gather + two HIGHEST
    contractions."""
    vec, ids, qs, _ = _table(d)
    out = gathered_distances(jnp.asarray(vec)[jnp.asarray(ids)],
                             jnp.asarray(qs), metric)
    np.testing.assert_allclose(np.asarray(out), _oracle(qs, vec[ids], metric),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("sq8", [False, True], ids=["f32", "sq8"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_make_distance_fn_matches_float64(sq8, metric):
    """The hop's distance closure: masked ids score row 0 (the caller
    discards them), valid ids score their own row — exact f32 and sq8."""
    vec, ids, qs, (off, sc) = _table(96, sq8=sq8)
    dequant = (jnp.asarray(off), jnp.asarray(sc)) if sq8 else None
    mask = np.random.default_rng(5).random(ids.shape) < 0.8
    fn = _make_distance_fn(jnp.asarray(vec), None, jnp.asarray(qs), metric,
                           dequant=dequant)
    out = np.asarray(fn(jnp.asarray(ids), jnp.asarray(mask)))
    rows = vec[np.where(mask, ids, 0)].astype(np.float32)
    if sq8:
        rows = off + sc * rows
    np.testing.assert_allclose(out, _oracle(qs, rows, metric),
                               rtol=RTOL, atol=ATOL)

