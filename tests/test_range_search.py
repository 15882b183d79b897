"""range_search — faiss ``IndexHNSW.range_search`` / ``IndexFlat.range_search``
capability parity (CSR lims/D/I output; L2 keeps d² < radius, IP keeps
dot > radius)."""

import numpy as np
import pytest

import hnsw_jax
from hnsw_jax.utils.datasets import synthetic_workload


@pytest.fixture(scope="module")
def wl():
    return synthetic_workload(2000, 16, n_queries=32, metric="l2", seed=91)


@pytest.fixture(scope="module")
def flat(wl):
    f = hnsw_jax.FlatIndex(16, "l2")
    f.add(wl.base)
    return f


@pytest.fixture(scope="module")
def hnsw(wl):
    h = hnsw_jax.HnswIndex(16, 8, "l2", capacity=2048, ef_construction=80)
    h.add(wl.base)
    return h


def _pick_radius(flat, q):
    # radius capturing ~5 neighbors per query on average
    d, _ = flat.search(q, 8)
    return float(np.median(d[:, 4]))


def test_flat_range_exact(flat, wl):
    q = np.asarray(wl.queries, np.float32)
    r = _pick_radius(flat, q)
    lims, D, I = flat.range_search(q, r)
    assert lims[0] == 0 and lims[-1] == len(D) == len(I)
    base = np.asarray(wl.base, np.float32)
    for qi in range(len(q)):
        d2 = ((q[qi] - base) ** 2).sum(1)
        want = set(np.flatnonzero(d2 < r))
        got = I[lims[qi]: lims[qi + 1]]
        assert set(got) == want
        got_d = D[lims[qi]: lims[qi + 1]]
        assert (np.diff(got_d) >= 0).all()          # best-first
        np.testing.assert_allclose(got_d, d2[got], rtol=1e-4, atol=1e-4)


def test_hnsw_range_tracks_exact(flat, hnsw, wl):
    q = np.asarray(wl.queries, np.float32)
    r = _pick_radius(flat, q)
    lims_e, _, I_e = flat.range_search(q, r)
    lims, D, I = hnsw.range_search(q, r, ef_search=64)
    assert (D < r).all()
    found = expected = 0
    for qi in range(len(q)):
        want = set(I_e[lims_e[qi]: lims_e[qi + 1]])
        got = set(I[lims[qi]: lims[qi + 1]])
        assert got <= set(range(2000))
        # every reported hit must genuinely be in range (no false positives)
        base = np.asarray(wl.base, np.float32)
        for g in got:
            assert ((q[qi] - base[g]) ** 2).sum() < r
        expected += len(want)
        found += len(want & got)
    assert found >= 0.95 * expected, (found, expected)


def test_ip_range_sign_convention():
    wl = synthetic_workload(1500, 16, n_queries=16, metric="ip", seed=93)
    q = np.asarray(wl.queries, np.float32)
    base = np.asarray(wl.base, np.float32)
    dots = q @ base.T
    r = float(np.median(np.sort(dots, axis=1)[:, -5]))  # ~5 hits/query

    f = hnsw_jax.FlatIndex(16, "ip")
    f.add(wl.base)
    lims, D, I = f.range_search(q, r)
    assert (D > r).all()
    for qi in range(len(q)):
        want = set(np.flatnonzero(dots[qi] > r))
        assert set(I[lims[qi]: lims[qi + 1]]) == want
        seg = D[lims[qi]: lims[qi + 1]]
        assert (np.diff(seg) <= 0).all()            # descending dot

    h = hnsw_jax.HnswIndex(16, 8, "ip", capacity=2048, ef_construction=80)
    h.add(wl.base)
    hl, hD, hI = h.range_search(q, r, ef_search=96)
    assert (hD > r).all()
    total_want = sum(len(set(np.flatnonzero(dots[qi] > r)))
                     for qi in range(len(q)))
    total_got = sum(len(set(hI[hl[qi]: hl[qi + 1]]) &
                        set(np.flatnonzero(dots[qi] > r)))
                    for qi in range(len(q)))
    assert total_got >= 0.9 * total_want
