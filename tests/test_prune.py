"""Vectorized select-neighbors heuristic vs the NumPy reference (SURVEY.md §4
item 1)."""

import numpy as np
import jax.numpy as jnp
import pytest

from hnsw_jax import HnswConfig, NumpyHnsw
from hnsw_jax.ops.prune import select_neighbors


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_numpy_reference(metric, seed):
    rng = np.random.default_rng(seed)
    B, C, d, m = 8, 24, 16, 6
    ref = NumpyHnsw(HnswConfig(dim=d, m=m, metric=metric, capacity=B * C))

    ids = rng.permutation(B * C)[: B * C].reshape(B, C).astype(np.int32)
    vecs = rng.normal(size=(B, C, d)).astype(np.float32)
    qs = rng.normal(size=(B, d)).astype(np.float32)
    if metric == "ip":
        dists = -np.einsum("bd,bcd->bc", qs, vecs)
    else:
        dists = ((vecs - qs[:, None, :]) ** 2).sum(-1)
    # random invalid slots
    invalid = rng.random((B, C)) < 0.2
    ids = np.where(invalid, -1, ids)

    kept, mask = select_neighbors(jnp.asarray(ids), jnp.asarray(dists),
                                  jnp.asarray(vecs), m=m, metric=metric)
    kept = np.asarray(kept)

    for b in range(B):
        # install candidate vectors into the reference's storage
        ref.vectors[:] = 0
        for c in range(C):
            if ids[b, c] >= 0:
                ref.vectors[ids[b, c]] = vecs[b, c]
        cand = [(float(dists[b, c]), int(ids[b, c]))
                for c in range(C) if ids[b, c] >= 0]
        expect = ref.select_neighbors(qs[b], cand, m)
        got = [x for x in kept[b].tolist() if x >= 0]
        assert got == expect, (b, got, expect)


def test_respects_m_and_padding():
    B, C, d = 4, 10, 8
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(B, C, d)).astype(np.float32)
    ids = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    dists = np.linalg.norm(vecs, axis=-1) ** 2
    kept, mask = select_neighbors(jnp.asarray(ids), jnp.asarray(dists),
                                  jnp.asarray(vecs), m=3)
    kept = np.asarray(kept)
    assert kept.shape == (B, 3)
    assert (np.asarray(mask).sum(1) <= 3).all()


def test_all_invalid():
    B, C, d = 2, 5, 4
    ids = np.full((B, C), -1, np.int32)
    kept, mask = select_neighbors(jnp.asarray(ids),
                                  jnp.zeros((B, C), np.float32),
                                  jnp.zeros((B, C, d), np.float32), m=2)
    assert (np.asarray(kept) == -1).all()
    assert not np.asarray(mask).any()
