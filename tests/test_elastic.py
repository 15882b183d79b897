"""Failure detection / elastic recovery for the sharded index (SURVEY.md §5
failure-detection row): per-shard health probing, degraded-mode serving over
the surviving shards, checkpointed build resume, and shard restore from a
checkpoint. Fault model per parallel/sharded.py: per-shard STATE corruption
or operator-declared outage (a device loss kills the process on a single
host; multi-host re-meshes then uses the same restore flow).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from hnsw_jax.parallel.sharded import ShardedHnswIndex, make_mesh
from hnsw_jax.utils.datasets import synthetic_workload

from conftest import exact_knn


def _build(n=2000, d=16, seed=71, n_shards=4):
    mesh = make_mesh(n_shards=n_shards, q_parallel=2)
    wl = synthetic_workload(n, d, n_queries=64, metric="l2", seed=seed)
    idx = ShardedHnswIndex(d, 8, "l2", mesh=mesh, capacity_per_shard=1024,
                           ef_construction=60, seed=29)
    idx.add(wl.base)
    return idx, wl


def test_healthy_by_default():
    idx, _ = _build(n=400)
    assert idx.failed_shards == []
    report = idx.health_check()
    assert all(r["ok"] for r in report), report


def test_mark_failed_degrades_then_recovers():
    idx, wl = _build()
    q = wl.queries
    d_full, i_full = idx.search(q, k=10, ef_search=64)

    idx.mark_shard_failed(1)
    assert idx.failed_shards == [1]
    d_deg, i_deg = idx.search(q, k=10, ef_search=64)
    # round-robin assignment: shard 1 owns user ids ≡ 1 (mod 4) — none may
    # appear while it is down, and the survivors must still answer
    live = i_deg[i_deg >= 0]
    assert live.size > 0
    assert not (live % 4 == 1).any()
    # degraded recall vs exact k-NN over the surviving shards' points
    # (original ids remapped into the alive-only id space)
    alive_ids = np.flatnonzero(np.arange(idx.ntotal) % 4 != 1)
    _, gt_alive = exact_knn(np.asarray(wl.base)[alive_ids], q, 10, "l2")
    from hnsw_jax.utils.recall import recall_at_k
    remap = -np.ones(idx.ntotal, np.int64)
    remap[alive_ids] = np.arange(len(alive_ids))
    i_deg_r = np.where(i_deg >= 0, remap[np.maximum(i_deg, 0)], -1)
    r = recall_at_k(i_deg_r, gt_alive, 10)
    assert r >= 0.9, r

    idx.mark_shard_ok(1)
    d_back, i_back = idx.search(q, k=10, ef_search=64)
    np.testing.assert_array_equal(i_back, i_full)
    np.testing.assert_allclose(d_back, d_full)


def test_health_check_detects_corruption_and_restore_recovers(tmp_path):
    idx, wl = _build(seed=73)
    q = wl.queries
    d_full, i_full = idx.search(q, k=10, ef_search=64)
    p = str(tmp_path / "ckpt.npz")
    idx.save(p)

    # inject: NaN the whole vector table of shard 2 (a torn restore / bad
    # DMA analogue) — the self-query probe must fail for exactly that shard
    idx._vectors = idx._vectors.at[2].set(jnp.nan)
    report = idx.health_check()
    assert [r["shard"] for r in report if not r["ok"]] == [2], report
    assert idx.failed_shards == [2]

    # serving continues without shard 2's ids
    _, i_deg = idx.search(q, k=10, ef_search=64)
    live = i_deg[i_deg >= 0]
    assert live.size > 0 and not (live % 4 == 2).any()

    # restore just the failed shard from the checkpoint -> full recovery,
    # bit-identical to the pre-corruption results
    assert idx.restore_shards(p) == [2]
    assert idx.failed_shards == []
    assert all(r["ok"] for r in idx.health_check())
    d_back, i_back = idx.search(q, k=10, ef_search=64)
    np.testing.assert_array_equal(i_back, i_full)
    np.testing.assert_allclose(d_back, d_full)


def test_health_check_detects_bad_entry_point():
    idx, _ = _build(n=400, seed=77)
    idx._host_scalars()["entry"][0] = -3
    report = idx.health_check(auto_mark=False)
    assert not report[0]["ok"]
    assert "entry_point" in report[0]["errors"][0]
    assert idx.failed_shards == []  # auto_mark=False left serving alone


def test_checkpointed_build_resume_is_bit_identical(tmp_path):
    mesh = make_mesh(n_shards=4, q_parallel=2)
    wl = synthetic_workload(1600, 16, n_queries=48, metric="l2", seed=79)
    h1, h2 = np.asarray(wl.base[:800]), np.asarray(wl.base[800:])

    a = ShardedHnswIndex(16, 8, "l2", mesh=mesh, capacity_per_shard=1024,
                         ef_construction=60, seed=37)
    a.add(h1)
    a.add(h2)

    b = ShardedHnswIndex(16, 8, "l2", mesh=mesh, capacity_per_shard=1024,
                         ef_construction=60, seed=37)
    b.add(h1)
    p = str(tmp_path / "mid.npz")
    b.save(p)  # mid-build checkpoint (RNG state + scalars ride along)
    c = ShardedHnswIndex.load(p, mesh=mesh)
    c.add(h2)

    da, ia = a.search(wl.queries, k=10, ef_search=64)
    dc, ic = c.search(wl.queries, k=10, ef_search=64)
    np.testing.assert_array_equal(ia, ic)
    np.testing.assert_allclose(da, dc)


def test_restore_rejects_mismatched_checkpoint(tmp_path):
    idx, _ = _build(n=400, seed=81)
    other = ShardedHnswIndex(16, 16, "l2", mesh=idx.mesh,
                             capacity_per_shard=1024, seed=5)
    rng = np.random.default_rng(0)
    other.add(rng.normal(size=(64, 16)).astype(np.float32))
    p = str(tmp_path / "other.npz")
    other.save(p)
    idx.mark_shard_failed(0)
    with pytest.raises(ValueError, match="config"):
        idx.restore_shards(p)
