"""vacuum() — physical removal of tombstoned nodes from routing
(ops/vacuum.py), and compacted() — the renumbering rebuild (faiss
remove_ids semantics). No upstream faiss equivalent (faiss-HNSW has no
deletion; reference /root/reference/README.md:2); hnswlib's deletion
repair is the behavioral model."""

import numpy as np
import pytest

import hnsw_jax
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k

from conftest import exact_knn


def _built(n=3000, d=24, m=8, metric="l2", seed=7, **kw):
    wl = synthetic_workload(n, d, n_queries=128, metric=metric, seed=seed)
    idx = hnsw_jax.HnswIndex(d, m, metric, capacity=n + 512,
                             ef_construction=80, **kw)
    idx.add(wl.base)
    return idx, wl


def test_vacuum_noop_without_deletions():
    idx, _ = _built(n=800)
    before = np.asarray(idx.graph.neighbors0)
    assert idx.vacuum() == 0
    np.testing.assert_array_equal(np.asarray(idx.graph.neighbors0), before)


def test_vacuum_removes_dead_from_routing():
    idx, wl = _built(n=3000)
    rng = np.random.default_rng(0)
    dead_ids = rng.choice(3000, 600, replace=False)
    idx.remove_ids(dead_ids)
    assert not idx._routing_clean
    assert idx.vacuum() == 600
    assert idx._routing_clean
    # no live row references a dead id; dead rows are cleared
    chk = idx.check(strict=True)
    assert chk["links_to_dead"] == 0
    nbr0 = np.asarray(idx.graph.neighbors0)[:3000]
    assert (nbr0[dead_ids] == -1).all()
    # entry point is live
    assert bool(np.asarray(idx._alive)[int(idx.graph.entry_point)])
    # searches (now UNFILTERED routing) never return dead ids, and recall
    # vs the live-only ground truth holds
    alive = np.ones(3000, bool)
    alive[dead_ids] = False
    base = np.asarray(wl.base)
    live_ids = np.flatnonzero(alive)
    _, gt_l = exact_knn(base[live_ids], wl.queries, 10, "l2")
    gt_live = live_ids[gt_l]
    d, i = idx.search(wl.queries, 10, ef_search=96)
    v = i[i >= 0]
    assert alive[v].all(), "vacuumed search returned a dead id"
    assert recall_at_k(i, gt_live, 10) >= 0.9


def test_vacuum_recall_matches_filtered_search():
    """Vacuumed routing must not be materially worse than tombstone
    filtering (the repair re-prunes with the same heuristic)."""
    idx, wl = _built(n=2500)
    rng = np.random.default_rng(3)
    dead_ids = rng.choice(2500, 500, replace=False)
    idx.remove_ids(dead_ids)
    _, i_f = idx.search(wl.queries, 10, ef_search=96)   # filtered
    idx.vacuum()
    _, i_v = idx.search(wl.queries, 10, ef_search=96)   # routed-clean
    alive = np.ones(2500, bool)
    alive[dead_ids] = False
    live_ids = np.flatnonzero(alive)
    _, gt_l = exact_knn(np.asarray(wl.base)[live_ids], wl.queries, 10, "l2")
    gt_live = live_ids[gt_l]
    r_f = recall_at_k(i_f, gt_live, 10)
    r_v = recall_at_k(i_v, gt_live, 10)
    assert r_v >= r_f - 0.02, (r_v, r_f)


def test_vacuum_then_add_stays_clean():
    idx, wl = _built(n=1500)
    idx.remove_ids(np.arange(100))
    idx.vacuum()
    idx.add(np.asarray(wl.base[:64], np.float32) + 0.01)
    _, i = idx.search(wl.queries, 10, ef_search=64)
    v = i[i >= 0]
    assert (v >= 100).all(), "new links resurrected a dead id"
    assert idx.check(strict=True)["links_to_dead"] == 0


def test_vacuum_all_deleted():
    idx, wl = _built(n=600)
    idx.remove_ids(np.arange(600))
    idx.vacuum()
    assert int(idx.graph.entry_point) == -1
    d, i = idx.search(wl.queries[:8], 5)
    assert (i == -1).all() and np.isinf(d).all()
    idx.check(strict=True)  # all-dead graph is structurally legal


def test_vacuum_save_load_roundtrip(tmp_path):
    idx, wl = _built(n=1200)
    idx.remove_ids(np.arange(0, 1200, 5))
    idx.vacuum()
    d1, i1 = idx.search(wl.queries[:32], 5, ef_search=64)
    p = str(tmp_path / "v.npz")
    idx.save(p)
    idx2 = hnsw_jax.HnswIndex.load(p)
    assert idx2._routing_clean
    d2, i2 = idx2.search(wl.queries[:32], 5, ef_search=64)
    np.testing.assert_array_equal(i1, i2)
    # and a PRE-vacuum save keeps filtering after reload
    idx3, _ = _built(n=400, seed=9)
    idx3.remove_ids(np.arange(50))
    p3 = str(tmp_path / "pre.npz")
    idx3.save(p3)
    idx4 = hnsw_jax.HnswIndex.load(p3)
    assert not idx4._routing_clean
    _, i4 = idx4.search(wl.queries[:16], 5, ef_search=64)
    assert (i4[i4 >= 0] >= 50).all()


def test_vacuum_sq8_storage():
    wl = synthetic_workload(1500, 16, n_queries=64, metric="l2", seed=5)
    idx = hnsw_jax.HnswIndex(16, 8, "l2", capacity=2048, dtype="sq8",
                             ef_construction=60)
    idx.train(wl.base)
    idx.add(wl.base)
    idx.remove_ids(np.arange(0, 1500, 4))
    idx.vacuum()
    assert idx.check(strict=True)["links_to_dead"] == 0
    _, i = idx.search(wl.queries, 5, ef_search=64)
    assert (i[i >= 0] % 4 != 0).all()


def test_compacted_renumbers():
    idx, wl = _built(n=1000)
    dead = np.arange(0, 1000, 3)
    idx.remove_ids(dead)
    new, old_ids = idx.compacted(np.asarray(wl.base, np.float32))
    assert new.ntotal == len(old_ids) == 1000 - len(dead)
    assert (old_ids % 3 != 0).all()
    # new index returns renumbered ids that map back to live originals
    _, i_new = new.search(wl.queries, 5, ef_search=64)
    mapped = old_ids[i_new[i_new >= 0]]
    assert (mapped % 3 != 0).all()
    # quality: recall vs live-only GT
    alive = np.ones(1000, bool)
    alive[dead] = False
    live_ids = np.flatnonzero(alive)
    _, gt_l = exact_knn(np.asarray(wl.base)[live_ids], wl.queries, 5, "l2")
    gt_live = live_ids[gt_l]
    full = old_ids[np.maximum(i_new, 0)]
    full[i_new < 0] = -1
    assert recall_at_k(full, gt_live, 5) >= 0.9


def test_sharded_vacuum():
    """ShardedHnswIndex.vacuum: one shard_map program patches every shard;
    unfiltered fan-out searches never return dead ids afterwards."""
    from hnsw_jax.parallel.sharded import ShardedHnswIndex, make_mesh

    wl = synthetic_workload(4000, 16, n_queries=96, metric="l2", seed=17)
    idx = ShardedHnswIndex(16, 8, "l2", mesh=make_mesh(4),
                           capacity_per_shard=2048, ef_construction=60)
    idx.add(wl.base)
    rng = np.random.default_rng(1)
    dead_ids = rng.choice(4000, 800, replace=False)
    idx.remove_ids(dead_ids)
    assert not idx._routing_clean
    assert idx.vacuum() == 800
    assert idx._routing_clean
    # per-shard invariants hold with the alive-aware checker, and no live
    # row references a dead id on any shard
    for chk in idx.check(strict=True):
        assert chk.get("links_to_dead", 0) == 0
    alive = np.ones(4000, bool)
    alive[dead_ids] = False
    d, i = idx.search(wl.queries, 10, ef_search=96)
    v = i[i >= 0]
    assert alive[v].all(), "sharded vacuum returned a dead id"
    live_ids = np.flatnonzero(alive)
    _, gt_l = exact_knn(np.asarray(wl.base)[live_ids], wl.queries, 10, "l2")
    gt_live = live_ids[gt_l]
    assert recall_at_k(i, gt_live, 10) >= 0.85


def test_sharded_vacuum_save_load(tmp_path):
    from hnsw_jax.parallel.sharded import ShardedHnswIndex, make_mesh

    wl = synthetic_workload(1200, 16, n_queries=32, metric="l2", seed=23)
    idx = ShardedHnswIndex(16, 8, "l2", mesh=make_mesh(4),
                           capacity_per_shard=1024, ef_construction=60)
    idx.add(wl.base)
    idx.remove_ids(np.arange(0, 1200, 5))
    # PRE-vacuum save keeps filtering after reload
    p = str(tmp_path / "pre.npz")
    idx.save(p)
    idx2 = ShardedHnswIndex.load(p, mesh=make_mesh(4))
    assert not idx2._routing_clean
    _, i2 = idx2.search(wl.queries, 5, ef_search=64)
    assert (i2[i2 >= 0] % 5 != 0).all()
    # post-vacuum save keeps the clean flag
    idx.vacuum()
    p2 = str(tmp_path / "post.npz")
    idx.save(p2)
    idx3 = ShardedHnswIndex.load(p2, mesh=make_mesh(4))
    assert idx3._routing_clean
    _, i3 = idx3.search(wl.queries, 5, ef_search=64)
    assert (i3[i3 >= 0] % 5 != 0).all()


def test_vacuum_invalidates_packed():
    idx, wl = _built(n=1200)
    idx.enable_packed()
    idx.remove_ids(np.arange(64))
    idx.vacuum()
    assert not idx.packed_enabled
    idx.enable_packed()
    _, i = idx.search(wl.queries, 5, ef_search=64)
    assert (i[i >= 0] >= 64).all()
