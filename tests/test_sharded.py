"""Sharded build + query fan-out/merge (C14) on the faked 8-device CPU mesh
(SURVEY.md §4 item 5)."""

import numpy as np
import pytest
import jax

from hnsw_jax.parallel.sharded import ShardedHnswIndex, make_mesh
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k

from conftest import exact_knn


@pytest.fixture(scope="module")
def sharded_built():
    mesh = make_mesh(n_shards=4, q_parallel=2)
    wl = synthetic_workload(4000, 16, n_queries=128, metric="l2", seed=31)
    idx = ShardedHnswIndex(16, 8, "l2", mesh=mesh, capacity_per_shard=2048,
                           ef_construction=60, seed=17)
    idx.add(wl.base)
    return idx, wl


def test_mesh_shapes():
    mesh = make_mesh(n_shards=4, q_parallel=2)
    assert mesh.shape == {"shard": 4, "q": 2}
    assert len(jax.devices()) == 8


def test_sharded_recall(sharded_built):
    idx, wl = sharded_built
    assert idx.ntotal == 4000
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    d, i = idx.search(wl.queries, k=10, ef_search=64)
    r = recall_at_k(i, gt, 10)
    # 4 sub-indexes of 1k each, global merge: recall should match or beat a
    # single index (each shard is easier to search exhaustively)
    assert r >= 0.95, r


def test_user_ids_are_insertion_order(sharded_built):
    idx, wl = sharded_built
    # self-query: every database point must find itself under its USER id
    d, i = idx.search(wl.base[:64], k=1, ef_search=32)
    assert (i[:, 0] == np.arange(64)).mean() > 0.95
    assert (d[:, 0] < 1e-3).mean() > 0.95


def test_results_sorted_and_unique(sharded_built):
    idx, wl = sharded_built
    d, i = idx.search(wl.queries[:32], k=10)
    assert (np.diff(d, axis=1) >= -1e-6).all()  # ascending merge
    for row in i:
        vals = row[row >= 0]
        assert len(set(vals.tolist())) == len(vals)  # shards are disjoint


def test_query_padding(sharded_built):
    idx, wl = sharded_built
    # query count not divisible by the q axis (2): padding must be invisible
    d, i = idx.search(wl.queries[:7], k=5)
    assert i.shape == (7, 5)
    d2, i2 = idx.search(wl.queries[:8], k=5)
    assert (i == i2[:7]).all()


def test_empty_and_errors():
    mesh = make_mesh(n_shards=4, q_parallel=2)
    idx = ShardedHnswIndex(8, 4, mesh=mesh, capacity_per_shard=64)
    d, i = idx.search(np.zeros((3, 8), np.float32), k=2)
    assert (i == -1).all()
    with pytest.raises(ValueError, match="expected"):
        idx.add(np.zeros((4, 9), np.float32))


def test_sharded_save_load(tmp_path, sharded_built):
    idx, wl = sharded_built
    d1, i1 = idx.search(wl.queries[:32], k=5)
    p = str(tmp_path / "sharded.npz")
    idx.save(p)
    from hnsw_jax.parallel.sharded import ShardedHnswIndex
    idx2 = ShardedHnswIndex.load(p, mesh=idx.mesh)
    assert idx2.ntotal == idx.ntotal
    d2, i2 = idx2.search(wl.queries[:32], k=5)
    assert (i1 == i2).all()
    import numpy as np
    np.testing.assert_array_equal(d1, d2)
    # resumed adds keep working
    import numpy as _np
    extra = _np.asarray(wl.base[:8], _np.float32) + 0.01
    idx2.add(extra)
    assert idx2.ntotal == idx.ntotal + 8


def test_sharded_invariants(sharded_built):
    idx, _ = sharded_built
    for st in idx.check():
        assert st["errors"] == []


@pytest.mark.slow  # compile-heavy standalone build; path covered by the fast representatives + dryrun
def test_sharded_ip_metric():
    """The sharded test matrix mirrors the single-chip one:
    inner-product metric through build, fan-out, and merge."""
    mesh = make_mesh(n_shards=4, q_parallel=2)
    wl = synthetic_workload(3000, 16, n_queries=96, metric="ip", seed=53)
    idx = ShardedHnswIndex(16, 8, "ip", mesh=mesh, capacity_per_shard=1024,
                           ef_construction=60, seed=19)
    idx.add(wl.base)
    _, gt = exact_knn(wl.base, wl.queries, 10, "ip")
    _, i = idx.search(wl.queries, k=10, ef_search=64)
    r = recall_at_k(i, gt, 10)
    assert r >= 0.93, r


def test_sharded_deletion_and_filtering(sharded_built):
    idx, wl = sharded_built
    _, gt = exact_knn(wl.base, wl.queries, 1, "l2")
    victims = np.unique(gt[:, 0])[:20]
    removed_before = idx.n_deleted
    assert idx.remove_ids(victims) == len(victims)
    assert idx.n_deleted == removed_before + len(victims)
    _, i = idx.search(wl.queries, k=10, ef_search=64)
    assert not np.isin(i, victims).any()

    # user filter composes with tombstones; both are USER-id space
    allowed = np.zeros(idx.ntotal, bool)
    allowed[:500] = True
    allowed[victims] = True  # tombstones must still win
    _, fi = idx.search(wl.queries[:32], k=5, ef_search=128, allowed=allowed)
    valid = fi[fi >= 0]
    assert (valid < 500).all()
    assert not np.isin(valid, victims).any()

    # int whitelist form
    _, wi = idx.search(wl.queries[:8], k=5, ef_search=128,
                       allowed=np.arange(100, 200))
    wv = wi[wi >= 0]
    assert ((wv >= 100) & (wv < 200)).all()

    # out-of-range removal raises
    with pytest.raises(IndexError):
        idx.remove_ids(np.asarray([idx.ntotal]))


def test_sharded_deletion_survives_save_load(tmp_path, sharded_built):
    idx, wl = sharded_built
    p = str(tmp_path / "sharded_del.npz")
    idx.save(p)
    idx2 = ShardedHnswIndex.load(p, mesh=idx.mesh)
    assert idx2.n_deleted == idx.n_deleted
    if idx.n_deleted:
        removed = np.flatnonzero(idx._removed)
        _, i = idx2.search(wl.queries[:16], k=10, ef_search=64)
        assert not np.isin(i, removed).any()


@pytest.mark.slow  # compile-heavy standalone build; path covered by the fast representatives + dryrun
def test_uneven_shard_counts():
    """A shard count that does not divide the device count or the point
    count: 3 shards on the 8-device host, 1000 points (334/333/333)."""
    mesh = make_mesh(n_shards=3, q_parallel=1)
    assert mesh.shape == {"shard": 3, "q": 1}
    wl = synthetic_workload(1000, 12, n_queries=64, metric="l2", seed=59)
    idx = ShardedHnswIndex(12, 8, "l2", mesh=mesh, capacity_per_shard=512,
                           ef_construction=60, seed=23)
    idx.add(wl.base)
    assert idx.ntotal == 1000
    assert sorted(idx._counts.tolist()) == [333, 333, 334]
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    _, i = idx.search(wl.queries, k=10, ef_search=64)
    assert recall_at_k(i, gt, 10) >= 0.95
    for st in idx.check():
        assert st["errors"] == []


@pytest.mark.slow  # compile-heavy standalone build; path covered by the fast representatives + dryrun
def test_sharded_sq8_storage(tmp_path):
    """sq8 storage composes with the sharded build/search (one shared
    quantizer across shards, models/hnsw.py semantics)."""
    mesh = make_mesh(n_shards=4, q_parallel=2)
    wl = synthetic_workload(2000, 16, n_queries=64, metric="l2", seed=61)
    idx = ShardedHnswIndex(16, 8, "l2", mesh=mesh, capacity_per_shard=1024,
                           ef_construction=60, seed=11, dtype="sq8")
    assert not idx.is_trained
    with pytest.raises(RuntimeError, match="train"):
        idx.add(wl.base)
    idx.train(wl.base)
    idx.add(wl.base)
    assert str(idx._vectors.dtype) == "uint8"
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    d, i = idx.search(wl.queries, k=10, ef_search=64)
    r = recall_at_k(i, gt, 10)
    assert r >= 0.9, r
    # health probe understands code storage
    assert all(s["ok"] for s in idx.health_check())
    # save/load keeps params + codes
    p = str(tmp_path / "sq_sharded.npz")
    idx.save(p)
    idx2 = ShardedHnswIndex.load(p, mesh=mesh)
    assert idx2.is_trained and str(idx2._vectors.dtype) == "uint8"
    d2, i2 = idx2.search(wl.queries, k=10, ef_search=64)
    np.testing.assert_array_equal(i, i2)
    np.testing.assert_allclose(d, d2, rtol=1e-5)


@pytest.mark.slow  # compile-heavy standalone build; path covered by the fast representatives + dryrun
def test_sharded_packed_serving():
    """enable_packed(): per-shard code tables built as one shard_map
    program; packed fan-out search matches unpacked recall (routing is
    quantized, extraction reranks exactly)."""
    mesh = make_mesh(n_shards=4, q_parallel=2)
    wl = synthetic_workload(4000, 16, n_queries=128, metric="l2", seed=67)
    idx = ShardedHnswIndex(16, 8, "l2", mesh=mesh, capacity_per_shard=2048,
                           ef_construction=60, seed=5)
    idx.add(wl.base)
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    d_u, i_u = idx.search(wl.queries, k=10, ef_search=96)
    r_u = recall_at_k(i_u, gt, 10)
    nb = idx.enable_packed(bits=8)
    assert idx.packed_enabled
    # table rows sized by the max shard count, stacked over shards
    assert idx._packed.nbr_codes.shape[0] == 4
    assert nb > 0
    d_p, i_p = idx.search(wl.queries, k=10, ef_search=96)
    r_p = recall_at_k(i_p, gt, 10)
    assert r_p >= r_u - 0.02, (r_p, r_u)
    # extraction reranks exactly: distances of agreeing ids match unpacked
    match = i_p == i_u
    np.testing.assert_allclose(np.asarray(d_p)[match],
                               np.asarray(d_u)[match], rtol=1e-4, atol=1e-4)
    # composes with deletion tombstones (filtered results, packed routing)
    idx.remove_ids(np.arange(0, 4000, 7))
    _, i_f = idx.search(wl.queries, k=10, ef_search=96)
    v = i_f[i_f >= 0]
    assert (v % 7 != 0).all()
    # add() drops the tables (documented v1 scope) but search still works
    idx2 = ShardedHnswIndex(16, 8, "l2", mesh=mesh, capacity_per_shard=2048,
                            ef_construction=60, seed=5)
    idx2.add(wl.base[:2000])
    idx2.enable_packed()
    idx2.add(wl.base[2000:])
    assert not idx2.packed_enabled
    _, i2 = idx2.search(wl.queries, k=10, ef_search=96)
    assert recall_at_k(i2, gt, 10) >= 0.9
    # vacuum() drops the tables too (rows bake the old adjacency)
    idx2.enable_packed()
    idx2.remove_ids(np.arange(100))
    idx2.vacuum()
    assert not idx2.packed_enabled


@pytest.mark.slow  # compile-heavy standalone build; path covered by the fast representatives + dryrun
def test_sharded_packed_sq8_and_4bit():
    """Packed rows over sq8 storage (stored codes ARE routing codes at
    8-bit) and 4-bit rows (half the bytes, coarser routing absorbed by
    ef)."""
    mesh = make_mesh(n_shards=4, q_parallel=2)
    wl = synthetic_workload(2000, 16, n_queries=64, metric="l2", seed=71)
    idx = ShardedHnswIndex(16, 8, "l2", mesh=mesh, capacity_per_shard=1024,
                           ef_construction=60, seed=9, dtype="sq8")
    idx.train(wl.base)
    idx.add(wl.base)
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    _, i_u = idx.search(wl.queries, k=10, ef_search=96)
    r_u = recall_at_k(i_u, gt, 10)
    idx.enable_packed(bits=8)
    _, i_p = idx.search(wl.queries, k=10, ef_search=96)
    assert recall_at_k(i_p, gt, 10) >= r_u - 0.02
    idx.disable_packed()
    idx.enable_packed(bits=4)
    assert idx._packed.nbr_codes.shape[2] == idx.config.m0 * 8  # 16/2 dims
    _, i_4 = idx.search(wl.queries, k=10, ef_search=192)
    assert recall_at_k(i_4, gt, 10) >= r_u - 0.05


@pytest.mark.slow  # compile-heavy standalone build; path covered by the fast representatives + dryrun
def test_sharded_composes_with_wrappers():
    """PreTransformIndex / IdMapIndex / Searcher wrap the sharded index
    like any other (faiss composability parity)."""
    from hnsw_jax import (IdMapIndex, NormalizationTransform,
                          PreTransformIndex, Searcher)

    mesh = make_mesh(n_shards=4, q_parallel=2)
    rng = np.random.default_rng(73)
    base = (rng.standard_normal((2000, 16)) *
            rng.uniform(0.1, 5.0, (2000, 1))).astype(np.float32)
    queries = rng.standard_normal((64, 16)).astype(np.float32)

    # cosine via L2norm + IP over the mesh
    inner = ShardedHnswIndex(16, 8, "ip", mesh=mesh,
                             capacity_per_shard=1024, ef_construction=60)
    idx = PreTransformIndex(NormalizationTransform(16), inner)
    idx.train(base)
    idx.add(base)
    _, i = idx.search(queries, 10, ef_search=96)
    cos = (queries / np.linalg.norm(queries, axis=1, keepdims=True)) @ \
        (base / np.linalg.norm(base, axis=1, keepdims=True)).T
    gt = np.argsort(-cos, axis=1)[:, :10]
    assert recall_at_k(np.asarray(i), gt, 10) >= 0.9

    # user-id mapping over the mesh
    inner2 = ShardedHnswIndex(16, 8, "l2", mesh=mesh,
                              capacity_per_shard=1024, ef_construction=60)
    im = IdMapIndex(inner2)
    ids = np.arange(2000) * 10 + 7
    im.add_with_ids(base, ids)
    _, mi = im.search(base[:4], 1, ef_search=32)
    np.testing.assert_array_equal(mi[:, 0], ids[:4])

    # micro-batching front-end over the mesh
    s = Searcher(inner2, k=5, ef_search=64, min_bucket=64)
    d, i = s.search(base[:3])
    assert i.shape == (3, 5) and i[0, 0] == 0


def test_sharded_packed_words_layout_parity():
    """Per-shard packed tables in the int32 'words' layout must return
    results identical to the 'bytes' layout (same code values — ops/packed.py
    pack_words)."""
    mesh = make_mesh(n_shards=4, q_parallel=2)
    wl = synthetic_workload(3000, 16, n_queries=96, metric="l2", seed=68)
    idx = ShardedHnswIndex(16, 8, "l2", mesh=mesh, capacity_per_shard=1024,
                           ef_construction=60, seed=5)
    idx.add(wl.base)
    idx.enable_packed(bits=8, layout="bytes")
    assert str(idx._packed.nbr_codes.dtype) == "uint8"
    d_b, i_b = idx.search(wl.queries, k=10, ef_search=64)
    idx.enable_packed(bits=8, layout="words")
    assert str(idx._packed.nbr_codes.dtype) == "int32"
    d_w, i_w = idx.search(wl.queries, k=10, ef_search=64)
    np.testing.assert_array_equal(i_b, i_w)
    np.testing.assert_allclose(d_b, d_w, rtol=1e-5, atol=1e-5)
    # auto on the CPU mesh resolves to bytes
    idx.enable_packed(bits=8)
    assert str(idx._packed.nbr_codes.dtype) == "uint8"
