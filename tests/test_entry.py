"""Entry selection: sampled dense entry scan vs greedy descent.

``entry_mode="sample"`` (hnsw_jax.search._sample_seeds) replaces the faiss
greedy upper-level walk (SURVEY.md §3.1 hot loop #1) with dense matmul
scoring of a strided sample of the live prefix. These tests pin the semantics that make it a
drop-in: recall parity with the descent, correct masking of tombstoned /
vacuum-isolated nodes, and composition with every storage/serving mode.
"""
import numpy as np
import pytest

import hnsw_jax
from hnsw_jax.search import entry_sample_size
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k


@pytest.fixture(scope="module")
def wl():
    return synthetic_workload(4000, 32, n_queries=256, metric="l2", seed=7)


@pytest.fixture(scope="module")
def built(wl):
    idx = hnsw_jax.HnswIndex(32, 16, "l2", capacity=4096, ef_construction=60)
    idx.add(wl.base)
    flat = hnsw_jax.FlatIndex(32, "l2")
    flat.add(wl.base)
    _, gt = flat.search(wl.queries, 10)
    return idx, gt


def test_sample_size_static():
    assert entry_sample_size(1 << 20) == 32768
    assert entry_sample_size(1 << 26) == 32768   # clamped high
    assert entry_sample_size(4096) == 128
    assert entry_sample_size(100) == 128         # clamped low
    # power of two always (reshape into scan chunks relies on it)
    for cap in (1 << 20, 4096, 100, 12345, 777777):
        s = entry_sample_size(cap)
        assert s & (s - 1) == 0


def test_recall_parity_with_descend(built, wl):
    idx, gt = built
    _, i_s = idx.search(wl.queries, 10, ef_search=64, entry_mode="sample")
    _, i_d = idx.search(wl.queries, 10, ef_search=64, entry_mode="descend")
    r_s = recall_at_k(i_s, gt, 10)
    r_d = recall_at_k(i_d, gt, 10)
    assert r_s >= 0.95
    assert r_s >= r_d - 0.02, (r_s, r_d)


def test_sample_deterministic(built, wl):
    idx, _ = built
    d1, i1 = idx.search(wl.queries, 10, ef_search=64, entry_mode="sample")
    d2, i2 = idx.search(wl.queries, 10, ef_search=64, entry_mode="sample")
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)


def test_ip_metric_sample():
    wl = synthetic_workload(4000, 32, n_queries=128, metric="ip", seed=8)
    idx = hnsw_jax.HnswIndex(32, 16, "ip", capacity=4096, ef_construction=60)
    idx.add(wl.base)
    flat = hnsw_jax.FlatIndex(32, "ip")
    flat.add(wl.base)
    _, gt = flat.search(wl.queries, 10)
    _, i = idx.search(wl.queries, 10, ef_search=64, entry_mode="sample")
    assert recall_at_k(i, gt, 10) >= 0.93


def test_sample_with_packed(built, wl):
    idx, gt = built
    idx2 = hnsw_jax.HnswIndex(32, 16, "l2", capacity=4096,
                              ef_construction=60)
    idx2.add(wl.base)
    idx2.enable_packed(bits=8)
    _, i = idx2.search(wl.queries, 10, ef_search=64, entry_mode="sample")
    assert recall_at_k(i, gt, 10) >= 0.95


@pytest.mark.slow  # compile-heavy standalone build; path covered by the fast representatives + dryrun
def test_sample_with_sq8(wl):
    idx = hnsw_jax.HnswIndex(32, 16, "l2", capacity=4096,
                             ef_construction=60, dtype="sq8")
    idx.train(wl.base)
    idx.add(wl.base)
    flat = hnsw_jax.FlatIndex(32, "l2")
    flat.add(wl.base)
    _, gt = flat.search(wl.queries, 10)
    _, i = idx.search(wl.queries, 10, ef_search=64, entry_mode="sample")
    assert recall_at_k(i, gt, 10) >= 0.93


def test_tombstones_pre_vacuum(wl):
    idx = hnsw_jax.HnswIndex(32, 16, "l2", capacity=4096, ef_construction=60)
    idx.add(wl.base)
    dead = np.arange(0, 4000, 3)
    idx.remove_ids(dead)
    _, i = idx.search(wl.queries, 10, ef_search=64, entry_mode="sample")
    assert not np.isin(i[i >= 0], dead).any()


@pytest.mark.slow  # compile-heavy standalone build; path covered by the fast representatives + dryrun
def test_vacuum_isolated_nodes_never_entry(wl):
    """Post-vacuum, dead nodes keep their level but have cleared adjacency
    rows; a sampled entry landing there would strand the query with a
    one-id result. The non-isolated mask (neighbors0[:, 0] >= 0) must
    exclude them."""
    idx = hnsw_jax.HnswIndex(32, 16, "l2", capacity=4096, ef_construction=60)
    idx.add(wl.base)
    dead = np.arange(0, 4000, 3)
    idx.remove_ids(dead)
    idx.vacuum()
    _, i = idx.search(wl.queries, 10, ef_search=64, entry_mode="sample")
    assert not np.isin(i[i >= 0], dead).any()
    # every query keeps a full result set (nobody stranded on an island)
    assert (i >= 0).all()
    keep = np.setdiff1d(np.arange(4000), dead)
    flat = hnsw_jax.FlatIndex(32, "l2")
    flat.add(wl.base[keep])
    _, g2 = flat.search(wl.queries, 10)
    assert recall_at_k(i, keep[g2], 10) >= 0.95


def test_filtered_search_sample(built, wl):
    idx, _ = built
    allow = np.zeros(4096, bool)
    allow[np.arange(0, 4000, 2)] = True
    _, i = idx.search(wl.queries, 10, ef_search=96, allowed=allow,
                      entry_mode="sample")
    assert (np.asarray(i)[i >= 0] % 2 == 0).all()


def test_tiny_index_sample():
    idx = hnsw_jax.HnswIndex(8, 4, "l2", capacity=1024)
    x = np.eye(8, dtype=np.float32)[:3]
    idx.add(x)
    d, i = idx.search(x, 1, ef_search=16, entry_mode="sample")
    np.testing.assert_array_equal(i[:, 0], [0, 1, 2])
    assert np.allclose(d[:, 0], 0.0, atol=1e-5)


def test_seed_mode_recall_and_determinism(built, wl):
    """entry_mode='seed' re-scores stratified seeds and starts the beam
    from the best; recall must match sample-mode and runs must be
    deterministic."""
    idx, gt = built
    d1, i1 = idx.search(wl.queries, 10, ef_search=64, entry_mode="seed")
    d2, i2 = idx.search(wl.queries, 10, ef_search=64, entry_mode="seed")
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)
    assert recall_at_k(i1, gt, 10) >= 0.95


def test_seed_mode_fewer_hops_same_recall(built, wl):
    """At a tight hop cap, seeding reaches at least sample-mode recall."""
    idx, gt = built
    _, i_seed = idx.search(wl.queries, 10, ef_search=64, max_hops=12,
                           entry_mode="seed")
    _, i_samp = idx.search(wl.queries, 10, ef_search=64, max_hops=12,
                           entry_mode="sample")
    r_seed = recall_at_k(i_seed, gt, 10)
    r_samp = recall_at_k(i_samp, gt, 10)
    assert r_seed >= r_samp - 0.005, (r_seed, r_samp)


def test_seed_mode_packed(wl):
    idx = hnsw_jax.HnswIndex(32, 16, "l2", capacity=4096,
                             ef_construction=60)
    idx.add(wl.base)
    idx.enable_packed(bits=8)
    flat = hnsw_jax.FlatIndex(32, "l2")
    flat.add(wl.base)
    _, gt = flat.search(wl.queries, 10)
    _, i = idx.search(wl.queries, 10, ef_search=64, entry_mode="seed")
    assert recall_at_k(i, gt, 10) >= 0.95


def test_seed_mode_legacy_fallback(built, wl):
    """Filtered search with entry_mode='seed' starts from a single entry
    and honors the filter."""
    idx, _ = built
    allow = np.zeros(4096, bool)
    allow[np.arange(0, 4000, 2)] = True
    _, i = idx.search(wl.queries, 10, ef_search=96, allowed=allow,
                      entry_mode="seed")
    assert (np.asarray(i)[i >= 0] % 2 == 0).all()


@pytest.mark.slow  # compile-heavy standalone build; path covered by the fast representatives + dryrun
def test_seed_mode_vacuum(wl):
    """Seeds must never be vacuum-isolated nodes (cleared adjacency)."""
    idx = hnsw_jax.HnswIndex(32, 16, "l2", capacity=4096, ef_construction=60)
    idx.add(wl.base)
    dead = np.arange(0, 4000, 3)
    idx.remove_ids(dead)
    idx.vacuum()
    _, i = idx.search(wl.queries, 10, ef_search=64, entry_mode="seed")
    assert not np.isin(i[i >= 0], dead).any()
    assert (i >= 0).all()


@pytest.mark.slow  # compile-heavy standalone build; path covered by the fast representatives + dryrun
def test_pq_auto_keeps_descend(wl):
    """entry_mode='auto' on PQ storage resolves to the descent (dense ADC
    over the sample would cost more than it saves); explicit 'sample' on
    pq storage is also legal and falls back to descend inside the impl."""
    idx = hnsw_jax.HnswIndex(32, 16, "l2", capacity=4096,
                             ef_construction=60, dtype="pq", pq_m=8)
    idx.train(wl.base[:2000])
    idx.add(wl.base)
    d1, i1 = idx.search(wl.queries[:32], 10, ef_search=64)
    d2, i2 = idx.search(wl.queries[:32], 10, ef_search=64,
                        entry_mode="descend")
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_seed_mode_small_ef(built, wl):
    """ef_search below the seed count (ef=10 in the 32-wide bucket used to
    place 17 seed rows): recall must track sample mode at the same small
    ef."""
    idx, gt = built
    d_s, i_s = idx.search(wl.queries, 10, ef_search=10, entry_mode="seed")
    _, i_p = idx.search(wl.queries, 10, ef_search=10, entry_mode="sample")
    r_s = recall_at_k(i_s, gt, 10)
    r_p = recall_at_k(i_p, gt, 10)
    assert r_s >= r_p - 0.02, (r_s, r_p)
    # determinism unchanged
    d2, i2 = idx.search(wl.queries, 10, ef_search=10, entry_mode="seed")
    np.testing.assert_array_equal(i_s, i2)


def test_seed_dedup_sparse_index(wl):
    """ntotal < entry sample size: strided sampling repeats ids, so
    adjacent strata can emit the SAME seed — duplicates must be masked
    before the buffer init (search.py adjacent-dup mask).
    Functional check: tiny index, seed mode returns valid deduped ids."""
    idx = hnsw_jax.HnswIndex(32, 16, "l2", capacity=4096,
                             ef_construction=60)
    idx.add(wl.base[:50])   # far fewer than the 128-min sample
    d, i = idx.search(wl.base[:8], 10, ef_search=32, entry_mode="seed")
    np.testing.assert_array_equal(i[:, 0], np.arange(8))  # self-query
    for row in np.asarray(i):
        live = row[row >= 0]
        assert len(np.unique(live)) == len(live), row  # no dup results
