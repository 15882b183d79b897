"""Word-packed (int32) packed-serving layout: pack/unpack round-trips,
bit-pattern parity with the uint8 bytes layout, routing distances from
words rows vs a NumPy oracle, and end-to-end search parity against the
bytes layout. The layout holds the same bits as the bytes layout in int32
words; enable_packed(layout="words") selects it explicitly."""

import numpy as np
import jax.numpy as jnp
import pytest

import hnsw_jax
from hnsw_jax.ops.packed import (
    make_packed_expand, pack_neighbors, pack_words, unpack_nibbles,
    unpack_words, word_width,
)
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k


# ---------------------------------------------------------------------------
# word packing primitives
# ---------------------------------------------------------------------------

def test_word_width_table():
    assert word_width(128, 8) == 32      # SIFT: 32 words, zero pad
    assert word_width(128, 4) == 16
    assert word_width(96, 8) == 32       # 24 -> padded to divisor of 128
    assert word_width(100, 8) == 32
    assert word_width(64, 8) == 16
    assert word_width(24, 8) == 8        # ceil(24/4)=6 -> 8
    assert word_width(960, 8) == 0       # 240 words > 128: unsupported
    assert word_width(960, 4) == 128


@pytest.mark.parametrize("d,bits", [(128, 8), (128, 4), (100, 8), (24, 8),
                                    (17, 4)])
def test_pack_words_roundtrip(d, bits):
    rng = np.random.default_rng(d * 10 + bits)
    vals = rng.integers(0, 1 << bits, size=(37, d), dtype=np.uint8)
    # force the wrap-sensitive case: high byte/nibble >= half range
    vals[0, :] = (1 << bits) - 1
    words = pack_words(jnp.asarray(vals), bits)
    assert words.dtype == jnp.int32
    assert words.shape == (37, word_width(d, bits))
    back = unpack_words(words, bits, d)
    np.testing.assert_array_equal(np.asarray(back), vals)


def test_pack_words_bit_pattern_matches_bytes_layout():
    """The words table holds EXACTLY the bytes-layout bit pattern (values
    little-endian within each word), so a host-side byte view reproduces
    the u8 rows — the contract that lets the two layouts share tests,
    canaries, and quantization params."""
    rng = np.random.default_rng(7)
    d = 128
    vals = rng.integers(0, 256, size=(11, d), dtype=np.uint8)
    words = np.asarray(pack_words(jnp.asarray(vals), 8))
    view = words.view("<u1").reshape(11, -1)[:, :d]  # little-endian bytes
    np.testing.assert_array_equal(view, vals)


# ---------------------------------------------------------------------------
# routing distances from words rows vs unpack_words + NumPy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,bits,k", [(128, 8, 64), (128, 8, 16),
                                      (64, 8, 16), (100, 8, 64),
                                      (128, 4, 64), (24, 8, 16)])
def test_words_routing_dist_matches_numpy(d, bits, k):
    """make_packed_expand on a words table: the rows unpack (unpack_words)
    to exactly the stored code values, and the routing distances match a
    float64 NumPy oracle over those values."""
    from test_packed import _packed_rows, routing_oracle
    rng = np.random.default_rng(d + bits + k)
    q = 64
    vals = rng.integers(0, 1 << bits, size=(q, k, d), dtype=np.uint8)
    qs = rng.normal(size=(q, d)).astype(np.float32)
    scale = rng.uniform(0.01, 0.1, size=(d,)).astype(np.float32)
    sq = rng.uniform(1, 10, size=(q, k)).astype(np.float32)
    packed, nbr0 = _packed_rows(vals, bits, scale, sq, layout="words")
    assert packed.layout == "words" and packed.bits_for(d, k) == bits
    wp = word_width(d, bits)
    back = unpack_words(packed.nbr_codes.reshape(q, k, wp), bits, d)
    np.testing.assert_array_equal(np.asarray(back), vals)
    expand, _ = make_packed_expand(packed, nbr0, jnp.asarray(qs), "l2")
    _, dist = expand(jnp.arange(q, dtype=jnp.int32)[:, None],
                     jnp.ones((q, 1), bool))
    np.testing.assert_allclose(np.asarray(dist),
                               routing_oracle(qs, vals, scale, sq, "l2"),
                               rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# table construction parity with the bytes layout
# ---------------------------------------------------------------------------

def _small_index(n=3000, d=24, m=8, metric="l2", seed=11):
    wl = synthetic_workload(n, d, n_queries=256, metric=metric, seed=seed)
    idx = hnsw_jax.HnswIndex(d, m, metric, capacity=4096, ef_construction=80)
    idx.add(wl.base)
    return idx, wl


@pytest.mark.parametrize("bits", [8, 4])
def test_pack_neighbors_words_matches_bytes(bits):
    idx, _ = _small_index(n=800, d=24)
    g = idx._graph
    pb = pack_neighbors(g.neighbors0, idx._vectors, g.levels, bits=bits,
                        n_rows=idx.ntotal, layout="bytes")
    pw = pack_neighbors(g.neighbors0, idx._vectors, g.levels, bits=bits,
                        n_rows=idx.ntotal, layout="words")
    assert pb.layout == "bytes" and pw.layout == "words"
    assert pw.bits_for(24, g.neighbors0.shape[1]) == bits
    m0 = g.neighbors0.shape[1]
    wp = word_width(24, bits)
    n = idx.ntotal
    wc = unpack_words(pw.nbr_codes[:n].reshape(n, m0, wp), bits, 24)
    if bits == 8:
        bc = np.asarray(pb.nbr_codes[:n]).reshape(n, m0, 24)
    else:
        bc = np.asarray(unpack_nibbles(
            pb.nbr_codes[:n].reshape(n, m0, -1), 24))
    np.testing.assert_array_equal(np.asarray(wc), bc)
    np.testing.assert_array_equal(np.asarray(pw.nbr_sq), np.asarray(pb.nbr_sq))
    np.testing.assert_array_equal(np.asarray(pw.scale), np.asarray(pb.scale))


def test_make_packed_expand_words_fallback_parity():
    """The words layout's unpack+einsum distances must match the bytes
    layout's to f32 tolerance (identical code values, different unpack)."""
    idx, wl = _small_index(n=800, d=24)
    g = idx._graph
    q = jnp.asarray(wl.queries[:64])
    pb = pack_neighbors(g.neighbors0, idx._vectors, g.levels, bits=8,
                        n_rows=idx.ntotal, layout="bytes")
    pw = pack_neighbors(g.neighbors0, idx._vectors, g.levels, bits=8,
                        n_rows=idx.ntotal, layout="words")
    cur = jnp.asarray(np.random.default_rng(0).integers(
        0, idx.ntotal, (64, 1)).astype(np.int32))
    ok = jnp.ones((64, 1), bool)
    eb, _ = make_packed_expand(pb, g.neighbors0, q, "l2")
    ew, _ = make_packed_expand(pw, g.neighbors0, q, "l2")
    nb, db_ = eb(cur, ok)
    nw, dw = ew(cur, ok)
    np.testing.assert_array_equal(np.asarray(nb), np.asarray(nw))
    np.testing.assert_allclose(np.asarray(dw), np.asarray(db_),
                               rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# end-to-end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_words_layout_search_parity(metric):
    """enable_packed(layout='words') end-to-end through the beam vs the
    bytes layout on the same index."""
    idx, wl = _small_index(metric=metric)
    flat = hnsw_jax.FlatIndex(wl.base.shape[1], metric)
    flat.add(wl.base)
    _, gt = flat.search(wl.queries, 10)

    idx.enable_packed(bits=8, layout="bytes")
    db_, ib = idx.search(wl.queries, 10, ef_search=64)
    rb = recall_at_k(ib, np.asarray(gt), 10)

    idx.enable_packed(bits=8, layout="words")
    assert idx._packed.layout == "words"
    dw, iw = idx.search(wl.queries, 10, ef_search=64)
    rw = recall_at_k(iw, np.asarray(gt), 10)

    # identical code values -> identical routing -> identical results
    np.testing.assert_array_equal(np.asarray(iw), np.asarray(ib))
    np.testing.assert_allclose(np.asarray(dw), np.asarray(db_),
                               rtol=1e-5, atol=1e-5)
    assert rw >= rb - 1e-9


def test_words_layout_incremental_maintenance():
    """add() after enable_packed(layout='words') keeps the table bit-equal
    to a fresh re-pack of the current adjacency under retained params."""
    idx, wl = _small_index(n=1000)
    idx.enable_packed(bits=8, layout="words")
    assert idx._packed.layout == "words"
    idx.add(wl.base[:8])
    assert idx.packed_enabled and idx._packed.layout == "words"
    fresh = pack_neighbors(idx._graph.neighbors0, idx._vectors,
                           idx._graph.levels, bits=8, n_rows=idx.ntotal,
                           layout="words")
    n = idx.ntotal
    np.testing.assert_array_equal(np.asarray(idx._packed.nbr_codes[:n]),
                                  np.asarray(fresh.nbr_codes[:n]))
    np.testing.assert_array_equal(np.asarray(idx._packed.nbr_sq[:n]),
                                  np.asarray(fresh.nbr_sq[:n]))
    # and the packed search still answers (duplicate ids 0..3 or copies)
    d, i = idx.search(wl.base[:4], 1, ef_search=64, use_packed=True)
    ok = (i[:, 0] == np.arange(4)) | (i[:, 0] == 1000 + np.arange(4))
    assert ok.all() and np.allclose(d[:, 0], 0.0, atol=1e-5)


def test_auto_layout_on_cpu_is_bytes():
    idx, _ = _small_index(n=500)
    idx.enable_packed(bits=8)           # layout="auto": the platform's choice
    assert idx._packed.layout == "bytes"
