"""Packed neighbor-code serving mode (ops/packed.py): quantization
correctness, routing-distance algebra, end-to-end recall parity with the
unpacked beam, and API semantics (invalidation, use_packed)."""

import numpy as np
import jax.numpy as jnp
import pytest

import hnsw_jax
from hnsw_jax.ops.packed import (
    PackedNeighbors, _pack_nibbles, make_packed_expand, pack_neighbors,
    quantization_params, quantize_codes, unpack_nibbles,
)
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k


def _small_index(n=3000, d=24, m=8, metric="l2", seed=11):
    wl = synthetic_workload(n, d, n_queries=256, metric=metric, seed=seed)
    idx = hnsw_jax.HnswIndex(d, m, metric, capacity=4096, ef_construction=80)
    idx.add(wl.base)
    return idx, wl


# ---------------------------------------------------------------------------
# quantization primitives
# ---------------------------------------------------------------------------

def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=(500, 16)).astype(np.float32) * 3.0)
    live = jnp.ones((500,), bool)
    for bits in (8, 4):
        off, scale = quantization_params(v, live, bits)
        codes = quantize_codes(v, off, scale, bits)
        xhat = np.asarray(off + scale * codes.astype(jnp.float32))
        err = np.abs(xhat - np.asarray(v))
        # max error is half a quantization step per dim
        assert (err <= np.asarray(scale)[None, :] * 0.5 + 1e-5).all(), bits


def test_quantization_handles_constant_dims():
    v = jnp.asarray(np.stack([np.ones(100), np.linspace(0, 1, 100)], 1)
                    .astype(np.float32))
    off, scale = quantization_params(v, jnp.ones((100,), bool), 8)
    codes = quantize_codes(v, off, scale, 8)
    xhat = np.asarray(off + scale * codes.astype(jnp.float32))
    np.testing.assert_allclose(xhat[:, 0], 1.0, atol=1e-5)


def test_nibble_pack_roundtrip():
    rng = np.random.default_rng(1)
    for d in (8, 7):  # even and odd dims
        codes = jnp.asarray(rng.integers(0, 16, size=(5, 3, d), dtype=np.uint8))
        packed = _pack_nibbles(codes)
        assert packed.shape[-1] == (d + 1) // 2
        out = unpack_nibbles(packed, d)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(codes))


# ---------------------------------------------------------------------------
# routing distance algebra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_packed_distances_match_dequantized(metric):
    """expand()'s code-row distances must equal the surrogate distance on the
    dequantized vectors plus the documented per-query constant shift."""
    rng = np.random.default_rng(2)
    n, d, m0 = 200, 12, 8
    vecs = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    nbrs = jnp.asarray(rng.integers(0, n, size=(n, m0), dtype=np.int32))
    levels = jnp.zeros((n,), jnp.int32)
    pk = pack_neighbors(nbrs, vecs, levels, bits=8)

    q = jnp.asarray(rng.normal(size=(4, d)).astype(np.float32))
    expand, shift = make_packed_expand(pk, nbrs, q, metric)
    cur = jnp.asarray(rng.integers(0, n, size=(4, 1), dtype=np.int32))
    out_nbrs, dist = expand(cur, jnp.ones((4, 1), bool))
    np.testing.assert_array_equal(np.asarray(out_nbrs[:, 0]),
                                  np.asarray(nbrs)[np.asarray(cur[:, 0])])

    # reference: dequantize and compute the surrogate + shift by hand
    off, scale = pk.offset, pk.scale
    codes = quantize_codes(vecs, off, scale, 8)
    xhat = np.asarray(off + scale * codes.astype(jnp.float32))
    qn = np.asarray(q)
    for qi in range(4):
        ids = np.asarray(nbrs)[int(cur[qi, 0])]
        x = xhat[ids]
        if metric == "ip":
            ref = -(x @ qn[qi])
        else:
            ref = (x * x).sum(1) - 2 * x @ qn[qi]
        np.testing.assert_allclose(np.asarray(dist[qi]),
                                   ref + np.asarray(shift)[qi], rtol=2e-4,
                                   atol=2e-4)


# ---------------------------------------------------------------------------
# end-to-end
# ---------------------------------------------------------------------------

def _packed_rows(vals, bits, scale, sq, layout="bytes"):
    """PackedNeighbors whose node j holds candidate codes vals[j] ([Q, K,
    d] code values), with neighbors0 [Q, K] = distinct ids."""
    from hnsw_jax.ops.packed import pack_words
    q, k, d = vals.shape
    if layout == "words":
        rows = pack_words(jnp.asarray(vals), bits).reshape(q, -1)
    elif bits == 4:
        rows = _pack_nibbles(jnp.asarray(vals)).reshape(q, -1)
    else:
        rows = jnp.asarray(vals.reshape(q, k * d))
    packed = PackedNeighbors(rows, jnp.asarray(sq), jnp.asarray(scale),
                             jnp.zeros((d,), jnp.float32))
    nbr0 = jnp.asarray(np.arange(q * k, dtype=np.int32).reshape(q, k))
    return packed, nbr0


def routing_oracle(qs, vals, scale, sq, metric):
    """float64 routing distances of the packed hop: sq - 2 (q*scale)·u
    (L2) or -(q*scale)·u (IP)."""
    dots = np.einsum("qd,qkd->qk", (qs * scale).astype(np.float64),
                     vals.astype(np.float64))
    return -dots if metric == "ip" else sq - 2.0 * dots


@pytest.mark.parametrize("d", [64, 96, 100, 128])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("bits", [8, 4])
def test_packed_routing_dist(bits, metric, d):
    """The packed hop's routing distances (make_packed_expand: XLA unpack
    + one einsum) against a float64 NumPy oracle, 8- and 4-bit rows, at
    widths that are not powers of two and an odd d for the nibble pad."""
    rng = np.random.default_rng(100 * bits + d)
    q, k = 64, 16
    vals = rng.integers(0, 1 << bits, size=(q, k, d), dtype=np.uint8)
    qs = rng.normal(size=(q, d)).astype(np.float32)
    scale = rng.uniform(0.01, 0.1, size=(d,)).astype(np.float32)
    sq = rng.uniform(1, 10, size=(q, k)).astype(np.float32)
    packed, nbr0 = _packed_rows(vals, bits, scale, sq)
    expand, _ = make_packed_expand(packed, nbr0, jnp.asarray(qs), metric)
    cur = jnp.arange(q, dtype=jnp.int32)[:, None]
    nbrs, dist = expand(cur, jnp.ones((q, 1), bool))
    np.testing.assert_array_equal(np.asarray(nbrs)[:, 0], np.asarray(nbr0))
    np.testing.assert_allclose(np.asarray(dist),
                               routing_oracle(qs, vals, scale, sq, metric),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_packed_search_recall_parity(metric):
    idx, wl = _small_index(metric=metric)
    flat = hnsw_jax.FlatIndex(wl.base.shape[1], metric)
    flat.add(wl.base)
    _, gt = flat.search(wl.queries, 10)

    d0, i0 = idx.search(wl.queries, 10, ef_search=64)
    r0 = recall_at_k(i0, np.asarray(gt), 10)

    nbytes = idx.enable_packed(bits=8)
    assert nbytes > 0 and idx.packed_enabled
    d8, i8 = idx.search(wl.queries, 10, ef_search=64)
    r8 = recall_at_k(i8, np.asarray(gt), 10)
    assert r8 >= r0 - 0.02, (r8, r0)

    # returned distances are EXACT (rerank): rows that agree with the
    # unpacked search must carry identical distances
    same = np.asarray(i8) == np.asarray(i0)
    np.testing.assert_allclose(np.asarray(d8)[same], np.asarray(d0)[same],
                               rtol=1e-5, atol=1e-5)

    # 4-bit routing is coarser; the documented contract is that the loss is
    # absorbed by efSearch — verify it reaches the 8-bit ef=64 level at 2x ef
    idx.enable_packed(bits=4)
    _, i4 = idx.search(wl.queries, 10, ef_search=128)
    r4 = recall_at_k(i4, np.asarray(gt), 10)
    assert r4 >= r0 - 0.02, (r4, r0)


def test_packed_survives_add_and_use_packed_flag():
    idx, wl = _small_index(n=1000)
    idx.enable_packed()
    assert idx.packed_enabled
    # growth MAINTAINS the packed tables (incrementally or via re-pack,
    # whichever is cheaper) — serving + inserts compose (ROADMAP item 7)
    idx.add(wl.base[:8])
    assert idx.packed_enabled
    # the added rows are duplicates of ids 0..7, so nearest is either copy
    d, i = idx.search(wl.base[:4], 1, ef_search=64, use_packed=True)
    ok = (i[:, 0] == np.arange(4)) | (i[:, 0] == 1000 + np.arange(4))
    assert ok.all() and np.allclose(d[:, 0], 0.0, atol=1e-5), (i[:, 0], d)
    idx.disable_packed()
    with pytest.raises(ValueError, match="use_packed"):
        idx.search(wl.queries[:4], 5, use_packed=True)
    # bypass works whether or not packing is enabled
    d, i = idx.search(wl.queries[:4], 5, use_packed=False)
    assert i.shape == (4, 5)


@pytest.mark.parametrize("bits", [8, 4])
def test_incremental_packed_maintenance_parity(bits):
    """After enable_packed(), a device add() must leave the packed tables
    BIT-EQUAL to a row-by-row re-pack of the CURRENT adjacency under the
    RETAINED quantization params (the incremental path re-packs exactly the
    rows the build touched — fingerprint diff + the new ids)."""
    d, m = 24, 8
    wl = synthetic_workload(3200, d, n_queries=16, metric="l2", seed=31)
    idx = hnsw_jax.HnswIndex(d, m, "l2", capacity=4096, ef_construction=60)
    idx.add(wl.base[:3000])
    # small chunk + explicit reserve -> row headroom covers the add below,
    # forcing the INCREMENTAL path (not the full-re-pack fallback)
    idx.enable_packed(bits=bits, reserve=256, chunk=256)
    pad_cap = idx._packed.nbr_sq.shape[0]
    offset = np.asarray(idx._packed.offset)
    scale = np.asarray(idx._packed.scale)

    idx.add(wl.base[3000:3200])
    assert idx.packed_enabled
    pk = idx._packed
    n = idx.ntotal
    assert n <= pad_cap  # sanity: the incremental path was reachable
    # quantization params retained — proves no silent full retrain happened
    np.testing.assert_array_equal(np.asarray(pk.offset), offset)
    np.testing.assert_array_equal(np.asarray(pk.scale), scale)

    codes_all = np.asarray(quantize_codes(idx.vectors, pk.offset, pk.scale,
                                          bits))
    xhat = offset + scale * codes_all.astype(np.float32)
    sq_all = (xhat ** 2).sum(1)
    nbr0 = np.asarray(idx.graph.neighbors0[:n])
    safe = np.maximum(nbr0, 0)
    want = codes_all[safe]                             # [n, m0, d]
    if bits == 4:
        want = np.asarray(_pack_nibbles(jnp.asarray(want)))
    got_codes = np.asarray(pk.nbr_codes).reshape(-1, pk.row_w)[:n]
    np.testing.assert_array_equal(got_codes, want.reshape(n, -1))
    np.testing.assert_allclose(np.asarray(pk.nbr_sq)[:n], sq_all[safe],
                               rtol=1e-5, atol=1e-5)

    # end-to-end: packed routing reaches the post-add points
    q = np.asarray(wl.base[3000:3032])
    _, ii = idx.search(q, 1, ef_search=64, use_packed=True)
    hit = (ii[:, 0] == np.arange(3000, 3032)).mean()
    assert hit >= 0.9, hit


def test_packed_full_repack_when_headroom_exhausted():
    """Adds past the packed table's padded row count fall back to a full
    re-pack (with retrained params) instead of serving a truncated table."""
    d, m = 24, 8
    wl = synthetic_workload(1300, d, n_queries=8, metric="l2", seed=37)
    idx = hnsw_jax.HnswIndex(d, m, "l2", capacity=2048, ef_construction=60)
    idx.add(wl.base[:1000])
    idx.enable_packed(bits=8)     # chunk-aligned pad == n: zero headroom
    assert idx._packed.nbr_sq.shape[0] == 1000
    idx.add(wl.base[1000:1300])
    assert idx.packed_enabled
    assert idx._packed.nbr_sq.shape[0] >= 1300
    _, ii = idx.search(np.asarray(wl.base[1000:1016]), 1, ef_search=64,
                       use_packed=True)
    assert (ii[:, 0] == np.arange(1000, 1016)).mean() >= 0.9


def test_packed_composes_with_filters_and_deletion():
    idx, wl = _small_index(n=1500)
    flat = hnsw_jax.FlatIndex(wl.base.shape[1], "l2")
    flat.add(wl.base)
    _, gt = flat.search(wl.queries, 1)
    victim = int(gt[0, 0])

    idx.enable_packed()
    idx.remove_ids(np.asarray([victim]))
    assert idx.packed_enabled  # deletion filters results, not routing
    d, i = idx.search(wl.queries[:1], 5, ef_search=64)
    assert victim not in i[0]

    allowed = np.zeros(idx.config.capacity, bool)
    allowed[:200] = True
    d, i = idx.search(wl.queries[:8], 5, ef_search=128, allowed=allowed)
    valid = i[i >= 0]
    assert (valid < 200).all()


@pytest.mark.slow
def test_big_table_boundary():
    """Regression for an int32 overflow: a
    1-D packed code-table byte offset ``id * row_w`` crosses 2^31 at node id
    262,144 for row_w = 8192 (d=128, m0=64 — the SIFT1M serving shape), so
    int32 offset arithmetic silently clip-gathered wrong rows for 75% of a
    1M index. The table is now 2-D with row-index addressing; this test keeps
    the whole class pinned: it builds a small REAL graph, embeds it at ids
    straddling the byte boundary (capacity ~263k, table ~2.6 GB) and
    asserts:
      (a) assembled table rows are bit-correct on BOTH sides of 2^31 bytes
          (catches any assembly-offset arithmetic bug), and
      (b) packed self-queries hit their own id across the boundary and
          packed/unpacked results agree (catches row-fetch addressing bugs).
    """
    import hnsw_jax.search as search_mod
    from hnsw_jax.ops.packed import quantize_codes

    d, m = 128, 32
    m0 = 2 * m
    row_w = m0 * d                      # 8192
    boundary = (1 << 31) // row_w       # 262,144
    n_small = 1200
    off = boundary - n_small // 2       # embed straddling the boundary
    cap_big = off + n_small

    wl = synthetic_workload(n_small, d, n_queries=1, metric="l2", seed=23)
    small = hnsw_jax.HnswIndex(d, m, "l2", capacity=n_small,
                               ef_construction=60)
    small.add(wl.base)
    g = {k: np.asarray(v) for k, v in small.graph._asdict().items()}

    def shift(a):  # remap node ids by +off, keeping -1 padding
        return np.where(a >= 0, a + off, a).astype(np.int32)

    cfg_big = small.config.replace(
        capacity=cap_big, upper_capacity=int(g["upper_node"].shape[0]))
    nbr0 = np.full((cap_big, m0), -1, np.int32)
    nbr0[off:] = shift(g["neighbors0"][:n_small])
    levels = np.full((cap_big,), -1, np.int32)
    levels[off:] = g["levels"][:n_small]
    upper_slot = np.full((cap_big,), -1, np.int32)
    upper_slot[off:] = g["upper_slot"][:n_small]
    vecs = np.zeros((cap_big, d), np.float32)
    vecs[off:] = np.asarray(wl.base, np.float32)

    from hnsw_jax.graph import GraphArrays
    graph_big = GraphArrays(
        neighbors0=jnp.asarray(nbr0),
        levels=jnp.asarray(levels),
        upper_slot=jnp.asarray(upper_slot),
        upper_node=jnp.asarray(shift(g["upper_node"])),
        upper_neighbors=jnp.asarray(shift(g["upper_neighbors"])),
        entry_point=jnp.asarray(int(g["entry_point"]) + off, jnp.int32),
        max_level=jnp.asarray(g["max_level"]),
        ntotal=jnp.asarray(cap_big, jnp.int32),
        n_upper=jnp.asarray(g["n_upper"]),
    )
    big = hnsw_jax.HnswIndex(config=cfg_big, _alloc=False)
    big._graph = graph_big
    big._vectors = jnp.asarray(vecs)
    big._sqnorms = search_mod.compute_sqnorms(big._vectors)

    nbytes = big.enable_packed(bits=8)
    assert nbytes > (1 << 31), nbytes   # the table genuinely crosses 2^31
    pk = big._packed

    # (a) table-row integrity across the (byte) boundary
    codes_all = np.asarray(
        quantize_codes(big._vectors, pk.offset, pk.scale, 8))
    for nid in (off, boundary - 1, boundary, boundary + 1, cap_big - 1):
        row = np.asarray(pk.nbr_codes[nid])
        ids = nbr0[nid]
        expect = codes_all[np.maximum(ids, 0)]
        expect[ids < 0] = codes_all[0]
        np.testing.assert_array_equal(
            row.reshape(m0, d), expect,
            err_msg=f"corrupt packed row for node {nid} "
                    f"(byte start {nid * row_w}, 2^31={1 << 31})")

    # (b) packed self-queries across the boundary hit their own id
    probe = np.concatenate([np.arange(0, n_small, 97),
                            [n_small // 2 - 1, n_small // 2,
                             n_small // 2 + 1]]).astype(np.int64)
    q = np.asarray(wl.base)[probe]
    dp, ip_ = big.search(q, 10, ef_search=64, use_packed=True)
    assert (ip_[:, 0] == probe + off).all(), \
        np.stack([probe + off, ip_[:, 0]], 1)
    du, iu = big.search(q, 10, ef_search=64, use_packed=False)
    overlap = np.mean([
        len(set(ip_[r]) & set(iu[r])) / 10 for r in range(len(q))])
    assert overlap >= 0.9, overlap


def test_pack_neighbors_memory_guard():
    rng = np.random.default_rng(3)
    vecs = jnp.asarray(rng.normal(size=(64, 8)).astype(np.float32))
    nbrs = jnp.asarray(rng.integers(0, 64, size=(64, 4), dtype=np.int32))
    levels = jnp.zeros((64,), jnp.int32)
    with pytest.raises(ValueError, match="budget"):
        pack_neighbors(nbrs, vecs, levels, bits=8, max_bytes=10)
