"""Packed neighbor-code rows: one-fetch level-0 expansion.

Motivation: the standard hop pays ~1 + K scattered row fetches per
expanded node (1 adjacency row + one vector row per candidate), and
scattered fetches are latency- and transaction-bound rather than bound by
bytes. This module trades memory for fetches, the same idea DiskANN uses
to beat SSD latency: for every node, store the quantized vectors of ALL
its level-0 neighbors contiguously in one fat row. A hop then fetches

    1 adjacency row  (m0 x int32)
  + 1 code row       (m0 x d x bits/8 bytes, one contiguous row)
  + 1 sqnorm row     (m0 x f32)

per expanded node — ~3 fetches instead of ~1 + K — and computes all K
candidate distances straight from the code row.

Distance algebra (no dequantized [Q, K, d] intermediate): with per-dim
affine dequantization x̂ = offset + scale * u,

    L2 surrogate:  ||x̂||² - 2 q·x̂ = sq_hat - 2 (q*scale)·u - 2 q·offset
    IP surrogate:  -q·x̂           =        - (q*scale)·u -   q·offset

The q·offset term is constant per query, so it cannot change any ranking:
the beam runs on `sq_hat - 2 (q*scale)·u` (resp. `-(q*scale)·u`), and the
one exactly-computed distance that enters the beam (the entry point, scored
from f32 vectors) is shifted by the same constant to stay on-scale.

Precision: the beam routes on quantized distances (8-bit per dim by
default; 4-bit packed two-per-byte for half the row bytes); the final ef
buffer is re-ranked with exact f32 distances (one [Q, ef] gather — the cost
of a single hop), so returned (D, I) retain full precision and only the
*routing* is approximate; its effect on recall is absorbed by a few
points of efSearch.

Memory: codes cost capacity * m0 * d * bits/8 bytes (the vector data is
replicated once per in-edge, the price of one-fetch hops) — 8.4 GB at
1M x 128-d x 8-bit, half that at 4-bit. `pack_neighbors` refuses tables that
cannot fit next to the index (caller passes the budget).

No upstream faiss equivalent (faiss's HNSW reads vectors through
DistanceComputer per candidate; reference `/root/reference/README.md:2`
names faiss-HNSW as the capability spec) — this is an accelerator-shaped
serving layout on top of the same graph.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class PackedNeighbors(NamedTuple):
    """Device pytree of the packed serving tables.

    ``nbr_codes`` is TWO-dimensional [rows, row_w]: every gather indexes
    ROWS (ids < 2^31), so all index arithmetic stays int32 even when the
    table passes 2^31 bytes (8.6e9 bytes at 1M x 128 x 8-bit)."""

    nbr_codes: jax.Array  # uint8 [rows, row_w] (bytes layout) or int32
    #                       [rows, m0 * word_width(d, bits)] (words layout)
    nbr_sq: jax.Array     # f32   [rows, m0]   ||x̂||² of each neighbor
    scale: jax.Array      # f32   [d]   per-dim dequant scale
    offset: jax.Array     # f32   [d]   per-dim dequant offset

    @property
    def row_w(self) -> int:
        return self.nbr_codes.shape[1]

    @property
    def layout(self) -> str:
        """"bytes" (uint8 rows, the default) or "words" (int32 rows that
        hold the same bit pattern, 32/bits code values per word)."""
        return "words" if self.nbr_codes.dtype == jnp.int32 else "bytes"

    def bits_for(self, d: int, m0: int) -> int:
        w = self.row_w
        if self.layout == "words":
            w8, w4 = word_width(d, 8), word_width(d, 4)
            if w8 and w8 == w4 and w in (m0 * w8,):
                raise ValueError(
                    f"word-packed row width {w} is ambiguous at d={d} "
                    f"(8- and 4-bit segments both pad to {w8} words)")
            if w8 and w == m0 * w8:
                return 8
            if w4 and w == m0 * w4:
                return 4
            raise ValueError(
                f"word-packed row width {w} matches neither 8-bit "
                f"({m0 * w8}) nor 4-bit ({m0 * w4}) at d={d}")
        if w == m0 * d:
            return 8
        if w == m0 * ((d + 1) // 2):
            return 4
        raise ValueError(f"packed row width {w} matches neither 8-bit "
                         f"({m0 * d}) nor 4-bit ({m0 * ((d + 1) // 2)})")

    @property
    def nbytes(self) -> int:
        return sum(int(a.size) * a.dtype.itemsize for a in self)


class PackedPQ(NamedTuple):
    """Packed rows of PQ ROUTING codes — the low-memory packed variant.

    Same fat-row idea as ``PackedNeighbors`` (one row fetch per expanded
    node), but each neighbor contributes its ``pq_m`` PQ codes (1 byte per
    8-bit code, a nibble per 4-bit code) instead of ``d`` scalar-quantized
    dims: the table costs capacity * m0 * bpn bytes — 8-16x smaller than
    sq8 rows (1M x 128d: 1 GB at pq_m=16 vs 8.4 GB), the configuration
    that fits Deep10M-scale packed serving on one chip. Routing distances
    are ADC against the ROUTING reconstruction x̂ (ops/pq.py
    adc_decode_distance, bf16 one-hot decode); the extraction rerank
    restores storage-grade distances. ADC distances carry the full
    ``||x̂||² - 2 q·x̂`` surrogate (the norm rides in the codebooks), so
    exactly-scored entry points need NO scale shift (cf. PackedNeighbors'
    q·offset shift).

    The routing codebooks ``cb`` ride in the tuple: they are independent
    of the storage codec (flat/sq8 storage trains routing-only codebooks;
    pq storage reuses its own), and the expand closure needs them.

    """

    nbr_codes: jax.Array  # uint8 [rows, row_w], row_w = m0 * bpn
    cb: jax.Array         # f32 [pq_m, ksub, dsub] routing codebooks

    def bpn(self, m0: int) -> int:
        """Bytes per neighbor in a row."""
        return self.nbr_codes.shape[1] // m0

    def pq_bits_for(self, m0: int) -> int:
        pm = self.cb.shape[0]
        b = self.bpn(m0)
        if b == pm:
            return 8
        if b == (pm + 1) // 2:
            return 4
        raise ValueError(f"packed-pq row width {self.nbr_codes.shape[1]} "
                         f"matches neither 8-bit (m0*{pm}) nor 4-bit")

    @property
    def nbytes(self) -> int:
        return sum(int(a.size) * a.dtype.itemsize for a in self)


def quantization_params(vectors: jax.Array, live: jax.Array, bits: int):
    """Per-dim affine (offset, scale) over live rows, faiss
    ScalarQuantizer-style min/max training. Returns (offset [d], scale [d]),
    scale floored so constant dims don't divide by zero."""
    v = vectors.astype(jnp.float32)
    big = jnp.float32(jnp.inf)
    vmin = jnp.min(jnp.where(live[:, None], v, big), axis=0)
    vmax = jnp.max(jnp.where(live[:, None], v, -big), axis=0)
    vmin = jnp.where(jnp.isfinite(vmin), vmin, 0.0)
    vmax = jnp.where(jnp.isfinite(vmax), vmax, 0.0)
    levels = jnp.float32((1 << bits) - 1)
    scale = jnp.maximum(vmax - vmin, 1e-20) / levels
    return vmin, scale


def quantize_codes(vectors: jax.Array, offset: jax.Array, scale: jax.Array,
                   bits: int) -> jax.Array:
    """uint8 codes [n, d] (values 0..2^bits-1, still one byte per dim —
    4-bit packing happens at row assembly)."""
    levels = (1 << bits) - 1
    u = jnp.round((vectors.astype(jnp.float32) - offset) / scale)
    return jnp.clip(u, 0, levels).astype(jnp.uint8)


def _pack_nibbles(codes: jax.Array) -> jax.Array:
    """[..., d] 4-bit values -> [..., ceil(d/2)] bytes (low nibble first)."""
    d = codes.shape[-1]
    if d % 2:
        codes = jnp.concatenate(
            [codes, jnp.zeros(codes.shape[:-1] + (1,), codes.dtype)], -1)
    lo = codes[..., 0::2]
    hi = codes[..., 1::2]
    return (lo | (hi << 4)).astype(jnp.uint8)


def unpack_nibbles(rows: jax.Array, d: int) -> jax.Array:
    """[..., ceil(d/2)] bytes -> [..., d] 4-bit values (uint8)."""
    lo = rows & jnp.uint8(0x0F)
    hi = (rows >> 4) & jnp.uint8(0x0F)
    out = jnp.stack([lo, hi], axis=-1).reshape(*rows.shape[:-1], -1)
    return out[..., :d]


def word_width(d: int, bits: int) -> int:
    """int32 words per candidate segment in the "words" layout: ceil(d /
    (32/bits)) padded up to a power of two (a divisor of 128). Returns 0
    when a segment would exceed 128 words (d too large — use the bytes
    layout)."""
    w = -(-d // (32 // bits))
    for wp in (1, 2, 4, 8, 16, 32, 64, 128):
        if wp >= w:
            return wp
    return 0


def pack_words(codes: jax.Array, bits: int) -> jax.Array:
    """[..., d] code values (< 2^bits) -> int32 [..., word_width(d, bits)],
    32/bits values per word, value j at bit [bits*j, bits*(j+1)) — i.e. the
    little-endian byte/nibble order of the bytes layout, so a words table
    holds the exact bit pattern of the corresponding u8 rows. The packing
    is arithmetic (multiply-and-sum), so it is the same on every backend
    whatever its byte order. Int32 products deliberately wrap (two's
    complement) for the high byte; the consumer masks after an arithmetic
    shift, so values round-trip."""
    d = codes.shape[-1]
    vpw = 32 // bits
    wp = word_width(d, bits)
    if not wp:
        raise ValueError(f"word layout unsupported at d={d}, bits={bits} "
                         f"(candidate segment exceeds 128 words)")
    pad = wp * vpw - d
    c = codes.astype(jnp.int32)
    if pad:
        c = jnp.pad(c, [(0, 0)] * (c.ndim - 1) + [(0, pad)])
    c = c.reshape(*c.shape[:-1], wp, vpw)
    weights = jnp.left_shift(
        jnp.int32(1), bits * jnp.arange(vpw, dtype=jnp.int32))
    return jnp.sum(c * weights, axis=-1, dtype=jnp.int32)


def unpack_words(words: jax.Array, bits: int, d: int) -> jax.Array:
    """int32 [..., word_width(d, bits)] -> [..., d] code values (uint8).
    Inverse of ``pack_words`` (arithmetic shift + mask strips the sign
    extension of wrapped high bytes)."""
    vpw = 32 // bits
    mask = (1 << bits) - 1
    planes = [(words >> (bits * j)) & mask for j in range(vpw)]
    out = jnp.stack(planes, axis=-1).reshape(*words.shape[:-1], -1)
    return out[..., :d].astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("chunk", "n_rows"))
def _assemble_payload_rows(neighbors0: jax.Array, payload: jax.Array,
                           sq_all: jax.Array, *, chunk: int, n_rows: int):
    """Gather each node's per-neighbor payload rows + sqnorms into
    contiguous fat rows, chunked through a fori_loop so the [rows, m0,
    w_node] intermediate never materializes (the output alone is GBs).
    ``payload`` is the per-node encoded row segment ([cap, w_node]; u8
    codes / nibble-packed bytes / int32 words — layout-agnostic here).

    The output keeps the chunk-aligned padded row count (<= chunk-1 junk
    rows, never gathered since node ids < n_rows): trimming with a final
    slice would COPY the multi-GB table — the pad-then-slice transient is
    what used to push a 1M x 128 pack from 9 GB to HBM exhaustion."""
    m0 = neighbors0.shape[1]
    row_w = m0 * payload.shape[1]
    n_chunks = (n_rows + chunk - 1) // chunk
    pad_cap = n_chunks * chunk
    nb = jnp.pad(neighbors0[:n_rows], ((0, pad_cap - n_rows), (0, 0)))

    # 2-D [rows, row_w]: all offsets are ROW indices (< 2^31 by
    # construction) so everything stays int32 even once the table crosses
    # 2^31 bytes (1M x 128d x 8-bit = 8.6 GB; regression-tested across the
    # boundary in tests/test_packed.py::test_big_table_boundary)
    out_codes = jnp.zeros((pad_cap, row_w), payload.dtype)
    out_sq = jnp.zeros((pad_cap, m0), jnp.float32)

    def body(i, carry):
        oc, osq = carry
        rows = jax.lax.dynamic_slice(nb, (i * chunk, 0), (chunk, m0))
        safe = jnp.maximum(rows, 0)
        nc = payload[safe].reshape(chunk, row_w)  # [chunk, m0 * w_node]
        nsq = sq_all[safe]                        # [chunk, m0]
        oc = jax.lax.dynamic_update_slice(oc, nc, (i * chunk, 0))
        osq = jax.lax.dynamic_update_slice(osq, nsq, (i * chunk, 0))
        return oc, osq

    return jax.lax.fori_loop(0, n_chunks, body, (out_codes, out_sq))


def _assemble_rows(neighbors0: jax.Array, codes_all: jax.Array,
                   sq_all: jax.Array, *, bits: int, chunk: int,
                   n_rows: int):
    """Bytes-layout row assembly from raw [cap, d] codes (kept as the
    sharded builder's entry point; single-chip packing goes through
    ``pack_neighbors`` which picks the payload encoding per layout)."""
    payload = _pack_nibbles(codes_all) if bits == 4 else codes_all
    return _assemble_payload_rows(neighbors0, payload, sq_all,
                                  chunk=chunk, n_rows=n_rows)


def pack_neighbors(neighbors0: jax.Array, vectors: jax.Array,
                   levels: jax.Array, *, bits: int = 8,
                   max_bytes: int | None = None,
                   n_rows: int | None = None,
                   chunk: int = 1 << 16,
                   dequant=None, layout: str = "bytes") -> PackedNeighbors:
    """Build the packed serving tables from a finished graph.

    bits: 8 (one byte/dim) or 4 (two dims/byte, half the row bytes — use for
    larger capacities; routing quality drops slightly, absorbed by ef).
    max_bytes: refuse (ValueError) if the code table would exceed this.
    n_rows: build rows only for ids < n_rows (pass ntotal: the beam only
    ever expands inserted nodes, so preallocated-but-empty capacity needs
    no rows — the table scales with the LIVE index, not its capacity).
    dequant: (offset, scale) when ``vectors`` are sq8 storage codes. At
    bits=8 the stored codes ARE the routing codes (shared params, zero
    re-quantization); at bits=4 values are dequantized and re-trained.
    layout: "bytes" (uint8 rows, the default) or "words" (int32
    word-packed rows holding the same bit pattern; each candidate segment
    is zero-padded to ``word_width(d, bits)`` words).
    """
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if layout not in ("bytes", "words"):
        raise ValueError(f"layout must be 'bytes' or 'words', got {layout!r}")
    cap, m0 = neighbors0.shape
    d = vectors.shape[1]
    n_rows = cap if n_rows is None else max(1, min(int(n_rows), cap))
    if layout == "words":
        wp = word_width(d, bits)
        if not wp:
            raise ValueError(f"layout='words' unsupported at d={d}, "
                             f"bits={bits} (segment > 128 words); "
                             f"use layout='bytes'")
        row_bytes = m0 * wp * 4
    else:
        row_bytes = m0 * d if bits == 8 else m0 * ((d + 1) // 2)
    # budget against what _assemble_payload_rows actually allocates: the
    # chunk-aligned padded row count (up to chunk-1 rows beyond n_rows)
    eff_chunk = min(chunk, n_rows)
    pad_cap = ((n_rows + eff_chunk - 1) // eff_chunk) * eff_chunk
    total = pad_cap * row_bytes + pad_cap * m0 * 4
    if max_bytes is not None and total > max_bytes:
        raise ValueError(
            f"packed table needs {total / 1e9:.1f} GB "
            f"(> budget {max_bytes / 1e9:.1f} GB); use bits=4 or skip "
            f"packing for this capacity")
    live = levels >= 0
    if dequant is not None and bits == 8:
        offset = jnp.asarray(dequant[0], jnp.float32)
        scale = jnp.asarray(dequant[1], jnp.float32)
        codes_all = vectors                                    # [cap, d] u8
    elif dequant is not None:
        vf = jnp.asarray(dequant[0], jnp.float32) + \
            jnp.asarray(dequant[1], jnp.float32) * vectors.astype(jnp.float32)
        offset, scale = quantization_params(vf, live, bits)
        codes_all = quantize_codes(vf, offset, scale, bits)
    else:
        offset, scale = quantization_params(vectors, live, bits)
        codes_all = quantize_codes(vectors, offset, scale, bits)  # [cap, d]
    xhat_sq = jnp.sum(
        (offset + scale * codes_all.astype(jnp.float32)) ** 2, axis=1)
    if layout == "words":
        payload = pack_words(codes_all, bits)
    elif bits == 4:
        payload = _pack_nibbles(codes_all)
    else:
        payload = codes_all
    nbr_codes, nbr_sq = _assemble_payload_rows(neighbors0, payload, xhat_sq,
                                               chunk=eff_chunk,
                                               n_rows=n_rows)
    return PackedNeighbors(nbr_codes, nbr_sq, scale=scale, offset=offset)


def _update_packed_rows_impl(nbr_codes: jax.Array, nbr_sq: jax.Array,
                             neighbors0: jax.Array, vectors: jax.Array,
                             offset: jax.Array, scale: jax.Array,
                             ids: jax.Array, dequant=None, *, bits: int):
    m0 = neighbors0.shape[1]
    u = ids.shape[0]
    ok = ids >= 0
    safe = jnp.maximum(ids, 0)
    rows = jnp.maximum(neighbors0[safe], 0)            # [U, m0]
    nv = vectors[rows].astype(jnp.float32)             # [U, m0, d]
    if dequant is not None:  # sq8 storage: codes -> x̂ before re-quantizing
        nv = dequant[0] + dequant[1] * nv
    nc = quantize_codes(nv, offset, scale, bits)
    nsq = jnp.sum((offset + scale * nc.astype(jnp.float32)) ** 2, axis=-1)
    if nbr_codes.dtype == jnp.int32:                   # words layout
        nc = pack_words(nc, bits)
    elif bits == 4:
        nc = _pack_nibbles(nc)
    upd = nc.reshape(u, nbr_codes.shape[1])
    n_rows = nbr_sq.shape[0]
    tgt = jnp.where(ok, safe, n_rows)  # n_rows == OOB -> dropped (pad ids)
    nbr_codes = nbr_codes.at[tgt].set(upd, mode="drop")
    nbr_sq = nbr_sq.at[tgt].set(nsq, mode="drop")
    return nbr_codes, nbr_sq


@functools.partial(jax.jit, static_argnames=("bits",), donate_argnums=(0, 1))
def update_packed_rows(nbr_codes: jax.Array, nbr_sq: jax.Array,
                       neighbors0: jax.Array, vectors: jax.Array,
                       offset: jax.Array, scale: jax.Array,
                       ids: jax.Array, dequant=None, *, bits: int):
    """Rewrite the packed rows of ``ids`` (int32 [U], -1 = pad/skip) from the
    CURRENT adjacency + vectors, keeping the existing quantization params.
    The incremental counterpart of ``_assemble_rows`` for post-``add()``
    maintenance: only rows whose adjacency changed are touched, so a
    serving index absorbs small inserts without the full multi-GB rebuild.
    The tables are donated and updated in place. Returns (nbr_codes,
    nbr_sq) updated.

    Quantization params are NOT retrained: vectors added later that exceed
    the trained per-dim [min, max] range have their ROUTING codes clipped
    (the exact f32 rerank is unaffected). Callers that add a large or
    distribution-shifted fraction should re-pack from scratch instead —
    HnswIndex picks between the two automatically."""
    return _update_packed_rows_impl(nbr_codes, nbr_sq, neighbors0, vectors,
                                    offset, scale, ids, dequant, bits=bits)


@jax.jit
def row_fingerprints(neighbors0: jax.Array) -> jax.Array:
    """Two independent 32-bit position-salted hashes per adjacency row,
    [capacity, 2] uint32. Lets a caller detect WHICH rows an add() modified
    by comparing before/after fingerprints — without holding a second copy
    of the adjacency (256 MB at 1M x 64) across the build. Collision odds
    per changed row are ~2^-64 (two independent avalanche mixes)."""
    x = neighbors0.astype(jnp.uint32)
    pos = jnp.arange(x.shape[1], dtype=jnp.uint32)

    def mix(v, m1, m2):
        v = v ^ (v >> 16)
        v = v * jnp.uint32(m1)
        v = v ^ (v >> 15)
        v = v * jnp.uint32(m2)
        return v ^ (v >> 16)

    h1 = jnp.sum(mix(x ^ (pos * jnp.uint32(0x9E3779B9)),
                     0x7FEB352D, 0x846CA68B), axis=1)
    h2 = jnp.sum(mix(x ^ (pos * jnp.uint32(0x85EBCA6B)),
                     0xC2B2AE35, 0x27D4EB2F), axis=1)
    return jnp.stack([h1, h2], axis=1)


def make_packed_expand(packed: PackedNeighbors, neighbors0: jax.Array,
                       queries: jax.Array, metric: str):
    """Returns expand(cur [Q, T], step_ok [Q, T]) -> (nbrs [Q, T, m0],
    dist [Q, T*m0]) for ops.beam.beam_search: all candidate distances of an
    expanded node computed from its one packed code row.

    Also returns the per-query scale shift to add to exactly-computed
    distances (entry point) so they compare against code-row distances:
    L2 surrogate shift = 2 q·offset, IP shift = q·offset (module docstring).

    Both layouts take the same path: the gathered row is unpacked to code
    values in XLA (bytes: as is or nibble-split; words: shift-and-mask)
    and contracted against the pre-scaled query in one einsum, which XLA
    fuses with the unpack.
    """
    from ..config import IP

    qf = queries.astype(jnp.float32)
    qs = qf * packed.scale                            # [Q, d]
    qoff = jnp.einsum("qd,d->q", qf, packed.offset,
                      precision=jax.lax.Precision.HIGHEST)
    shift = qoff if metric == IP else 2.0 * qoff
    m0 = neighbors0.shape[1]
    d = qf.shape[1]
    words = packed.layout == "words"
    bits = packed.bits_for(d, m0)
    wp = packed.row_w // m0 if words else 0

    def expand(cur: jax.Array, step_ok: jax.Array):
        safe = jnp.where(step_ok, cur, 0)
        nbrs = neighbors0[safe]                       # [Q, T, m0]
        qn, t = safe.shape
        # one contiguous row fetch per expanded node; indices are ROW ids,
        # so int32 never overflows (1-D BYTE offsets would cross 2^31 at
        # node 262,144 for row_w=8192 — see PackedNeighbors)
        rows = packed.nbr_codes.at[safe.reshape(-1)].get(
            mode="clip")                              # [Q*T, row_w]
        if words:
            u = unpack_words(rows.reshape(qn, t, m0, wp), bits, d)
        elif bits == 8:
            u = rows.reshape(qn, t, m0, d)
        else:
            u = unpack_nibbles(rows.reshape(qn, t, m0, -1), d)
        # routing distances: quantized operand straight into the
        # contraction at default precision — the codes are 4/8-bit, so
        # HIGHEST buys nothing. On the GPU that is TF32, which keeps more
        # mantissa than the single bf16 pass the routing was first tuned
        # with; the extraction rerank is exact either way.
        dots = jnp.einsum("qd,qtkd->qtk", qs, u.astype(jnp.float32),
                          preferred_element_type=jnp.float32)
        if metric == IP:
            dist = -dots
        else:
            dist = packed.nbr_sq[safe] - 2.0 * dots   # [Q, T, m0]
        return nbrs, dist.reshape(qn, t * m0)

    return expand, shift


# ---------------------------------------------------------------------------
# PQ-coded packed rows (PackedPQ)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("pq_bits", "chunk", "n_rows"))
def _assemble_pq_rows(neighbors0: jax.Array, codes_all: jax.Array, *,
                      pq_bits: int, chunk: int, n_rows: int) -> jax.Array:
    """Gather each node's neighbor PQ codes into contiguous rows (nibble-
    packed at 4 bits), chunked like ``_assemble_rows`` so only the output
    table is ever table-sized. Keeps the chunk-aligned padded row count
    (junk pad rows are never gathered — ids < n_rows)."""
    m0 = neighbors0.shape[1]
    pm = codes_all.shape[1]
    bpn = pm if pq_bits == 8 else (pm + 1) // 2
    row_w = m0 * bpn
    n_chunks = (n_rows + chunk - 1) // chunk
    pad_cap = n_chunks * chunk
    nb = jnp.pad(neighbors0[:n_rows], ((0, pad_cap - n_rows), (0, 0)))
    out = jnp.zeros((pad_cap, row_w), jnp.uint8)

    def body(i, oc):
        rows = jax.lax.dynamic_slice(nb, (i * chunk, 0), (chunk, m0))
        safe = jnp.maximum(rows, 0)
        nc = codes_all[safe]                      # [chunk, m0, pm] uint8
        if pq_bits == 4:
            nc = _pack_nibbles(nc)
        return jax.lax.dynamic_update_slice(
            oc, nc.reshape(chunk, row_w), (i * chunk, 0))

    return jax.lax.fori_loop(0, n_chunks, body, out)


def pack_pq_neighbors(neighbors0: jax.Array, codes_all: jax.Array,
                      cb, *, pq_bits: int = 8,
                      max_bytes: int | None = None,
                      n_rows: int | None = None,
                      chunk: int = 1 << 16) -> PackedPQ:
    """Build PQ-coded packed serving tables from a finished graph.

    codes_all: uint8 [capacity, pq_m] ROUTING codes of every vector under
    ``cb`` (for pq storage these are the stored codes; for flat/sq8 storage
    the caller encodes x/x̂ with routing-only codebooks first).
    pq_bits: 8 (1 byte/code) or 4 (two codes/byte; code values must be
    < 16, i.e. cb trained with ksub=16)."""
    if pq_bits not in (4, 8):
        raise ValueError(f"pq_bits must be 4 or 8, got {pq_bits}")
    cb = jnp.asarray(cb, jnp.float32)
    if pq_bits == 4 and cb.shape[1] > 16:
        raise ValueError("pq_bits=4 requires ksub<=16 routing codebooks "
                         f"(got ksub={cb.shape[1]})")
    cap, m0 = neighbors0.shape
    pm = codes_all.shape[1]
    if pm != cb.shape[0]:
        raise ValueError(f"codes have {pm} sub-codes but codebooks have "
                         f"{cb.shape[0]} subspaces")
    n_rows = cap if n_rows is None else max(1, min(int(n_rows), cap))
    bpn = pm if pq_bits == 8 else (pm + 1) // 2
    eff_chunk = min(chunk, n_rows)
    pad_cap = ((n_rows + eff_chunk - 1) // eff_chunk) * eff_chunk
    total = pad_cap * m0 * bpn
    if max_bytes is not None and total > max_bytes:
        raise ValueError(
            f"packed-pq table needs {total / 1e9:.1f} GB "
            f"(> budget {max_bytes / 1e9:.1f} GB); lower pq_m / use "
            f"pq_bits=4 or skip packing for this capacity")
    rows = _assemble_pq_rows(neighbors0, codes_all, pq_bits=pq_bits,
                             chunk=eff_chunk, n_rows=n_rows)
    return PackedPQ(rows, cb)


def make_packed_pq_expand(packed: PackedPQ, neighbors0: jax.Array,
                          queries: jax.Array, metric: str):
    """Returns (expand, shift) for ops.beam.beam_search, like
    ``make_packed_expand`` but with ADC routing distances computed from the
    PQ code row (ops/pq.py adc_decode_distance). ADC carries the complete
    surrogate (norm included), so shift == 0: exactly-scored entry points
    are already on-scale."""
    from .pq import adc_decode_distance

    qf = queries.astype(jnp.float32)
    m0 = neighbors0.shape[1]
    pm = packed.cb.shape[0]
    four_bit = packed.pq_bits_for(m0) == 4
    bpn = packed.bpn(m0)

    def expand(cur: jax.Array, step_ok: jax.Array):
        safe = jnp.where(step_ok, cur, 0)
        nbrs = neighbors0[safe]                       # [Q, T, m0]
        qn, t = safe.shape
        rows = packed.nbr_codes.at[safe.reshape(-1)].get(
            mode="clip")                              # [Q*T, m0*bpn]
        rows = rows.reshape(qn, t * m0, bpn)
        codes = unpack_nibbles(rows, pm) if four_bit else rows
        dist = adc_decode_distance(packed.cb, qf, codes, metric)
        return nbrs, dist                             # [Q, T*m0]

    return expand, jnp.float32(0.0)


def _update_packed_pq_rows_impl(nbr_codes: jax.Array, neighbors0: jax.Array,
                                codes_all: jax.Array, ids: jax.Array, *,
                                pq_bits: int):
    m0 = neighbors0.shape[1]
    pm = codes_all.shape[1]
    bpn = pm if pq_bits == 8 else (pm + 1) // 2
    u = ids.shape[0]
    ok = ids >= 0
    safe = jnp.maximum(ids, 0)
    rows = jnp.maximum(neighbors0[safe], 0)            # [U, m0]
    nc = codes_all[rows]                               # [U, m0, pm]
    if pq_bits == 4:
        nc = _pack_nibbles(nc)
    upd = nc.reshape(u, m0 * bpn)
    tgt = jnp.where(ok, safe, nbr_codes.shape[0])      # OOB -> dropped
    return nbr_codes.at[tgt].set(upd, mode="drop")


@functools.partial(jax.jit, static_argnames=("pq_bits",), donate_argnums=(0,))
def update_packed_pq_rows(nbr_codes: jax.Array, neighbors0: jax.Array,
                          codes_all: jax.Array, ids: jax.Array, *,
                          pq_bits: int) -> jax.Array:
    """Rewrite the packed-pq rows of ``ids`` (int32 [U], -1 = pad/skip) from
    the CURRENT adjacency + routing codes — the incremental post-``add()``
    maintenance path (mirrors ``update_packed_rows``; the donated table is
    updated in place)."""
    return _update_packed_pq_rows_impl(nbr_codes, neighbors0, codes_all, ids,
                                       pq_bits=pq_bits)

