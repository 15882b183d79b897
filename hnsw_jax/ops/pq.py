"""Product quantization — faiss ``IndexHNSWPQ`` / ``ProductQuantizer``
capability parity (SURVEY.md §1b storage-codec layer; upstream
``faiss/impl/ProductQuantizer.{h,cpp}`` + ``faiss/IndexHNSW.h`` IndexHNSWPQ,
not in snapshot — the reference is the 2-line README naming faiss as the
spec, /root/reference/README.md:2).

Semantics: the d-dim space is split into ``m_sub`` contiguous subspaces of
``dsub = d / m_sub`` dims; each subspace gets a k-means codebook of
``ksub = 256`` centroids (8 bits/sub-code, the faiss default); a vector is
stored as ``m_sub`` uint8 codes. Every search/build distance is the ADC
(asymmetric distance computation) value — the exact distance between the
raw query and the RECONSTRUCTION x̂ — so, like faiss, the engine is exact
over x̂ and the recall ceiling is set by the codes, not the traversal.

Device realization:
  * training: all subspaces' Lloyd iterations run BATCHED in one program
    (assignment = one [n, m, ksub] einsum, centroid update = a
    one-hot matmul), chunked over n so nothing n×ksub-sized materializes.
  * query-side distances ride a per-query LUT [Q, m_sub, ksub] (one einsum),
    then every candidate distance is ``m_sub`` in-register table lookups —
    the stored rows fetched per hop shrink from d floats to m_sub BYTES,
    which also makes PQ the lowest-bandwidth routing mode in the package.
  * LUT entries hold the per-subspace L2 SURROGATE ``||c||² - 2 q_m·c``
    (IP: ``-q_m·c``); summed over subspaces they equal the global surrogate
    ``||x̂||² - 2 q·x̂`` exactly, so PQ distances compose with the package's
    surrogate convention (search.py docstring) unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..config import IP

KSUB = 256  # 8 bits per sub-code (faiss ProductQuantizer default);
# ksub=16 (4 bits, faiss PQx4 "fast-scan" parity) is supported everywhere —
# every consumer derives ksub from the codebook/LUT shape.


def split_sub(x: jax.Array, m_sub: int) -> jax.Array:
    """[..., d] -> [..., m_sub, dsub] contiguous subspace view."""
    d = x.shape[-1]
    return x.reshape(*x.shape[:-1], m_sub, d // m_sub)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _assign_update(xs: jax.Array, cb: jax.Array, *, chunk: int):
    """One Lloyd step over all subspaces at once, streamed in n-chunks.

    xs: f32 [n, m, dsub] (n divisible by chunk — caller pads), cb: f32
    [m, ksub, dsub]. Returns (sums [m, ksub, dsub], counts [m, ksub],
    sse []) — the caller divides and handles empty clusters."""
    n, m, dsub = xs.shape
    ksub = cb.shape[1]
    cb_sq = jnp.sum(cb * cb, axis=-1)                       # [m, ksub]

    def step(carry, xt):                                     # xt [chunk, m, dsub]
        sums, counts, sse = carry
        dots = jnp.einsum("nmd,mkd->nmk", xt, cb,
                          preferred_element_type=jnp.float32)
        dist = cb_sq[None] - 2.0 * dots                      # [chunk, m, ksub]
        code = jnp.argmin(dist, axis=-1)                     # [chunk, m]
        best = jnp.take_along_axis(dist, code[..., None], axis=-1)[..., 0]
        oh = jax.nn.one_hot(code, ksub, dtype=jnp.float32)   # [chunk, m, ksub]
        sums = sums + jnp.einsum("nmk,nmd->mkd", oh, xt,
                                 preferred_element_type=jnp.float32)
        counts = counts + jnp.sum(oh, axis=0)
        xsq = jnp.sum(xt * xt, axis=-1)                      # [chunk, m]
        sse = sse + jnp.sum(best + xsq)  # ||x-c||² = ||x||² + (||c||²-2x·c)
        return (sums, counts, sse), None

    init = (jnp.zeros((m, ksub, dsub), jnp.float32),
            jnp.zeros((m, ksub), jnp.float32), jnp.float32(0.0))
    (sums, counts, sse), _ = jax.lax.scan(
        step, init, xs.reshape(-1, chunk, m, dsub))
    return sums, counts, sse


def train_pq(x: np.ndarray, m_sub: int, *, ksub: int = KSUB,
             iters: int = 25, seed: int = 42,
             max_points: int = 65536, chunk: int = 8192,
             init_cb: np.ndarray | None = None) -> np.ndarray:
    """Per-subspace k-means (faiss ``ProductQuantizer::train`` semantics:
    Lloyd iterations, ``ksub`` centroids — 256 for the faiss 8-bit default,
    16 for PQx4 fast-scan parity — training subsampled to ``max_points``).
    Deterministic given ``seed``. Returns f32 codebooks [m_sub, ksub, dsub]
    as numpy (callers device_put / close over them).

    ``init_cb`` warm-starts the codebooks (shape [m_sub, ksub, dsub]) — the
    OPQ alternating loop re-trains with few iterations per rotation update
    (faiss ``OPQMatrix::train`` does the same)."""
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if d % m_sub:
        raise ValueError(f"pq_m={m_sub} must divide d={d}")
    if n < ksub:
        raise ValueError(f"PQ training needs >= {ksub} points, got {n} "
                         "(faiss ProductQuantizer has the same floor)")
    rng = np.random.default_rng(seed)
    if n > max_points:
        x = x[rng.choice(n, max_points, replace=False)]
        n = max_points
    dsub = d // m_sub
    xs_np = x.reshape(n, m_sub, dsub)
    if init_cb is not None:
        if init_cb.shape != (m_sub, ksub, dsub):
            raise ValueError(f"init_cb shape {init_cb.shape} != "
                             f"{(m_sub, ksub, dsub)}")
        cb = np.asarray(init_cb, np.float32)
    else:
        # init: a shared random sample of training points (faiss seeds each
        # subquantizer from the data too)
        cb = np.ascontiguousarray(
            xs_np[rng.choice(n, ksub, replace=False)].transpose(1, 0, 2))
    pad = (-n) % chunk
    xs = jnp.asarray(np.concatenate(
        [xs_np, np.zeros((pad, m_sub, dsub), np.float32)]) if pad else xs_np)
    # padded rows are all-zero: they bias the cluster nearest the origin.
    # Correct by subtracting their contribution from that cluster's count
    # and (zero) sum — cheap host-side fixup, exact.
    cb_dev = jnp.asarray(cb)
    ck = min(chunk, xs.shape[0])
    for _ in range(iters):
        sums, counts, _ = _assign_update(xs, cb_dev, chunk=ck)
        sums = np.asarray(sums)
        counts = np.array(counts)  # copy: jax buffers view as read-only
        if pad:
            z = np.argmin(np.sum(np.asarray(cb_dev) ** 2, axis=-1), axis=-1)
            counts[np.arange(m_sub), z] -= pad
        new_cb = np.where(counts[..., None] > 0,
                          sums / np.maximum(counts[..., None], 1),
                          np.asarray(cb_dev))
        # empty clusters: re-seed from random training points (seeded) —
        # the faiss fix splits the largest cluster; random restart converges
        # to the same quality in the remaining iterations
        empty_m, empty_k = np.nonzero(counts <= 0)
        if len(empty_m):
            steal = rng.integers(0, n, size=len(empty_m))
            new_cb[empty_m, empty_k] = xs_np[steal, empty_m]
        cb_dev = jnp.asarray(new_cb)
    return np.asarray(cb_dev)


@functools.partial(jax.jit, static_argnames=("chunk",))
def encode_pq(x: jax.Array, cb: jax.Array, *, chunk: int = 1 << 16,
              dequant=None) -> jax.Array:
    """f32 [n, d] -> uint8 codes [n, m_sub] (nearest centroid per subspace),
    streamed in n-chunks so the [n, m, ksub] distance tensor never
    materializes (16 GB at 1M x m=16).

    ``dequant``: optional (offset [d], scale [d]) when ``x`` holds sq8
    storage codes — each chunk is dequantized to x̂ in-register before
    encoding (never materializing an f32 copy of the table)."""
    n, d = x.shape
    m_sub = cb.shape[0]
    cb_sq = jnp.sum(cb * cb, axis=-1)

    def enc(xt):
        xt = xt.astype(jnp.float32)
        if dequant is not None:
            xt = dequant[0] + dequant[1] * xt
        xsub = split_sub(xt, m_sub)
        dots = jnp.einsum("nmd,mkd->nmk", xsub, cb,
                          preferred_element_type=jnp.float32)
        return jnp.argmin(cb_sq[None] - 2.0 * dots, axis=-1).astype(jnp.uint8)

    if n <= chunk:
        return enc(x)
    pad = (-n) % chunk
    xp = jnp.pad(x, ((0, pad), (0, 0)))
    out = jax.lax.map(enc, xp.reshape(-1, chunk, d))
    return out.reshape(-1, m_sub)[:n]


def decode_pq(codes: jax.Array, cb: jax.Array) -> jax.Array:
    """uint8 codes [..., m_sub] -> reconstruction x̂ f32 [..., d]. One gather
    of m_sub dsub-wide rows per vector from the flattened codebook."""
    m_sub, ksub, dsub = cb.shape
    flat = jnp.asarray(cb).reshape(m_sub * ksub, dsub)
    idx = codes.astype(jnp.int32) + \
        jnp.arange(m_sub, dtype=jnp.int32) * ksub       # [..., m_sub]
    return flat[idx].reshape(*codes.shape[:-1], m_sub * dsub)


def pq_lut(queries: jax.Array, cb: jax.Array, metric: str) -> jax.Array:
    """Per-query ADC tables [Q, m_sub, ksub] holding the per-subspace
    SURROGATE ``||c||² - 2 q_m·c`` (IP: ``-q_m·c``); summing a vector's
    m_sub entries equals the global surrogate distance to x̂ exactly."""
    cb = jnp.asarray(cb)
    m_sub = cb.shape[0]
    qsub = split_sub(queries.astype(jnp.float32), m_sub)  # [Q, m, dsub]
    dots = jnp.einsum("qmd,mkd->qmk", qsub, cb,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    if metric == IP:
        return -dots
    return jnp.sum(cb * cb, axis=-1)[None] - 2.0 * dots


def adc_distance(lut: jax.Array, codes: jax.Array) -> jax.Array:
    """lut [Q, m_sub, ksub] x codes [Q, K, m_sub] -> surrogate distances
    [Q, K] via per-element LUT lookups.

    NOT the hot path: Q*K*m_sub per-element take_along_axis lookups are
    an element-rate gather, where the one-hot-matmul decode formulation is
    dense. Kept as the reference implementation (tests) and for small
    host-side calls; serving and build route through
    ``adc_decode_distance``."""
    idx = jnp.swapaxes(codes.astype(jnp.int32), -1, -2)   # [Q, m, K]
    vals = jnp.take_along_axis(lut, idx, axis=-1)          # [Q, m, K]
    return jnp.sum(vals, axis=-2)


def _decode_onehot(codes: jax.Array, cb: jax.Array, dt, precision):
    """codes [..., m] -> x̂ [..., m*dsub] by one-hot matmul (no gather).

    With ``dt=float32`` + HIGHEST precision the selection is EXACT (each
    output element is 1.0 * one codebook entry accumulated in f32)."""
    m_sub, ksub, dsub = cb.shape
    oh = jax.nn.one_hot(codes.astype(jnp.int32), ksub, dtype=dt)
    xh = jnp.einsum("...mc,mcd->...md", oh, cb.astype(dt),
                    preferred_element_type=jnp.float32,
                    precision=precision)
    return xh.reshape(*codes.shape[:-1], m_sub * dsub)


def adc_decode_distance(cb: jax.Array, queries: jax.Array, codes: jax.Array,
                        metric: str, *, exact: bool = False,
                        max_bytes: int = 1 << 29) -> jax.Array:
    """Surrogate ADC distances [Q, K] from cb [m, ksub, dsub], queries
    [Q, d], codes [Q, K, m] — value-equal to the LUT formulation
    (``sum_m lut[q, m, codes]``): decode x̂ by a one-hot matmul, then
    contract with the query — dense products in place of per-element LUT
    lookups.

    ``exact=False`` (routing): default-precision matmuls — TF32 on the
    GPU (~1e-3 relative rounding of x̂; no looser than the single bf16
    pass it was first tuned with), well under PQ's own quantization error;
    the extraction rerank restores exact ADC values. f32 operands keep
    the CPU backend happy (its dot thunk lacks bf16 x bf16 -> f32).
    ``exact=True`` (rerank/oracle-grade): HIGHEST precision — the decode
    is bit-exact (each x̂ element is 1.0 * one f32 codebook entry) and
    distances match the brute-force ADC oracle.

    The one-hot transient is [Q, K, m, ksub] f32; queries are chunked with
    lax.map so it stays under ``max_bytes``.
    """
    q, k = codes.shape[:2]
    m_sub, ksub, _ = cb.shape
    dt = jnp.float32
    prec = jax.lax.Precision.HIGHEST if exact else None
    itemsize = 4
    qf = queries.astype(jnp.float32)

    def dist(args):
        qc, cc = args
        xh = _decode_onehot(cc, cb, dt, prec)              # [cq, K, d]
        dots = jnp.einsum("qd,qkd->qk", qc, xh,
                          preferred_element_type=jnp.float32,
                          precision=prec)
        if metric == IP:
            return -dots
        sq = jnp.einsum("qkd,qkd->qk", xh, xh,
                        preferred_element_type=jnp.float32,
                        precision=prec)
        return sq - 2.0 * dots

    row_bytes = max(k * m_sub * ksub * itemsize, 1)
    chunk = max(min(q, max_bytes // row_bytes), 1)
    if chunk >= q:
        return dist((qf, codes))
    pad = (-q) % chunk
    qp = jnp.pad(qf, ((0, pad), (0, 0)))
    cp = jnp.pad(codes, ((0, pad), (0, 0), (0, 0)))
    out = jax.lax.map(dist, (qp.reshape(-1, chunk, qf.shape[1]),
                             cp.reshape(-1, chunk, k, m_sub)))
    return out.reshape(-1, k)[:q]


def pq_sqnorms(codes: jax.Array, cb: jax.Array) -> jax.Array:
    """||x̂||² per row from codes alone: gather from the per-centroid norm
    table (exact — subspaces are orthogonal coordinate blocks)."""
    m_sub, ksub, _ = cb.shape
    cb = jnp.asarray(cb)
    norms = jnp.sum(cb * cb, axis=-1).reshape(-1)          # [m*ksub]
    idx = codes.astype(jnp.int32) + \
        jnp.arange(m_sub, dtype=jnp.int32) * ksub
    return jnp.sum(norms[idx], axis=-1)
