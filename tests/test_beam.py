"""One hop of the beam engine (ops/beam.py beam_search) against a NumPy
reference of the per-hop contract: nearest-unexpanded selection and its
expansion mark, buffer-membership dedup of the candidates, top-ef merge,
and the runtime ef_live mask."""

import numpy as np
import jax.numpy as jnp
import pytest

from hnsw_jax.ops import beam as beam_ops


def _ref_hop(buf_d, buf_i, buf_e, cand_i, cand_d, ef_live):
    """NumPy reference of one hop, per query: returns the new buffer as a
    list of (dist, id, expanded) rows plus the distance count."""
    qn, ef = buf_d.shape
    out, ndis = [], np.zeros(qn, np.int32)
    for q in range(qn):
        entries = [(float(buf_d[q, i]), int(buf_i[q, i]), bool(buf_e[q, i]))
                   for i in range(ef)]
        open_ = [i for i in range(ef) if not entries[i][2]
                 and entries[i][0] < np.inf]
        if open_:
            j = min(open_, key=lambda i: entries[i][0])
            d0, i0, _ = entries[j]
            entries[j] = (d0, i0, True)
            members = set(buf_i[q].tolist())
            for c, cd in zip(cand_i[q], cand_d[q]):
                if c >= 0 and int(c) not in members:
                    ndis[q] += 1
                    entries.append((float(cd), int(c), False))
        entries.sort(key=lambda t: t[0])
        entries = entries[:ef]
        entries = [e if i < ef_live else (np.inf, -1, True)
                   for i, e in enumerate(entries)]
        out.append(entries)
    return out, ndis


@pytest.mark.parametrize("ef,K,ef_live", [(64, 64, 64), (32, 64, 32),
                                          (64, 64, 48), (128, 48, 100)])
def test_beam_hop_matches_reference(ef, K, ef_live):
    qn = 128
    rng = np.random.default_rng(ef * 1000 + K)
    n_fill = rng.integers(1, ef, qn)
    buf_d = np.full((qn, ef), np.inf, np.float32)
    buf_i = np.full((qn, ef), -1, np.int32)
    buf_e = np.ones((qn, ef), bool)
    for q in range(qn):
        nf = n_fill[q]
        buf_d[q, :nf] = np.sort(rng.standard_normal(nf).astype(np.float32))
        buf_i[q, :nf] = rng.choice(1 << 20, nf, replace=False)
        buf_e[q, :nf] = rng.random(nf) < 0.5
    # candidates: distinct per query, some already in the buffer, some -1
    cand_i = np.stack([rng.choice(1 << 20, K, replace=False)
                       for _ in range(qn)]).astype(np.int32)
    for q in range(qn):
        dup = np.flatnonzero(rng.random(K) < 0.2)[: n_fill[q]]
        cand_i[q, dup] = rng.choice(buf_i[q, :n_fill[q]], len(dup),
                                    replace=False)
    cand_i[rng.random((qn, K)) < 0.15] = -1
    cand_d = rng.standard_normal((qn, K)).astype(np.float32)

    state = beam_ops.BeamState(
        jnp.asarray(buf_i), jnp.asarray(buf_d), jnp.asarray(buf_e),
        jnp.zeros((qn, 1), jnp.uint32), jnp.asarray(0, jnp.int32),
        jnp.zeros((qn,), jnp.int32))
    ci, cd = jnp.asarray(cand_i), jnp.asarray(cand_d)
    out = beam_ops.beam_search(
        state, lambda cur: ci[:, None, :], lambda ids, mask: cd,
        max_hops=1, ef_live=jnp.int32(ef_live))
    ref, ref_ndis = _ref_hop(buf_d, buf_i, buf_e, cand_i, cand_d, ef_live)

    assert int(out.hops) == 1
    np.testing.assert_array_equal(np.asarray(out.ndis), ref_ndis)
    od, oi, oe = (np.asarray(out.buf_dist), np.asarray(out.buf_ids),
                  np.asarray(out.buf_exp))
    for q in range(qn):
        got = [(float(od[q, i]), int(oi[q, i]), bool(oe[q, i]))
               for i in range(ef)]
        assert got == ref[q], q
