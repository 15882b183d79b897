"""At-scale regression tier: a packed-table int32 offset
corruption was once invisible to CI because nothing exercised bench-scale node
counts. This tier builds a >=256k-node graph on the CPU backend and checks
the properties that only break at scale: id arithmetic in the packed
serving tables, structural invariants over a large graph, and recall of
both serving paths. Run with `pytest tests/ -m slow`.
"""

import numpy as np
import pytest

import hnsw_jax
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k

pytestmark = pytest.mark.slow

N = 260_000
D = 16
M = 8


@pytest.fixture(scope="module")
def big_index():
    wl = synthetic_workload(N, D, n_queries=512, metric="l2", seed=41)
    idx = hnsw_jax.HnswIndex(D, M, "l2", capacity=N + 8192,
                             ef_construction=48)
    idx.add(wl.base)
    return idx, wl


def test_invariants_at_scale(big_index):
    idx, _ = big_index
    chk = idx.check(strict=False)
    assert not chk["errors"], chk["errors"]
    # the vectorized checker must stay usable as a bench pre-flight
    assert chk.get("reciprocity0", 0) > 0.5
    assert chk.get("deg0_mean", 0) > 2.0


def test_recall_and_packed_agreement_at_scale(big_index):
    """Unpacked recall holds at 256k, and the packed route agrees — the
    canary that would have caught the round-2 overflow class (works at toy
    scale, corrupts at bench scale) had it existed."""
    idx, wl = big_index
    flat = hnsw_jax.FlatIndex(D, "l2")
    flat.add(wl.base)
    _, gt = flat.search(wl.queries, 10)
    gt = np.asarray(gt)

    _, iu = idx.search(wl.queries, 10, ef_search=96)
    r_u = recall_at_k(np.asarray(iu), gt, 10)
    assert r_u >= 0.92, r_u

    idx.enable_packed(bits=8, reserve=8192)
    _, ip_ = idx.search(wl.queries, 10, ef_search=96, use_packed=True)
    r_p = recall_at_k(np.asarray(ip_), gt, 10)
    assert r_p >= r_u - 0.03, (r_p, r_u)

    # incremental maintenance at real chunk sizes (eff_chunk = 65536)
    extra = synthetic_workload(512, D, n_queries=1, metric="l2",
                               seed=43).base
    idx.add(extra)
    assert idx.packed_enabled
    _, ii = idx.search(extra[:64], 1, ef_search=64, use_packed=True)
    hit = (np.asarray(ii)[:, 0] == N + np.arange(64)).mean()
    assert hit >= 0.95, hit
