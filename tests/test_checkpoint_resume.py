"""Mid-build checkpoint/resume (SURVEY.md §5).

Guarantees tested:
  * the level RNG stream continues exactly (levels identical to an
    uninterrupted build),
  * resuming is deterministic (two resumes from the same checkpoint are
    bit-identical),
  * the resumed graph is structurally valid and of equivalent quality.
(The resumed graph is NOT bit-identical to an uninterrupted build: an add()
call must flush its final partial batch, so batch boundaries differ — same
as faiss where insert order changes the graph but not its quality.)
"""

import numpy as np

from hnsw_jax import HnswIndex
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k

from conftest import exact_knn


def test_resume(tmp_path):
    wl = synthetic_workload(900, 16, n_queries=80, seed=44)
    kw = dict(capacity=1024, build="device", ef_construction=40, seed=77)

    full = HnswIndex(16, 8, **kw)
    full.add(wl.base)

    part = HnswIndex(16, 8, **kw)
    part.add(wl.base[:500])
    p = str(tmp_path / "ckpt.npz")
    part.save(p)  # mid-build checkpoint

    resumed = []
    for _ in range(2):
        r = HnswIndex.load(p)
        assert r.ntotal == 500
        r.add(wl.base[500:])
        resumed.append(r)

    a, b = resumed
    # deterministic resume
    assert (np.asarray(a.graph.neighbors0) ==
            np.asarray(b.graph.neighbors0)).all()
    # exact RNG continuation: same level stream as the uninterrupted build
    assert (np.asarray(a.graph.levels)[:900] ==
            np.asarray(full.graph.levels)[:900]).all()
    # structural health + equivalent quality
    assert a.check()["errors"] == []
    _, gt = exact_knn(wl.base, wl.queries, 10, "l2")
    _, i_full = full.search(wl.queries, k=10, ef_search=64)
    _, i_res = a.search(wl.queries, k=10, ef_search=64)
    r_full = recall_at_k(i_full, gt, 10)
    r_res = recall_at_k(i_res, gt, 10)
    assert r_res >= r_full - 0.03, (r_res, r_full)
