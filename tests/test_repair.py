"""apply_backlinks vs a literal per-pair NumPy emulation of faiss's
append-or-shrink back-link semantics."""

import numpy as np
import jax.numpy as jnp

from hnsw_jax import HnswConfig, NumpyHnsw
from hnsw_jax.ops.repair import apply_backlinks


def _numpy_apply(adj, dst_rows, dst_ids, src_ids, valid, vectors, metric):
    """Sequential oracle: for each valid pair in dst-grouped order, append or
    heuristic-prune (capacity W), deduping against the current row."""
    adj = adj.copy()
    W = adj.shape[1]
    ref = NumpyHnsw(HnswConfig(dim=vectors.shape[1], m=max(2, W // 2),
                               metric=metric, capacity=len(vectors)))
    ref.vectors[: len(vectors)] = vectors
    order = np.argsort(np.where(valid, dst_rows, 2**31 - 1), kind="stable")
    # group all sources per dst (window semantics: batch-applied at once)
    from collections import OrderedDict
    groups = OrderedDict()
    for p in order:
        if not valid[p]:
            continue
        groups.setdefault(int(dst_rows[p]), []).append(
            (int(dst_ids[p]), int(src_ids[p])))
    for row, pairs in groups.items():
        dst_id = pairs[0][0]
        cur = [x for x in adj[row] if x >= 0]
        news = [s for _, s in pairs if s not in cur]
        cand = cur + news
        if len(cand) <= W:
            out = cand
        else:
            q = vectors[dst_id]
            if metric == "ip":
                d = -(vectors[cand] @ q)
            else:
                d = ((vectors[cand] - q) ** 2).sum(1)
            out = ref.select_neighbors(q, list(zip(d.tolist(), cand)), W)
        adj[row] = -1
        adj[row, : len(out)] = out
    return adj


def test_matches_sequential_oracle():
    rng = np.random.default_rng(0)
    n, d, W = 40, 8, 4
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    adj = np.full((n, W), -1, np.int32)
    # pre-populate some rows
    for i in range(n):
        k = rng.integers(0, W + 1)
        adj[i, :k] = rng.choice(n, size=k, replace=False)

    P = 32
    dst = rng.integers(0, n, size=P).astype(np.int32)
    src = rng.integers(0, n, size=P).astype(np.int32)
    valid = (rng.random(P) < 0.8) & (dst != src)
    # dedupe (dst, src) pairs: at most one back-link per (dst, src) per level
    seen = set()
    for p in range(P):
        if (dst[p], src[p]) in seen:
            valid[p] = False
        elif valid[p]:
            seen.add((dst[p], src[p]))

    got = np.asarray(apply_backlinks(
        jnp.asarray(adj), jnp.asarray(dst), jnp.asarray(dst), jnp.asarray(src),
        jnp.asarray(valid), jnp.asarray(vectors), r_window=16, metric="l2")[0])
    want = _numpy_apply(adj, dst, dst, src, valid, vectors, "l2")
    assert (got == want).all(), np.argwhere(got != want)


def test_append_no_overflow():
    n, d, W = 10, 4, 6
    vectors = np.zeros((n, d), np.float32)
    adj = np.full((n, W), -1, np.int32)
    adj[3, :2] = [1, 2]
    dst = np.array([3, 3], np.int32)
    src = np.array([5, 7], np.int32)
    valid = np.ones(2, bool)
    got = np.asarray(apply_backlinks(
        jnp.asarray(adj), jnp.asarray(dst), jnp.asarray(dst), jnp.asarray(src),
        jnp.asarray(valid), jnp.asarray(vectors))[0])
    assert got[3].tolist() == [1, 2, 5, 7, -1, -1]
    assert (got[[0, 1, 2] + list(range(4, n))] == -1).all()


def test_dedupes_existing_link():
    n, d, W = 6, 4, 4
    vectors = np.zeros((n, d), np.float32)
    adj = np.full((n, W), -1, np.int32)
    adj[2, 0] = 4
    dst = np.array([2], np.int32)
    src = np.array([4], np.int32)  # already present
    got = np.asarray(apply_backlinks(
        jnp.asarray(adj), jnp.asarray(dst), jnp.asarray(dst), jnp.asarray(src),
        jnp.ones(1, bool), jnp.asarray(vectors))[0])
    assert got[2].tolist() == [4, -1, -1, -1]


def test_window_drop_count():
    """Pairs beyond the R-window of a hub destination are counted as dropped
    (observability contract, ops/repair.py docstring)."""
    n, d, W, R = 40, 4, 8, 4
    rng = np.random.default_rng(5)
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    adj = np.full((n, W), -1, np.int32)
    # 10 sources all back-link into destination 0; window R=4 keeps 4
    P = 10
    dst = np.zeros(P, np.int32)
    src = np.arange(1, P + 1, dtype=np.int32)
    _, ndrop = apply_backlinks(
        jnp.asarray(adj), jnp.asarray(dst), jnp.asarray(dst),
        jnp.asarray(src), jnp.ones(P, bool), jnp.asarray(vectors),
        r_window=R)
    assert int(ndrop) == P - R
    # within-window batches drop nothing
    _, ndrop2 = apply_backlinks(
        jnp.asarray(adj), jnp.asarray(dst[:R]), jnp.asarray(dst[:R]),
        jnp.asarray(src[:R]), jnp.ones(R, bool), jnp.asarray(vectors),
        r_window=R)
    assert int(ndrop2) == 0


def test_all_invalid_is_noop():
    n, W = 5, 3
    adj = np.arange(15, dtype=np.int32).reshape(n, W) % n
    got = np.asarray(apply_backlinks(
        jnp.asarray(adj), jnp.zeros(4, jnp.int32), jnp.zeros(4, jnp.int32),
        jnp.zeros(4, jnp.int32), jnp.zeros(4, bool),
        jnp.zeros((n, 4), jnp.float32))[0])
    assert (got == adj).all()


def test_index_r_window_reaches_builder():
    """HnswIndex.r_window is consumed by the lazily created DeviceBuilder
    (the back-link-completeness lever, scripts/backlink_probe.py)."""
    import hnsw_jax
    rng = np.random.default_rng(5)
    x = rng.standard_normal((600, 16), dtype=np.float32)
    idx = hnsw_jax.HnswIndex(16, 8, "l2", capacity=1024, ef_construction=40)
    idx.r_window = 32
    idx.add(x)
    assert idx._builder.r_window == 32
    assert not idx.check(strict=False)["errors"]
