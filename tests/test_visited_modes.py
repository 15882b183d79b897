"""The fast 'buffer' dedup must be outcome-equivalent to the exact 'bitmap'
visited set (the argument in ops/beam.py's docstring, verified here)."""

import numpy as np
import jax.numpy as jnp

from hnsw_jax.search import compute_sqnorms, hnsw_search


def test_buffer_equals_bitmap(host_index, small_workload):
    wl = small_workload
    graph = host_index.to_graph_arrays()
    vectors = jnp.asarray(host_index.vectors)
    sq = compute_sqnorms(vectors)
    qs = jnp.asarray(wl.queries)
    out = {}
    for mode in ("buffer", "bitmap"):
        d, i = hnsw_search(graph, vectors, sq, qs, k=10, ef_search=48,
                           metric="l2", max_level_cap=6, visited_mode=mode)
        out[mode] = (np.asarray(d), np.asarray(i))
    # identical result sets (expansion order and termination coincide)
    assert (out["buffer"][1] == out["bitmap"][1]).mean() > 0.999
    np.testing.assert_allclose(out["buffer"][0], out["bitmap"][0],
                               rtol=1e-5, atol=1e-5)


def test_buffer_equals_bitmap_small_ef(host_index, small_workload):
    """Tight ef stresses displacement/re-encounter paths."""
    wl = small_workload
    graph = host_index.to_graph_arrays()
    vectors = jnp.asarray(host_index.vectors)
    sq = compute_sqnorms(vectors)
    qs = jnp.asarray(wl.queries[:40])
    outs = []
    for mode in ("buffer", "bitmap"):
        _, i = hnsw_search(graph, vectors, sq, qs, k=5, ef_search=8,
                           metric="l2", max_level_cap=6, visited_mode=mode)
        outs.append(np.asarray(i))
    assert (outs[0] == outs[1]).mean() > 0.99
