"""Serving pattern: micro-batching many small requests into device-shaped
launches with hnsw_jax.Searcher.

    python examples/serving_loop.py
"""

import numpy as np

from hnsw_jax import HnswIndex, Searcher


def main():
    rng = np.random.default_rng(0)
    xb = rng.random((20_000, 64), np.float32)
    index = HnswIndex(64, 16, "l2", capacity=1 << 15, ef_construction=80)
    index.add(xb)

    s = Searcher(index, k=10, ef_search=64, max_bucket=1024)

    # direct mode: any request size, no recompiles (pow-2 buckets)
    for n in (1, 3, 17, 500):
        D, I = s.search(rng.random((n, 64), np.float32))
        assert I.shape == (n, 10)

    # coalescing mode: queue tiny requests, serve them in ONE launch
    handles = [s.submit(rng.random((rng.integers(1, 8), 64), np.float32))
               for _ in range(20)]
    s.flush()
    total = sum(s.result(h)[1].shape[0] for h in handles)
    st = s.stats
    print(f"served {st['queries_served']} queries in {st['launches']} "
          f"launches ({st['rows_padded']} padded rows); "
          f"coalesced batch covered {total} rows")

    # runtime knobs: no recompile between these
    s.search(rng.random((8, 64), np.float32), ef_search=128)
    s.search(rng.random((8, 64), np.float32), ef_search=32)
    print("ef sweeps reused the same executable (runtime scalar)")


if __name__ == "__main__":
    main()
