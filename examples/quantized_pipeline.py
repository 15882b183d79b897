"""Quantized serving pipeline: OPQ rotation -> HNSW over PQ codes -> exact
rerank — the faiss "OPQ16,HNSW32,PQ16 + RFlat" composition, built via the
same index_factory grammar.

    python examples/quantized_pipeline.py
"""

import numpy as np

from hnsw_jax import FlatIndex, index_factory


def main():
    rng = np.random.default_rng(0)
    # correlated data — the regime OPQ exists for
    w = rng.standard_normal((64, 64)) * np.linspace(2.0, 0.05, 64)
    xb = (rng.standard_normal((15_000, 64)) @ w.T).astype(np.float32)
    xq = (rng.standard_normal((500, 64)) @ w.T).astype(np.float32)

    # 16 bytes/vector storage + learned rotation + exact-f32 rerank
    index = index_factory(64, "OPQ16,HNSW16,PQ16,RFlat", capacity=1 << 14,
                          ef_construction=100, k_factor=8.0)
    index.train(xb)          # trains OPQ rotation, then the PQ codebooks
    index.add(xb)
    D, I = index.search(xq, 10, ef_search=96)

    flat = FlatIndex(64)
    flat.add(xb)
    _, gt = flat.search(xq, 10)
    r = (np.asarray(I)[:, :, None] == np.asarray(gt)[:, None, :]) \
        .any(-1).mean()
    print(f"OPQ16,HNSW16,PQ16,RFlat recall@10 vs exact GT: {r:.4f}")

    # without the rerank, the PQ codes cap recall much lower:
    inner = index.index.index      # PreTransform -> Refine -> HnswIndex
    tq = index.transforms[0].apply(xq)
    _, I_pq = inner.search(tq, 10, ef_search=96)
    r_pq = (np.asarray(I_pq)[:, :, None] == np.asarray(gt)[:, None, :]) \
        .any(-1).mean()
    print(f"same index without rerank:            {r_pq:.4f}")


if __name__ == "__main__":
    main()
