"""Quickstart: build, search, persist — the faiss IndexHNSWFlat flow.

Runs on whatever JAX device is attached; the CPU backend is much slower
than a GPU (it exists for CI, not serving).

    python examples/quickstart.py
"""

import numpy as np

import hnsw_jax


def main():
    rng = np.random.default_rng(0)
    xb = rng.random((20_000, 128), np.float32)   # database
    xq = rng.random((1_000, 128), np.float32)    # queries

    # faiss: index = faiss.IndexHNSWFlat(128, 32)
    index = hnsw_jax.HnswIndex(128, 32, "l2", capacity=1 << 15,
                               ef_construction=100)
    index.add(xb)                                # batched on-device build
    index.ef_search = 64                         # faiss: hnsw.efSearch
    D, I = index.search(xq, k=10)
    print(f"ntotal={index.ntotal}  first hit id={I[0, 0]} "
          f"dist={D[0, 0]:.4f}")

    # exact ground truth (faiss IndexFlat) -> recall
    flat = hnsw_jax.FlatIndex(128)
    flat.add(xb)
    _, gt = flat.search(xq, 10)
    recall = (np.asarray(I)[:, :, None] == np.asarray(gt)[:, None, :]) \
        .any(-1).mean()
    print(f"recall@10 = {recall:.4f}")

    # persist + reload: results are bit-identical
    index.save("/tmp/quickstart.npz")
    index2 = hnsw_jax.HnswIndex.load("/tmp/quickstart.npz")
    D2, I2 = index2.search(xq, k=10)
    assert (np.asarray(I) == np.asarray(I2)).all()
    print("save/load roundtrip: identical results")

    # deletion: tombstone, then physically unlink
    index.remove_ids(np.arange(0, 20_000, 2))    # drop every even id
    index.vacuum()                               # re-prune routing on-device
    _, I3 = index.search(xq, k=10)
    assert (np.asarray(I3)[np.asarray(I3) >= 0] % 2 == 1).all()
    print("deletion + vacuum: only odd ids returned")


if __name__ == "__main__":
    main()
