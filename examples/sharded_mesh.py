"""Sharded index over a device mesh: per-shard build, fan-out search,
packed serving, elastic degradation.

On a host with four GPUs this uses the real cards; anywhere else, fake
four devices on the CPU:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
    JAX_PLATFORMS=cpu python examples/sharded_mesh.py
"""

import numpy as np

from hnsw_jax import ShardedHnswIndex, make_mesh


def main():
    mesh = make_mesh(n_shards=4, q_parallel=1)   # 4 devices
    print("mesh:", dict(mesh.shape))

    rng = np.random.default_rng(0)
    xb = rng.random((20_000, 64), np.float32)
    xq = rng.random((512, 64), np.float32)

    index = ShardedHnswIndex(64, 16, "l2", mesh=mesh,
                             capacity_per_shard=8192, ef_construction=80)
    index.add(xb)                   # shard_map'd per-shard builds
    D, I = index.search(xq, 10, ef_search=64)
    print(f"ntotal={index.ntotal}  shard counts={index._counts.tolist()}")

    # packed serving: per-shard code tables, one shard_map build
    nbytes = index.enable_packed(bits=8)
    D2, I2 = index.search(xq, 10, ef_search=64)
    agree = (np.asarray(I) == np.asarray(I2)).mean()
    print(f"packed tables: {nbytes/1e6:.1f} MB, id agreement with "
          f"unpacked: {agree:.3f}")

    # elastic serving: a failed shard degrades coverage, not availability
    index.mark_shard_failed(2)
    D3, I3 = index.search(xq, 10, ef_search=64)
    print(f"degraded (shard 2 out): still {np.asarray(I3).shape} results, "
          f"failed={index.failed_shards}")
    index.mark_shard_ok(2)

    index.save("/tmp/sharded.npz")
    back = ShardedHnswIndex.load("/tmp/sharded.npz", mesh=mesh)
    assert back.ntotal == index.ntotal
    print("save/load over the mesh: ok")


if __name__ == "__main__":
    main()
