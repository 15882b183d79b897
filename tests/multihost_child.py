"""Child process for tests/test_multihost.py: one of N jax.distributed
processes, each holding 4 virtual CPU devices, jointly running the sharded
index over the GLOBAL 8-device mesh. Usage:
    python multihost_child.py <process_id> <num_processes> <port>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax
jax.config.update("jax_platforms", "cpu")

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid,
                           initialization_timeout=60)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from hnsw_jax.parallel.sharded import ShardedHnswIndex, make_mesh
from hnsw_jax.utils.datasets import synthetic_workload
from hnsw_jax.utils.recall import recall_at_k

assert jax.device_count() == 4 * nproc, jax.device_count()
assert jax.local_device_count() == 4

mesh = make_mesh(n_shards=4, q_parallel=2)  # spans both processes
wl = synthetic_workload(800, 16, n_queries=32, metric="l2", seed=31)
idx = ShardedHnswIndex(16, 8, "l2", mesh=mesh, capacity_per_shard=512,
                       ef_construction=60, seed=17)
idx.add(np.asarray(wl.base))
assert idx.ntotal == 800

d, i = idx.search(np.asarray(wl.queries), k=10, ef_search=64)
dmat = ((np.asarray(wl.queries)[:, None, :]
         - np.asarray(wl.base)[None, :, :]) ** 2).sum(-1)
gt = np.argsort(dmat, axis=1)[:, :10]
r = recall_at_k(i, gt, 10)
assert r >= 0.9, r

# degraded serving across hosts: mask one shard, survivors still answer
idx.mark_shard_failed(1)
_, i_deg = idx.search(np.asarray(wl.queries), k=10, ef_search=64)
live = i_deg[i_deg >= 0]
assert live.size and not (live % 4 == 1).any()

print(f"proc {pid}: recall@10={r:.3f} MULTIHOST OK", flush=True)
