"""Precompute + commit the CPU-baseline cache entry for a bench config:
the single-core C++ baseline build at 1M takes many minutes, too long to
repeat in every bench run. Run this once per eval config on a quiet
machine; bench.py then reads the committed cache and prints its parsed
summary with a real vs_baseline immediately.

Usage mirrors bench.py's env knobs: BENCH_N/D/Q/M/EFC/BENCH_DATASET/
BENCH_CPU_N/BENCH_TARGET_RECALL.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from hnsw_jax.utils.datasets import (load_eval_workload,  # noqa: E402
                                     synthetic_workload)


def main():
    n = int(os.environ.get("BENCH_N", 1_000_000))
    d = int(os.environ.get("BENCH_D", 128))
    nq = int(os.environ.get("BENCH_Q", 8192))
    n_probe = int(os.environ.get("BENCH_PROBE_Q", 2048))
    m = int(os.environ.get("BENCH_M", 32))
    efc = int(os.environ.get("BENCH_EFC", 100))
    dataset = os.environ.get("BENCH_DATASET", "")
    target_recall = float(os.environ.get("BENCH_TARGET_RECALL", 0.95))

    if dataset:
        wl = load_eval_workload(dataset, n_queries=nq + n_probe)
    else:
        wl = synthetic_workload(n, d, n_queries=nq + n_probe, metric="l2",
                                seed=1234, name=f"sift-shaped-{n}x{d}")
    base = wl.base
    queries = wl.queries[:nq]
    n, d = base.shape
    nq_cap = min(len(queries), 1000)
    cpu_n = min(len(base), int(os.environ.get("BENCH_CPU_N", len(base))))
    key = (f"{wl.name}|M={m}|efC={efc}|target={target_recall}"
           f"|nq={nq_cap}|cpu_n={cpu_n}")
    print(f"[precompute] key={key}", flush=True)
    cached = bench._baseline_cache_get(key)
    if cached[1] is not None and os.environ.get("PRECOMPUTE_FORCE") != "1":
        print(f"[precompute] already cached: {cached}", flush=True)
        return

    # ground truth for the capped query set — device brute force if a chip
    # is up, else exact NumPy (fine at nq_cap=1000). When the baseline is
    # CAPPED (cpu_n < n), skip this entirely: _cpu_baseline_qps computes
    # the subset GT itself (the full-set GT would go unused — and at
    # deep10m it costs ~11 min of device time).
    if cpu_n < n:
        gt = None
    elif wl.ground_truth is not None:
        gt = wl.ground_truth[:nq_cap, :10]
    else:
        t0 = time.time()
        try:
            import jax.numpy as jnp
            import hnsw_jax
            flat = hnsw_jax.FlatIndex(d, wl.metric)
            flat.add(base)
            _, gt = flat.search(queries[:nq_cap], 10)
            gt = np.asarray(gt)
            del flat
        except Exception as e:  # noqa: BLE001 — no chip: NumPy oracle
            print(f"[precompute] device GT unavailable ({e!r}) — NumPy",
                  flush=True)
            # dot-product formulation (bench._subset_gt): the naive
            # [64, n, d] broadcast is 245 GB at 1M x 960
            gt = bench._subset_gt(base, queries[:nq_cap], wl.metric)
        print(f"[precompute] GT: {time.time()-t0:.1f}s", flush=True)

    qps, src = bench._cpu_baseline_qps(base, queries, gt, wl.metric, m, efc,
                                       target_recall)
    if src != "none":
        bench._baseline_cache_put(key, qps, src)
    print(f"[precompute] done: {qps} qps [{src}]", flush=True)


if __name__ == "__main__":
    main()
