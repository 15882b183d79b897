#!/usr/bin/env python
"""One-command faiss IndexHNSWFlat parity run (BASELINE.json:8; SURVEY.md §4
item 3, §6).

faiss-cpu is not a dependency of this repository; run THIS script on any
machine where it can be installed:

    pip install "faiss-cpu==1.8.0" numpy && python scripts/faiss_parity.py

It reproduces the exact seeded synthetic workload the GPU bench uses
(hnsw_jax.utils.datasets.synthetic_workload with the same seed/shape — or
real SIFT1M if the TEXMEX files are under $HNSW_DATA, see
scripts/fetch_datasets.sh), builds faiss IndexHNSWFlat single-threaded at
the same hyperparameters, sweeps efSearch, and prints the recall@10 / QPS
frontier as JSON lines comparable to bench.py's output and to the bundled
C++ engine rows (bench.py's denominator).

Parity claim this validates: the recall-vs-ef frontier of the device
engine matches faiss IndexHNSWFlat within tolerance at equal (M,
efConstruction) memory budget.

Env knobs: PARITY_N (default 1_000_000), PARITY_D (128), PARITY_M (32),
PARITY_EFC (100), PARITY_Q (8192), PARITY_THREADS (1),
BENCH_DATASET=sift1m to use the real TEXMEX files instead.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    try:
        import faiss  # type: ignore
    except ImportError:
        print("faiss is not installed. Run on a machine with egress:\n"
              "    pip install 'faiss-cpu==1.8.0'\n"
              "(pin the version so recorded numbers are reproducible)",
              file=sys.stderr)
        return 2

    from hnsw_jax.utils.datasets import load_eval_workload, synthetic_workload
    from hnsw_jax.utils.recall import recall_at_k

    n = int(os.environ.get("PARITY_N", 1_000_000))
    d = int(os.environ.get("PARITY_D", 128))
    m = int(os.environ.get("PARITY_M", 32))
    efc = int(os.environ.get("PARITY_EFC", 100))
    nq = int(os.environ.get("PARITY_Q", 8192))
    threads = int(os.environ.get("PARITY_THREADS", 1))
    dataset = os.environ.get("BENCH_DATASET", "")

    if dataset:
        wl = load_eval_workload(dataset, n_queries=nq)
    else:
        # EXACT same seeded workload as `python bench.py` on the GPU side
        wl = synthetic_workload(n, d, n_queries=nq, metric="l2", seed=1234,
                                name=f"sift-shaped-{n}x{d}")
    base = np.ascontiguousarray(wl.base, np.float32)
    queries = np.ascontiguousarray(wl.queries, np.float32)
    n, d = base.shape

    # ground truth: faiss exact flat search (multithreaded — oracle only)
    if wl.ground_truth is not None:
        gt = np.asarray(wl.ground_truth[:, :10])
    else:
        t0 = time.time()
        flat = faiss.IndexFlatL2(d) if wl.metric == "l2" \
            else faiss.IndexFlatIP(d)
        flat.add(base)
        _, gt = flat.search(queries, 10)
        print(f"# brute-force GT: {time.time() - t0:.1f}s", file=sys.stderr)

    fmetric = (faiss.METRIC_INNER_PRODUCT if wl.metric == "ip"
               else faiss.METRIC_L2)
    faiss.omp_set_num_threads(threads)
    idx = faiss.IndexHNSWFlat(d, m, fmetric)
    idx.hnsw.efConstruction = efc
    t0 = time.time()
    idx.add(base)
    build_s = time.time() - t0
    print(f"# faiss build ({threads} thread(s)): {build_s:.1f}s "
          f"({n / build_s:.0f} inserts/s)", file=sys.stderr)

    rows = []
    for ef in (16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512):
        idx.hnsw.efSearch = ef
        t0 = time.time()
        _, ii = idx.search(queries, 10)
        dt = time.time() - t0
        r = recall_at_k(ii, gt, 10)
        row = {"system": f"faiss-IndexHNSWFlat-{threads}t",
               "faiss_version": faiss.__version__,
               "workload": wl.name, "n": n, "d": d, "M": m, "efC": efc,
               "ef": ef, "recall@10": round(float(r), 4),
               "qps": round(len(queries) / dt, 1),
               "build_seconds": round(build_s, 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if r >= 0.999:
            break

    at_target = [x for x in rows if x["recall@10"] >= 0.95]
    if at_target:
        best = max(at_target, key=lambda x: x["qps"])
        print(f"# faiss operating point: {best['qps']} qps @ "
              f"recall {best['recall@10']} (ef={best['ef']}) — compare "
              f"bench.py's output at the same workload", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
