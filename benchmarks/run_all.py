"""Sweep the BASELINE.json eval configs (SURVEY.md §2b C15) and emit JSON
lines per (config, efSearch) point — the ann-benchmarks-style harness.

Usage:
    python benchmarks/run_all.py [config ...]   # default: sift10k sift1m
Configs: sift10k sift1m gist1m glove100 deep10m (real files under
$HNSW_DATA when present, equal-shape synthetic otherwise — the loader
records which). Results print as JSON lines and append to
chiprun_out/run_all.jsonl (not committed). Fails when JAX finds no GPU.

Sizes can be scaled down for smoke runs: BENCH_SCALE=0.1 uses 10% of each
config's database.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

logging.basicConfig(stream=sys.stderr, level=logging.INFO,
                    format="[%(name)s] %(message)s")

CONFIG_HP = {  # BASELINE.json:7-11 hyperparameters
    "sift10k": dict(m=16, efc=200, ef_sweep=(16, 32, 64)),
    "sift1m": dict(m=32, efc=100, ef_sweep=(16, 32, 48, 64, 96, 128, 192,
                                            256, 384, 512)),
    "gist1m": dict(m=32, efc=100, ef_sweep=(32, 64, 128, 256)),
    "glove100": dict(m=32, efc=100, ef_sweep=(32, 64, 128, 256)),
    "deep10m": dict(m=32, efc=100, ef_sweep=(32, 64, 96, 128, 192, 256)),
}


def device_record() -> dict:
    """platform, kind, count and the card's nvidia-smi name and power
    limit; exits when JAX finds no GPU."""
    import subprocess
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        logging.error("no GPU (JAX platform %r)", devs[0].platform)
        sys.exit(2)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card}


def run_config(name: str, scale: float, out, device: dict):
    import jax
    import jax.numpy as jnp
    import hnsw_jax
    from hnsw_jax.utils.datasets import load_eval_workload
    from hnsw_jax.utils.recall import recall_at_k

    hp = CONFIG_HP[name]
    wl = load_eval_workload(name, n_queries=8192)
    base = wl.base
    if scale < 1.0:
        base = base[: max(1000, int(len(base) * scale))]
    n, d = base.shape
    logging.info("config=%s n=%d d=%d metric=%s", wl.name, n, d, wl.metric)

    cap = 1 << (n - 1).bit_length()
    if cap >= 1 << 24:  # config caps per-index capacity below 2^24
        cap = n
    kw = {}
    big = n >= 8_000_000
    if big:
        # deep10m device-memory budget: trim the upper-table headroom
        # 4x -> 2x (need is cap/m rows; still ~2x margin) to make room for
        # program temps
        kw["upper_capacity"] = 2 * cap // hp["m"]
    idx = hnsw_jax.HnswIndex(d, hp["m"], wl.metric, capacity=cap,
                             ef_construction=hp["efc"], **kw)

    t0 = time.time()
    # chunk large adds: each add() stages its schedule on device, so a
    # 10M-point single call would hold dataset + staging + graph at once
    chunk = 2_500_000 if n < 8_000_000 else 1_250_000
    for s in range(0, n, chunk):
        idx.add(base[s:s + chunk])
    build_s = time.time() - t0
    logging.info("build: %.1fs (%.0f inserts/s)", build_s, n / build_s)

    # ground truth AFTER the build, from the index's own device-resident
    # vectors — no second multi-GB copy of base on device
    if wl.ground_truth is not None and scale >= 1.0:
        gt = wl.ground_truth[:, :10]
    else:
        t0 = time.time()
        # n_valid (not an eager [:n] slice — that would materialize a full
        # multi-GB copy of the capacity-sized vector array)
        _, gt = hnsw_jax.brute_force_topk(
            jnp.asarray(np.asarray(wl.queries, np.float32)), idx.vectors,
            k=10, metric=wl.metric, tile_n=16384 if big else 65536,
            n_valid=n)
        gt = np.asarray(gt)
        logging.info("brute-force GT: %.1fs", time.time() - t0)

    # packed serving mode, mirroring bench.py: on for configs below 8M
    # rows (BENCH_PACKED=0 disables, =4/=8 forces the bit width), then a
    # packed-vs-unpacked recall canary at one ef — a diverging packed path
    # fails the run, it is never timed
    packed_env = os.environ.get("BENCH_PACKED", "auto")
    packed_bits = 0
    if packed_env != "0" and (not big or packed_env in ("4", "8")):
        packed_bits = int(packed_env) if packed_env in ("4", "8") else 8
        t0 = time.time()
        nb = idx.enable_packed(bits=packed_bits)
        logging.info("packed tables: %.2f GB (%d-bit) in %.1fs",
                     nb / 1e9, packed_bits, time.time() - t0)
        nc = min(len(wl.queries), 1024)
        qc = jnp.asarray(np.asarray(wl.queries[:nc], np.float32))
        _, ic_p = idx.search(qc, k=10, ef_search=64, use_packed=True)
        _, ic_u = idx.search(qc, k=10, ef_search=64, use_packed=False)
        r_p = recall_at_k(np.asarray(ic_p), gt[:nc], 10)
        r_u = recall_at_k(np.asarray(ic_u), gt[:nc], 10)
        logging.info("packed canary: %.4f / %.4f", r_p, r_u)
        if r_p < r_u - 0.05:
            raise RuntimeError(f"packed canary failed: packed recall "
                               f"{r_p:.4f} vs unpacked {r_u:.4f}")

    # timed sweep: queries staged on device once, results stay device-side
    # during timing, best-of-reps
    idx.beam_keys = os.environ.get("BENCH_BEAM_KEYS", "auto")
    reps = int(os.environ.get("BENCH_REPS", 3))
    qs = jnp.asarray(np.asarray(wl.queries, np.float32))

    def timed_point(ef, max_hops=0):
        dd, ii = idx.search(qs, k=10, ef_search=ef, max_hops=max_hops,
                            device_out=True)
        jax.block_until_ready(ii)
        times = []
        for _ in range(max(reps, 1)):
            t0 = time.time()
            dd, ii = idx.search(qs, k=10, ef_search=ef, max_hops=max_hops,
                                device_out=True)
            jax.block_until_ready(ii)
            times.append(time.time() - t0)
        return (round(recall_at_k(np.asarray(ii), gt, 10), 4),
                round(len(wl.queries) / min(times), 1))

    def emit(ef, r, qps, max_hops=0):
        rec = {
            "config": name, "workload": wl.name, "n": n, "d": d,
            "metric": wl.metric, "m": hp["m"], "ef_construction": hp["efc"],
            "ef_search": ef, "max_hops": max_hops,
            "recall@10": r, "qps": qps,
            "build_seconds": round(build_s, 1),
            "batch": len(wl.queries),
            "packed_bits": packed_bits, "beam_keys": idx.beam_keys,
            "device": device,
        }
        print(json.dumps(rec), flush=True)
        out.write(json.dumps(rec) + "\n")
        out.flush()

    best = None
    for ef in hp["ef_sweep"]:
        r, qps = timed_point(ef)
        emit(ef, r, qps)
        if r >= 0.95 and best is None:
            best = (ef, r, qps)

    # refined operating point (mirrors bench.py): tune (ef, hop cap) on a
    # probe prefix, then time the refined pair as its own results row
    if best is not None and os.environ.get("BENCH_REFINE", "1") != "0":
        ef_r, hops_r = idx.tune_operating_point(
            qs[: min(len(wl.queries), 2048)], 0.95, k=10,
            set_default=False,
            ef_grid=tuple(e for e in (16, 24, 32, 40, 48, 56, 64, 80,
                                      96, 128, 192, 256, 384, 512)
                          if e <= best[0] + 16))
        r, qps = timed_point(ef_r, hops_r)
        logging.info("refined op point: ef=%d hops=%d recall=%.4f "
                     "qps=%.0f", ef_r, hops_r, r, qps)
        emit(ef_r, r, qps, max_hops=hops_r)


def main():
    from hnsw_jax.utils.compile_cache import use_compile_cache
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    use_compile_cache(root)
    device = device_record()
    logging.info("device: %s", json.dumps(device))
    configs = sys.argv[1:] or ["sift10k", "sift1m"]
    scale = float(os.environ.get("BENCH_SCALE", "1.0"))
    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "run_all.jsonl"), "a") as out:
        for c in configs:
            run_config(c, scale, out, device)


if __name__ == "__main__":
    main()
