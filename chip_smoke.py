"""Smoke test of the build-and-serve path on one NVIDIA GPU.

    python chip_smoke.py                # one card: build, serve, packed serve
    python chip_smoke.py --four-cards   # the sharded path on four cards only

One card, phases in order (any failure exits non-zero before the last line):

1. device: JAX must see a GPU; prints its kind and count, and the card's
   name and power limit from ``nvidia-smi`` (a child process, no JAX);
2. build: ``HnswIndex(128, 32, "l2", capacity=1<<20, ef_construction=100)``
   over the SIFT1M-shaped workload (1M x 128 L2, synthetic from --seed),
   through ``add()``; prints build seconds, inserts/s and ``check()``;
3. serve: requests of 1, 37, 1000 and 8192 queries through
   ``Searcher.submit``/``flush``/``result``; recall@10 against the exact
   ``FlatIndex`` oracle must reach 0.95 at some ef_search <= 256, and the
   returned distances must match a float64 NumPy recomputation;
4. packed serving: ``enable_packed(bits=8)``, the same requests again;
   packed recall must be within 0.01 of unpacked at the same ef_search;
5. memory: peak device bytes in use.

There is no kernel-parity phase: the engine runs no hand-written kernel
(the one raced against XLA lost and was removed; PERF.md).

The last line of standard output is one JSON object naming the device.
``--four-cards`` builds the Deep10M shape (96-d L2, M=32, efC=100) sharded
four ways over ``make_mesh(n_shards=4, q_parallel=1)`` and checks the
fan-out search and ``all_gather`` merge against the exact oracle.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
REQUEST_SIZES = (1, 37, 1000, 8192)
EF_SWEEP = (32, 48, 64, 96, 128, 192, 256)
TARGET_RECALL = 0.95


def log(*a):
    print(*a, flush=True)


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    """``name, power limit`` of every card, from nvidia-smi (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(l.strip() for l in out.stdout.splitlines() if l.strip())


def phase_device(n_cards: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        sys.exit(2)
    check(len(devs) >= n_cards,
          f"{n_cards} cards needed, JAX sees {len(devs)}")
    card = card_line()
    log(f"[device] kind={devs[0].device_kind} count={len(devs)} "
        f"nvidia-smi: {card}")
    return devs, card


def recall10(ids: np.ndarray, gt: np.ndarray) -> float:
    from hnsw_jax.utils.recall import recall_at_k
    return recall_at_k(ids, gt, 10)


def serve_requests(searcher, requests):
    """All requests through submit/flush/result; returns (D, I) stacked in
    request order."""
    handles = [searcher.submit(r) for r in requests]
    searcher.flush()
    out = [searcher.result(h) for h in handles]
    return (np.concatenate([d for d, _ in out]),
            np.concatenate([i for _, i in out]))


def sweep(searcher, requests, gt, tag):
    """Smallest ef in EF_SWEEP whose recall@10 reaches the target; returns
    (ef, recall, D, I) of that point, or of the best point if none does."""
    best = None
    for ef in EF_SWEEP:
        searcher.ef_search = ef
        t0 = time.time()
        d, i = serve_requests(searcher, requests)
        r = recall10(i, gt)
        log(f"[{tag}] ef={ef} recall@10={r:.4f} "
            f"wall={time.time() - t0:.3f}s (first pass compiles)")
        if best is None or r > best[1]:
            best = (ef, r, d, i)
        if r >= TARGET_RECALL:
            return ef, r, d, i
    return best


def check_distances(base, queries, d, i, n=256):
    """Returned squared-L2 distances vs float64 NumPy for n queries.
    Tolerance: rtol 1e-4, plus an absolute term for the f32 cancellation
    of the surrogate form ||x||² - 2q·x + ||q||² (error ~1e-7 of the norms
    summed)."""
    q = queries[:n].astype(np.float64)
    ids = i[:n]
    rows = base[np.maximum(ids, 0)].astype(np.float64)
    ref = ((rows - q[:, None, :]) ** 2).sum(-1)
    scale = (q ** 2).sum(-1)[:, None] + (rows ** 2).sum(-1)
    err = np.abs(d[:n] - ref)
    ok = (ids >= 0)
    bad = ok & (err > 1e-4 * np.abs(ref) + 1e-6 * scale)
    log(f"[serve] distances vs float64 for {n} queries: "
        f"max rel err {float((err / np.maximum(ref, 1e-30))[ok].max()):.2e}")
    check(not bad.any(), f"{int(bad.sum())} returned distances disagree "
                         f"with the float64 recomputation")


def one_card(args, card: str):
    import hnsw_jax
    from hnsw_jax.utils.datasets import load_eval_workload

    n_q = sum(REQUEST_SIZES)
    wl = load_eval_workload(
        "sift1m", n_queries=n_q, seed=args.seed,
        n=None if args.n == 1_000_000 else args.n)
    base, queries = wl.base, wl.queries
    n, d = base.shape
    if n != 1_000_000:
        log(f"[build] SIZE CUT: n={n} instead of the published 1,000,000")
    requests, s = [], 0
    for r in REQUEST_SIZES:
        requests.append(queries[s:s + r])
        s += r

    # ---- build
    idx = hnsw_jax.HnswIndex(d, 32, "l2", capacity=1 << 20,
                             ef_construction=100)
    t0 = time.time()
    idx.add(base)
    build_s = time.time() - t0
    log(f"[build] {wl.name}: n={n} d={d} M=32 efC=100 in {build_s:.1f}s = "
        f"{n / build_s:.0f} inserts/s ({card}; includes compilation)")
    cs = idx.check(strict=False)
    log(f"[build] check(strict=False): errors={cs['errors']} "
        f"deg0_mean={cs.get('deg0_mean', 0):.2f} "
        f"reciprocity0={cs.get('reciprocity0', 0):.3f} "
        f"max_level={cs['max_level']}")
    check(not cs["errors"], f"graph invariants: {cs['errors']}")
    check(idx.ntotal == n, f"ntotal {idx.ntotal} != {n}")

    # ---- exact oracle (HIGHEST-precision brute force)
    t0 = time.time()
    flat = hnsw_jax.FlatIndex(d, "l2")
    flat.add(base)
    _, gt = flat.search(queries, 10)
    del flat
    log(f"[oracle] FlatIndex exact top-10 for {n_q} queries in "
        f"{time.time() - t0:.1f}s")

    # ---- serve through Searcher
    searcher = hnsw_jax.Searcher(idx, k=10)
    ef, r, dd, ii = sweep(searcher, requests, gt, "serve")
    check(r >= TARGET_RECALL,
          f"recall@10 {r:.4f} < {TARGET_RECALL} at every ef <= 256")
    log(f"[serve] recall@10={r:.4f} at ef_search={ef} over requests "
        f"{REQUEST_SIZES} ({searcher.stats})")
    check_distances(base, queries, dd, ii)

    # ---- packed serving
    t0 = time.time()
    nbytes = idx.enable_packed(bits=8)
    log(f"[packed] enable_packed(bits=8): {nbytes / 1e9:.2f} GB in "
        f"{time.time() - t0:.1f}s, layout={idx._packed.layout}")
    searcher.ef_search = ef
    _, ip = serve_requests(searcher, requests)
    rp = recall10(ip, gt)
    log(f"[packed] recall@10={rp:.4f} at ef_search={ef} "
        f"(unpacked {r:.4f})")
    check(rp >= r - 0.01, f"packed recall {rp:.4f} more than 0.01 below "
                          f"unpacked {r:.4f}")
    idx.disable_packed()
    del idx, searcher
    return {"recall@10": r, "ef_search": ef, "packed_recall@10": rp,
            "build_inserts_per_s": n / build_s}


def four_cards(args, card: str):
    import jax
    import hnsw_jax
    from hnsw_jax.parallel.sharded import ShardedHnswIndex, make_mesh
    from hnsw_jax.utils.datasets import load_eval_workload

    devs = jax.devices()[:4]
    mesh = make_mesh(n_shards=4, q_parallel=1, devices=devs)
    wl = load_eval_workload(
        "deep10m", n_queries=1000, seed=args.seed,
        n=None if args.four_n == 10_000_000 else args.four_n)
    base, queries = wl.base, wl.queries
    n, d = base.shape
    if n != 10_000_000:
        log(f"[four-cards] SIZE CUT: n={n} instead of the published "
            f"10,000,000")
    per_shard = -(-n // 4)
    idx = ShardedHnswIndex(d, 32, "l2", mesh=mesh,
                           capacity_per_shard=per_shard,
                           ef_construction=100)
    # every per-shard array must be spread over the four cards, one
    # shard each — none may sit whole on one device
    for name, arr in (("vectors", idx._vectors),
                      ("neighbors0", idx._graph.neighbors0)):
        shards = arr.addressable_shards
        check(sorted(s.device.id for s in shards) ==
              sorted(dv.id for dv in devs) and
              all(s.data.shape[0] == 1 for s in shards),
              f"{name} is not sharded one shard per card")
    t0 = time.time()
    idx.add(base)
    build_s = time.time() - t0
    log(f"[four-cards] {wl.name}: n={n} d={d} M=32 efC=100 over "
        f"{dict(mesh.shape)} in {build_s:.1f}s = {n / build_s:.0f} "
        f"inserts/s ({card}; includes compilation)")

    t0 = time.time()
    flat = hnsw_jax.FlatIndex(d, "l2")
    flat.add(base)
    _, gt = flat.search(queries, 10)
    del flat
    log(f"[four-cards] exact oracle in {time.time() - t0:.1f}s")
    best = 0.0
    for ef in EF_SWEEP:
        t0 = time.time()
        _, ii = idx.search(queries, 10, ef_search=ef)
        r = recall10(ii, gt)
        log(f"[four-cards] fan-out + all_gather merge: ef={ef} "
            f"recall@10={r:.4f} wall={time.time() - t0:.3f}s")
        best = max(best, r)
        if r >= TARGET_RECALL:
            break
    check(best >= TARGET_RECALL,
          f"sharded recall@10 {best:.4f} < {TARGET_RECALL}")
    for dv in devs:
        log(f"[four-cards] {dv}: peak_bytes_in_use="
            f"{(dv.memory_stats() or {}).get('peak_bytes_in_use')}")
    return {"recall@10": best, "build_inserts_per_s": n / build_s}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="database rows for the one-card build (a cut below "
                         "1,000,000 is printed)")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path, on four cards")
    ap.add_argument("--four-n", type=int, default=10_000_000,
                    help="database rows for --four-cards (a cut below "
                         "10,000,000 is printed)")
    args = ap.parse_args()

    n_cards = 4 if args.four_cards else 1
    devs, card = phase_device(n_cards)
    sys.path.insert(0, ROOT)
    from hnsw_jax.utils.compile_cache import use_compile_cache
    log(f"[device] compile cache: {use_compile_cache(ROOT)}")
    try:
        if args.four_cards:
            four_cards(args, card)
        else:
            one_card(args, card)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
    peak = (devs[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"[memory] peak_bytes_in_use={peak} ({devs[0]})")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
