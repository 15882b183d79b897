"""Where the device time of a serving batch goes, stage by stage.

    python benchmarks/hop_profile.py --trace            # SIFT1M shape, 1M
    python benchmarks/hop_profile.py --hlo              # fusion of the hop

--trace   build the SIFT1M-shaped index (--n rows, 128-d L2, M=32,
          efC=100), find the ef reaching recall@10 >= 0.95, profile one
          8192-query Searcher batch, and split the device time by the
          hop's named scopes (ops/beam.py: select, neighbors, dedup,
          distances -> row_gather / contract, merge); the rest of the
          program (entry scan, extraction rerank) is "outside hop". Also
          reports the device's busy time over the traced window. XLA runs
          the while loops as CUDA graphs (command buffers), which the
          profiler sees as one event each; --trace turns them off for its
          process so that every kernel is its own event (its qps is
          therefore not the production number).
--hlo     compile the plain hop distances (gather + einsum at HIGHEST) at
          Q=8192, K=64 for d=128 and d=960 and report whether XLA fused
          the row gather into the reduction; the optimised HLO goes to
          chiprun_out/.

Every line names the card and its power limit. Fails (non-zero exit)
without a GPU. Results also go to chiprun_out/hop_profile.json.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def hlo_report(card: str) -> list:
    import jax
    import jax.numpy as jnp
    from hnsw_jax.search import gathered_distances
    rows = []
    for d, n in ((128, 1 << 20), (960, 1 << 18)):
        vec = jax.ShapeDtypeStruct((n, d), jnp.float32)
        ids = jax.ShapeDtypeStruct((8192, 64), jnp.int32)
        qs = jax.ShapeDtypeStruct((8192, d), jnp.float32)
        c = jax.jit(lambda v, i, q: gathered_distances(v[i], q, "l2")
                    ).lower(vec, ids, qs).compile()
        text = c.as_text()
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, f"hop_hlo_d{d}.txt"), "w") as f:
            f.write(text)
        # the gather is fused iff a fused computation holds both the
        # gather and the reduction (or dot) that consumes it
        comps = re.split(r"\n(?=\S)", text)
        fused = any(("gather(" in b and ("reduce(" in b or " dot(" in b))
                    for b in comps if b.startswith(("%fused", "fused")))
        temp = getattr(c.memory_analysis(), "temp_size_in_bytes", None)
        print(f"[hlo] d={d} Q=8192 K=64: gather fused into the reduction: "
              f"{fused}; temp bytes {temp} ({card})", flush=True)
        rows.append({"d": d, "gather_fused_into_reduction": fused,
                     "temp_bytes": temp})
    return rows


def op_names(hlo_text: str) -> dict:
    """instruction name -> op_name metadata of an optimised HLO module; a
    fusion without its own metadata takes its root's."""
    inst = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = ")
    names, comp_root, pending, comp = {}, {}, [], None
    for line in hlo_text.splitlines():
        if line and not line[0].isspace() and "{" in line:
            head = line.split()
            comp = (head[1] if head[0] == "ENTRY" else head[0]).lstrip("%")
            continue
        m = inst.match(line)
        if not m:
            continue
        calls = re.search(r"calls=%?([\w.\-]+)", line)
        op = re.search(r'op_name="([^"]+)"', line)
        if op:
            names[m.group(1)] = op.group(1)
            if line.lstrip().startswith("ROOT"):
                comp_root[comp] = op.group(1)
        elif calls:
            pending.append((m.group(1), calls.group(1)))
    for name, calls in pending:
        if calls in comp_root:
            names[name] = comp_root[calls]
    return names


def stage(op_name: str) -> str:
    """Hop stage of an op, from the named scopes of ops/beam.py
    beam_search (and row_gather / contract inside its distances scope);
    anything else (entry scan, extraction rerank) is "outside hop"."""
    parts = op_name.split("/")
    if "distances" in parts:
        for s in ("row_gather", "contract"):
            if s in parts:
                return s
        return "distances"
    for s in ("select", "neighbors", "dedup", "merge"):
        if s in parts:
            return s
    return "outside hop"


def busy_ns(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy


def trace(card: str, n: int, seed: int) -> dict:
    import jax
    import hnsw_jax
    import hnsw_jax.search as hs
    from jax.profiler import ProfileData
    from hnsw_jax.utils.datasets import load_eval_workload
    from hnsw_jax.utils.recall import recall_at_k

    wl = load_eval_workload("sift1m", n_queries=8192, seed=seed,
                            n=None if n == 1_000_000 else n)
    idx = hnsw_jax.HnswIndex(128, 32, "l2", capacity=1 << 20,
                             ef_construction=100)
    t0 = time.time()
    idx.add(wl.base)
    build_s = time.time() - t0
    print(f"[build] {wl.name}: {build_s:.1f}s = {n / build_s:.0f} "
          f"inserts/s ({card}; includes compilation)", flush=True)
    flat = hnsw_jax.FlatIndex(128, "l2")
    flat.add(wl.base)
    _, gt = flat.search(wl.queries, 10)
    del flat

    s = hnsw_jax.Searcher(idx, k=10)
    for ef in (32, 48, 64, 96, 128, 192, 256):
        _, ii = s.search(wl.queries, ef_search=ef)
        r = recall_at_k(ii, gt, 10)
        if r >= 0.95:
            break
    s.ef_search = ef
    t = []
    for _ in range(5):
        t0 = time.perf_counter()
        s.search(wl.queries)
        t.append(time.perf_counter() - t0)
    print(f"[serve] ef={ef} recall@10={r:.4f}: {len(wl.queries) / min(t):.0f}"
          f" qps (Searcher, 8192 queries, best of 5, profiler off, command "
          f"buffers off) ({card})", flush=True)

    # the optimised HLO of the very executable the batch runs: record the
    # arguments of the jitted search, then lower + compile them again
    calls = []
    jitted = hs._hnsw_search

    def recording(*a, **kw):
        calls.append((a, kw))
        return jitted(*a, **kw)

    hs._hnsw_search = recording
    try:
        tdir = os.path.join(ROOT, ".hop_profile", "trace")
        shutil.rmtree(tdir, ignore_errors=True)
        with jax.profiler.trace(tdir):
            s.search(wl.queries)
    finally:
        hs._hnsw_search = jitted
    a, kw = calls[-1]
    names = op_names(jitted.lower(*a, **kw).compile().as_text())
    _, _, st = idx.search(wl.queries, 10, ef_search=ef, with_stats=True)
    hops = int(st.hops)

    path = glob.glob(os.path.join(tdir, "plugins", "profile", "*",
                                  "*.xplane.pb"))[0]
    by, spans, unmatched = {}, [], {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for e in line.events:
                stats = dict(e.stats)
                op = str(stats.get("hlo_op", e.name))
                if op in names:
                    b = stage(names[op])
                else:
                    b = "outside hop"
                    unmatched[op] = unmatched.get(op, 0) + 1
                by[b] = by.get(b, 0.0) + e.duration_ns / 1e6
                spans.append((e.start_ns, e.start_ns + e.duration_ns))
    window = (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e6
    busy = busy_ns(spans) / 1e6
    total = sum(by.values())
    print(f"[trace] {wl.name} ef={ef}: one 8192-query Searcher batch, "
          f"{hops} hops; device busy {busy:.2f} ms of a {window:.2f} ms "
          f"window, idle share {1 - busy / window:.3f} ({card})", flush=True)
    for b, ms in sorted(by.items(), key=lambda t: -t[1]):
        print(f"[trace]   {b:12s} {ms:8.3f} ms  {100 * ms / total:5.1f}%  "
              f"{ms / max(hops, 1):.4f} ms/hop", flush=True)
    if unmatched:
        top = sorted(unmatched.items(), key=lambda t: -t[1])[:8]
        print(f"[trace] events with no HLO op_name: {top}", flush=True)
    return {"config": wl.name, "ef": ef, "recall@10": r, "hops": hops,
            "build_s": build_s, "qps": len(wl.queries) / min(t),
            "split_ms": by, "busy_ms": busy, "window_ms": window}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hlo", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="rows of the SIFT1M-shaped index (--trace)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.trace:  # one profiler event per kernel (see --trace above)
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_gpu_enable_command_buffer=")
    import jax
    if jax.devices()[0].platform != "gpu":
        print("hop_profile: no GPU", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    from hnsw_jax.utils.compile_cache import use_compile_cache
    use_compile_cache(ROOT)
    card = card_line()
    print(f"[device] {jax.devices()[0].device_kind}: {card}", flush=True)
    res = {"card": card}
    if args.hlo:
        res["hlo"] = hlo_report(card)
    if args.trace:
        res["trace"] = trace(card, args.n, args.seed)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "hop_profile.json"), "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
