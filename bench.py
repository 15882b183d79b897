"""Benchmark harness (SURVEY.md §2b C15): build + query an HNSW index on
one NVIDIA GPU, sweep efSearch for the recall@10 >= 0.95 operating point,
report QPS there.

Prints ONE JSON line:
  {"metric": ..., "value": QPS, "unit": "qps", "vs_baseline": r,
   "device": {"platform", "kind", "count", "card"}}

vs_baseline = our QPS / single-core CPU HNSW QPS at the same recall on the
same data, from the bundled C++ single-core engine (hnsw_jax/native) when
built, else None. Every sweep point is best-of-BENCH_REPS synced reps. The
run fails when JAX finds no GPU, and any failing phase (packed tables, the
packed recall canary, the operating-point refinement) fails the run.

Env knobs:
  BENCH_N       database size        (default 1_000_000 — the north-star
                config, BASELINE.json)
  BENCH_D       dimensionality       (default 128; SIFT-shaped)
  BENCH_Q       query count          (default 8192)
  BENCH_M       HNSW M               (default 32)
  BENCH_EFC     efConstruction       (default 100)
  BENCH_REPS    timing reps per sweep point (default 3, best-of)
  BENCH_CPU_N   CPU-baseline build size (default = BENCH_N)
  BENCH_DATASET named eval config (sift10k/sift1m/gist1m/glove100) overrides
                N/D and uses real files under $HNSW_DATA when present
  BENCH_DTYPE   vector storage codec (float32 default | sq8) — sq8 is the
                Deep10M-scale configuration (vectors at 1 byte/dim; recall
                is still measured against the TRUE f32 ground truth)
  BENCH_PACKED  auto (default, = 8) | 0 | 8 | 4 | pq — packed serving rows;
                "pq" packs PQ ROUTING codes (BENCH_PQ_M sub-codes x
                BENCH_PQ_BITS bits), the low-memory packed mode
"""

from __future__ import annotations

import json
import logging
import os
import platform
import sys
import time

import numpy as np

logging.basicConfig(stream=sys.stderr, level=logging.INFO,
                    format="[%(name)s] %(message)s")


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_record() -> dict:
    """The device this run measures: JAX's view plus the card's name and
    power limit from nvidia-smi (a child process that does not import
    JAX). Exits when JAX finds no GPU — a CPU number is never reported
    under a device metric."""
    import subprocess
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        _log(f"[bench] no GPU (JAX platform {devs[0].platform!r})")
        sys.exit(2)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card}


def main():
    import jax
    from hnsw_jax.utils.compile_cache import use_compile_cache
    use_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    import jax.numpy as jnp
    import hnsw_jax
    from hnsw_jax.utils.datasets import load_eval_workload, synthetic_workload
    from hnsw_jax.utils.recall import recall_at_k
    from hnsw_jax.utils.stats import HnswStats

    device = device_record()
    _log(f"[bench] device: {json.dumps(device)}")

    n = int(os.environ.get("BENCH_N", 1_000_000))
    d = int(os.environ.get("BENCH_D", 128))
    nq = int(os.environ.get("BENCH_Q", 8192))
    m = int(os.environ.get("BENCH_M", 32))
    efc = int(os.environ.get("BENCH_EFC", 100))
    reps = int(os.environ.get("BENCH_REPS", 3))
    dataset = os.environ.get("BENCH_DATASET", "")
    target_recall = float(os.environ.get("BENCH_TARGET_RECALL", 0.95))

    # refinement probe: DISJOINT from the reported query set — ask the
    # workload for nq + n_probe queries and tune only on
    # the tail. If a real dataset ships fewer, the probe falls back to a
    # prefix overlap and the artifact says so.
    n_probe = int(os.environ.get("BENCH_PROBE_Q", 2048))
    if dataset:
        wl = load_eval_workload(dataset, n_queries=nq + n_probe)
    else:
        wl = synthetic_workload(n, d, n_queries=nq + n_probe, metric="l2",
                                seed=1234, name=f"sift-shaped-{n}x{d}")
    base = wl.base
    queries = wl.queries[:nq]
    probe_queries = wl.queries[nq:]
    probe_disjoint = len(probe_queries) > 0
    if not probe_disjoint:  # dataset had <= nq queries: overlap, flagged
        probe_queries = wl.queries[:min(len(wl.queries), n_probe)]
    n, d = base.shape
    _log(f"[bench] workload={wl.name} n={n} d={d} nq={len(queries)} "
         f"probe_nq={len(probe_queries)} (disjoint={probe_disjoint}) "
         f"metric={wl.metric} M={m} efC={efc}")

    # ---- build on device
    cap = 1 << (n - 1).bit_length()
    if cap >= 1 << 24:  # config caps per-index capacity below 2^24
        cap = n
    dtype = os.environ.get("BENCH_DTYPE", "float32")
    kw = {}
    big = n >= 8_000_000
    if big:
        # deep10m device-memory budget: trim the upper-table headroom
        # 4x -> 2x (need is cap/m rows) to make room for program temps
        kw["upper_capacity"] = 2 * cap // m
    idx = hnsw_jax.HnswIndex(d, m, wl.metric, capacity=max(cap, 1024),
                             ef_construction=efc, dtype=dtype, **kw)
    # BENCH_BEAM_KEYS=bf16 opts exact-storage routing into the cheap bf16
    # merge keys (index-level default; recall is measured honestly per
    # sweep point either way)
    idx.beam_keys = os.environ.get("BENCH_BEAM_KEYS", "auto")
    # BENCH_ENTRY_MODE=seed|sample|descend overrides the index default
    # ("auto" -> sample)
    idx.entry_mode = os.environ.get("BENCH_ENTRY_MODE", "auto")
    t0 = time.time()
    if not idx.is_trained:  # sq8: train the quantizer on a sample
        idx.train(np.asarray(base[:262144], np.float32))
    # chunk large adds: each add() stages its schedule on device, so a
    # 10M-point single call would hold dataset + staging + graph at once
    add_chunk = len(base) if not big else 1_250_000
    for s in range(0, len(base), add_chunk):
        idx.add(base[s:s + add_chunk])
    build_s = time.time() - t0
    _log(f"[bench] device build: {build_s:.1f}s ({n/build_s:.0f} inserts/s)")
    bl_dropped = getattr(idx._builder, "last_backlink_dropped", 0)
    if bl_dropped:
        _log(f"[bench] back-link window drops this build: {bl_dropped} "
             f"({100.0 * bl_dropped / max(n * m, 1):.4f}% of forward links)")

    # ---- structural invariant check: host-side (a device->host copy of
    # neighbors0), so by default it runs AFTER the parsed summary line is
    # printed; its failure mode (post-build corruption) is also caught by
    # the measured recall and the packed canary. BENCH_CHECK=pre runs it
    # before the sweep; =0 skips it.
    check_mode = os.environ.get("BENCH_CHECK", "post")

    def run_invariant_check():
        t0 = time.time()
        cs = idx.check(strict=False)
        cs["seconds"] = round(time.time() - t0, 1)
        _log(f"[bench] invariant check ({cs['seconds']}s): "
             f"{len(cs['errors'])} errors, "
             f"reciprocity0={cs.get('reciprocity0', 0):.3f}, "
             f"deg0_mean={cs.get('deg0_mean', 0):.1f}")
        if cs["errors"]:
            raise RuntimeError(f"graph invariant errors: {cs['errors']}")
        return cs

    check_summary = None
    if check_mode == "pre" or check_mode == "1":
        check_summary = run_invariant_check()

    # ---- ground truth (on-device brute force) unless the dataset ships one
    if wl.ground_truth is not None:
        gt = wl.ground_truth[:len(queries), :10]
    elif big:
        # from the index's own device-resident vectors: no second multi-GB
        # copy of base on device (run_all.py big-config pattern)
        t0 = time.time()
        _, gt = hnsw_jax.brute_force_topk(
            jnp.asarray(np.asarray(queries, np.float32)), idx.vectors,
            k=10, metric=wl.metric, tile_n=16384, n_valid=n,
            dequant=idx._sq)
        gt = np.asarray(gt)
        _log(f"[bench] brute-force GT: {time.time()-t0:.1f}s")
    else:
        t0 = time.time()
        flat = hnsw_jax.FlatIndex(d, wl.metric)
        flat.add(base)
        _, gt = flat.search(queries, 10)
        del flat  # release the oracle's device copy of base before packing
        _log(f"[bench] brute-force GT: {time.time()-t0:.1f}s")

    # ---- packed serving mode (ops/packed.py): route on neighbor-code rows
    # (one row fetch per expanded node) + exact rerank. On by default;
    # BENCH_PACKED=0 disables, =4 forces 4-bit, =pq packs PQ ROUTING codes
    # instead (m0 * BENCH_PQ_M bytes/row, 8-16x smaller — the
    # Deep10M-scale configuration). A table that does not fit fails the run.
    packed_env = os.environ.get("BENCH_PACKED", "auto")
    packed_bits = 0
    packed_mode = None
    t0 = time.time()
    if packed_env == "pq":
        pq_m = int(os.environ.get("BENCH_PQ_M", max(d // 8, 1)))
        pq_bits = int(os.environ.get("BENCH_PQ_BITS", 8))
        nb = idx.enable_packed(mode="pq", pq_m=pq_m, pq_bits=pq_bits,
                               train_x=np.asarray(base[:65536], np.float32))
        packed_bits = pq_bits
        packed_mode = f"pq{pq_m}x{pq_bits}"
    elif packed_env != "0":
        packed_bits = int(packed_env) if packed_env in ("4", "8") else 8
        nb = idx.enable_packed(bits=packed_bits)
        packed_mode = f"sq{packed_bits}"
    if packed_mode:
        _log(f"[bench] packed tables ({packed_mode}): {nb/1e9:.2f} GB in "
             f"{time.time()-t0:.1f}s")

    # ---- packed-mode canary: a broken packed path must never set the
    # operating point. Before any timed sweep, compare packed vs unpacked
    # recall on a spot-check; a divergence fails the run.
    canary = None
    if packed_bits:
        nc = min(len(queries), 1024)
        qc = jnp.asarray(np.asarray(queries[:nc], np.float32))
        _, ic_p = idx.search(qc, k=10, ef_search=64, use_packed=True)
        _, ic_u = idx.search(qc, k=10, ef_search=64, use_packed=False)
        r_p = recall_at_k(np.asarray(ic_p), gt[:nc], 10)
        r_u = recall_at_k(np.asarray(ic_u), gt[:nc], 10)
        canary = {"packed_recall": round(r_p, 4),
                  "unpacked_recall": round(r_u, 4), "n_queries": nc}
        _log(f"[bench] packed canary: packed {r_p:.4f} / unpacked "
             f"{r_u:.4f} at ef=64")
        if r_p < r_u - 0.05:
            raise RuntimeError(f"packed canary failed: packed recall "
                               f"{r_p:.4f} vs unpacked {r_u:.4f}")

    # ---- efSearch sweep: find the cheapest ef reaching the target recall.
    # Queries staged on device once; results stay on device during timing;
    # ids are fetched ONCE per point for recall, outside the timed reps.
    queries_dev = jnp.asarray(np.asarray(queries, np.float32))

    # BENCH_SWEEP=fast (default): stop as soon as the target-recall point is
    # found; BENCH_SWEEP=full records the whole recall/qps frontier.
    sweep_mode = os.environ.get("BENCH_SWEEP", "fast")

    def run_sweep():
        results = []
        chosen = None
        for ef in (16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512):
            dd, ii = idx.search(queries_dev, k=10, ef_search=ef,
                                device_out=True)  # compile+warm
            jax.block_until_ready(ii)
            times = []
            for _ in range(max(reps, 1)):
                t0 = time.time()
                dd, ii = idx.search(queries_dev, k=10, ef_search=ef,
                                    device_out=True)
                jax.block_until_ready(ii)
                times.append(time.time() - t0)
            dt = min(times)
            r = recall_at_k(np.asarray(ii), gt, 10)
            qps = len(queries) / dt
            results.append({"ef": ef, "recall@10": round(r, 4),
                            "qps": round(qps, 1),
                            "reps_ms": [round(t * 1e3, 1) for t in times]})
            _log(f"[bench] ef={ef:4d} recall@10={r:.4f} qps={qps:,.0f} "
                 f"(best of {len(times)})")
            if r >= target_recall and chosen is None:
                chosen = results[-1]
                if sweep_mode == "fast":
                    break
            if r >= max(0.999, target_recall):
                break
        return results, chosen

    results, chosen = run_sweep()

    # ---- operating-point refinement: both ef and the hop cap are runtime
    # scalars, and the coarse sweep leaves some throughput on the table.
    # Tune on the DISJOINT probe split, then TIME the refined point and
    # keep it only if it still reaches the target on the full reported
    # query set and is actually faster. BENCH_REFINE=0 disables.
    refined = None
    if chosen is not None and os.environ.get("BENCH_REFINE", "1") != "0":
        probe_dev = jnp.asarray(np.asarray(probe_queries, np.float32))
        ef_r, hops_r = idx.tune_operating_point(
            probe_dev, target_recall, k=10, set_default=False,
            ef_grid=tuple(e for e in (16, 24, 32, 40, 48, 56, 64, 80,
                                      96, 128, 192, 256, 384, 512)
                          if e <= chosen["ef"] + 16))
        dd, ii = idx.search(queries_dev, k=10, ef_search=ef_r,
                            max_hops=hops_r, device_out=True)
        jax.block_until_ready(ii)
        times = []
        for _ in range(max(reps, 1)):
            t0 = time.time()
            dd, ii = idx.search(queries_dev, k=10, ef_search=ef_r,
                                max_hops=hops_r, device_out=True)
            jax.block_until_ready(ii)
            times.append(time.time() - t0)
        r = recall_at_k(np.asarray(ii), gt, 10)
        qps = len(queries) / min(times)
        refined = {"ef": ef_r, "max_hops": hops_r,
                   "recall@10": round(r, 4), "qps": round(qps, 1)}
        _log(f"[bench] refined op point: ef={ef_r} hops={hops_r} "
             f"recall@10={r:.4f} qps={qps:,.0f}")
        if r >= target_recall and qps > chosen["qps"]:
            chosen = dict(refined)

    # Fail-honest operating point: when no sweep point reaches the target
    # recall, the artifact must say so — value 0 and a metric string
    # carrying the best recall actually achieved, never a passing-shaped
    # number.
    target_reached = chosen is not None
    if not target_reached:
        chosen = max(results, key=lambda p: p["recall@10"])
        _log(f"[bench] TARGET RECALL {target_recall} NOT REACHED — best "
             f"point: recall {chosen['recall@10']} at ef={chosen['ef']} "
             f"({chosen['qps']} qps). Reporting value=0.")

    # ---- stream throughput at the op point: the single-batch wall above
    # charges a full host<->device sync to every batch. A serving system
    # keeps the dispatch queue non-empty, so the stream number pipelines
    # BENCH_PIPELINE dispatches back-to-back and syncs once (execution is
    # stream-ordered: syncing the last result fences them all).
    # BENCH_PIPELINE=0/1 disables (headline = batch wall).
    pipeline_depth = int(os.environ.get("BENCH_PIPELINE", 8))
    qps_stream = None
    if target_reached and pipeline_depth > 1:
        kw_op = {"ef_search": chosen["ef"], "device_out": True}
        if chosen.get("max_hops"):
            kw_op["max_hops"] = chosen["max_hops"]
        dd, ii = idx.search(queries_dev, k=10, **kw_op)  # warm
        jax.block_until_ready(ii)
        s_times = []
        for _ in range(max(reps, 1)):
            t0 = time.time()
            for _ in range(pipeline_depth):
                dd, ii = idx.search(queries_dev, k=10, **kw_op)
            jax.block_until_ready(ii)
            s_times.append(time.time() - t0)
        qps_stream = pipeline_depth * len(queries) / min(s_times)
        _log(f"[bench] stream qps (depth={pipeline_depth}, one sync): "
             f"{qps_stream:,.0f} vs batch-wall {chosen['qps']:,.0f} "
             f"(sync amortized: "
             f"{min(s_times)/pipeline_depth*1e3:.1f} ms/batch vs "
             f"{len(queries)/chosen['qps']*1e3:.1f} ms)")

    # ---- hnsw_stats at the operating point (ndis/hops, faiss parity)
    stats = HnswStats()
    t0 = time.time()
    _, ii, st = idx.search(queries_dev, k=10, ef_search=chosen["ef"],
                           max_hops=chosen.get("max_hops", 0),
                           with_stats=True)
    stats.accumulate(len(queries), st, wall=time.time() - t0)
    stat_summary = stats.summary()
    _log(f"[bench] stats@op: ndis/query={stat_summary['ndis_per_query']:.0f} "
         f"hops/batch={stat_summary['hops_per_batch']:.0f}")

    # ---- CPU single-core baseline: CACHED (the workload is seeded and
    # deterministic, and the from-scratch serial 1M build takes many
    # minutes). On a cache hit the ratio is real; on a miss the summary
    # prints vs_baseline=null IMMEDIATELY and the baseline is computed +
    # cached afterwards so the next run has it.
    nq_cap = min(len(queries), 1000)
    cpu_n = min(len(base), int(os.environ.get("BENCH_CPU_N", len(base))))
    cache_key = (f"{wl.name}|M={m}|efC={efc}|target={target_recall}"
                 f"|nq={nq_cap}|cpu_n={cpu_n}")
    base_qps, base_src = _baseline_cache_get(cache_key)
    baseline_cached = base_src is not None
    if baseline_cached:
        _log(f"[bench] cpu baseline (cached): {base_qps} qps "
             f"[{base_src}] key={cache_key}")
    # headline = stream throughput when measured (and faster); single-batch
    # wall is always in the detail line as qps_batch_wall
    head_qps = chosen["qps"]
    if qps_stream is not None and qps_stream > head_qps:
        head_qps = round(qps_stream, 1)
    vs = (head_qps / base_qps) if (base_qps and target_reached) else None

    metric_s = (f"qps @ recall@10>={target_recall} "
                f"({wl.name}, M={m}, efC={efc})")
    if not target_reached:
        metric_s += (f" — TARGET NOT REACHED (best recall "
                     f"{chosen['recall@10']} at ef={chosen['ef']})")
    out = {
        "metric": metric_s,
        "value": head_qps if target_reached else 0.0,
        "unit": "qps",
        "vs_baseline": round(vs, 3) if vs else None,
        "device": device,
    }
    # THE machine-parseable line — printed before any post-flight work so a
    # time limit cannot eat it.
    print(json.dumps(out), flush=True)

    # ---- post-summary work: diagnostics + cache fills
    if check_mode == "post":
        check_summary = run_invariant_check()
    if not baseline_cached and os.environ.get("BENCH_BASELINE", "1") != "0":
        base_qps, base_src = _cpu_baseline_qps(base, queries, gt, wl.metric,
                                               m, efc, target_recall)
        if base_src != "none":
            _baseline_cache_put(cache_key, base_qps, base_src)
        if base_qps and target_reached:
            vs = head_qps / base_qps
            _log(f"[bench] vs_baseline (freshly measured, cached for next "
                 f"run): {vs:.3f}")
    extra = {
        "target_reached": target_reached,
        "recall_at_op": chosen["recall@10"], "ef_at_op": chosen["ef"],
        "max_hops_at_op": chosen.get("max_hops", 0), "refined": refined,
        "qps_batch_wall": chosen["qps"],
        "qps_stream": round(qps_stream, 1) if qps_stream else None,
        "pipeline_depth": pipeline_depth,
        "probe_disjoint": probe_disjoint,
        "build_seconds": round(build_s, 1),
        "build_inserts_per_s": round(n / build_s, 1),
        "timing": (f"best-of-{reps}, device-resident results, "
                   f"block_until_ready; "
                   f"headline streams depth-{pipeline_depth} dispatches per "
                   f"sync when that is faster"),
        "device": device,
        "ndis_per_query": round(stat_summary["ndis_per_query"], 1),
        "hops_per_batch": round(stat_summary["hops_per_batch"], 1),
        "packed_bits": packed_bits, "packed_mode": packed_mode,
        "packed_canary": canary,
        "invariant_check": check_summary,
        "backlink_window_drops": bl_dropped,
        "sweep": results, "sweep_mode": sweep_mode,
        "baseline_qps": base_qps, "baseline_source": base_src,
        "baseline_cached": baseline_cached,
        "vs_baseline_final": round(vs, 3) if vs else None,
        "n": n, "d": d, "batch": len(queries), "dtype": dtype,
        "beam_keys": idx.beam_keys,
    }
    _log("[bench] detail: " + json.dumps(extra))


_BASELINE_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "data", "baseline_cache.json")


def _baseline_cache_get(key: str):
    """(qps, source) for a cached CPU-baseline measurement, else (None,
    None). The cache is committed alongside the repo: the baseline engine
    is single-core deterministic C++ on a seeded workload, so the number is
    machine-class-stable, and re-deriving it every run costs many
    minutes."""
    try:
        with open(_BASELINE_CACHE) as f:
            ent = json.load(f).get(key)
        if ent:
            return ent["qps"], ent["source"] + "(cached)"
    except Exception:  # noqa: BLE001 — absent/corrupt cache = miss
        pass
    return None, None


_LAST_BASELINE_META: dict = {}  # provenance from the most recent
# _cpu_baseline_qps run (host, date, reps, per-rep qps): entries carry
# enough context to judge their error bar.


def _baseline_cache_put(key: str, qps, source: str) -> None:
    if not qps:  # never cache a failed measurement (it would pin the
        return   # failure across runs; recomputing is the safe default)
    try:
        data = {}
        try:
            with open(_BASELINE_CACHE) as f:
                data = json.load(f)
        except Exception:  # noqa: BLE001
            pass
        data[key] = {"qps": qps, "source": source, **_LAST_BASELINE_META}
        os.makedirs(os.path.dirname(_BASELINE_CACHE), exist_ok=True)
        with open(_BASELINE_CACHE, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        _log(f"[bench] baseline cached: {key} -> {qps} qps [{source}]")
    except Exception as e:  # noqa: BLE001
        _log(f"[bench] baseline cache write failed: {e!r}")


def _subset_gt(b, q, metric, k=10, tile=131072):
    """Exact top-k of q against b on the HOST, dot-product formulation
    (never materializes [nq, n, d] — the naive broadcast at 1M x 960 is
    245 GB). Used for capped CPU baselines; nq <= 1000 so cost is one
    [nq, n] matmul in tiles."""
    q = np.asarray(q, np.float32)
    b = np.asarray(b, np.float32)
    scores = np.empty((len(q), len(b)), np.float32)
    for s in range(0, len(b), tile):
        blk = b[s:s + tile]
        dots = q @ blk.T
        if metric == "ip":
            scores[:, s:s + len(blk)] = -dots
        else:
            scores[:, s:s + len(blk)] = (blk * blk).sum(1)[None, :] - 2 * dots
    return np.argsort(scores, axis=1, kind="stable")[:, :k].astype(np.int64)


def _cpu_baseline_qps(base, queries, gt, metric, m, efc, target_recall):
    """Single-core CPU HNSW QPS at the target recall on the same workload.
    Uses the bundled C++ engine; None when it is not built."""
    from hnsw_jax.utils.recall import recall_at_k
    nq_cap = min(len(queries), 1000)  # CPU sweep cost control
    q = queries[:nq_cap]
    # gt may be None when the caller knows the baseline is capped (the
    # subset GT below replaces it); uncapped runs require it
    g = None if gt is None else gt[:nq_cap]
    try:
        from hnsw_jax.native import cpu_baseline  # bundled C++ engine
        eng = cpu_baseline.CpuHnsw(base.shape[1], m, metric)
        n_build = min(len(base), int(os.environ.get("BENCH_CPU_N",
                                                    len(base))))
        if n_build < len(base):
            # capped baseline (BENCH_CPU_N): the denominator index holds
            # only base[:n_build], so its recall must be measured against
            # the SUBSET ground truth — the full-set GT caps recall at
            # ~n_build/len(base) no matter how well it searches. A
            # smaller index is also faster to search, so the published
            # multiple is conservative.
            t0 = time.time()
            g = _subset_gt(base[:n_build], q, metric)
            _log(f"[bench] capped baseline: subset GT over base[:{n_build}]"
                 f" ({time.time()-t0:.1f}s)")
        elif g is None:
            raise ValueError("uncapped CPU baseline needs ground truth")
        t0 = time.time()
        eng.add(base[:n_build], ef_construction=efc)
        _log(f"[bench] cpu baseline build ({n_build} pts, 1 core): "
             f"{time.time()-t0:.1f}s")
        best_r = 0.0
        for ef in (16, 32, 64, 128, 256, 512):
            t0 = time.time()
            ii = eng.search(q, 10, ef_search=ef)
            dt = time.time() - t0
            r = recall_at_k(ii, g, 10)
            best_r = max(best_r, r)
            qps = nq_cap / dt
            _log(f"[bench] cpu ef={ef} recall={r:.4f} qps={qps:,.0f}")
            if r >= target_recall:
                # median-of-reps at the crossing ef (recall is
                # deterministic for a built engine, only the timing is
                # noisy on a shared host). Record
                # provenance so the cache entry's error bar is auditable.
                reps = max(1, int(os.environ.get("BENCH_CPU_REPS", 3)))
                qps_reps = [qps]
                for _ in range(reps - 1):
                    t0 = time.time()
                    eng.search(q, 10, ef_search=ef)
                    qps_reps.append(nq_cap / (time.time() - t0))
                med = float(np.median(qps_reps))
                _LAST_BASELINE_META.update(
                    host=platform.node(), date=time.strftime("%Y-%m-%d"),
                    reps=reps, ef=ef, recall=round(float(r), 4),
                    qps_reps=[round(x, 1) for x in qps_reps])
                _log(f"[bench] cpu baseline median-of-{reps} at ef={ef}: "
                     f"{med:,.1f} qps (reps {qps_reps})")
                return round(med, 1), "bundled-cpp-single-core"
        # a baseline that never reaches the target recall is NOT a valid
        # denominator (a 0-point index "searches" at
        # 15M qps) — report failure instead of a nonsense ratio.
        _log(f"[bench] cpu baseline NEVER reached target recall "
             f"{target_recall} (best {best_r:.4f}) — no vs_baseline")
        return None, f"bundled-cpp-single-core(target-not-reached " \
                     f"best={best_r:.4f})"
    except Exception as e:  # noqa: BLE001 — the comparator is optional
        _log(f"[bench] bundled cpu baseline unavailable: {e!r}")
    return None, "none"


if __name__ == "__main__":
    main()
