#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run: one card, exits 0 when all holds

Phases (any failure exits non-zero, and no result line is printed):

0. Card and build: the card's name and power limit (nvidia-smi), then the
   hand-written kernels built from ``src/repro_torch/csrc`` with nvcc.
1. Kernels against their plain torch versions, on the card, at the main
   path's shapes: error, kernel / plain / library times (CUDA events), and
   the least time the card could take (its bound).
2. The main path at full preset size: ``brain_like`` at scale 1.0 (40,000
   vertices; 400,000 edges drawn, 352,471 after de-duplication, in file
   order), k = 32, window_max = 256, lazy
   traversal, clustering score on — partitioned by ADWISE, hash and dbh
   through the registry, checked (every edge assigned, caps respected,
   ADWISE's replication degree below hash's), built into the engine, run
   through pagerank (30 supersteps) and label propagation, and billed as
   ``benchmarks/bench_total_latency.py`` bills pagerank_300. The kernels'
   launch counts are zeroed just before and read just after.
3. The card against the port's own CPU path on ``brain_like`` at scale
   0.02: non-lazy ADWISE bit-identical, lazy ADWISE agreement and RD, and
   pagerank on both devices on the same partition.
4. A torch.profiler trace of a short ADWISE run: kernels and device busy
   time per step, against the step's wall time from phase 2.

Then one JSON line with every kernel's numbers, and, last, the
``{"ok": true, "device": ...}`` line. It imports nothing of JAX and nothing
of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

CHECKS: list[str] = []


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    CHECKS.append(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, timed with CUDA events — the host's per-call Python and
    launch overhead stays out, as it does on the main path, which replays
    the ADWISE step from CUDA graphs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 3
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def eager_ms(fn, iters: int = 50) -> float:
    """Wall time per eager call, host dispatch included (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------------
# Phase 1: kernels against their plain versions
# ----------------------------------------------------------------------------

def ws_inputs(w, k, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 200, (w, 2)).astype(np.int32),
        rng.random(w) < 0.85,
        rng.random((w, k)) < 0.2,
        rng.random((w, k)) < 0.2,
        rng.integers(1, 40, w).astype(np.int32),
        rng.integers(1, 40, w).astype(np.int32),
        rng.random(k).astype(np.float32),
        rng.random(k) < 0.9,
    )


def ws_work(uv, valid, rows, k, use_cs):
    """(bytes, operations) the row-scoring function needs on these inputs:
    every input it reads read once, the output written once. It reads the
    selected rows' ids, degrees and replica rows, max_deg, and, for the
    clustering score, every slot's (u, v) and valid flag and the replica row
    of every slot that shares an endpoint with a selected row (rep_v where
    its u matches, rep_u where its v does). Operations: per row one
    4-comparison match test per window slot, per (row, p) one add per
    matched slot and ~8 epilogue operations."""
    import numpy as np

    w = len(uv)
    r = len(rows)
    u, v = uv[:, 0], uv[:, 1]
    need_u = np.zeros(w, bool)
    need_v = np.zeros(w, bool)
    need_u[rows] = need_v[rows] = True
    den = 0
    if use_cs:
        for i in rows:
            keep = valid & (np.arange(w) != i)
            a = ((u == u[i]) | (u == v[i])) & keep
            b = ((v == u[i]) | (v == v[i])) & keep
            need_v |= a
            need_u |= b
            den += int(a.sum()) + int(b.sum())
    nbytes = (r * 4 + 2 * r * 4 + 4 + (need_u.sum() + need_v.sum()) * k
              + use_cs * (w * 8 + w) + r * k * 4)
    ops = r * w * 4 * use_cs + k * den + 8 * r * k
    return int(nbytes), ops


def phase_kernels(edges, n):
    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.segment_sum import segment_layout, segment_offsets

    dev = torch.device("cuda")
    rows_out = {}

    def T(a):
        return torch.as_tensor(a, device=dev)

    # window_score, full op at the shapes of the kernel tests.
    for w, k, use_cs in [(256, 32, True), (200, 20, True), (7, 3, True), (130, 64, False)]:
        arr = ws_inputs(w, k, w * 31 + k)
        t = [T(a) for a in arr]
        lam, md = T(np.float32(1.3)), T(np.int32(40))
        got = ops.window_score(*t, lam, md, use_cs=use_cs)
        want = ref.window_score_ref(*t, lam, md, use_cs=use_cs)
        torch.cuda.synchronize()
        mask = (~t[1])[:, None] | (~t[7])[None, :]
        bit_equal = torch.equal(got.view(torch.int32), want.view(torch.int32))
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5), f"window_score full ({w},{k}) within 1e-5")
        check(torch.equal(got[mask], want[mask]), f"window_score full ({w},{k}) masks bit-equal")
        ms = cuda_ms(lambda: ops.window_score(*t, lam, md, use_cs=use_cs))
        plain = cuda_ms(lambda: ref.window_score_ref(*t, lam, md, use_cs=use_cs))
        log(f"kernel window_score full W={w} K={k} cs={use_cs}: max_abs_err={err} "
            f"bit_equal={bit_equal} ms={ms:.5f} plain_ms={plain:.5f}")

    # window_score, the step's row variant: R = 32 rows of W = 256, K = 32.
    w, k, r = 256, 32, 32
    arr = ws_inputs(w, k, 7)
    t = [T(a) for a in arr[:6]]
    rows_np = np.random.default_rng(8).choice(w, r, replace=False).astype(np.int32)
    rows = T(rows_np)
    md = T(np.int32(40))
    got = ops.window_score_rows(*t, md, rows)
    want = ref.window_score_rows_ref(*t, md, rows)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    bit_equal = torch.equal(got.view(torch.int32), want.view(torch.int32))
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5), "window_score rows within 1e-5")
    ms = cuda_ms(lambda: ops.window_score_rows(*t, md, rows), iters=200)
    plain = cuda_ms(lambda: ref.window_score_rows_ref(*t, md, rows), iters=200)
    eager = eager_ms(lambda: ops.window_score_rows(*t, md, rows), iters=200)
    b, o = ws_work(arr[0], arr[1], rows_np, k, True)
    bms, by = bound(b, o)
    log(f"kernel window_score rows R={r} W={w} K={k}: max_abs_err={err} "
        f"bit_equal={bit_equal} ms={ms:.5f} plain_ms={plain:.5f} eager_call_ms={eager:.5f} "
        f"bound_ms={bms:.3g} ({by}) bytes={b} ops={o}")
    rows_out["window_score"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=None, shape=f"rows R={r} of W={w}, K={k}", bit_equal=bit_equal,
    )

    # segment_sum at the main path's message layout (E = 2m, S = V).
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    seg = np.sort(dst, kind="stable").astype(np.int32)
    offs_np = segment_offsets(seg, n)
    lay = segment_layout(seg, n, dev)
    seg_t = lay.seg_ids
    longest = int(np.diff(offs_np).max())
    rng = np.random.default_rng(0)
    for d, tag in [(1, "pagerank"), (256, "triangle")]:
        # Small integers first: every partial sum is exact in fp32 (|sum| <=
        # 4 * 37,078 < 2^24), so kernel, plain version and the fp64 sum must
        # agree bit for bit whatever the order of the adds.
        ints = T(rng.integers(-4, 5, (len(seg), d)).astype(np.float32))
        got = ops.segment_sum_sorted(ints, lay)
        exact = torch.zeros((n, d), dtype=torch.float64, device=dev).index_add_(0, seg_t.long(), ints.double())
        check(torch.equal(got, exact.float()), f"segment_sum {tag} small integers equal to the fp64 sum")
        check(torch.equal(got, ref.segment_sum_ref(ints, seg_t, n)),
              f"segment_sum {tag} small integers equal to the plain version")
        del ints, exact
        data = T(rng.normal(size=(len(seg), d)).astype(np.float32))
        got = ops.segment_sum_sorted(data, lay)
        again = ops.segment_sum_sorted(data, lay)
        want = ref.segment_sum_ref(data, seg_t, n)
        # On real-valued data both fp32 sums are held to the fp64 sum within
        # the worst-case bound of an n-term fp32 sum in any order,
        # n·2^-24·sum|x| per segment (runs reach 37,078 rows here, so a
        # fixed rtol would not state a bound).
        idx2 = seg_t.long()[:, None].expand(-1, d)
        exact = torch.zeros((n, d), dtype=torch.float64, device=dev).scatter_add_(0, idx2, data.double())
        mag = torch.zeros((n, d), dtype=torch.float64, device=dev).scatter_add_(0, idx2, data.double().abs())
        runs = torch.as_tensor(np.diff(offs_np), dtype=torch.float64, device=dev)[:, None]
        tol = runs * 2.0**-24 * mag
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(bool(((got.double() - exact).abs() <= tol).all()), f"segment_sum {tag} within the fp32 sum bound")
        check(bool(((want.double() - exact).abs() <= tol).all()), f"segment_sum {tag} plain within the fp32 sum bound")
        check(torch.equal(got, again), f"segment_sum {tag} deterministic")
        del idx2, exact, mag, tol
        iters = 20 if d > 1 else 100
        ms = cuda_ms(lambda: ops.segment_sum_sorted(data, lay), iters=iters)
        plain = cuda_ms(lambda: ref.segment_sum_ref(data, seg_t, n), iters=iters)
        idx = seg_t.long()

        def lib():
            return torch.zeros((n, d), dtype=torch.float32, device=dev).index_add_(0, idx, data)

        library = cuda_ms(lib, iters=iters)
        e = len(seg)
        bms, by = bound(e * d * 4 + (n + 1) * 4 + n * d * 4, e * d)
        log(f"kernel segment_sum {tag} E={e} D={d} S={n} longest_run={longest} "
            f"chunks={lay.chunk_out.shape[0]} split_segments={lay.multi_seg.shape[0]}: "
            f"max_abs_err={err} ms={ms:.5f} "
            f"plain_ms={plain:.5f} index_add_ms={library:.5f} bound_ms={bms:.5f} ({by})")
        if tag == "pagerank":
            rows_out["segment_sum"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=library, shape=f"E={e}, D={d}, S={n}",
            )
        del data, got, again, want
    # f16 input at the kernel test's shape.
    e, d, s = 2048, 16, 256
    seg16 = np.sort(rng.integers(0, s, e)).astype(np.int32)
    lay16 = segment_layout(seg16, s, dev)
    data = T(rng.normal(size=(e, d)).astype(np.float16))
    got = ops.segment_sum_sorted(data, lay16)
    want = ref.segment_sum_ref(data, lay16.seg_ids, s)
    torch.cuda.synchronize()
    check(torch.allclose(got, want, rtol=2e-3, atol=2e-3), "segment_sum f16 within 2e-3")
    log(f"kernel segment_sum f16 E={e} D={d} S={s}: max_abs_err={(got - want).abs().max().item()}")
    return rows_out


# ----------------------------------------------------------------------------
# Phase 2: the main path at full size
# ----------------------------------------------------------------------------

def phase_main_path(edges, n, k, window_max):
    import numpy as np
    import torch

    from repro_torch.core import AdwiseConfig, run_partitioner
    from repro_torch.engine import (
        PAPER_CLUSTER, build_partitioned_graph, label_propagation, pagerank,
        partition_latency, process_latency,
    )
    from repro_torch.graph import partition_balance, partition_sizes, replica_sets_from_assignment, replication_degree
    from repro_torch.kernels import ops

    m = len(edges)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    results = {}
    for name in ("adwise", "hash", "dbh"):
        cfg = dict(window_max=window_max) if name == "adwise" else {}
        before = ops.launch_counts()
        res = run_partitioner(name, edges, n, k, device="cuda", **cfg)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        rep = replica_sets_from_assignment(edges, res.assign, n, k)
        rd = replication_degree(rep)
        imb = partition_balance(res.assign, k)
        sizes = partition_sizes(res.assign, k)
        check((res.assign >= 0).all() and res.stats.get("unassigned", 0) == 0,
              f"{name}: every edge assigned")
        results[name] = (res, rd)
        line = f"main {name}: RD={rd:.4f} imbalance={imb:.4f} wall_s={res.stats['wall_time_s']:.3f}"
        if name == "adwise":
            cap = AdwiseConfig(k=k).cap_value(m, k)
            check(int(sizes.max()) <= cap, f"adwise: every partition <= cap {cap}")
            st = res.stats
            loop_s = st["wall_time_s"] - st["setup_s"]
            launches = after["window_score"] - before["window_score"]
            check(launches > 0, "adwise: window_score launched on the main path")
            check(launches == st["steps_run"] + st["warmup_steps"],
                  "adwise: one window_score launch per step run")
            line += (f" steps={st['steps_run']} steps_per_s={st['steps_run'] / loop_s:.1f} "
                     f"us_per_step={loop_s / st['steps_run'] * 1e6:.2f} setup_s={st['setup_s']:.3f} "
                     f"scan_calls={st['scan_calls']} score_rows={st['score_rows']} "
                     f"final_w={st['final_w']} window_score_launches={launches}")
        log(line)
    check(results["adwise"][1] < results["hash"][1], "ADWISE RD below hash RD")

    res, rd = results["adwise"]
    before = ops.launch_counts()["segment_sum"]
    g = build_partitioned_graph(edges, res.assign, n, k, device="cuda")
    t0 = time.perf_counter()
    pr, info = pagerank(g, iters=30)
    t_pr = time.perf_counter() - t0
    seg_launches = ops.launch_counts()["segment_sum"] - before
    check(pr.shape == (n,) and np.isfinite(pr).all() and (pr > 0).all(), "pagerank finite, positive, (V,)")
    check(seg_launches == 30, "pagerank: one segment_sum launch per superstep")
    t0 = time.perf_counter()
    labels, linfo = label_propagation(g)
    t_lp = time.perf_counter() - t0
    check(labels.shape == (n,) and (labels <= np.arange(n)).all(), "label_propagation labels <= own id")
    log(f"main engine: pagerank 30 supersteps {t_pr:.3f}s, label_propagation "
        f"{linfo['supersteps']} supersteps {t_lp:.3f}s, segment_sum_launches={seg_launches}, "
        f"components={len(np.unique(labels))}")
    counts = ops.launch_counts()
    log(f"main peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # Total latency as benchmarks/bench_total_latency.py forms its rows.
    log("graph,workload,strategy,L,partition_s,process_s,total_s,RD")
    for name, (r, r_rd) in results.items():
        gg = g if name == "adwise" else build_partitioned_graph(edges, r.assign, n, k, device="cuda")
        t_part = partition_latency(r.stats, m, k)
        model = process_latency(gg, 300, 1, PAPER_CLUSTER)
        row = dict(graph="brain_like", workload="pagerank_300", strategy=name,
                   budget=None, replication_degree=r_rd, t_partition_s=t_part,
                   t_partition_wall_s=r.stats.get("wall_time_s", 0.0),
                   t_process_s=model["t_total_s"],
                   t_total_s=t_part + model["t_total_s"],
                   sync_bytes=model["sync_bytes_per_step"])
        check(np.isfinite(row["t_total_s"]) and row["t_total_s"] > 0, f"{name}: total latency finite")
        log(f"brain_like,pagerank_300,{name},,{row['t_partition_s']:.3f},"
            f"{row['t_process_s']:.3f},{row['t_total_s']:.3f},{row['replication_degree']:.3f}")
    return counts


# ----------------------------------------------------------------------------
# Phase 3: the card against the port's CPU path
# ----------------------------------------------------------------------------

def phase_cpu_parity(k):
    import numpy as np

    from repro_torch.core import AdwiseConfig, partition_stream
    from repro_torch.engine import build_partitioned_graph, pagerank
    from repro_torch.graph import make_graph, replica_sets_from_assignment, replication_degree

    edges, n = make_graph("brain_like", seed=0, scale=0.02)
    rds = {}
    for lazy in (False, True):
        cfg = AdwiseConfig(k=k, window_max=256, lazy=lazy)
        gpu = partition_stream(edges, n, cfg, device="cuda")
        cpu = partition_stream(edges, n, cfg, device="cpu")
        agree = float((gpu.assign == cpu.assign).mean())
        rd_g = replication_degree(replica_sets_from_assignment(edges, gpu.assign, n, k))
        rd_c = replication_degree(replica_sets_from_assignment(edges, cpu.assign, n, k))
        log(f"parity lazy={lazy}: m={len(edges)} agreement={agree} RD cuda={rd_g:.5f} "
            f"cpu={rd_c:.5f} score_rows cuda={gpu.stats['score_rows']} cpu={cpu.stats['score_rows']}")
        if not lazy:
            check(agree == 1.0, "non-lazy ADWISE: cuda and cpu assignments bit-identical")
            check(np.array_equal(gpu.stats["w_trace"], cpu.stats["w_trace"]), "non-lazy ADWISE: w_trace equal")
        else:
            check(abs(rd_g - rd_c) <= 0.005 * rd_c, "lazy ADWISE: RD within 0.5%")
        rds[lazy] = gpu
    g_cpu = build_partitioned_graph(edges, rds[True].assign, n, k, device="cpu")
    g_gpu = build_partitioned_graph(edges, rds[True].assign, n, k, device="cuda")
    a, _ = pagerank(g_cpu, iters=30)
    b, _ = pagerank(g_gpu, iters=30)
    err = float(np.abs(a - b).max())
    check(np.allclose(b, a, rtol=1e-5, atol=1e-8), "pagerank cuda vs cpu allclose rtol 1e-5")
    log(f"parity pagerank: max_abs_err={err}")


def phase_profile(k):
    """Device busy time per ADWISE step under torch.profiler (CUPTI): kernels
    per step, busy µs per step (the sum of kernel durations, inflated by the
    profiler's own per-kernel cost), and the kernels that take the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import AdwiseConfig, partition_stream
    from repro_torch.graph import make_graph

    # 400 edges of a small brain_like stream: ~660 steps (m + W + 2). The
    # step's shapes are fixed by W and K, so its kernels are those of the
    # full-size run; the phases before built the kernels and warmed torch.
    edges, n = make_graph("brain_like", seed=0, scale=0.005)
    edges = edges[:400]
    cfg = AdwiseConfig(k=k, window_max=256)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = partition_stream(edges, n, cfg, device="cuda")
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    steps = res.stats["steps_run"] + res.stats["warmup_steps"]
    if not kern:
        log("profile: the profiler recorded no device activity")
        return
    busy_us = sum(e.self_device_time_total for e in kern)
    n_kern = sum(e.count for e in kern)
    log(f"profile: m={len(edges)} steps={steps} kernels_per_step={n_kern / steps:.1f} "
        f"device_busy_us_per_step={busy_us / steps:.2f} (wall of this profiled run "
        f"{res.stats['wall_time_s']:.3f}s)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile kernel {e.key[:90]}: {e.count / steps:.2f} per step, "
            f"{e.self_device_time_total / steps:.3f} us per step")


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        log(card_line())
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        from repro_torch.kernels import _build, ops
        from repro_torch.kernels import segment_sum as ss_mod
        from repro_torch.kernels import window_score as ws_mod

        t0 = time.perf_counter()
        secs = _build.build()
        log(f"build: {time.perf_counter() - t0:.2f}s wall ({', '.join(f'{k} {v:.2f}s' for k, v in secs.items())})")
        for name, text in _build.BUILD_LOGS.items():
            for ln in text.splitlines():
                if "registers" in ln or "spill" in ln or "error" in ln.lower():
                    log(f"ptxas {name}: {ln.strip()}")

        from repro_torch.graph import make_graph

        edges, n = make_graph("brain_like", seed=0, scale=1.0)
        log(f"graph brain_like scale=1.0: |V|={n} |E|={len(edges)}")
        t0 = time.perf_counter()
        kernel_rows = phase_kernels(edges, n)
        log(f"phase 1 (kernels vs plain): {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        counts = phase_main_path(edges, n, k=32, window_max=256)
        log(f"phase 2 (main path): {time.perf_counter() - t0:.1f}s launches={counts}")
        for name in ("window_score", "segment_sum"):
            check(counts[name] > 0, f"{name} launched on the main path")
        t0 = time.perf_counter()
        phase_cpu_parity(k=32)
        log(f"phase 3 (cuda vs cpu): {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        phase_profile(k=32)
        log(f"phase 4 (profile of the step): {time.perf_counter() - t0:.1f}s")
        sources = {"window_score": ws_mod, "segment_sum": ss_mod}
        kernels = []
        for name, row in kernel_rows.items():
            kernels.append(dict(
                name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
                replaces=sources[name].REPLACES, launches=counts[name],
                max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"], shape=row["shape"],
            ))
        log(f"checks passed: {len(CHECKS)}; total {time.perf_counter() - t_start:.1f}s")
        log(json.dumps({"kernels": kernels}))
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: FAILED after {len(CHECKS)} passing checks", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
