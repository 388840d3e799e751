#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run: one card, exits 0 when all holds

Phases (any failure exits non-zero, and no result line is printed):

0. Card and build: the card's name and power limit (nvidia-smi), then the
   three hand-written kernels built from ``src/repro_torch/csrc`` with nvcc,
   one process per source, in parallel.
1. Kernels against their plain torch versions, on the card, at the main
   path's shapes: error, kernel / plain / library times (CUDA events), and
   the least time the card could take (its bound). ``segment_sum`` at the
   engine's brain_like message layout, D = 1 and 256, and in f16: small
   integers equal to the fp64 sum and the plain version, normal data
   within the fp32 sum bound, repeated calls bit-equal, one device kernel
   per call (torch.profiler), and several calls captured in one CUDA graph
   replayed twice, bit-equal to eager, the layout's counters back at 0. ``window_score``'s row
   op is read from (V+1, K) replica tables and timed beside an empty
   kernel on its grid (the launch floor), on three windows: ids below 200
   (the inputs the kernel before the redesign was timed on), a window of
   the brain_like stream over its 40,001-row table (the main path's data,
   reported in the kernels line), and a hub.
2. The main path at full preset size: ``brain_like`` at scale 1.0 (40,000
   vertices; 400,000 edges drawn, 352,471 after de-duplication, in file
   order), k = 32, window_max = 256, lazy
   traversal, clustering score on — partitioned by ADWISE, hash and dbh
   through the registry, checked (every edge assigned, caps respected,
   ADWISE's replication degree below hash's), built into the engine, run
   through pagerank (30 supersteps: the wall, 30 ``segment_sum`` launches;
   then one superstep under torch.profiler, its device time and the
   kernel's share) and label propagation, and billed as
   ``benchmarks/bench_total_latency.py`` bills pagerank_300. The kernels'
   launch counts are zeroed just before and read just after.
3. The card against the port's own CPU path on ``brain_like`` at scale
   0.005: non-lazy ADWISE bit-identical, lazy ADWISE agreement and RD, and
   pagerank on both devices on the same partition.
4. A torch.profiler trace of a short ADWISE run: kernels and device busy
   time per step, against the step's wall time from phase 2.
5. ``flash_attention`` against its plain version on the card, each call
   checked to have run the body ``body_for`` names: at the serving shape
   (q (4, 24, 2048, 128), k/v (4, 8, 2048, 128), bf16, causal — each
   prefill layer's launch, on the ``wgmma`` body), the same at Dh 64, at
   Tq = Tk = 2000, at a long context (B = 1, T = 8192; the plain version
   checked once, not timed),
   at Tk = 129 for Dh 64 and 128, at the shapes of the JAX kernel tests in
   fp32 and fp16, at each Dh in {32, 64, 96, 128}, non-causal at Tk =
   256, Zamba2-7B's shared attention (q (4, 32, 2048, 112), causal) on the
   ``mma_sync`` (bf16) and ``fma`` (fp32) bodies, and Whisper-tiny's
   non-causal shapes at batch 8 (the encoder over 224 frames, the
   cross-attention of 448 queries and of one decoded query over them), and
   phase 14's prefills at one tp 2 rank's heads (llama 12 over 4, granite 8
   over 4, prompt 512), and phase 16's (zamba2's shared block, 16 heads of
   Dh 112 at prompt 512 on ``mma_sync``; whisper's encoder, self- and
   cross-attention at 3 heads, batch 4, prompt 448); at each, kernel /
   plain / SDPA times and the bound (SDPA is timed as a yardstick only; the
   port never calls it).
6. LM serving at full width: ``repro_torch.launch.serve.main`` on
   Llama-3.2-3B (28 layers, bf16, random weights from the seed), batch 4,
   prompt 2048, 64 generated tokens — 28 flash launches in the prefill,
   all on the ``wgmma`` body, none in decode, tokens in range, logits finite; prefill and decode
   rates and peak memory. Then a second prefill of the same model (steady
   state), a torch.profiler trace of a third (device time by kernel), and
   one of decode steps (device busy time per step against its wall).
7. The card against the port's CPU path at full width: 2 layers of
   Llama-3.2-3B in fp32 (TF32 off), batch 1, prompt 300, 4 decode steps —
   prefill and decode logits at 2e-3, greedy tokens equal wherever the
   top-2 margin exceeds that.
8. The paper's comparison set through the registry, launch counts zeroed
   just before and read just after: ``hdrf`` and ``greedy`` on brain_like at
   scale 0.06 (a depth cut for the smoke's time limit), k = 32 (steps/s,
   µs per edge), each bit-equal to its numpy oracle; ``hash``, ``2ps-l``
   (bit-equal to the numpy oracles of both phases), ``2ps`` (the same
   clustering phase) and ``adwise-restream`` with 2 passes at W = 256 (one ``window_score`` launch
   per step of each pass, pass 2 included; RD(ADWISE) below RD(hash)) at
   scale 0.02 (``bench_total_latency.py``'s is 0.08: a depth cut for the
   smoke's time limit); every partition run through 30
   pagerank supersteps on the card (``segment_sum``) and billed for
   pagerank_300. Then non-lazy ``adwise-restream`` (W = 64) and ``2ps`` on
   the card bit-identical to the CPU path at scale 0.005, and the device kernels and
   busy time per edge of each single-edge core (profiler, the difference of
   two runs).

9. Spotlight and tracing: (a) ``adwise`` on brain_like at scale 0.3 with
   z = 8 instances on disjoint blocks of 4 of the k = 32 partitions
   (spread k/z), W = 256, one batched step for all instances — one
   ``window_score`` launch per step — then 30 pagerank supersteps on its
   partition (launch counts zeroed just before and read just after), its
   RD beside phase 2's z = 1 RD, ``hdrf`` and ``dbh`` at the same z and
   spread, and the profiler's kernels and busy µs per step at z = 8
   (phase 4 has z = 1); (b) ``benchmarks/bench_spotlight.py``'s sweep (scale 0.06, z = 8,
   spreads 32/16/8/4, dbh/hdrf/adwise at W = 128), every edge inside its
   instance's spread; (c) batched against the loop backend bit for bit on
   the card for adwise, hdrf, greedy, 2ps, 2ps-l and adwise-restream (scale
   0.005, z = 4, spread 8), and a skewed batch of two length buckets
   against z = 1 runs; (d) the batched card against the batched CPU path
   (scale 0.0025, non-lazy where the phase-3 rule asks); (e) a traced
   ``adwise-restream`` run at scale 0.02 equal to phase 8's untraced run,
   its Chrome trace export (``build/chip_smoke/trace.json``)
   validated, one scan span per scan call, two pass lanes, 30 superstep
   spans.
10. Out-of-core (``partition_file`` over graph files, the file-fed ring on
   the card): (a) a SNAP text dump of phase 9 (a)'s stream (brain_like at
   0.3) ingested (wall, MB/s), byte-equal to ``write_edge_file``'s binary;
   (b) ADWISE at z = 1, W = 256 from a file of brain_like at 0.04 with an
   8,192-row chunk (a 12,288-row ring that wraps), prefetch 2, traced,
   bit-equal to a resident run of the same cut, every row shipped once at
   8 B, one ``window_score`` launch per step, every refill into the one
   ring; its wall against the resident run's, scan calls, spans
   prestaged / missed, ``h2d_wait_s``, ``prestage_wall_s`` and the overlap
   1 − wait / prestage; (c) ``repro_torch.launch.partition.main`` on the
   text file with ``--ingest --z 8 --spread 4 --chunk-edges 8192
   --spill-dir ... --workload pagerank``: the spill bit-equal to phase 9a's
   z = 8 ADWISE, 30 ``segment_sum`` launches; ``hdrf`` at the same z from
   the file bit-equal to phase 9a's; (d) ``adwise-restream`` (2 passes,
   pass 2 adopting the ring: ``h2d_bytes == 12 m``), ``2ps``, ``2ps-l``,
   ``dbh`` and ``hash`` at scale 0.02 from files (chunk 8,192), each
   bit-equal to the in-memory run on the card; (e) the same file with
   prefetch 0 equal to (b)'s prefetch 2, and (b)'s trace: ``refill``
   total = ``h2d_wait_s``, ``stage`` total = ``prestage_wall_s``, one scan
   span per scan call, the export (``build/chip_smoke/oocore_trace.json``)
   validated.
11. LM training at full width: (a) ``flash_attention`` under autograd
   (``FlashAttentionFn``) at the training shape (q (1, 24, 4096, 128), k/v
   (1, 8, 4096, 128), bf16, causal) and at Dh 64: the forward bit-equal to
   the bare kernel, dq/dk/dv within one bf16 ulp of autograd through the
   plain version; kernel, plain-backward and SDPA forward + backward times;
   (b) ``repro_torch.launch.train.main`` on Llama-3.2-3B (28 layers, bf16,
   random weights from seed 0), batch 1, seq 4,096 (``train_4k``'s), 6
   steps, counts zeroed just before and read just after: 56
   ``flash_attention`` launches per step (28 forward + 28 under remat), all
   on the ``wgmma`` body, 28 attention backward calls, every parameter's
   gradient at step 0 finite and non-zero, the last loss below the first;
   step wall, tokens/s, the share of the bf16 peak, peak memory; a profile
   of one step (device time by kernel name and by range) and the step split
   by CUDA events; (c) one step of 2 full-width layers in fp32 (TF32 off),
   batch 1, seq 256, on the card against the CPU: loss, every gradient,
   the moments and each leaf's update; (d) the launcher at reduced width
   with checkpoints, an injected failure, top-k compression and a resume.
12. The other LM families at full width: (a) ``repro_torch.launch.serve.main``
   on granite-moe-1b-a400m, internvl2-26b (+ 256 patches), zamba2-7b and
   rwkv6-7b at batch 4, prompt 2048, and whisper-tiny at batch 8, prompt
   448 (its decoder context; 224 frames), 16 tokens each, bf16, random
   weights from seed 0, one model at a time, counts zeroed just before
   each and read just after: tokens in range, finite logits, the
   ``flash_attention`` launches per prefill by body (granite 24 and
   internvl 48 ``wgmma``, zamba2 13 ``mma_sync``, whisper 12 ``wgmma``,
   rwkv6 none) and per decode step (whisper 4 ``wgmma``, the others none);
   prefill ms, decode ms per step, peak memory; then the same model again,
   a second prefill and decode steps under torch.profiler (busy time and
   idle share); (b) each family at full width cut in depth
   (``FAMILY_PARITY_CUTS``: 2 layers, internvl and rwkv6 1, zamba2 3 with
   its shared block after the 2nd; whisper 2 + 2), fp32 (TF32 off), batch
   1, prompt 128, 4 decode steps, on the card against the CPU from the
   same weights, logits within ``FAMILY_PARITY_TOL`` of their scale; for
   the MoE the tokens whose top-k experts differ between the devices are
   counted first and the logits compared before the first of them.
13. The other LM families trained at full width: (a) ``FlashAttentionFn``
   at Zamba2-7B's training shape (q (1, 32, 4096, 112), causal, the
   ``mma_sync`` body) and Whisper-tiny's cross-attention (q (8, 6, 448, 64)
   against k/v (8, 6, 224, 64), non-causal, ``wgmma``), checked as in 11
   (a); (b) bf16, random weights from seed 0, counts zeroed just before
   each run and read just after: granite-moe-1b-a400m (batch 1, seq 4,096)
   and whisper-tiny (batch 8, seq 448, 224 frames) at full depth through
   ``launch.train.main``, internvl2-26b (3 of 48 layers; 4,096 tokens + 256
   patches), zamba2-7b (13 of 81 layers: 2 applications of the shared
   block and a 1-layer remainder) and rwkv6-7b (4 of 32 layers) at seq
   4,096 through ``build_state`` + ``make_step`` — depth cuts that keep each
   at <= 3.6 B parameters (internvl's, zamba2's and rwkv6's deeper, for
   the smoke's time); flash launches per step by body (48, 24, 6
   ``wgmma``; 2 ``mma_sync``, the shared block not rematerialised; none)
   and attention backward calls, every gradient at the first step finite
   and non-zero, granite's MoE aux positive, the last loss below the first;
   step wall, tokens/s, the share of the bf16 peak and peak memory; (c)
   each family cut in depth as in 12 (b) (``family_parity_cfg``) in fp32
   (TF32 off), batch 1, seq 128: one ``make_step`` on the card against
   ``loss_fn`` + ``backward()`` on the CPU from the same weights, the MoE's
   routes counted first, then the loss, the MoE aux and every gradient
   leaf.
14. Tensor-parallel serving: (a) llama3.2-3b (the ``shard`` head policy,
   the vocab split) and granite-moe-1b-a400m (its 32 experts split, its
   vocab of 49,155 whole) at full width, bf16, batch 4, prompt 512, 8
   tokens, served at tp 1 in this process, then by ``launch.serve --tp 2``
   as two ranks on cuda:0 over gloo (``torch.multiprocessing`` spawn, a
   file store under ``build/chip_smoke/tp``, joined with a timeout; each
   rank's counts zeroed just before its run and read just after): the
   first-token logits and every step's within ``TP_LOGIT_TOL`` of tp 1's
   scale while both runs hold the same tokens and MoE routes (granite's
   route flips counted first), a greedy token different only at a near
   tie, every prefill's ``flash_attention`` launches on the ``wgmma`` body
   at the rank's local head counts, each rank's peak memory below tp 1's;
   prefill ms, decode ms per step and collectives per decode step; (b)
   llama at world 1 over NCCL through the same distributed path: tokens
   and logits bit-equal to tp 1's; (c) with two cards, llama at tp 2 over
   NCCL on cuda:0-1: (a)'s tokens (logged as not run on one card).

15. The partition → process pipeline over ranks (brain_like cut to 0.08,
   k = 32, W = 256, z = 8, spread 4): (a) spotlight through
   ``partition_stream_batched(backend="shard_map")`` as two gloo ranks on
   cuda:0 (spawned; a file store under ``build/chip_smoke/ranks``; joined
   with a timeout), each stepping its 4 instances, bit-equal (assignments,
   per-instance stats, ``w_trace``) to a one-process run of the same cut,
   ``n_shards`` 2 and one ``window_score`` launch per batched step on each
   rank; (b) on its assignment, pagerank (30 supersteps) over the ``parts``
   mesh within rtol 1e-5 of one process's and bit-equal between the ranks,
   label propagation exact, one ``segment_sum`` launch and one all-reduce
   per superstep a rank, slabs (16, 16) at k = 32 and (4, 3) at k = 7;
   µs per batched step and the superstep wall against one process; (c) the
   same at world 1 over NCCL (a group of one rank in the smoke's own
   process), bit-equal to the run with no group; (d) with
   two cards, (a) and (b) over NCCL on cuda:0-1 (logged as not run on one
   card).

16. Tensor-parallel serving of the other families: (a) whisper-tiny at
   full depth (4 × 448, 224 frames), rwkv6-7b cut to 4 of 32 layers and
   zamba2-7b to 13 of 81 (two applications of the shared block and a
   remainder layer) at full width, 4 × 512, bf16, 8 tokens, through
   ``launch.serve.main`` (the cut config passed in) at tp 1 in this
   process, in fp32 at tp 1 (the bf16 floor), then at ``--tp 2`` as two
   gloo ranks on cuda:0: logits and tokens against tp 1's
   (``tp_compare``, tolerance ``TP_LOGIT_TOL`` or half the bf16 run's
   distance from fp32, ``TPF_FLOOR_SHARE``), each prefill's flash launches
   at the rank's local heads by body (zamba2 2 ``mma_sync`` at (4, 16,
   512, 112), whisper 12 ``wgmma``), none in decode (tp 1's whisper
   launches 4 a step), one decode merge per attention a step, each rank's
   peak memory below tp 1's; prefill ms, decode ms a step, peak GiB a
   rank, collectives a decode step; (b) each family's 2 full-width layers
   (``family_parity_cfg``: zamba2 3, rwkv6 1, whisper 2 + 2) in fp32, batch 1, prompt 128, 3 decode steps,
   at tp 2 against tp 1 within ``TPF_PARITY_TOL`` of the logits' scale;
   (c) with two cards, zamba2 at tp 2 over NCCL on cuda:0-1: (a)'s tokens
   (logged as not run on one card).

17. Tensor-parallel + FSDP training over two gloo ranks on cuda:0 (one
   spawned group for both meshes, its ranks started while this process
   runs tp 1): (a) Llama-3.2-3B at full width cut to 2 of 28 layers, bf16,
   2 × 512, 3 steps through ``launch.train.main`` at ``--tp 2`` (mesh
   (1, 2), TP) and ``--tp 1`` (mesh (2, 1), FSDP) against tp 1 in this
   process and tp 1 in fp32: losses equal on both ranks and within the
   bf16 run's distance from fp32 of tp 1's, 4 flash launches a step, all
   ``wgmma``, at the rank's local heads (12 under TP); step ms, tokens/s,
   peak a rank, collectives a step; the same for whisper-tiny at full
   width and depth, bf16, 8 × 448 with 224 frames (24 ``wgmma`` launches a
   step: encoder, decoder self- and cross-attention at 3 heads a rank
   under TP, 4 rows under FSDP); (b) granite-moe-1b-a400m at full width
   cut to 2 layers, fp32, capacity factor 1.0, one step at 2 × 512 (EP on
   (1, 2), the whole-batch plan on (2, 1)): every MoE call's routes and
   expert loads equal to tp 1's, pairs dropped, the first MoE output and
   the loss within ``TPT_GRAD_TOL`` / ``TPT_LOSS_TOL``; (c) two full-width
   fp32 layers of llama and granite, and internvl2-26b and rwkv6-7b (1
   layer), zamba2-7b (3 layers, the shared block after the 2nd) and
   whisper-tiny (4 + 4) at full width in fp32 (``tpt_grad_cfg``), a training step at
   2 × 128 without remat (granite two): the losses, the first gradient's global norm (within
   ``TPT_NORM_TOL``) and every leaf of it (norm and 4 random sketches)
   within ``TPT_GRAD_TOL`` of its norm,
   every leaf's two-step update within ``TPT_UPDATE_TOL``
   (``tools/tp_train_readings.py`` places both between sound and planted
   faults); every flash launch of the ranks and of (d) at a shape phase 5
   held to the plain version (``tpt_flash_shapes``); (d) NCCL at world 1 in this process: (a)'s losses and (c)'s
   llama sketches bit-equal to the run with no group; with two cards, (a)
   at tp 2 over NCCL on cuda:0-1 (logged as not run on one card).

18. The multi-pod dry run (``repro_torch.launch.dryrun``: a rank's step on
   ``meta`` tensors, its shard counting collectives without issuing them),
   held to the runs above: (a) every rank of phase 17 (a) (llama and
   whisper on (1, 2) and (2, 1)) — each training step's collectives by op,
   count and bytes equal the dry run's, its parameter and AdamW bytes the
   pieces the rank held, and its measured peak over the dry run's live
   peak plus the launcher's residual within ``DRY_PEAK_RATIO``; every
   rank of phase 14 (a) — the prefill's and the decode steps' collectives;
   (b) the dry run's CLI on ``DRY_CELLS`` at production size (rank 0 of
   256): status ok, no card memory allocated and no kernel launched in the
   phase; (c) the dry run's FLOPs of phase 11's training step over its
   measured wall: the achieved rate beside phase 11's share of the bf16
   peak. Phase 18 launches nothing.

The kernels' ``launches`` are those of phases 2, 6, 8, 9, 10, 11, 12, 13, 14,
15, 16 and 17 (each path's counts zeroed just before it and read just after;
phases 14's, 15's, 16's and 17's are their ranks', with 17 (d)'s). Then one JSON line with
every kernel's numbers, and, last, the
``{"ok": true, "device": ...}`` line. It imports nothing of JAX and nothing
of the JAX package.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import re
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # tensor cores, bf16 and fp16 alike

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


def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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


def ws_table_inputs(w, k, v, seed, uv=None):
    """A window of W slots over a (v + 1)-row vertex table, as the ADWISE
    step holds it: slot ids (random in [0, v), or ``uv``), valid flags, a
    (v + 1, K) bool replica table and (v + 1,) int32 degrees."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if uv is None:
        uv = rng.integers(0, v, (w, 2))
    return (
        np.asarray(uv, np.int32),
        rng.random(w) < 0.85,
        rng.random((v + 1, k)) < 0.2,
        rng.integers(1, 40, v + 1).astype(np.int32),
    )


def ws_work(uv, valid, rows, k, use_cs):
    """(bytes, operations) the row-scoring function needs on these inputs:
    every input it reads read once, the output written once. It reads the
    selected rows' ids, the replica-table rows and degrees of their
    endpoints, max_deg, and, for the clustering score, every slot's (u, v)
    and valid flag and the table row of every vertex that a matching slot
    brings in (v_j where u_j matches, u_j where v_j does), each row once.
    Operations: per row one 4-comparison match test per window slot, per
    (row, p) one add per matched slot and ~8 epilogue operations."""
    import numpy as np

    w = len(uv)
    r = len(rows)
    u, v = uv[:, 0], uv[:, 1]
    ends = set(u[rows].tolist()) | set(v[rows].tolist())
    table_rows = set(ends)
    den = 0
    if use_cs:
        for i in rows:
            keep = valid & (np.arange(w) != i)
            a = ((u == u[i]) | (u == v[i])) & keep
            b = ((v == u[i]) | (v == v[i])) & keep
            table_rows |= set(v[a].tolist()) | set(u[b].tolist())
            den += int(a.sum()) + int(b.sum())
    nbytes = (r * 4 + len(ends) * 4 + 4 + len(table_rows) * k
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

    # window_score, the step's row variant: R = 32 rows of W = 256, K = 32,
    # read from a (V+1, K) replica table: ids below 200 (the inputs the
    # previous kernel was timed on), a window of the brain_like stream over
    # its full 40,001-row table, and a hub window whose first slot matches
    # every column.
    from repro_torch.kernels import window_score as ws_mod

    w, k, r = 256, 32, 32
    rows_np = np.random.default_rng(8).choice(w, r, replace=False).astype(np.int32)
    rows_np[0] = 0
    rows = T(rows_np)
    md = T(np.int32(40))
    hub = np.stack([np.full(w, 7), np.random.default_rng(9).integers(0, 200, w)], 1)
    cases = [("ids<200", ws_table_inputs(w, k, 200, 7)),
             ("brain_like window", ws_table_inputs(w, k, n, 7, uv=edges[100_000:100_000 + w])),
             ("hub", ws_table_inputs(w, k, 200, 7, uv=hub))]
    floor = cuda_ms(lambda: ws_mod.launch_floor(r), iters=200)
    for tag, arr in cases:
        t = [T(a) for a in arr]
        got = ops.window_score_rows(*t, md, rows)
        want = ref.window_score_rows_ref(*t, md, rows)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        bit_equal = torch.equal(got.view(torch.int32), want.view(torch.int32))
        check(bit_equal, f"window_score rows ({tag}) bit-equal to the plain version")
        ms = cuda_ms(lambda: ops.window_score_rows(*t, md, rows), iters=200)
        plain = cuda_ms(lambda: ref.window_score_rows_ref(*t, md, rows), iters=200)
        eager = eager_ms(lambda: ops.window_score_rows(*t, md, rows), iters=200)
        b, o = ws_work(arr[0], arr[1], rows_np, k, True)
        bms, by = bound(b, o)
        log(f"kernel window_score rows R={r} W={w} K={k} ({tag}, table {len(arr[3])} rows): "
            f"max_abs_err={err} bit_equal={bit_equal} ms={ms:.5f} launch_floor_ms={floor:.5f} "
            f"plain_ms={plain:.5f} eager_call_ms={eager:.5f} bound_ms={bms:.3g} ({by}) "
            f"bytes={b} ops={o} (before the redesign: 0.02659 ms)")
        if tag == "brain_like window":  # the main path's data
            rows_out["window_score"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=None,
                shape=f"rows R={r} of W={w}, K={k}, brain_like window, table {len(arr[3])} x {k}",
                bit_equal=bit_equal, launch_floor_ms=floor,
            )

    # The batched row op at the spotlight path's shape: z = 8 instances,
    # each a window of its own eighth of the brain_like stream over its own
    # 40,001-row table, in one launch — bit-equal to the batched plain
    # version and to eight z = 1 launches.
    z = 8
    per = -(-len(edges) // z)
    parts = [ws_table_inputs(w, k, n, 7 + i, uv=edges[i * per + 1000:i * per + 1000 + w])
             for i in range(z)]
    tb = [T(np.stack(x)) for x in zip(*parts)]
    mdz = T(np.full(z, 40, np.int32))
    rows_z = T(np.stack([np.roll(rows_np, i) for i in range(z)]))
    got = ops.window_score_rows_batched(*tb, mdz, rows_z)
    want = ref.window_score_rows_batched_ref(*tb, mdz, rows_z)
    singles = torch.stack([ops.window_score_rows(*(x[i] for x in tb), mdz[i], rows_z[i])
                           for i in range(z)])
    torch.cuda.synchronize()
    bit_equal = torch.equal(got.view(torch.int32), want.view(torch.int32))
    check(bit_equal, "window_score rows z=8: bit-equal to the batched plain version")
    check(torch.equal(got.view(torch.int32), singles.view(torch.int32)),
          "window_score rows z=8: bit-equal to eight z = 1 launches")
    ms_z = cuda_ms(lambda: ops.window_score_rows_batched(*tb, mdz, rows_z), iters=200)
    plain_z = cuda_ms(lambda: ref.window_score_rows_batched_ref(*tb, mdz, rows_z), iters=50)
    floor_z = cuda_ms(lambda: ws_mod.launch_floor(r * z), iters=200)
    b = o = 0
    for i in range(z):
        bi, oi = ws_work(parts[i][0], parts[i][1], np.roll(rows_np, i), k, True)
        b, o = b + bi, o + oi
    bms_z, by_z = bound(b, o)
    log(f"kernel window_score rows z={z} x R={r} W={w} K={k} (brain_like windows, tables "
        f"{z} x {n + 1} rows): max_abs_err={(got - want).abs().max().item()} bit_equal={bit_equal} "
        f"ms={ms_z:.5f} (z=1: {rows_out['window_score']['ms']:.5f}) launch_floor_ms={floor_z:.5f} "
        f"plain_ms={plain_z:.5f} bound_ms={bms_z:.3g} ({by_z})")
    rows_out["window_score"].update(batched_z8_ms=ms_z, batched_z8_plain_ms=plain_z,
                                    batched_z8_bound_ms=bms_z)
    del tb, got, want, singles

    # segment_sum at the main path's message layout (E = 2m, S = V).
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    seg = np.sort(dst, kind="stable").astype(np.int32)
    offs_np = segment_offsets(seg, n)
    lay = segment_layout(seg, n, dev)
    seg_t = lay.seg_ids
    longest = int(np.diff(offs_np).max())
    rng = np.random.default_rng(0)
    graph_data = []
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
        per_call = ss_kernels_per_call(lambda: ops.segment_sum_sorted(data, lay))
        check(per_call == 1, f"segment_sum {tag}: one device kernel per call (profiler; counted {per_call})")
        log(f"kernel segment_sum {tag} E={e} D={d} S={n} longest_run={longest} "
            f"tiles={lay.num_tiles} crossing_segments={lay.cross.shape[0]}: "
            f"max_abs_err={err} ms={ms:.5f} (before the redesign: {SS_WAS_MS[d]}) "
            f"plain_ms={plain:.5f} index_add_ms={library:.5f} bound_ms={bms:.5f} ({by}) "
            f"kernels_per_call={per_call}")
        if tag == "pagerank":
            rows_out["segment_sum"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=library, shape=f"E={e}, D={d}, S={n}", kernels_per_call=per_call,
            )
        graph_data.append(data)
        del got, again, want
    # Several calls in one CUDA graph, replayed twice: the eager bits each
    # time, and every crossing segment's counter back at 0.
    eager = [ops.segment_sum_sorted(x, lay) for x in graph_data + graph_data[:1]]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [ops.segment_sum_sorted(x, lay) for x in graph_data + graph_data[:1]]
    for i in range(2):
        for o in outs:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(o, w) for o, w in zip(outs, eager)),
              f"segment_sum: CUDA-graph replay {i} bit-equal to eager")
        check(int(lay.counters.abs().sum()) == 0, f"segment_sum: counters 0 after replay {i}")
    log(f"kernel segment_sum graph: {len(outs)} calls (D=1, 256, 1) captured, 2 replays bit-equal")
    del graph, outs, eager, graph_data
    # f16 input at the kernel test's shape.
    e, d, s = 2048, 16, 256
    seg16 = np.sort(rng.integers(0, s, e)).astype(np.int32)
    lay16 = segment_layout(seg16, s, dev)
    data = T(rng.normal(size=(e, d)).astype(np.float16))
    got = ops.segment_sum_sorted(data, lay16)
    want = ref.segment_sum_ref(data, lay16.seg_ids, s)
    torch.cuda.synchronize()
    check(torch.allclose(got, want, rtol=2e-3, atol=2e-3), "segment_sum f16 within 2e-3")
    per_call = ss_kernels_per_call(lambda: ops.segment_sum_sorted(data, lay16))
    check(per_call == 1, f"segment_sum f16: one device kernel per call (profiler; counted {per_call})")
    log(f"kernel segment_sum f16 E={e} D={d} S={s}: max_abs_err={(got - want).abs().max().item()} "
        f"kernels_per_call={per_call}")
    return rows_out


# The kernel before its redesign, by D, for the log (NVIDIA H100 80GB HBM3,
# 700.00 W).
SS_WAS_MS = {1: 0.01153, 256: 0.26669}


def profile_session(fn, what: str, tries: int = 3, cpu: bool = False):
    """``fn()`` under torch.profiler (CUDA activity; CPU activity too where
    ``cpu``, which ``record_function`` ranges need), the device
    synchronised before the session ends: (its result, the profile, the
    device's kernels and copies, the session's wall in s). CUPTI now and
    then hands back a session with no device record at all although the
    work ran on the card (seen on the H100 in a loop of profiled pagerank
    supersteps). Such a session says nothing of the program, so ``fn`` runs
    again under a new session, up to ``tries`` sessions in all, each empty
    one logged; a caller that still finds no device record fails its own
    check."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import device_kernels

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    for session in range(1, tries + 1):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = device_kernels(prof)
        if kern:
            break
        log(f"{what}: the profiler recorded no device activity (session {session} of {tries})")
    return out, prof, kern, wall


def range_device_us(prof, names) -> dict:
    """Device µs of the kernels launched inside each ``record_function``
    range of ``names`` in a CPU + CUDA profile, summed over the range's
    calls: what ``key_averages()`` gives as the range's
    ``device_time_total``, read from the raw records (a kernel belongs to
    the range whose span holds its runtime launch on the same thread) in a
    tenth of a second where ``key_averages()`` takes ~15 s on a full
    training step."""
    from torch.autograd import DeviceType

    spans, launches, kernels = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.name() in names:
                spans.append((e.name(), e.start_thread_id(), e.start_ns(), e.end_ns()))
            elif e.name().startswith("cu") and e.correlation_id():  # cudaLaunchKernel and kin
                launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            kernels.append((e.correlation_id(), e.duration_ns()))
    totals = dict.fromkeys(names, 0.0)
    for corr, dur in kernels:
        launch = launches.get(corr)
        for name, tid, start, end in spans if launch else ():
            if tid == launch[0] and start <= launch[1] <= end:
                totals[name] += dur / 1e3
    return totals


def profiled(fn, what: str, tries: int = 3):
    """:func:`profile_session` without the profile: (result, kernels, wall)."""
    out, _, kern, wall = profile_session(fn, what, tries)
    return out, kern, wall


def ss_kernels_per_call(fn, calls: int = 5, tries: int = 3) -> float:
    """Device kernels per call of ``fn`` under torch.profiler; fails if any
    of them is not the segment_sum kernel. Every call launches the kernel
    (its launch counter says so), so a session with fewer kernel records
    than calls has lost records, as CUPTI now and then does (seen on the
    H100 late in the smoke, never in a fresh process: 4 of 5, in every
    session of a run): it is logged and the calls are profiled again, up to
    ``tries`` sessions. Each session brackets the calls with a reduction
    (``reduce_kernel``, which segment_sum never launches, left out of the
    count), so a record lost at either end of the session is the
    bracket's. More records than calls are returned at once."""
    import torch

    fn()
    bracket = torch.zeros(8, device="cuda")
    torch.cuda.synchronize()

    def session():
        bracket.sum()
        out = [fn() for _ in range(calls)]
        bracket.sum()
        return out

    for session_no in range(1, tries + 1):
        _, kern, _ = profiled(session, "segment_sum kernels per call")
        kern = [e for e in kern if "reduce_kernel" not in e.key]
        n = sum(e.count for e in kern)
        if n >= calls:
            break
        log(f"segment_sum kernels per call: the profiler recorded {n} kernels for {calls} calls "
            f"(session {session_no} of {tries})")
    check(all("segsum_" in e.key for e in kern),
          f"segment_sum: only its kernel on the device ({[e.key[:60] for e in kern]})")
    return n / calls


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
                     f"us_per_step={loop_s / st['steps_run'] * 1e6:.2f} (before the redesign: 361.92) setup_s={st['setup_s']:.3f} "
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
    log(f"main engine: pagerank 30 supersteps wall_s={t_pr:.4f}, label_propagation "
        f"{linfo['supersteps']} supersteps {t_lp:.3f}s, segment_sum_launches={seg_launches}, "
        f"components={len(np.unique(labels))}")
    counts = ops.launch_counts()
    log(f"main peak device memory: {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    # One pagerank superstep under torch.profiler: its device time and the
    # segment_sum kernel's share of it.
    _, kern, t_step = profiled(lambda: pagerank(g, iters=1), "main pagerank superstep profile")
    busy_us = sum(e.self_device_time_total for e in kern)
    ss_us = sum(e.self_device_time_total for e in kern if "segsum_" in e.key)
    check(busy_us > 0 and ss_us > 0, "pagerank superstep profile: segment_sum on the device")
    log(f"main pagerank superstep profile: kernels={sum(e.count for e in kern)} "
        f"device_busy_us={busy_us:.3f} segment_sum_us={ss_us:.3f} "
        f"segment_sum_share={ss_us / busy_us:.4f} wall_ms={t_step * 1e3:.3f} (profiled, "
        f"pagerank(iters=1) with its set-up)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"main pagerank kernel {e.key[:80]}: {e.count} launches, {e.self_device_time_total:.3f} us")

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
    return counts, rd


# ----------------------------------------------------------------------------
# Phase 3: the card against the port's CPU path
# ----------------------------------------------------------------------------

# Phase 3's scale (a depth cut for the smoke's time limit: the CPU's
# non-lazy ADWISE run leads the phase).
CPU_PARITY_SCALE = 0.005


def phase_cpu_parity(k):
    import numpy as np

    from repro_torch.core import AdwiseConfig, partition_stream
    from repro_torch.engine import build_partitioned_graph, pagerank
    from repro_torch.graph import make_graph, replica_sets_from_assignment, replication_degree

    edges, n = make_graph("brain_like", seed=0, scale=CPU_PARITY_SCALE)
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


# Edges of phase 4's profiled run (and per instance of phase 9 (a)'s): 358
# steps, enough for the per-step means; the profiler's processing of each
# kernel's events, not the run, sets these profiles' walls.
PROFILE_EDGES = 100


def phase_profile(k):
    """Device busy time per ADWISE step under torch.profiler (CUPTI): kernels
    per step, busy µs per step (the sum of kernel durations, inflated by the
    profiler's own per-kernel cost), and the kernels that take the most."""
    from repro_torch.core import AdwiseConfig, partition_stream
    from repro_torch.graph import make_graph

    # PROFILE_EDGES edges of a small brain_like stream: m + W + 2 steps. The
    # step's shapes are fixed by W and K, so its kernels are those of the
    # full-size run; the phases before built the kernels and warmed torch.
    edges, n = make_graph("brain_like", seed=0, scale=0.005)
    edges = edges[:PROFILE_EDGES]
    cfg = AdwiseConfig(k=k, window_max=256)
    res, kern, _ = profiled(lambda: partition_stream(edges, n, cfg, device="cuda"), "profile")
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


# ----------------------------------------------------------------------------
# Phase 8: the paper's comparison set
# ----------------------------------------------------------------------------

# The window of bench_total_latency.py's adwise-restream rows at W = 256
# (benchmarks/common.py: window_init = W // 4), and its default scale.
RESTREAM_CFG = dict(passes=2, window_max=256, window_init=64)
# The restreaming set's scale: bench_total_latency.py's 0.08, cut to 0.02 for
# the smoke's time limit (phases 8, 9 e and 10 d run it).
BENCH_SCALE = 0.02


def profile_per_edge(run, m_short: int, m_long: int) -> tuple[float, float]:
    """(device kernels, device busy µs) per edge of ``run(m)`` on the card,
    from two profiled runs at m_short and m_long edges: the difference
    cancels the set-up, the capture and the warm-up, and leaves what the
    replayed graphs launch per edge."""
    got = []
    for m in (m_short, m_long):
        _, kern, _ = profiled(lambda: run(m), f"profile of {m} edges")
        got.append((sum(e.count for e in kern), sum(e.self_device_time_total for e in kern)))
    dm = m_long - m_short
    return (got[1][0] - got[0][0]) / dm, (got[1][1] - got[0][1]) / dm


def bill(name, res, edges, n, k, graph):
    """RD, 30 pagerank supersteps on the card (one segment_sum launch each)
    and the pagerank_300 bill, as bench_total_latency.py forms its rows."""
    import numpy as np

    from repro_torch.engine import (
        PAPER_CLUSTER, build_partitioned_graph, pagerank, partition_latency, process_latency,
    )
    from repro_torch.graph import partition_balance, replica_sets_from_assignment, replication_degree

    check((res.assign >= 0).all() and (res.assign < k).all() and res.stats.get("unassigned", 0) == 0,
          f"{name} ({graph}): every edge assigned")
    rd = replication_degree(replica_sets_from_assignment(edges, res.assign, n, k))
    g = build_partitioned_graph(edges, res.assign, n, k, device="cuda")
    pr, _ = pagerank(g, iters=30)
    check(pr.shape == (n,) and np.isfinite(pr).all(), f"{name} ({graph}): pagerank finite")
    t_part = partition_latency(res.stats, len(edges), k)
    t_proc = process_latency(g, 300, 1, PAPER_CLUSTER)["t_total_s"]
    check(np.isfinite(t_part + t_proc) and t_part + t_proc > 0, f"{name} ({graph}): total latency finite")
    return dict(strategy=name, graph=graph, rd=rd, imbalance=partition_balance(res.assign, k),
                wall_s=res.stats["wall_time_s"], t_partition_s=t_part, t_process_s=t_proc)


SINGLE_EDGE_SCALE = 0.06  # phase 8's hdrf / greedy: one torch step per edge (a depth cut)


def phase_comparison(k):
    """HDRF and Greedy at ``SINGLE_EDGE_SCALE``; 2PS-L, 2PS and adwise-restream
    at ``BENCH_SCALE`` — through the registry on the card, each against the
    port's CPU oracle where one finishes in seconds, billed for
    pagerank_300."""
    import numpy as np
    import torch

    from repro_torch.core import registry, restream
    from repro_torch.graph import make_graph
    from repro_torch.kernels import ops

    rows = []
    ops.reset_launch_counts()
    # Single-edge cores at SINGLE_EDGE_SCALE.
    edges_q, n_q = make_graph("brain_like", seed=0, scale=SINGLE_EDGE_SCALE)
    graph_q = f"brain_like {SINGLE_EDGE_SCALE}"
    for name in ("hdrf", "greedy"):
        res = registry.run_partitioner(name, edges_q, n_q, k, device="cuda")
        torch.cuda.synchronize()
        st = res.stats
        loop_s = st["wall_time_s"] - st["setup_s"]
        t0 = time.perf_counter()
        oracle = registry.run_partitioner(name, edges_q, n_q, k, device="cpu", scan=False)
        t_oracle = time.perf_counter() - t0
        check(np.array_equal(res.assign, oracle.assign),
              f"{name}: the card's assignment equals the numpy oracle bit for bit ({graph_q})")
        row = bill(name, res, edges_q, n_q, k, graph_q)
        row.update(steps=st["steps_run"], us_per_edge=loop_s / st["steps_run"] * 1e6,
                   steps_per_s=st["steps_run"] / loop_s, setup_s=st["setup_s"], oracle_s=t_oracle)
        rows.append(row)

    # The restreaming set at the benchmark's scale (a depth cut).
    edges, n = make_graph("brain_like", seed=0, scale=BENCH_SCALE)
    graph = f"brain_like {BENCH_SCALE}"
    mem = {}  # the in-memory results phase 10(d) holds its file runs to
    res = mem["hash"] = registry.run_partitioner("hash", edges, n, k, device="cuda")
    rows.append(bill("hash", res, edges, n, k, graph))
    hash_rd = rows[-1]["rd"]
    res = mem["2ps-l"] = registry.run_partitioner("2ps-l", edges, n, k, device="cuda")
    t0 = time.perf_counter()
    oracle = registry.run_partitioner("2ps-l", edges, n, k, device="cpu", scan=False)
    t_oracle = time.perf_counter() - t0
    check(np.array_equal(res.assign, oracle.assign),
          f"2ps-l: the card's assignment equals the numpy oracles of both phases bit for bit ({graph})")
    rows.append(dict(bill("2ps-l", res, edges, n, k, graph), oracle_s=t_oracle,
                     phase1_s=res.stats["phase1_wall_s"], n_clusters=res.stats["n_clusters"]))
    # 2ps shares 2ps-l's phase 1 (the clustering just held to its numpy
    # oracle through 2ps-l's assignment).
    res = mem["2ps"] = registry.run_partitioner("2ps", edges, n, k, device="cuda")
    check(res.stats["n_clusters"] == oracle.stats["n_clusters"], "2ps: the oracle's clusters")
    rows.append(dict(bill("2ps", res, edges, n, k, graph), phase1_s=res.stats["phase1_wall_s"],
                     n_clusters=res.stats["n_clusters"]))
    before = ops.launch_counts()["window_score"]
    res = registry.run_partitioner("adwise-restream", edges, n, k, device="cuda", **RESTREAM_CFG)
    ws = ops.launch_counts()["window_score"] - before
    restream_res = mem["adwise-restream"] = res
    st = res.stats
    check(ws == sum(st["pass_steps"]) and st["pass_steps"][1] > 0,
          "adwise-restream: one window_score launch per step of each pass, pass 2 included")
    check(st["pass_rd"][0] < hash_rd, "RD(ADWISE) below RD(hash) at the benchmark's scale")
    rows.append(dict(bill("adwise-restream[2p]", res, edges, n, k, graph),
                     pass_rd=st["pass_rd"], pass_wall_s=st["pass_wall_s"],
                     pass_steps=st["pass_steps"], window_score_launches=ws,
                     h2d_bytes=st["h2d_bytes"]))
    counts = ops.launch_counts()
    check(counts["segment_sum"] == 30 * len(rows), "comparison set: 30 segment_sum launches per bill")

    # Card against the CPU path where both finish in seconds: non-lazy, so
    # the order-dependent Θ sum does not enter (warm passes, residency and
    # the revocation table included).
    small, n_small = make_graph("brain_like", seed=0, scale=0.005)
    small_restream = dict(passes=2, window_max=64, window_init=16, lazy=False)
    for name, cfg in (("adwise-restream", small_restream), ("2ps", dict(lazy=False))):
        a = registry.run_partitioner(name, small, n_small, k, device="cuda", **cfg)
        b = registry.run_partitioner(name, small, n_small, k, device="cpu", **cfg)
        check(np.array_equal(a.assign, b.assign) and a.stats["score_rows"] == b.stats["score_rows"],
              f"{name} (non-lazy, brain_like 0.005): cuda and cpu bit-identical")

    # Device kernels and busy time per edge, by profiler (differences of two
    # runs, so only the replayed graphs count).
    prof_edges, n_prof = make_graph("brain_like", seed=0, scale=0.02)
    per_edge = {}
    for name in ("hdrf", "greedy", "2ps-l"):
        per_edge[name] = profile_per_edge(
            lambda m, name=name: registry.run_partitioner(name, prof_edges[:m], n_prof, k, device="cuda"),
            64, 256)
    per_edge["cluster"] = profile_per_edge(
        lambda m: restream.streaming_vertex_clustering(prof_edges[:m], n_prof, k, device="cuda"),
        64, 256)

    log("graph,workload,strategy,L,partition_s,process_s,total_s,RD")
    for r in rows:
        log(f"{r['graph']},pagerank_300,{r['strategy']},,{r['t_partition_s']:.3f},"
            f"{r['t_process_s']:.3f},{r['t_partition_s'] + r['t_process_s']:.3f},{r['rd']:.3f}")
    for r in rows:
        extra = " ".join(f"{key}={r[key]}" for key in (
            "steps", "us_per_edge", "steps_per_s", "setup_s", "oracle_s", "phase1_s", "n_clusters",
            "pass_rd", "pass_wall_s", "pass_steps", "window_score_launches", "h2d_bytes") if key in r)
        log(f"comparison {r['strategy']} ({r['graph']}): RD={r['rd']:.4f} imbalance={r['imbalance']:.4f} "
            f"wall_s={r['wall_s']:.3f} {extra}")
    for name, (kern, busy) in per_edge.items():
        what = "cluster step + 2ps-l step" if name == "2ps-l" else "step"
        log(f"comparison profile {name}: kernels_per_edge={kern:.1f} device_busy_us_per_edge={busy:.2f} "
            f"(one {what} per edge; profiled, graph replays)")
    return counts, restream_res, mem


# ----------------------------------------------------------------------------
# Phase 9: spotlight (z instances in one batched step) and tracing
# ----------------------------------------------------------------------------

SPOT_Z, SPOT_SPREAD = 8, 4  # k/z: disjoint blocks, the paper's recommendation
# Phase 9 (a)'s stream and phase 10 (a) and (c)'s: brain_like cut to 0.3 of
# its scale (105,571 edges; a depth cut for the smoke's time limit, each
# instance's share still past the 12,288-row ring of 10 (c)'s chunk).
SPOT_SCALE = 0.3


def spread_ok(assign, m, k, z, spread):
    """Every edge's partition lies in its instance's spread mask."""
    import numpy as np

    from repro_torch.core import spread_mask
    from repro_torch.graph import EdgeStream

    bounds = EdgeStream.split_bounds(m, z)
    return all(
        np.isin(assign[bounds[i]:bounds[i + 1]], np.flatnonzero(spread_mask(k, z, i, spread))).all()
        for i in range(z)
    )


def phase_spotlight(edges, n, k, window_max, rd_z1):
    """(a) the spotlight path at full width on brain_like at ``SPOT_SCALE``
    (``edges``): ADWISE with z = 8 instances on blocks of 4 partitions, one
    batched step each, then pagerank on its partition (the path whose
    launches are counted); hdrf and dbh at the same z and spread. ``rd_z1``
    is phase 2's RD at z = 1 (full scale). Returns the launch counts of
    (a)'s ADWISE path."""
    import numpy as np
    import torch

    from repro_torch.core import AdwiseConfig, spotlight_partition
    from repro_torch.engine import build_partitioned_graph, pagerank
    from repro_torch.graph import make_graph, replica_sets_from_assignment, replication_degree
    from repro_torch.kernels import ops

    m = len(edges)
    z, spread = SPOT_Z, SPOT_SPREAD
    cfg = AdwiseConfig(k=k, window_max=window_max)
    ops.reset_launch_counts()
    res = spotlight_partition(edges, n, k, z=z, spread=spread, strategy="adwise", cfg=cfg,
                              device="cuda")
    torch.cuda.synchronize()
    ws = ops.launch_counts()["window_score"]
    st = res.stats
    check((res.assign >= 0).all() and (res.assign < k).all(), "spotlight adwise: every edge assigned")
    check(spread_ok(res.assign, m, k, z, spread), "spotlight adwise: every edge inside its instance's spread")
    check(st["backend"] == "vmap" and st["n_buckets"] == 1, "spotlight adwise: one batched scan")
    check(ws == st["steps_run"] + st["warmup_steps"],
          f"spotlight adwise: one window_score launch per batched step ({ws} launches, "
          f"{st['steps_run']} + {st['warmup_steps']} steps)")
    rd = replication_degree(replica_sets_from_assignment(edges, res.assign, n, k))
    loop_s = st["wall_time_s"] - st["setup_s"]
    g = build_partitioned_graph(edges, res.assign, n, k, device="cuda")
    pr, _ = pagerank(g, iters=30)
    counts = ops.launch_counts()
    check(np.isfinite(pr).all() and counts["segment_sum"] == 30,
          "spotlight adwise: pagerank finite, 30 segment_sum launches")
    log(f"spotlight adwise z={z} spread={spread} (brain_like {SPOT_SCALE}, m={m}, k={k}, W={window_max}): "
        f"RD={rd:.4f} (z=1, phase 2: {rd_z1:.4f}) wall_s={st['wall_time_s']:.3f} "
        f"setup_s={st['setup_s']:.3f} steps={st['steps_run']} "
        f"us_per_step={loop_s / st['steps_run'] * 1e6:.2f} scan_calls={st['scan_calls']} "
        f"window_score_launches={ws} h2d_bytes={st['h2d_bytes']}")
    spot = {"adwise": res}
    for name in ("hdrf", "dbh"):
        r = spot[name] = spotlight_partition(edges, n, k, z=z, spread=spread, strategy=name,
                                             device="cuda")
        check(spread_ok(r.assign, m, k, z, spread), f"spotlight {name}: every edge inside its spread")
        rdn = replication_degree(replica_sets_from_assignment(edges, r.assign, n, k))
        extra = ""
        if "steps_run" in r.stats:
            ls = r.stats["wall_time_s"] - r.stats["setup_s"]
            extra = (f" steps={r.stats['steps_run']} "
                     f"us_per_step={ls / r.stats['steps_run'] * 1e6:.2f}")
        log(f"spotlight {name} z={z} spread={spread}: RD={rdn:.4f} "
            f"wall_s={r.stats['wall_time_s']:.3f}{extra}")

    # Kernels and busy µs per batched step (profiler) at z = 8, PROFILE_EDGES
    # edges per instance: the step shapes of phase 4's z = 1 profile (W = 256,
    # K = 32).
    small, n_small = make_graph("brain_like", seed=0, scale=0.02)
    sub = small[: PROFILE_EDGES * z]
    r, kern, _ = profiled(lambda: spotlight_partition(sub, n_small, k, z=z, spread=spread,
                                                      strategy="adwise", cfg=cfg, device="cuda"),
                          f"spotlight profile z={z}")
    steps = r.stats["steps_run"] + r.stats["warmup_steps"]
    if kern:
        log(f"spotlight profile z={z}: m={len(sub)} steps={steps} "
            f"kernels_per_step={sum(e.count for e in kern) / steps:.1f} "
            f"device_busy_us_per_step={sum(e.self_device_time_total for e in kern) / steps:.2f}")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"spotlight profile kernel {e.key[:90]}: {e.count / steps:.2f} per step, "
                f"{e.self_device_time_total / steps:.3f} us per step")
    return counts, spot


# Phase 9 (b)'s scale: bench_spotlight.py's 0.12, cut for the smoke's time.
SWEEP_SCALE = 0.06


def phase_spotlight_sweep(k):
    """(b) benchmarks/bench_spotlight.py's sweep on the card."""
    from repro_torch.core import AdwiseConfig, spotlight_partition
    from repro_torch.graph import make_graph, replica_sets_from_assignment, replication_degree

    edges, n = make_graph("brain_like", seed=0, scale=SWEEP_SCALE)
    z = SPOT_Z
    log(f"spotlight sweep brain_like {SWEEP_SCALE} (m={len(edges)}), k={k}, z={z}")
    log("strategy,spread,RD,improvement_vs_full,wall_s")
    for strategy in ("dbh", "hdrf", "adwise"):
        full_rd = None
        for spread in (k, k // 2, k // 4, k // z):
            cfg = AdwiseConfig(k=k, window_max=128) if strategy == "adwise" else None
            res = spotlight_partition(edges, n, k, z=z, spread=spread, strategy=strategy,
                                      cfg=cfg, device="cuda")
            check(spread_ok(res.assign, len(edges), k, z, spread),
                  f"sweep {strategy} spread {spread}: every edge inside its spread")
            rd = replication_degree(replica_sets_from_assignment(edges, res.assign, n, k))
            full_rd = full_rd or rd
            log(f"{strategy},{spread},{rd:.4f},{100 * (1 - rd / full_rd):.1f}%,"
                f"{res.stats['wall_time_s']:.3f}")


# Phase 9 (c)'s and (d)'s scales (depth cuts for the smoke's time limit:
# the loop backend runs its four instances one after another, and the CPU
# path is slower still).
SPOT_PARITY_SCALE = 0.005
SPOT_CPU_SCALE = 0.0025


def phase_spotlight_parity(k):
    """(c) the card's batched scan against its loop backend, bit for bit,
    with a skewed batch of two length buckets; (d) the batched card
    against the batched CPU path."""
    import numpy as np

    from repro_torch.core import AdwiseConfig, partition_stream, spotlight_partition
    from repro_torch.core.adwise import partition_stream_batched
    from repro_torch.graph import make_graph

    cases = [
        ("adwise", dict(cfg=AdwiseConfig(k=k, window_max=64))),
        ("hdrf", {}), ("greedy", {}), ("2ps", {}), ("2ps-l", {}),
        ("adwise-restream", dict(strategy_cfg=dict(passes=2, window_max=64, window_init=16))),
    ]
    par, n_par = make_graph("brain_like", seed=0, scale=SPOT_PARITY_SCALE)
    for name, kw in cases:
        a = spotlight_partition(par, n_par, k, z=4, spread=8, strategy=name, device="cuda", **kw)
        b = spotlight_partition(par, n_par, k, z=4, spread=8, strategy=name, device="cuda",
                                backend="loop", **kw)
        check(np.array_equal(a.assign, b.assign),
              f"spotlight {name} (brain_like {SPOT_PARITY_SCALE}, z=4): batched equals loop on the card")
        log(f"spotlight parity {name}: batched wall_s={a.stats['wall_time_s']:.3f} "
            f"loop max-instance wall_s={b.stats['wall_time_s']:.3f} "
            f"loop serial wall_s={b.stats['wall_time_serial_s']:.3f}")
    # Two length buckets: 3 instances of 300 edges, one of 3,000.
    edges, n = make_graph("brain_like", seed=0, scale=0.02)
    ms = [300, 300, 3000, 300]
    streams = np.zeros((4, max(ms), 2), np.int32)
    valid = np.zeros((4, max(ms)), bool)
    start = 0
    for i, mi in enumerate(ms):
        streams[i, :mi] = edges[start:start + mi]
        valid[i, :mi] = True
        start += mi
    cfg = AdwiseConfig(k=k, window_max=64)
    got = partition_stream_batched(streams, valid, n, cfg, device="cuda")
    check(got[0].stats["n_buckets"] == 2, "skewed batch: two length buckets")
    for i, mi in enumerate(ms):
        one = partition_stream(streams[i, :mi], n, cfg, device="cuda")
        check(np.array_equal(one.assign, got[i].assign),
              f"skewed batch instance {i} ({mi} edges): equals its z = 1 run on the card")

    small, n_small = make_graph("brain_like", seed=0, scale=SPOT_CPU_SCALE)
    nonlazy = dict(window_max=64, window_init=16, lazy=False)
    cases = [
        ("adwise", dict(cfg=AdwiseConfig(k=k, window_max=64))),
        ("hdrf", {}), ("greedy", {}), ("2ps", dict(strategy_cfg=dict(lazy=False))),
        ("2ps-l", {}), ("adwise-restream", dict(strategy_cfg=dict(nonlazy, passes=2))),
    ]
    for name, kw in cases:
        a = spotlight_partition(small, n_small, k, z=4, spread=8, strategy=name, device="cuda", **kw)
        b = spotlight_partition(small, n_small, k, z=4, spread=8, strategy=name, device="cpu", **kw)
        check(np.array_equal(a.assign, b.assign),
              f"spotlight {name} (brain_like {SPOT_CPU_SCALE}, z=4): the batched card equals the batched CPU")


def phase_tracing(k, untraced):
    """(e) a traced adwise-restream run at the benchmark's scale, against
    phase 8's untraced run of the same configuration (``untraced``); its
    export validated; pagerank's supersteps on the same tracer."""
    import json

    import numpy as np
    import torch

    from repro_torch.core import restream
    from repro_torch.engine import build_partitioned_graph, pagerank
    from repro_torch.graph import make_graph
    from repro_torch.obs import Tracer, validate_chrome_trace

    edges, n = make_graph("brain_like", seed=0, scale=BENCH_SCALE)
    cfg = dict(RESTREAM_CFG)
    tr = Tracer()
    res = restream.restream_partition(edges, n, k, trace=tr, device="cuda", **cfg)
    torch.cuda.synchronize()
    check(np.array_equal(res.assign, untraced.assign),
          "traced adwise-restream equals the untraced run (phase 8) bit for bit")
    g = build_partitioned_graph(edges, res.assign, n, k, device="cuda")
    pagerank(g, iters=30, trace=tr)
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    n_events = tr.export(path)
    with open(path) as f:
        problems = validate_chrome_trace(json.load(f))
    check(problems == [], f"trace export validates ({problems[:3]})")
    summ = tr.summary()
    cats = summ.categories
    check(cats["scan"]["count"] == sum(res.stats["pass_scan_calls"]),
          "trace: one scan span per scan call")
    lanes = sorted(t for t in summ.tracks if t.startswith("restream-pass-"))
    check(lanes == ["restream-pass-1", "restream-pass-2"], f"trace: two restream-pass lanes ({lanes})")
    check(cats["engine"]["count"] == 30, "trace: 30 superstep spans")
    compiled = sum(bool(s.attrs.get("compiled")) for s in tr.spans if s.name == "scan-call")
    log(f"tracing adwise-restream[2p] (brain_like {BENCH_SCALE}): traced wall_s="
        f"{res.stats['wall_time_s']:.3f} untraced wall_s={untraced.stats['wall_time_s']:.3f} "
        f"events={n_events} scan_spans={cats['scan']['count']} capture_spans={compiled} "
        f"pass_spans={cats['pass']['count']} superstep_spans={cats['engine']['count']} "
        f"(export {os.path.relpath(path, HERE)})")


# ----------------------------------------------------------------------------
# Phase 10: out-of-core — graph files, the file-fed ring, partition_file
# ----------------------------------------------------------------------------

# Phase 10(d)'s chunk: its ring of B = 12,288 rows holds the m = 7,077 rows
# of BENCH_SCALE, so restream adopts the ring; a file run's scan call runs
# the chunk's steps whatever m is, so a larger chunk only adds padded steps.
OOC_CHUNK_SMALL = 8192
# Phase 10 (b) and (e)'s depth cut: 14,069 edges, past the 12,288 rows of
# the 8,192-row chunk's ring, so the ring still wraps (at full scale and the
# default 65,536-row chunk, 137.0 s on an NVIDIA H100 80GB HBM3 at 700 W).
OOC_FILE_SCALE = 0.04
OOC_FILE_CHUNK = 8192


def ooc_dir() -> str:
    path = os.path.join(HERE, "build", "chip_smoke", "oocore")
    os.makedirs(path, exist_ok=True)
    return path


def file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def ring_line(st: dict) -> str:
    """The ring and pipeline numbers of a file run's stats."""
    wait, pre = st["h2d_wait_s"], st["prestage_wall_s"]
    overlap = 1.0 - wait / pre if pre > 0 else float("nan")
    return (f"scan_calls={st['scan_calls']} steps={st.get('steps_run')} ring={st['buffer_rows']} "
            f"h2d_rows={st['h2d_rows']} h2d_bytes={st['h2d_bytes']} spans={st['refill_spans']} "
            f"prestaged={st['spans_prestaged']} missed={st['spans_missed']} "
            f"h2d_wait_s={wait:.6f} prestage_wall_s={pre:.6f} overlap={overlap:.4f} "
            f"io_wall_s={st['io_wall_s']:.6f}")


def phase_oocore(edges, n, k, window_max, spot, cmp_res):
    """(a) ingest a SNAP text dump of phase 9a's stream (``edges``, brain_like
    at ``SPOT_SCALE``), byte-equal to the binary writer; (b) ADWISE at z = 1
    from a file of brain_like at scale ``OOC_FILE_SCALE`` (prefetch 2,
    traced), bit-equal to a resident run of the same cut; (c) z = 8
    through the launcher from the text file, bit-equal to phase 9a
    (``spot``), then pagerank; hdrf at the same z; (d) the restreaming set, dbh and hash at ``BENCH_SCALE`` from files,
    bit-equal to the in-memory runs (phase 8's, ``cmp_res``); (e) prefetch
    0 against (b)'s prefetch 2, and (b)'s traced file run
    whose category totals are its counters. Returns the launch counts of
    (b)-(e)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.core import partition_file, run_partitioner
    from repro_torch.graph import make_graph
    from repro_torch.graph.io import EdgeFileReader, ingest_text, write_edge_file
    from repro_torch.kernels import ops
    from repro_torch.launch.partition import main as launch_main
    from repro_torch.obs import Tracer, validate_chrome_trace

    out_dir = ooc_dir()
    m = len(edges)
    # (a) Ingest: the SNAP text form of phase 9a's stream.
    text = os.path.join(out_dir, "brain_like.txt")
    with open(text, "w") as f:
        f.write(f"# brain_like scale {SPOT_SCALE}: {n} vertices, {m} edges (u v)\n")
        np.savetxt(f, edges, fmt="%d", delimiter="\t")
    binary = os.path.join(out_dir, "brain_like.adw")
    ingested = os.path.join(out_dir, "ingested.adw")
    write_edge_file(binary, edges, n)
    rep = ingest_text(text, ingested, num_vertices=n)
    check(rep.num_edges == m and file_bytes(ingested) == file_bytes(binary),
          "ingest: the text dump ingests to the bytes write_edge_file writes")
    log(f"oocore ingest: {rep.bytes_read / 1e6:.3f} MB text, {rep.num_edges} edges in "
        f"{rep.wall_s:.4f}s ({rep.bytes_read / 1e6 / max(rep.wall_s, 1e-9):.1f} MB/s, "
        f"parser {rep.parser}); binary {os.path.getsize(binary)} bytes")

    ops.reset_launch_counts()
    # (b) ADWISE from a file at a depth cut that still wraps its chunk's ring
    # (8,192-row chunk, 12,288-row ring), prefetch 2 and traced (the run (e)
    # reads), beside a resident run of the same cut. Phase 2 holds the
    # resident path at full scale.
    cut, n_cut = make_graph("brain_like", seed=0, scale=OOC_FILE_SCALE)
    m_cut = len(cut)
    cut_path = os.path.join(out_dir, f"brain_like_{OOC_FILE_SCALE}.adw")
    write_edge_file(cut_path, cut, n_cut)
    resident = run_partitioner("adwise", cut, n_cut, k, window_max=window_max, device="cuda")
    torch.cuda.synchronize()
    before = ops.launch_counts()["window_score"]
    tr = Tracer()
    with EdgeFileReader(cut_path) as r:
        res = partition_file(r, "adwise", k, window_max=window_max, chunk_edges=OOC_FILE_CHUNK,
                             prefetch=2, trace=tr, device="cuda", spill_dir=os.path.join(out_dir, "b"))
    torch.cuda.synchronize()
    ws = ops.launch_counts()["window_score"] - before
    st = res.stats
    check(np.array_equal(np.asarray(res.assign), resident.assign),
          f"oocore adwise z=1 (brain_like {OOC_FILE_SCALE}): the file run equals the resident run bit for bit")
    check(st["h2d_rows"] == m_cut and st["h2d_bytes"] == 8 * m_cut,
          "oocore adwise z=1: every row shipped once, 8 B/row on a cold pass")
    check(ws == st["steps_run"] + st["warmup_steps"],
          "oocore adwise z=1: one window_score launch per step")
    check(st["ring_addrs"] == 1, "oocore adwise z=1: every refill wrote into the one ring")
    check(st["buffer_rows"] < m_cut, "oocore adwise z=1: the ring wraps")
    rst = resident.stats
    loop_s = st["wall_time_s"] - st["setup_s"]
    log(f"oocore adwise z=1 (brain_like {OOC_FILE_SCALE}, m={m_cut}, k={k}, W={window_max}, "
        f"chunk {OOC_FILE_CHUNK}, prefetch 2, traced): "
        f"wall_s={st['wall_time_s']:.3f} (resident, same cut: {rst['wall_time_s']:.3f}; "
        f"ratio {st['wall_time_s'] / rst['wall_time_s']:.4f}) setup_s={st['setup_s']:.3f} "
        f"us_per_step={loop_s / st['steps_run'] * 1e6:.2f} resident_steps={rst['steps_run']} "
        f"window_score_launches={ws} {ring_line(st)}")

    # (c) z = 8 on blocks of 4, through the launcher, from the text file.
    spill = os.path.join(out_dir, "c")
    stale = text + ".adw"
    if os.path.exists(stale):
        os.remove(stale)
    argv = ["--graph", text, "--ingest", "--strategy", "adwise", "--k", str(k),
            "--z", str(SPOT_Z), "--spread", str(SPOT_SPREAD), "--window-max", str(window_max),
            "--chunk-edges", "8192", "--spill-dir", spill, "--workload", "pagerank",
            "--device", "cuda"]
    before = ops.launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = launch_main(argv)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for ln in buf.getvalue().splitlines():
        log(f"oocore launcher: {ln}")
    got = np.fromfile(os.path.join(spill, "assign.i32"), dtype=np.int32)[:m]
    cst = out["stats"]
    check(np.array_equal(got, spot["adwise"].assign),
          "oocore launcher z=8: the spill equals phase 9a's in-memory z=8 ADWISE bit for bit")
    check(after["segment_sum"] - before["segment_sum"] == 30,
          "oocore launcher: pagerank launched segment_sum once per superstep")
    check(cst["buffer_rows"] == 12288 and cst["buffer_rows"] < -(-m // SPOT_Z),
          "oocore launcher z=8: each instance's ring wraps")
    check(after["window_score"] - before["window_score"] == cst["steps_run"] + cst["warmup_steps"],
          "oocore launcher z=8: one window_score launch per batched step")
    sst = spot["adwise"].stats
    log(f"oocore launcher z={SPOT_Z} spread={SPOT_SPREAD}: partition wall_s={cst['wall_time_s']:.3f} "
        f"(in-memory, phase 9a: {sst['wall_time_s']:.3f}; ratio "
        f"{cst['wall_time_s'] / sst['wall_time_s']:.4f}) resident_steps={sst['steps_run']} "
        f"RD={out['replication_degree']:.4f} total_latency_s={out['total_latency_s']:.3f} "
        f"{ring_line(cst)}")
    with EdgeFileReader(binary) as r:
        hres = partition_file(r, "hdrf", k, z=SPOT_Z, spread=SPOT_SPREAD, chunk_edges=8192,
                              device="cuda", spill_dir=os.path.join(out_dir, "c-hdrf"))
    check(np.array_equal(np.asarray(hres.assign), spot["hdrf"].assign),
          "oocore hdrf z=8: the file run equals phase 9a's in-memory run bit for bit")
    log(f"oocore hdrf z={SPOT_Z}: wall_s={hres.stats['wall_time_s']:.3f} (in-memory, phase 9a: "
        f"{spot['hdrf'].stats['wall_time_s']:.3f}) {ring_line(hres.stats)}")

    # (d) The restreaming set, dbh and hash at the benchmark's scale.
    small, n_small = make_graph("brain_like", seed=0, scale=BENCH_SCALE)
    ms = len(small)
    small_path = os.path.join(out_dir, f"brain_like_{BENCH_SCALE}.adw")
    write_edge_file(small_path, small, n_small)
    want = dict(cmp_res)
    want["dbh"] = run_partitioner("dbh", small, n_small, k, device="cuda")
    cfgs = {"adwise-restream": RESTREAM_CFG}
    for name in ("adwise-restream", "2ps", "2ps-l", "dbh", "hash"):
        with EdgeFileReader(small_path) as r:
            fres = partition_file(r, name, k, chunk_edges=OOC_CHUNK_SMALL, device="cuda",
                                  spill_dir=os.path.join(out_dir, f"d-{name}"),
                                  **cfgs.get(name, {}))
        check(np.array_equal(np.asarray(fres.assign), want[name].assign),
              f"oocore {name} (brain_like {BENCH_SCALE}): the file run equals the in-memory run")
        fst = fres.stats
        line = (f"oocore {name} (brain_like {BENCH_SCALE}, m={ms}, chunk {OOC_CHUNK_SMALL}): "
                f"wall_s={fst['wall_time_s']:.3f} (in-memory: "
                f"{want[name].stats['wall_time_s']:.3f}) stream_reads={fst['stream_reads']}")
        if "scan_calls" in fst:
            line += f" {ring_line(fst)}"
        log(line)
        if name == "adwise-restream":
            check(fst["h2d_rows"] == ms and fst["h2d_bytes"] == 12 * ms,
                  "oocore adwise-restream: pass 2 adopts the ring (h2d_bytes == 12 m)")

    # (e) The pipeline: prefetch 0 against (b)'s prefetch 2, which ran traced.
    runs = {2: res}
    with EdgeFileReader(cut_path) as r:
        runs[0] = partition_file(r, "adwise", k, window_max=window_max, chunk_edges=OOC_FILE_CHUNK,
                                 prefetch=0, device="cuda", spill_dir=os.path.join(out_dir, "e0"))
    check(np.array_equal(np.asarray(runs[0].assign), np.asarray(runs[2].assign)),
          f"oocore adwise (brain_like {OOC_FILE_SCALE}): prefetch 0 equals prefetch 2 bit for bit")
    est = runs[2].stats
    cats = tr.summary().categories
    check(abs(cats.get("refill", {}).get("wall_s", 0.0) - est["h2d_wait_s"]) < 1e-6,
          "oocore trace: the refill total is h2d_wait_s")
    check(abs(cats.get("stage", {}).get("wall_s", 0.0) - est["prestage_wall_s"]) < 1e-6,
          "oocore trace: the stage total is prestage_wall_s")
    check(cats["scan"]["count"] == est["scan_calls"], "oocore trace: one scan span per scan call")
    path = os.path.join(HERE, "build", "chip_smoke", "oocore_trace.json")
    n_events = tr.export(path)
    with open(path) as f:
        problems = validate_chrome_trace(json.load(f))
    check(problems == [], f"oocore trace export validates ({problems[:3]})")
    for pf in (0, 2):
        log(f"oocore adwise prefetch={pf} (brain_like {OOC_FILE_SCALE}, m={m_cut}, chunk {OOC_FILE_CHUNK}"
            f"{', traced' if pf else ''}): wall_s={runs[pf].stats['wall_time_s']:.3f} "
            f"{ring_line(runs[pf].stats)}")
    log(f"oocore trace: events={n_events} "
        + ", ".join(f"{c}:{d['count']}x/{d['wall_s']:.6f}s" for c, d in sorted(cats.items()))
        + f" (export {os.path.relpath(path, HERE)})")
    return ops.launch_counts()


# ----------------------------------------------------------------------------
# Phase 5: flash_attention against its plain version
# ----------------------------------------------------------------------------

# Tolerance of the kernel against its plain version, by dtype, as rtol = atol
# (the JAX kernel tests' form). fp32 and fp16 are the JAX tests' values;
# bf16 is 2e-2, about two bf16 ulps at |out| <= 4 (ulp 2^-6 in [2, 4)): the
# plain version computes in fp32 and rounds once; the kernel also rounds
# the probabilities to bf16 before P @ V, and the two outputs may then
# round to neighbouring bf16 values.
FA_TOL = {"float32": 2e-3, "float16": 5e-3, "bfloat16": 2e-2}


def fa_work(b, hq, hkv, tq, tk, dh, itemsize, causal):
    """(bytes, operations) attention needs on these shapes: q, k, v read
    once, the output written once; 4·Dh operations (two multiply-adds) per
    live (query, key) pair of every head — with causality at the end of KV,
    row r sees Tk - Tq + r + 1 keys."""
    nbytes = itemsize * (2 * b * hq * tq * dh + 2 * b * hkv * tk * dh)
    live = tq * (tk - tq) + tq * (tq + 1) // 2 if causal else tq * tk
    return nbytes, 4 * b * hq * live * dh


def phase_flash():
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(12)

    def inputs(b, hq, hkv, tq, tk, dh, dtype):
        return [torch.as_tensor(rng.normal(size=sh).astype(np.float32)).to(device=dev, dtype=dtype)
                for sh in ((b, hq, tq, dh), (b, hkv, tk, dh), (b, hkv, tk, dh))]

    def measure(tag, shape, dtype, causal=True, time_plain=True):
        """Error against the plain version (checked), the body that ran
        (checked), then kernel, plain and SDPA times and the bound. SDPA's
        is_causal aligns to the top left, so where Tq < Tk it gets the
        end-aligned mask instead. ``time_plain=False`` checks the plain
        version once and does not time it."""
        b, hq, hkv, tq, tk, dh = shape
        q, k, v = inputs(*shape, dtype)
        body = fa.body_for(dtype, dh)
        before = fa.LAUNCHES_BY_BODY[body]
        got = ops.flash_attention(q, k, v, causal=causal)
        check(fa.LAUNCHES_BY_BODY[body] - before == 1, f"flash_attention {tag} {shape} ran the {body} body")
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        name = str(dtype).split(".")[1]
        tol = FA_TOL[name]
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"flash_attention {tag} {shape} {name} causal={causal}: within rtol = atol = {tol}")
        mask = None
        if causal and tq < tk:
            qpos = torch.arange(tq, device=dev) + (tk - tq)
            mask = qpos[:, None] >= torch.arange(tk, device=dev)[None, :]

        def lib():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  is_causal=causal and mask is None, enable_gqa=True)

        sdpa_err = (lib().float() - want.float()).abs().max().item()
        del want
        nbytes, nops = fa_work(*shape, q.element_size(), causal)
        big = nops > 1e10
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal), iters=10 if big else 50)
        plain = (cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal), iters=3 if big else 20)
                 if time_plain else None)
        library = cuda_ms(lib, iters=10 if big else 50)
        bms, by = bound(nbytes, nops, FP32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S)
        line = (f"kernel flash_attention {tag} q=({b},{hq},{tq},{dh}) kv=({b},{hkv},{tk},{dh}) {name} "
                f"causal={causal} body={body}: max_abs_err={err} (rtol=atol={tol}) "
                f"sdpa_max_abs_err={sdpa_err} ms={ms:.5f} ")
        if plain is not None:
            line += f"plain_ms={plain:.5f} "
        else:
            line += "plain_ms=not timed "
        log(line + f"sdpa_ms={library:.5f} bound_ms={bms:.6f} ({by}) bytes={nbytes} ops={nops} "
            f"kernel_tflops={nops / ms / 1e9:.2f} sdpa_tflops={nops / library / 1e9:.2f}")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                    library_ms=library, body=body)

    row = measure("serve", (4, 24, 8, 2048, 2048, 128), torch.bfloat16)
    row["shape"] = "q (4,24,2048,128), k/v (4,8,2048,128), bf16, causal"
    check(row["body"] == "wgmma", "flash_attention: the serving shape ran the wgmma body")
    # The serving shape at Dh 64 (Qwen1.5-0.5B's, Granite's and Whisper's head
    # dim), on the same body.
    measure("serve Dh=64", (4, 24, 8, 2048, 2048, 64), torch.bfloat16)
    measure("ragged", (1, 24, 8, 2000, 2000, 128), torch.bfloat16)
    # Long context: the plain version's fp32 logits are 6.4 GB here, so it is
    # checked once and not timed.
    measure("long", (1, 24, 8, 8192, 8192, 128), torch.bfloat16, time_plain=False)
    gc.collect()
    torch.cuda.empty_cache()
    # A ragged one-tile-plus-one-row KV at both wgmma head dims.
    for dh in (64, 128):
        for dtype in (torch.bfloat16, torch.float16):
            measure("Tk=129", (2, 6, 2, 129, 129, dh), dtype)
    # The JAX kernel tests' shapes (tests/test_kernels.py), in fp32 and fp16.
    for dtype in (torch.float32, torch.float16):
        for shape in [(1, 1, 1, 8, 8, 32), (2, 4, 2, 130, 130, 64), (1, 8, 1, 256, 256, 128),
                      (2, 4, 4, 64, 64, 64), (1, 4, 2, 1, 513, 64), (1, 2, 2, 100, 356, 32)]:
            measure("test", shape, dtype)
    for dh in (32, 64, 96, 128):
        for dtype in (torch.bfloat16, torch.float32):
            measure(f"Dh={dh}", (2, 12, 4, 517, 517, dh), dtype)
    for dtype in (torch.float32, torch.bfloat16):
        measure("non-causal", (2, 8, 2, 256, 256, 64), dtype, causal=False)
    # The prefill shapes of phase 12's wgmma launches: Granite-MoE's (GQA
    # group 2, Dh 64) and InternVL2's (2048 tokens + 256 patches, GQA group
    # 6, Dh 128; the plain version's fp32 logits are 4.1 GB here).
    measure("granite prefill", (4, 16, 8, 2048, 2048, 64), torch.bfloat16)
    measure("internvl prefill", (4, 48, 8, 2304, 2304, 128), torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    # Zamba2-7B's shared attention block at the family serving shape: Dh 112
    # on mma_sync (bf16) and on fma (fp32).
    for dtype in (torch.bfloat16, torch.float32):
        measure("zamba2 Dh=112", (4, 32, 32, 2048, 2048, 112), dtype)
    gc.collect()
    torch.cuda.empty_cache()
    # Whisper-tiny at batch 8, prompt 448: the encoder over 224 frames, the
    # decoder's causal self-attention, the cross-attention in prefill and in
    # decode (Tq = 1) — non-causal at a Tk no 128-row tile divides.
    measure("whisper encoder", (8, 6, 6, 224, 224, 64), torch.bfloat16, causal=False)
    measure("whisper self", (8, 6, 6, 448, 448, 64), torch.bfloat16)
    measure("whisper cross", (8, 6, 6, 448, 224, 64), torch.bfloat16, causal=False)
    measure("whisper cross decode", (8, 6, 6, 1, 224, 64), torch.bfloat16, causal=False)
    # Phase 14's prefills at tp 2: each rank's local heads (llama 12 q over
    # 4 KV heads, granite 8 over 4) at prompt 512, wgmma.
    measure("llama tp 2 rank", (4, 12, 4, 512, 512, 128), torch.bfloat16)
    measure("granite tp 2 rank", (4, 8, 4, 512, 512, 64), torch.bfloat16)
    # Phase 16's prefills at one tp 2 rank's heads: zamba2's shared block (16
    # heads of Dh 112, mma_sync) at prompt 512; whisper's encoder over 224
    # frames, decoder self-attention and cross-attention at batch 4, prompt
    # 448 (3 heads of Dh 64, wgmma).
    measure("zamba2 tp 2 rank", (4, 16, 16, 512, 512, 112), torch.bfloat16)
    measure("whisper encoder tp 2 rank", (4, 3, 3, 224, 224, 64), torch.bfloat16, causal=False)
    measure("whisper self tp 2 rank", (4, 3, 3, 448, 448, 64), torch.bfloat16)
    measure("whisper cross tp 2 rank", (4, 3, 3, 448, 224, 64), torch.bfloat16, causal=False)
    # Phase 17's launches, under autograd: each of its runs at each mesh's
    # rank heads (wgmma in bf16, fma in fp32). Checked once, not timed plain.
    for tag, shape, dtype, causal in tpt_flash_shapes():
        measure(tag, shape, getattr(torch, dtype), causal=causal, time_plain=False)
    return row


# ----------------------------------------------------------------------------
# Phase 6: LM serving at full width
# ----------------------------------------------------------------------------

SERVE_ARGS = ["--arch", "llama3.2-3b", "--batch", "4", "--prompt-len", "2048", "--gen", "64"]


def phase_serve():
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_config("llama3.2-3b")
    b, t, n_gen = 4, 2048, 64
    torch.cuda.reset_peak_memory_stats()
    info = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    gen = serve.main(SERVE_ARGS, info=info)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(gen.shape == (b, n_gen) and (gen >= 0).all() and (gen < cfg.vocab).all(),
          "serve: (4, 64) tokens in [0, vocab)")
    check(info["logits_finite"], "serve: prefill and decode logits finite")
    check(info["prefill_launches"]["flash_attention"] == cfg.n_layers == 28,
          "serve: 28 flash_attention launches in the prefill")
    check(info["decode_launches"]["flash_attention"] == 0, "serve: no flash_attention launch in decode")
    check(counts["flash_attention"] == 28, "serve: 28 flash_attention launches in the run")
    by_body = dict(fa.LAUNCHES_BY_BODY)
    check(by_body["wgmma"] == 28 and sum(by_body.values()) == 28,
          "serve: the 28 prefill launches ran the wgmma body, and decode launched none")
    steps = n_gen - 1
    log(f"serve llama3.2-3b B={b} prompt={t} gen={n_gen}: prefill_ms={info['prefill_s'] * 1e3:.3f} "
        f"prefill_tok_per_s={b * t / info['prefill_s']:.1f} "
        f"decode_ms_per_token={info['decode_s'] / steps * 1e3:.3f} (per step of {b} tokens) "
        f"decode_tok_per_s={info['decode_tokens'] / info['decode_s']:.1f} "
        f"peak_mem_GiB={info['peak_bytes'] / 2**30:.3f} main_wall_s={wall:.3f} "
        f"(weights init and the loop included) params={cfg.param_count()}")
    log(f"serve generated[0][:12] = {gen[0, :12].tolist()}")
    gc.collect()
    torch.cuda.empty_cache()

    # Steady state: the same model again, a second prefill, and decode steps
    # under torch.profiler — device busy time per step against the wall.
    model = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    prompts = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (b, t)),
                              dtype=torch.int32).cuda()
    cache = lm.init_cache(cfg, b, t + n_gen, device="cuda")
    lm.forward_cached(model, cfg, cache, prompts, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = lm.forward_cached(model, cfg, cache, prompts, 0)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    del logits
    _, kern, _ = profiled(lambda: lm.forward_cached(model, cfg, cache, prompts, 0),
                          "serve prefill profile")
    busy_us = sum(e.self_device_time_total for e in kern)
    log(f"serve prefill profile: kernels={sum(e.count for e in kern)} "
        f"device_busy_ms={busy_us / 1e3:.3f} (profiled)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"serve prefill kernel {e.key[:80]}: {e.count} launches, "
            f"{e.self_device_time_total / 1e3:.3f} ms ({e.self_device_time_total / busy_us:.3f} of busy)")
    for i in range(3):  # warm decode
        lg, _ = lm.forward_cached(model, cfg, cache, tok, t + i)
        tok = lg[:, -1:].argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    n_prof = 8

    def decode(tok):
        for i in range(n_prof):
            lg, _ = lm.forward_cached(model, cfg, cache, tok, t + 3 + i)
            tok = lg[:, -1:].argmax(-1).to(torch.int32)
        return tok

    _, kern, wall_prof = profiled(lambda: decode(tok), "serve decode profile")
    busy_us = sum(e.self_device_time_total for e in kern)
    n_kern = sum(e.count for e in kern)
    log(f"serve steady: second prefill_ms={t_prefill * 1e3:.3f} (before the redesign: 142.033) "
        f"prefill_tok_per_s={b * t / t_prefill:.1f}")
    log(f"serve decode profile: {n_prof} steps, kernels_per_step={n_kern / n_prof:.1f} "
        f"device_busy_ms_per_step={busy_us / n_prof / 1e3:.3f} "
        f"wall_ms_per_step={wall_prof / n_prof * 1e3:.3f} (profiled) "
        f"idle_share={1 - busy_us / 1e6 / wall_prof:.3f}")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"serve decode kernel {e.key[:80]}: {e.count / n_prof:.1f} per step, "
            f"{e.self_device_time_total / n_prof:.1f} us per step")
    del model, cache, prompts
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------------
# Phase 7: the LM on the card against the port's CPU path, full width
# ----------------------------------------------------------------------------

def phase_lm_parity():
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm

    log(f"lm parity: allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    tol = 2e-3
    cfg = dataclasses.replace(get_config("llama3.2-3b"), n_layers=2, dtype="float32")
    cpu_model = lm.init_params(cfg, torch.Generator().manual_seed(0))
    gpu_model = lm.LM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    prompt_len, n_dec = 300, 4
    prompts = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (1, prompt_len)),
                              dtype=torch.int32)
    caches = [lm.init_cache(cfg, 1, prompt_len + n_dec, device=d) for d in ("cpu", "cuda")]
    before = ops.launch_counts()["flash_attention"]
    a, _ = lm.forward_cached(cpu_model, cfg, caches[0], prompts, 0)
    g, _ = lm.forward_cached(gpu_model, cfg, caches[1], prompts.cuda(), 0)
    check(ops.launch_counts()["flash_attention"] - before == 2, "lm parity: 2 flash launches in prefill")
    errs = [(g.cpu() - a).abs().max().item()]
    check(torch.allclose(g.cpu(), a, rtol=tol, atol=tol), "lm parity: prefill logits within 2e-3")
    same, decided = 0, 0
    last_a, last_g = a[:, -1], g[:, -1].cpu()
    for i in range(n_dec + 1):
        top2 = last_a.topk(2, dim=-1).values
        if (top2[:, 0] - top2[:, 1]).item() > tol:
            decided += 1
            check(torch.equal(last_a.argmax(-1), last_g.argmax(-1)),
                  f"lm parity: greedy token {i} equal (margin above {tol})")
        same += int(torch.equal(last_a.argmax(-1), last_g.argmax(-1)))
        if i == n_dec:
            break
        tok = last_a.argmax(-1, keepdim=True).to(torch.int32)  # the CPU's token feeds both
        a, _ = lm.forward_cached(cpu_model, cfg, caches[0], tok, prompt_len + i)
        g, _ = lm.forward_cached(gpu_model, cfg, caches[1], tok.cuda(), prompt_len + i)
        errs.append((g.cpu() - a).abs().max().item())
        check(torch.allclose(g.cpu(), a, rtol=tol, atol=tol), f"lm parity: decode step {i} logits within 2e-3")
        last_a, last_g = a[:, -1], g[:, -1].cpu()
    log(f"lm parity llama3.2-3b width, 2 layers, fp32, prompt {prompt_len}, {n_dec} decode steps: "
        f"max_abs_err per step={errs} tokens equal {same}/{n_dec + 1} "
        f"({decided} with top-2 margin > {tol})")
    del cpu_model, gpu_model, caches


# ----------------------------------------------------------------------------
# Phase 11: LM training at full width
# ----------------------------------------------------------------------------

TRAIN_SEQ = 4096  # the sequence length of the train_4k shape (configs/base.py)
TRAIN_STEPS = 6
TRAIN_ARGS = ["--arch", "llama3.2-3b", "--seq", str(TRAIN_SEQ), "--batch", "1",
              "--steps", str(TRAIN_STEPS), "--lr", "1e-3", "--device", "cuda"]
# Names of the GEMM kernels (cuBLAS / CUTLASS) in a profile.
GEMM_NAMES = ("gemm", "xmma", "cutlass", "nvjet", "sm90_")
# The port's profiler ranges on the training step (record_function).
TRAIN_RANGES = ("flash_attention_backward", "adamw_update")
# Tolerances of (c)'s bf16 step against the fp32 one: loss, relative, and
# the worst gradient leaf, relative norm.
BF16_LOSS_TOL = 2e-4
BF16_GRAD_TOL = 6e-2


# (tag, (b, hq, hkv, tq, tk, dh), causal) of phase 11 (a): Llama-3.2-3B's
# training shape, and the same at Dh 64.
TRAIN_ATTN_SHAPES = [
    ("train", (1, 24, 8, TRAIN_SEQ, TRAIN_SEQ, 128), True),
    ("train Dh=64", (1, 24, 8, TRAIN_SEQ, TRAIN_SEQ, 64), True),
]


def attn_bwd_work(b, hq, hkv, tq, tk, dh, itemsize, causal=True):
    """(bytes, operations) of attention's backward: q, k, v, out and dout
    read once, dq, dk, dv written once; five products per live pair (the
    logits again, dP, dV, dQ, dK) against the forward's two."""
    nbytes = itemsize * (4 * b * hq * tq * dh + 4 * b * hkv * tk * dh)
    return nbytes, fa_work(b, hq, hkv, tq, tk, dh, itemsize, causal)[1] * 5 // 2


def phase_train_attention(shapes=TRAIN_ATTN_SHAPES):
    """(a) The autograd Function at each of ``shapes`` (bf16; phase 11: the
    training shape and Dh 64): the forward on the body ``body_for`` names,
    against the plain version (FA_TOL) and bit-equal to the bare kernel
    call, dq/dk/dv against autograd through the plain version; times of the
    kernel, the backward and SDPA's forward + backward. The Function's
    backward is plain code (no kernel), so its check holds the backward's
    512-row blocking against the unblocked plain version; the kernel is
    held by the forward check. Returns the times at the first shape."""
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(19)
    out_row = None
    for tag, shape, causal in shapes:
        b, hq, hkv, tq, tk, dh = shape
        body = fa.body_for(torch.bfloat16, dh)
        q, k, v = (torch.as_tensor(rng.normal(size=sh).astype(np.float32) * 0.5)
                   .to(device="cuda", dtype=torch.bfloat16).requires_grad_(True)
                   for sh in ((b, hq, tq, dh), (b, hkv, tk, dh), (b, hkv, tk, dh)))
        dout = torch.as_tensor(rng.normal(size=(b, hq, tq, dh)).astype(np.float32)).to(
            device="cuda", dtype=torch.bfloat16)
        before, bwd0 = fa.LAUNCHES_BY_BODY[body], fa.BACKWARD_CALLS
        out = ops.flash_attention(q, k, v, causal=causal, scale=1.0)
        check(out.grad_fn is not None and fa.LAUNCHES_BY_BODY[body] - before == 1,
              f"train attention {tag}: the Function's forward launched the {body} body, with a grad_fn")
        with torch.no_grad():
            bare = fa.flash_attention(q, k, v, causal=causal, scale=1.0)
        check(torch.equal(out, bare), f"train attention {tag}: the Function's forward equals the bare kernel bit for bit")
        want_out = ref.flash_attention_ref(q, k, v, causal=causal, scale=1.0)
        out_tol = FA_TOL["bfloat16"]
        out_err = (out.float() - want_out.float()).abs().max().item()
        check(torch.allclose(out.float(), want_out.float(), rtol=out_tol, atol=out_tol),
              f"train attention {tag}: the kernel's output within rtol = atol = {out_tol} of the plain version")
        got = torch.autograd.grad(out, (q, k, v), dout)
        check(fa.BACKWARD_CALLS - bwd0 == 1, f"train attention {tag}: one backward call")
        want = torch.autograd.grad(want_out, (q, k, v), dout)
        torch.cuda.synchronize()
        errs = []
        for name, g, w in zip("qkv", got, want):
            # Both compute in fp32 and round once to bf16, summed in another
            # order: within one bf16 ulp (2^-7 relative), plus 1e-5 of the
            # tensor's largest element for results near zero.
            tol = 1e-5 * w.float().abs().max().item()
            err = (g.float() - w.float()).abs().max().item()
            errs.append(err)
            check(torch.allclose(g.float(), w.float(), rtol=2.0**-7, atol=tol),
                  f"train attention {tag}: d{name} within one bf16 ulp of autograd through the plain version")
            check(bool(torch.isfinite(g).all()) and bool((g != 0).any()), f"train attention {tag}: d{name} finite, non-zero")
        del want, got, want_out
        qd, kd, vd = (t.detach() for t in (q, k, v))
        fwd_ms = cuda_ms(lambda: ops.flash_attention(qd, kd, vd, causal=causal, scale=1.0), iters=10)
        bwd_ms = eager_ms(lambda: fa.attention_backward_plain(qd, kd, vd, dout, causal=causal, scale=1.0),
                          iters=3)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=1.0, enable_gqa=True)
            return torch.autograd.grad(o, (q, k, v), dout)

        sdpa_ms = eager_ms(sdpa_fwd_bwd, iters=5)
        nbytes, nops = attn_bwd_work(*shape, 2, causal)
        bms, by = bound(nbytes, nops, BF16_OPS_PER_S)
        n_blocks = -(-tq // fa.BACKWARD_Q_BLOCK)
        log(f"train attention {tag} q=({b},{hq},{tq},{dh}) kv=({b},{hkv},{tk},{dh}) bf16 "
            f"{'causal' if causal else 'non-causal'} body={body}: "
            f"max_abs_err out={out_err} (rtol=atol={out_tol}) dq/dk/dv={errs} kernel_fwd_ms={fwd_ms:.5f} plain_bwd_ms={bwd_ms:.3f} "
            f"(eager, {n_blocks} blocks of {fa.BACKWARD_Q_BLOCK} rows) sdpa_fwd_bwd_ms={sdpa_ms:.3f} "
            f"bwd_bound_ms={bms:.5f} ({by}) bwd_ops={nops}")
        if out_row is None:
            out_row = dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, sdpa_fwd_bwd_ms=sdpa_ms, bwd_bound_ms=bms)
        del q, k, v, dout, out, bare, qd, kd, vd
        gc.collect()
        torch.cuda.empty_cache()
    return out_row


def phase_train(attn):
    """(b) ``launch.train.main`` on full-width Llama-3.2-3B (bf16, batch 1,
    seq 4096, random weights from seed 0), its launches counted from zero;
    then a profile of one step and the step split by CUDA events. Returns
    the run's kernel launch counts and its reading (``step_s``, the median
    step's wall; ``model_flops`` and ``bf16_peak_share`` as logged), which
    phase 18 (c) reads."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import adamw_update

    cfg = get_config("llama3.2-3b")
    gc.collect()
    torch.cuda.empty_cache()
    info = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = train.main(TRAIN_ARGS, info=info)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    by_body = dict(fa.LAUNCHES_BY_BODY)
    per_step = 2 * cfg.n_layers
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), f"train: {TRAIN_STEPS} finite losses")
    check(losses[-1] < losses[0], f"train: the last loss below the first ({losses[0]:.4f} -> {losses[-1]:.4f})")
    check(info["flash_launches"] == [per_step] * TRAIN_STEPS,
          f"train: exactly {per_step} flash_attention launches per step ({info['flash_launches']})")
    check(counts["flash_attention"] == per_step * TRAIN_STEPS and by_body["wgmma"] == counts["flash_attention"]
          and sum(by_body.values()) == by_body["wgmma"], "train: every flash_attention launch on the wgmma body")
    check(info["attn_backward_calls"] == [cfg.n_layers] * TRAIN_STEPS,
          f"train: {cfg.n_layers} attention backward calls per step")
    flags = info["grad_flags"]
    # embed and ln_f (tied: no head), and per layer ln1, ln2, wq, wk, wv, wo,
    # w_gate, w_up, w_down.
    check(len(flags) == 2 + 9 * cfg.n_layers, "train: a gradient flag for every parameter")
    bad = [n for n, (finite, nonzero) in flags.items() if not (finite and nonzero)]
    check(not bad, f"train: every parameter's gradient at step 0 finite and non-zero ({bad[:6]})")
    for w in ("wq", "wk", "wv"):
        check(all(flags[f"blocks.{i}.attn.{w}"] == (True, True) for i in range(cfg.n_layers)),
              f"train: {w} of all {cfg.n_layers} layers has a finite, non-zero gradient at step 0")
    steps = info["step_s"][1:]  # the first step pays cuBLAS and allocator warm-up
    step_s = float(np.median(steps))
    tokens = info["tokens_per_step"]
    attn_fwd_ops = fa_work(1, cfg.n_heads, cfg.n_kv, TRAIN_SEQ, TRAIN_SEQ, cfg.d_head, 2, True)[1]
    model_flops = 8 * info["n_params"] * tokens + 4 * cfg.n_layers * attn_fwd_ops
    log(f"train llama3.2-3b B=1 seq={TRAIN_SEQ} steps={TRAIN_STEPS}: losses={[round(x, 4) for x in losses]}")
    log(f"train step_s={[round(x, 4) for x in info['step_s']]} median_step_ms={step_s * 1e3:.3f} "
        f"(steps 1-{TRAIN_STEPS - 1}) tok_per_s={tokens / step_s:.1f} model_flops={model_flops:.4e} "
        f"(8*N*tokens + 4*attention forward; N={info['n_params']}) "
        f"bf16_peak_share={model_flops / step_s / BF16_OPS_PER_S:.4f} "
        f"peak_mem_GiB={info['peak_bytes'] / 2**30:.3f} main_wall_s={wall:.3f} "
        f"flash_launches_per_step={per_step} attn_backward_per_step={cfg.n_layers}")
    reading = dict(step_s=step_s, model_flops=model_flops,
                   bf16_peak_share=model_flops / step_s / BF16_OPS_PER_S)
    del info, losses
    gc.collect()
    torch.cuda.empty_cache()

    # One step profiled, then the step split by CUDA events.
    model, state = train.build_state(cfg, torch.device("cuda"), seed=0)
    step = train.make_step(model, cfg, lambda s: 1e-3)
    data = SyntheticTokens(cfg, ShapeConfig("cli", TRAIN_SEQ, 1, "train"), seed=0)
    batch = {"tokens": torch.as_tensor(data.batch_at(0)["tokens"]).cuda()}
    step(state, batch)  # warm
    _, prof, kern, wall_prof = profile_session(lambda: step(state, batch), "train step profile", cpu=True)
    ranges = range_device_us(prof, TRAIN_RANGES)
    check(not any(e.key in TRAIN_RANGES for e in kern),
          "train step profile: device_kernels holds no record_function range")
    busy = sum(e.self_device_time_total for e in kern)
    check(busy > 0, "train step profile: device activity recorded")
    split = {"gemm": 0.0, "flash_attention (fwd kernel)": 0.0, "other": 0.0}
    for e in kern:
        key = ("flash_attention (fwd kernel)" if "flash_wgmma" in e.key
               else "gemm" if any(g in e.key.lower() for g in GEMM_NAMES) else "other")
        split[key] += e.self_device_time_total
    log(f"train step profile: kernels={sum(e.count for e in kern)} device_busy_ms={busy / 1e3:.3f} "
        f"wall_ms={wall_prof * 1e3:.3f} idle_share={1 - busy / 1e6 / wall_prof:.4f} (profiled)")
    log("train step profile by kernel name: " + " ".join(
        f"{k}={v / 1e3:.3f}ms ({v / busy:.3f})" for k, v in split.items()))
    log("train step profile by range (device ms, kernels of the range and its children): " + " ".join(
        f"{k}={v / 1e3:.3f}ms ({v / busy:.3f})" for k, v in ranges.items()))
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"train step kernel {e.key[:90]}: {e.count} launches, "
            f"{e.self_device_time_total / 1e3:.3f} ms ({e.self_device_time_total / busy:.3f} of busy)")
    del prof, kern

    params = state["params"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for p in params.values():
        p.grad = None
    ev[0].record()
    loss, _ = lm.loss_fn(model, cfg, batch)
    ev[1].record()
    loss.backward()
    ev[2].record()
    adamw_update({n: p.grad for n, p in params.items()}, state["opt"], params, 1e-3)
    ev[3].record()
    ev[3].synchronize()
    fwd, bwd, opt = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
    total = fwd + bwd + opt
    log(f"train step split (CUDA events): forward+loss_ms={fwd:.3f} backward_ms={bwd:.3f} "
        f"(remat recompute + attention backward) adamw_ms={opt:.3f} total_ms={total:.3f}; "
        f"attention backward ~{cfg.n_layers} x {attn['bwd_ms']:.3f} = {cfg.n_layers * attn['bwd_ms']:.3f} ms "
        f"({cfg.n_layers * attn['bwd_ms'] / total:.3f} of the step), flash forward "
        f"{per_step} x {attn['fwd_ms']:.5f} = {per_step * attn['fwd_ms']:.3f} ms "
        f"({per_step * attn['fwd_ms'] / total:.4f})")
    del model, state, params, loss, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts, reading


def phase_train_parity():
    """(c) One train step (make_step) of 2 full-width Llama-3.2-3B layers,
    batch 1, seq 256, from the same weights (seed 0, rounded to bf16): on
    the CPU in fp32 (the reference), on the card in fp32 (TF32 off; the
    kernel's fma body) and on the card in bf16 (its wgmma body, as the
    full-width run). fp32: the loss, every gradient, the moments and the
    params after one AdamW step. bf16: the loss and every gradient, which
    reach the kernel's output through wo and the layers after it."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train

    cfg32 = dataclasses.replace(get_config("llama3.2-3b"), n_layers=2, dtype="float32")
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg32.vocab, (1, 257)), dtype=torch.int32)

    def run(cfg, dev, start):
        model, state = train.build_state(cfg, torch.device(dev), seed=0)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n] if start is not None else p.bfloat16())
        begin = {n: p.detach().float().clone() for n, p in model.named_parameters()}
        step = train.make_step(model, cfg, lambda s: 1e-3)
        bodies = dict(fa.LAUNCHES_BY_BODY)
        _, metrics = step(state, {"tokens": toks.to(dev)})
        # Each run's tensors stay on its device; the CPU's go to the card
        # once, where the comparisons run.
        res = dict(
            start=begin, loss=metrics["loss"], launches=metrics["flash_launches"],
            bodies={b: fa.LAUNCHES_BY_BODY[b] - bodies[b] for b in fa.BODIES},
            grads={n: p.grad.float() for n, p in model.named_parameters()},
            m=dict(state["opt"]["m"]), v=dict(state["opt"]["v"]),
            params={n: p.detach().float() for n, p in model.named_parameters()},
        )
        del model, state, step
        gc.collect()
        return res

    a = run(cfg32, "cpu", None)
    g = run(cfg32, "cuda", a["start"])
    h = run(cfg16, "cuda", a["start"])
    for key in ("start", "grads", "m", "v", "params"):
        a[key] = {n: t.cuda() for n, t in a[key].items()}
    torch.cuda.empty_cache()

    def rel(x, y):
        return ((x - y).norm() / y.norm().clamp_min(1e-30)).item()

    loss_err = abs(g["loss"] - a["loss"])
    worst = {key: max(rel(g[key][n], a[key][n]) for n in a[key]) for key in ("grads", "m", "v")}
    upd = max(rel(g["params"][n] - a["start"][n], a["params"][n] - a["start"][n]) for n in a["params"])
    bf_loss_err = abs(h["loss"] - a["loss"])
    bf_grads = {n: rel(h["grads"][n], a["grads"][n]) for n in a["grads"]}
    bf_worst = max(bf_grads, key=bf_grads.get)
    log(f"train parity llama3.2-3b width, 2 layers, B=1 seq=256, weights in bf16: fp32 card: loss "
        f"cpu={a['loss']:.6f} cuda={g['loss']:.6f} abs_err={loss_err:.3e} worst_rel grads={worst['grads']:.3e} "
        f"m={worst['m']:.3e} v={worst['v']:.3e} update={upd:.3e}; bf16 card: loss={h['loss']:.6f} "
        f"abs_err={bf_loss_err:.3e} worst_rel grads={bf_grads[bf_worst]:.3e} ({bf_worst}) "
        + " ".join(f"{w}={max(bf_grads[f'blocks.{i}.attn.{w}'] for i in range(cfg32.n_layers)):.3e}"
                   for w in ("wq", "wk", "wv", "wo")))
    n_fa = 2 * cfg32.n_layers
    check(g["launches"] == n_fa and g["bodies"]["fma"] == n_fa, "train parity: 4 flash launches on the fma body (fp32)")
    check(h["launches"] == n_fa and h["bodies"]["wgmma"] == n_fa, "train parity: 4 flash launches on the wgmma body (bf16)")
    check(all(torch.equal(h["start"][n], a["start"][n]) for n in a["start"]),
          "train parity: the bf16 model holds the reference's weights exactly")
    check(loss_err <= 1e-4 * abs(a["loss"]), f"train parity: loss within 1e-4 relative ({g['loss']} vs {a['loss']})")
    for key, tol in (("grads", 1e-3), ("m", 1e-3), ("v", 2e-3)):
        check(worst[key] <= tol, f"train parity: every {key} leaf within {tol} relative norm ({worst[key]:.2e})")
    # The first AdamW step moves each element by ±lr·m̂/√v̂ = ±lr (the sign of
    # its gradient) plus the decay: an element whose gradient is within the
    # two devices' rounding of zero may step the other way, so the updates
    # are held by relative norm (5e-2 admits 0.06 % of the elements flipped).
    check(upd <= 5e-2, f"train parity: every leaf's update within 5e-2 relative norm ({upd:.2e})")
    # bf16 rounds every activation, product and gradient to 8 significant
    # bits, and the step compounds it: a sound run is 7.1e-5 off in the loss
    # and 2.1e-2 in its worst gradient leaf (wk); the tolerances are three
    # times that (PERF.md, the training findings).
    check(bf_loss_err <= BF16_LOSS_TOL * abs(a["loss"]),
          f"train parity bf16: loss within {BF16_LOSS_TOL} relative of fp32 ({h['loss']} vs {a['loss']})")
    check(bf_grads[bf_worst] <= BF16_GRAD_TOL,
          f"train parity bf16: every gradient within {BF16_GRAD_TOL} relative norm of fp32 "
          f"({bf_worst} {bf_grads[bf_worst]:.2e})")
    del a, g, h
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_launcher():
    """(d) The launcher on the card at reduced width: checkpoints every 4
    steps, an injected transient failure, top-k compression, then a resumed
    run."""
    import shutil

    import numpy as np

    from repro_torch.launch import train

    ck = os.path.join(HERE, "build", "chip_smoke", "train_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    common = ["--arch", "llama3.2-3b", "--reduced", "--batch", "4", "--seq", "64", "--lr", "1e-2",
              "--ckpt-dir", ck, "--ckpt-every", "4", "--device", "cuda"]
    info = {}
    losses = train.main(common + ["--steps", "12", "--inject-failure-at", "5",
                                  "--grad-compress", "0.1"], info=info)
    check(len(losses) == 12 and all(np.isfinite(losses)), "train launcher: 12 finite losses")
    check(info["retries"] == 1 and info["restores"] == 0, "train launcher: the injected failure retried once")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]), "train launcher: the loss falls under compression")
    info2 = {}
    resumed = train.main(common + ["--steps", "4", "--resume"], info=info2)
    check(info2["start_step"] == 12 and len(resumed) == 4 and all(np.isfinite(resumed)),
          "train launcher: resumed from step 12, 4 finite losses")
    log(f"train launcher (reduced, card): losses={[round(x, 4) for x in losses]} "
        f"resumed={[round(x, 4) for x in resumed]} retries={info['retries']}")
    shutil.rmtree(ck, ignore_errors=True)


# ----------------------------------------------------------------------------
# Phase 12: the other LM families, served at full width
# ----------------------------------------------------------------------------

# arch, batch, prompt, generated tokens, flash launches per prefill and per
# decode step by body. Whisper's prompt is its decoder context (448); its
# encoder gets prompt // 2 = 224 frames.
FAMILY_RUNS = [
    ("granite-moe-1b-a400m", 4, 2048, 16, {"wgmma": 24}, {}),
    ("internvl2-26b", 4, 2048, 16, {"wgmma": 48}, {}),
    ("zamba2-7b", 4, 2048, 16, {"mma_sync": 13}, {}),
    ("rwkv6-7b", 4, 2048, 16, {}, {}),
    ("whisper-tiny", 8, 448, 16, {"wgmma": 12}, {"wgmma": 4}),
]
# Decode steps under the profiler (the profiler's processing of ~7,000
# kernels' events a zamba2 step, not the steps, sets the session's wall).
FAMILY_PROFILE_STEPS = 2


def phase_families():
    """(a) Each family at full width and depth through ``serve.main`` (bf16,
    random weights from seed 0), its counts zeroed just before and read just
    after: tokens in range, finite logits, the flash launches of each phase
    by body; prefill ms, decode ms per step, peak memory. Then the same
    model again (steady state): one prefill, and decode steps under
    torch.profiler (device busy per step, idle share). Returns the summed
    launch counts of the serve runs."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm

    total = None
    for arch, b, t, n_gen, pre, dec in FAMILY_RUNS:
        cfg = get_config(arch)
        steps = n_gen - 1
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        info = {}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        gen = serve.main(["--arch", arch, "--batch", str(b), "--prompt-len", str(t),
                          "--gen", str(n_gen)], info=info)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        total = counts if total is None else {k: total[k] + counts[k] for k in counts}
        check(gen.shape == (b, n_gen) and (gen >= 0).all() and (gen < cfg.vocab).all(),
              f"families {arch}: ({b}, {n_gen}) tokens in [0, vocab)")
        check(info["logits_finite"], f"families {arch}: prefill and decode logits finite")
        want_pre = {body: pre.get(body, 0) for body in info["prefill_flash_bodies"]}
        want_dec = {body: dec.get(body, 0) * steps for body in info["decode_flash_bodies"]}
        check(info["prefill_flash_bodies"] == want_pre,
              f"families {arch}: flash launches per prefill by body {info['prefill_flash_bodies']} == {want_pre}")
        check(info["decode_flash_bodies"] == want_dec,
              f"families {arch}: flash launches in decode by body {info['decode_flash_bodies']} == {want_dec}")
        check(counts["flash_attention"] == sum(pre.values()) + sum(dec.values()) * steps,
              f"families {arch}: every flash launch of the run counted")
        log(f"families {arch} ({cfg.family}) B={b} prompt={t} gen={n_gen}: "
            f"prefill_ms={info['prefill_s'] * 1e3:.3f} "
            f"prefill_tok_per_s={b * t / info['prefill_s']:.1f} "
            f"decode_ms_per_step={info['decode_s'] / steps * 1e3:.3f} (of {b} tokens) "
            f"decode_tok_per_s={info['decode_tokens'] / info['decode_s']:.1f} "
            f"peak_mem_GiB={info['peak_bytes'] / 2**30:.3f} main_wall_s={wall:.3f} "
            f"flash_prefill={info['prefill_flash_bodies']} flash_decode={info['decode_flash_bodies']}")
        log(f"families {arch} generated[0][:12] = {gen[0, :12].tolist()}")
        del gen, info
        gc.collect()
        torch.cuda.empty_cache()

        # Steady state: the same model again, a second prefill (wall) and
        # decode steps under the profiler.
        model = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        n_params = sum(p.numel() for p in model.parameters())
        prompts, kw, offset = serve.family_inputs(cfg, b, t, np.random.default_rng(0), "cuda")
        cache = lm.init_cache(cfg, b, t + n_gen + FAMILY_PROFILE_STEPS, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.forward_cached(model, cfg, cache, prompts, 0, **kw)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        del logits
        outs, _, cache = serve.decode(model, cfg, cache, tok, offset + t, 2)  # warm decode
        tok = outs[-1]
        torch.cuda.synchronize()
        _, kern, wall_prof = profiled(
            lambda: serve.decode(model, cfg, cache, tok, offset + t + 2, FAMILY_PROFILE_STEPS),
            f"families {arch} decode profile")
        busy_us = sum(e.self_device_time_total for e in kern)
        check(busy_us > 0, f"families {arch}: decode ran on the device (profiler)")
        n = FAMILY_PROFILE_STEPS
        log(f"families {arch} steady: params={n_params} second prefill_ms={t_prefill * 1e3:.3f} "
            f"decode profile: {n} steps, kernels_per_step={sum(e.count for e in kern) / n:.1f} "
            f"device_busy_ms_per_step={busy_us / n / 1e3:.3f} "
            f"wall_ms_per_step={wall_prof / n * 1e3:.3f} (profiled) "
            f"idle_share={1 - busy_us / 1e6 / wall_prof:.3f}")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:4]:
            log(f"families {arch} decode kernel {e.key[:70]}: {e.count / n:.1f} per step, "
                f"{e.self_device_time_total / n:.1f} us per step")
        del model, cache, prompts, kw, tok, outs
        gc.collect()
        torch.cuda.empty_cache()
    return total


# The depth of phases 12 (b), 13 (c), 16 (b) and 17 (c) where it is not 2
# layers (whisper: 2 encoder and 2 decoder layers), cut for the smoke's
# time: internvl and rwkv6 one layer (the CPU's fp32 work grows with their
# 6,144- and 4,096-wide layers; each layer runs the same code); zamba2 3
# with the shared block after the 2nd (one application, then a one-layer
# remainder).
FAMILY_PARITY_CUTS = {"internvl2-26b": dict(n_layers=1), "rwkv6-7b": dict(n_layers=1),
                      "zamba2-7b": dict(n_layers=3, shared_every=2)}


def family_parity_cfg(arch, dtype="float32"):
    """``arch`` at full width cut to 2 layers or its ``FAMILY_PARITY_CUTS``
    (whisper to 2 encoder and 2 decoder layers), in ``dtype``: the depth of
    phases 12 (b), 13 (c), 16 (b) and 17 (c)."""
    import dataclasses

    from repro_torch.configs import get_config

    base = get_config(arch)
    cut = dict(n_layers=2, dtype=dtype)
    if base.family == "encdec":
        cut["n_enc_layers"] = 2
    return dataclasses.replace(base, **(cut | FAMILY_PARITY_CUTS.get(arch, {})))


def family_models(cfg, *copies):
    """``cfg``'s model from seed 0 on the card, then one model per
    ``(device, dtype)`` of ``copies`` holding the same weights (a bf16
    model's weights are exact in fp32; its fp32 leaves are fp32 in both)."""
    import dataclasses

    import torch

    from repro_torch.models import lm

    first = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    out = [first]
    for dev, dtype in copies:
        model = lm.LM(dataclasses.replace(cfg, dtype=dtype), device=dev)
        model.load_state_dict(first.state_dict())
        out.append(model)
    return out


class MoeRoutes:
    """While entered, every ``layers.moe_ffn`` call records its tokens' top-k
    experts (sorted; the router's fp32 softmax, stable-sorted as the layer
    sorts it) in ``routes[key]`` and the first input and output of each key
    in ``inputs[key]`` and ``outputs[key]``, where key is the input's device
    type and, if it is not fp32, its dtype ("cpu", "cuda", "cuda
    bfloat16"). ``first_input`` (an array of the first call's shape), if
    given, replaces the input of the first call."""

    def __init__(self, first_input=None):
        self.routes, self.inputs, self.outputs = {}, {}, {}
        self.first_input = first_input

    @staticmethod
    def key(x):
        import torch

        return x.device.type + ("" if x.dtype == torch.float32 else " " + str(x.dtype).split(".")[1])

    def __enter__(self):
        import torch

        from repro_torch.models import layers

        self.real = real = layers.moe_ffn

        def recording_moe(params, x, **kw):
            if self.first_input is not None:
                x = torch.as_tensor(self.first_input).to(x.device, x.dtype)
                self.first_input = None
            key = self.key(x)
            first = key not in self.inputs
            if first:
                self.inputs[key] = x.detach().float().cpu()
            logits = x.detach().reshape(-1, x.shape[-1]).float() @ params["router"].detach()
            top = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True, stable=True).indices
            self.routes.setdefault(key, []).append(top[:, :kw["top_k"]].sort(-1).values.cpu())
            out = real(params, x, **kw)
            if first:
                self.outputs[key] = out[0].detach().float().cpu()
            return out

        layers.moe_ffn = recording_moe
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers

        layers.moe_ffn = self.real

    def clear(self):
        self.routes.clear()
        self.inputs.clear()
        self.outputs.clear()

    def differing(self, a, b, since=0):
        """(tokens,) bool: the tokens whose top-k experts differ between the
        runs ``a`` and ``b`` (keys) in any MoE call from the ``since``-th on."""
        import torch

        pairs = list(zip(self.routes.get(a, [])[since:], self.routes.get(b, [])[since:]))
        if not pairs:
            return torch.zeros(0, dtype=torch.bool)
        return torch.stack([(ra != rb).any(-1) for ra, rb in pairs]).any(0)


# Phase 12 (b): the card against the port's CPU path, each family at full
# width with a depth cut, fp32 (TF32 off). Tolerance on logits, relative to
# their largest magnitude: three times the largest error of a sound run
# (zamba2-7b's prefill, 8.51e-5 at a logit scale of 5.36 = 1.59e-5, on an
# NVIDIA H100 80GB HBM3 at 700 W; the other families 1.2e-6 to 6.0e-6).
FAMILY_PARITY_TOL = 5e-5
# The MoE's prompt tokens whose top-k experts may differ between the devices
# in some layer: a sound run reads 0 of 128 (same card). Logits are compared
# before the first such token, which must lie in the prompt's second half.
FAMILY_MOE_FLIPS_MAX = 2


def phase_families_parity():
    """(b) Each family at full width, 2 layers (zamba2: 7 with its shared
    block after the 6th, so a remainder layer follows it; whisper: 2 encoder
    and 2 decoder layers), fp32, batch 1, prompt 128 (+ 256 patches; 64
    frames), 4 decode steps, on the card against the CPU from the same
    weights. For the MoE the routes are counted first: logits are compared
    at the prompt positions before the first token whose top-k experts
    differ between the devices in any layer, and decode only while no route
    has differed; at most ``FAMILY_MOE_FLIPS_MAX`` prompt tokens may differ,
    none in the prompt's first half. The first MoE layer's input (the
    attention sublayer's output, normed, which no route can change) is
    compared at every position."""
    import gc

    import numpy as np
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import lm

    b, t, n_dec = 1, 128, 4
    with MoeRoutes() as rec:
        for arch, *_ in FAMILY_RUNS:
            cfg = family_parity_cfg(arch)
            t0 = time.perf_counter()
            gpu_model, cpu_model = family_models(cfg, ("cpu", "float32"))
            prompts, kw, offset = serve.family_inputs(cfg, b, t, np.random.default_rng(1), "cpu")
            caches = [lm.init_cache(cfg, b, t + n_dec, device=d) for d in ("cpu", "cuda")]
            rec.clear()
            a, _ = lm.forward_cached(cpu_model, cfg, caches[0], prompts, 0, **kw)
            g, _ = lm.forward_cached(gpu_model, cfg, caches[1], prompts.cuda(), 0,
                                     **{k: v.cuda() for k, v in kw.items()})
            flipped = rec.differing("cpu", "cuda")
            first = int(flipped.nonzero()[0]) if flipped.any() else t  # b = 1: token = position
            route_note = ""
            if cfg.moe:
                xa, xg = rec.inputs["cpu"], rec.inputs["cuda"]
                x_scale = max(1.0, xa.abs().max().item())
                x_err = (xg - xa).abs().max().item()
                check(x_err <= FAMILY_PARITY_TOL * x_scale,
                      f"families parity {arch}: the first MoE layer's input at all {t} positions "
                      f"within {FAMILY_PARITY_TOL} of its scale ({x_err} at {x_scale:.4f})")
                check(int(flipped.sum()) <= FAMILY_MOE_FLIPS_MAX and first >= t // 2,
                      f"families parity {arch}: {int(flipped.sum())} prompt tokens route differently "
                      f"(at most {FAMILY_MOE_FLIPS_MAX}, the first at {first} >= {t // 2})")
                route_note = (f" first MoE input max_abs_err={x_err} (scale {x_scale:.4f}); routes: "
                              f"{int(flipped.sum())} of {b * t} prompt tokens differ in some layer "
                              f"(logits compared before position {first})")
            scale = max(1.0, a.abs().max().item())
            errs = [(g.cpu() - a)[:, :first].abs().max().item()]
            check(errs[0] <= FAMILY_PARITY_TOL * scale,
                  f"families parity {arch}: prefill logits within {FAMILY_PARITY_TOL} of their scale")
            same = int(torch.equal(a[:, -1].argmax(-1), g[:, -1].cpu().argmax(-1)))
            for i in range(n_dec if first == t else 0):
                tok = a[:, -1:].argmax(-1).to(torch.int32)  # the CPU's token feeds both
                since = len(rec.routes.get("cpu", []))
                a, _ = lm.forward_cached(cpu_model, cfg, caches[0], tok, offset + t + i)
                g, _ = lm.forward_cached(gpu_model, cfg, caches[1], tok.cuda(), offset + t + i)
                if rec.differing("cpu", "cuda", since).any():
                    break
                errs.append((g.cpu() - a).abs().max().item())
                check(errs[-1] <= FAMILY_PARITY_TOL * scale,
                      f"families parity {arch}: decode step {i} logits within {FAMILY_PARITY_TOL} of their scale")
                same += int(torch.equal(a[:, -1].argmax(-1), g[:, -1].cpu().argmax(-1)))
            log(f"families parity {arch} width, {cfg.n_layers} layers, fp32, prompt {t}, {n_dec} "
                f"decode steps: max_abs_err per step={errs} logit scale={scale:.4f} "
                f"(tolerance {FAMILY_PARITY_TOL} x scale) greedy tokens equal {same}/{len(errs)}"
                f"{route_note} wall_s={time.perf_counter() - t0:.1f}")
            del gpu_model, cpu_model, caches, a, g
            gc.collect()
            torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# Phase 13: the other LM families, trained at full width
# ----------------------------------------------------------------------------

# (a) The Function at every shape (b) launches: Zamba2-7B's shared attention
# (Dh 112, the mma_sync body), Granite-MoE's (GQA group 2, Dh 64),
# InternVL2's over 256 patches + 4,096 tokens (GQA group 6, Dh 128), and
# Whisper-tiny's decoder self-attention and cross-attention (448 decoder
# positions over 224 frames, non-causal) on wgmma. Whisper's encoder
# (224 frames over themselves, non-causal) is the cross shape's Tk; phase 5
# holds its forward.
FAMILY_TRAIN_ATTN_SHAPES = [
    ("zamba2 Dh=112", (1, 32, 32, TRAIN_SEQ, TRAIN_SEQ, 112), True),
    ("granite", (1, 16, 8, TRAIN_SEQ, TRAIN_SEQ, 64), True),
    ("internvl", (1, 48, 8, TRAIN_SEQ + 256, TRAIN_SEQ + 256, 128), True),
    ("whisper self", (8, 6, 6, 448, 448, 64), True),
    ("whisper cross", (8, 6, 6, 448, 224, 64), False),
]
# (b) arch, batch, seq, depth cut (None: full depth through launch.train.main;
# else build_state + make_step on dataclasses.replace(cfg, **cut)), steps,
# peak learning rate (the launcher's schedule: linear warm-up over a tenth
# of the steps, at least one, then a cosine to 0), flash launches per step
# by body, attention backward calls per step. The cuts keep each model at
# <= 3.6 B parameters: AdamW's fp32 moments and the fp32 residual take 12 B
# a parameter beside 2 each for the bf16 weights and gradients, and
# Llama-3.2-3B's 3.21 B peaked at 52.4 GiB in phase 11. Internvl keeps 3
# layers, zamba2 2 applications of its shared block and a 1-layer
# remainder, rwkv6 4 layers (cut for the smoke's time: each layer runs the
# same code, and phase 17 trains each family again). The peak rates
# of the cut runs come from a sweep under this schedule over 6 steps (NVIDIA
# H100 80GB HBM3 at 700 W; internvl, zamba2 and rwkv6 then at 6, 39 and 12
# layers): at 1e-3 internvl's loss climbed 11.94 -> 12.48
# before it fell and rwkv6's wandered, so both take 3e-4 (falls of 0.96 and
# 0.71); zamba2's moves slowly at any rate (3e-4 rose 0.016, 1e-3 fell
# 0.026, 3e-3 fell 0.074), so it takes 3e-3. Granite's bf16 routes, and so
# its losses, differ from run to run: at 1e-3 it fell by 0.002-0.05 over 6
# steps and 0.004-0.05 over 10, at 2e-3 by 0.45-0.59 over 10, so it takes
# 2e-3 and 10 steps. Each family's bf16 step is held to fp32 in (c) and to
# the JAX package's bf16 step in the CPU tests.
FAMILY_TRAIN_RUNS = [
    ("granite-moe-1b-a400m", 1, TRAIN_SEQ, None, 10, 2e-3, {"wgmma": 48}, 24),
    ("whisper-tiny", 8, 448, None, 6, 1e-3, {"wgmma": 24}, 12),
    ("internvl2-26b", 1, TRAIN_SEQ, dict(n_layers=3), 6, 3e-4, {"wgmma": 6}, 3),
    ("zamba2-7b", 1, TRAIN_SEQ, dict(n_layers=13), 6, 3e-3, {"mma_sync": 2}, 2),
    ("rwkv6-7b", 1, TRAIN_SEQ, dict(n_layers=4), 6, 3e-4, {}, 0),
]


def family_train_flops(cfg, numels, b, s):
    """Model FLOPs of one training step of ``cfg`` at batch ``b``, ``s``
    tokens: 8 per parameter and position it acts on (forward 2, its remat
    2, backward 4; 6 for the hybrid's shared block, which is not
    rematerialised, once per application), MoE experts at top_k / n_experts
    of theirs, the embedding only where it is the head; the encoder and the
    cross K/V projections at the frames (s // 2), the vlm's blocks at patches
    + tokens and ``vit_proj`` at the patches. Plus 4 × the attention
    forward's operations (3 × for the shared block). The SSM scans are not
    counted."""
    se, p = s // 2, cfg.vlm_patches
    n_apps = cfg.n_layers // cfg.shared_every
    total = 0.0
    for name, k in numels.items():
        if name == "embed" and not cfg.tie_embeddings:
            continue
        per, pos = 8, b * s
        if cfg.moe and ".moe.w_" in name:
            k = k * cfg.moe.top_k / cfg.moe.n_experts
        if name.startswith("enc_blocks.") or ".xattn.wk" in name or ".xattn.wv" in name:
            pos = b * se
        elif name == "vit_proj":
            pos = b * p
        elif cfg.family == "vlm" and name.startswith("blocks."):
            pos = b * (s + p)
        elif name.startswith("shared."):
            per, pos = 6, b * s * n_apps
        total += per * k * pos

    def attn(tq, tk, causal):
        return fa_work(b, cfg.n_heads, cfg.n_kv, tq, tk, cfg.d_head, 2, causal)[1]

    fam, n = cfg.family, cfg.n_layers
    if fam in ("dense", "moe"):
        total += 4 * n * attn(s, s, True)
    elif fam == "vlm":
        total += 4 * n * attn(s + p, s + p, True)
    elif fam == "encdec":
        total += 4 * cfg.n_enc_layers * attn(se, se, False)
        total += 4 * n * (attn(s, s, True) + attn(s, se, False))
    elif fam == "hybrid":
        total += 3 * n_apps * attn(s, s, True)
    return total


def phase_family_train():
    """(b) Each family trained at full width in bf16 (random weights from
    seed 0): granite and whisper at full depth through
    ``launch.train.main``, internvl, zamba2 and rwkv6 cut in depth through
    ``build_state`` + ``make_step`` under the launcher's schedule (the
    launcher has no depth option),
    counts zeroed just before each run and read just after: the flash
    launches per step by body and the attention backward calls, every
    parameter's gradient at the first step finite and non-zero (the patch
    projection, the encoder, the shared block and the fp32 leaves
    included), granite's MoE aux finite and positive, the last loss below
    the first; step wall, tokens/s, the share of the bf16 peak, peak
    memory. Returns the summed launch counts of the runs."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import cosine_schedule

    total = None
    for arch, b, s, cut, n_steps, lr, bodies, n_bwd in FAMILY_TRAIN_RUNS:
        cfg = get_config(arch) if cut is None else dataclasses.replace(get_config(arch), **cut)
        # The parameters' sizes and dtypes, from an uninitialised host model.
        shapes = lm.LM(cfg, device="cpu")
        numels = {n: p.numel() for n, p in shapes.named_parameters()}
        fp32 = [n for n, p in shapes.named_parameters() if p.dtype == torch.float32]
        del shapes
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if cut is None:
            info = {}
            train.main(["--arch", arch, "--batch", str(b), "--seq", str(s), "--steps",
                        str(n_steps), "--lr", str(lr), "--device", "cuda"], info=info)
        else:
            model, state = train.build_state(cfg, torch.device("cuda"), seed=0)
            step = train.make_step(model, cfg, cosine_schedule(lr, max(n_steps // 10, 1), n_steps))
            data = SyntheticTokens(cfg, ShapeConfig("cli", s, b, "train"), seed=0)
            hist, flags = [], None
            for i in range(n_steps):
                batch = {k: torch.as_tensor(v).cuda() for k, v in data.batch_at(i).items()}
                t1 = time.perf_counter()
                state, m = step(state, batch)
                m["step_time_s"] = time.perf_counter() - t1
                hist.append(m)
                if flags is None:
                    flags = train._grad_flags(state["params"])
            info = dict(train.history_info(hist), grad_flags=flags,
                        peak_bytes=torch.cuda.max_memory_allocated())
            del model, state, step, batch
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        total = counts if total is None else {k: total[k] + counts[k] for k in counts}
        losses = info["losses"]
        per_step = sum(bodies.values())
        want_bodies = {body: bodies.get(body, 0) for body in fa.BODIES}
        tag = f"family train {arch}" + ("" if cut is None else f" ({cfg.n_layers} layers)")
        check(len(losses) == n_steps and all(np.isfinite(losses)), f"{tag}: {n_steps} finite losses")
        check(losses[-1] < losses[0], f"{tag}: the last loss below the first ({losses[0]:.4f} -> {losses[-1]:.4f})")
        check(info["flash_bodies"] == [want_bodies] * n_steps,
              f"{tag}: flash launches per step by body {info['flash_bodies'][0]} == {want_bodies}")
        check(info["flash_launches"] == [per_step] * n_steps and counts["flash_attention"] == per_step * n_steps,
              f"{tag}: {per_step} flash launches per step, every one counted")
        check(info["attn_backward_calls"] == [n_bwd] * n_steps, f"{tag}: {n_bwd} attention backward calls per step")
        flags = info["grad_flags"]
        bad = [n for n, (finite, nonzero) in flags.items() if not (finite and nonzero)]
        check(set(flags) == set(numels) and not bad,
              f"{tag}: every parameter's gradient at step 0 finite and non-zero, the "
              f"{len(fp32)} fp32 leaves included ({bad[:6]})")
        if cfg.moe:
            check(all(np.isfinite(a) and a > 0 for a in info["moe_aux"]),
                  f"{tag}: moe_aux finite and positive at every step ({info['moe_aux']})")
        n_params = sum(numels.values())
        step_s = float(np.median(info["step_s"][1:]))  # the first step pays the warm-up
        flops = family_train_flops(cfg, numels, b, s)
        log(f"{tag} B={b} seq={s} steps={n_steps} lr={lr}: losses={[round(x, 4) for x in losses]} "
            f"moe_aux={[round(x, 4) for x in info['moe_aux']]}")
        log(f"{tag} step_s={[round(x, 4) for x in info['step_s']]} median_step_ms={step_s * 1e3:.3f} "
            f"(steps 1-{n_steps - 1}) tok_per_s={b * s / step_s:.1f} model_flops={flops:.4e} "
            f"(family_train_flops; N={n_params}) bf16_peak_share={flops / step_s / BF16_OPS_PER_S:.4f} "
            f"peak_mem_GiB={info['peak_bytes'] / 2**30:.3f} wall_s={wall:.3f} "
            f"flash_per_step={info['flash_bodies'][0]} attn_backward_per_step={n_bwd} "
            f"fp32_leaves={len(fp32)}")
        del info, flags
        gc.collect()
        torch.cuda.empty_cache()
    return total


# Phase 13 (c): one step of each family cut to 2 full-width layers, on the
# card in fp32 (TF32 off) and in bf16, against the CPU's fp32 from the same
# weights. fp32 tolerances: the loss and the MoE aux within 1e-5 relative (a
# sound run: at most 1.8e-7, granite's aux), every gradient leaf within 1e-4
# relative norm, three times the worst leaf of a sound run from fp32
# weights (zamba2's Mamba-2 dt_bias, 3.24e-5; the others <= 8.1e-6) and 2.3
# times that from these bf16-valued ones (4.37e-5; the others <= 8.2e-6) on
# an NVIDIA H100 80GB HBM3 at 700 W. Both are tighter than phase 11 (c)'s
# 1e-4 / 1e-3 for Llama-3.2-3B's layers.
FAMILY_TRAIN_LOSS_TOL = 1e-5
FAMILY_TRAIN_GRAD_TOL = 1e-4
# bf16 against the CPU's fp32, by family: (loss, MoE aux, both relative;
# the worst gradient leaf, relative norm), three times a sound run's errors
# on an NVIDIA H100 80GB HBM3 at 700 W. Internvl (3.2e-5, 2.14e-2), rwkv6
# (4.4e-5, 2.31e-2) and whisper (1.6e-5, 2.21e-2) sit where Llama's layers
# do (phase 11 c). Granite (3.4e-4, aux 1.17e-3, 0.255 on a router: 16 of
# 128 tokens route differently in bf16) and zamba2 (7.9e-4, 0.174 on a
# Mamba-2 dt_bias, a sum of cancelling terms) are far from fp32 by nature:
# the JAX package's own bf16 step is as far from its fp32 one, and
# tests/test_torch_train_families.py holds each family's bf16 step to
# JAX's, leaf by leaf.
FAMILY_BF16_TOL = {
    "granite-moe-1b-a400m": (1e-3, 3.5e-3, 0.8),
    "internvl2-26b": (BF16_LOSS_TOL, None, 7e-2),
    "zamba2-7b": (2.5e-3, None, 0.55),
    "rwkv6-7b": (BF16_LOSS_TOL, None, 7e-2),
    "whisper-tiny": (BF16_LOSS_TOL, None, 7e-2),
}


def phase_family_train_parity():
    """(c) Each family at full width cut in depth (``family_parity_cfg``),
    batch 1, seq 128 (+ 256 patches; 64 frames, from ``SyntheticTokens``),
    from the same weights (seed 0 drawn in bf16, which fp32 holds exactly):
    ``loss_fn`` + ``backward()`` on the CPU in fp32 (what the step runs
    before its AdamW, which is family-agnostic and phase 11 (c) holds), and
    one ``make_step`` on the card in fp32 (the fma body) and in bf16 (the
    body the full-width run launches). fp32: the MoE's tokens routed
    differently are counted first (a route that differs changes every
    gradient, so none may), then the loss, the MoE aux and every gradient
    leaf. bf16: the same, at bf16's tolerances, so that a fault of a
    family's bf16 path shows; its routes differ from fp32's where bf16
    rounding moves a token across an expert's boundary, and are counted.
    Each family is freed before the next."""
    import gc

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init

    b, s = 1, 128
    with MoeRoutes() as rec:
        for arch, *_ in FAMILY_RUNS:
            cfgs = {"cpu": family_parity_cfg(arch), "cuda": family_parity_cfg(arch),
                    "cuda bfloat16": family_parity_cfg(arch, "bfloat16")}
            cfg = cfgs["cpu"]
            t0 = time.perf_counter()
            batch = SyntheticTokens(cfg, ShapeConfig("cli", s, b, "train"), seed=1).batch_at(0)
            models = dict(zip(("cuda bfloat16", "cpu", "cuda"), family_models(
                cfgs["cuda bfloat16"], ("cpu", "float32"), ("cuda", "float32"))))
            rec.clear()
            res, walls = {}, {}
            for key in ("cpu", "cuda", "cuda bfloat16"):
                model, dev = models.pop(key), key.split()[0]
                model.requires_grad_(True)
                params = dict(model.named_parameters())
                t1 = time.perf_counter()
                if dev == "cpu":
                    loss, aux = lm.loss_fn(model, cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
                    loss.backward()
                    metrics = {k: v.item() for k, v in dict(aux, loss=loss).items()}
                    del loss, aux
                else:
                    state = dict(params=params, opt=adamw_init(params), residual={})
                    _, metrics = train.make_step(model, cfgs[key], lambda _: 1e-3)(
                        state, {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
                    del state
                walls[key] = time.perf_counter() - t1
                # Each run's gradients stay on its device; the CPU's go to
                # the card once, where the comparisons run.
                res[key] = dict(metrics=metrics, grads={n: p.grad.float() for n, p in params.items()})
                del params, model
                gc.collect()
                torch.cuda.empty_cache()
            a = res.pop("cpu")
            a["grads"] = {n: y.cuda() for n, y in a["grads"].items()}
            launches, n_bwd = lm.attention_calls(cfg)
            notes = []
            tols = {"cuda": (FAMILY_TRAIN_LOSS_TOL, FAMILY_TRAIN_LOSS_TOL, FAMILY_TRAIN_GRAD_TOL),
                    "cuda bfloat16": FAMILY_BF16_TOL[arch]}
            for key, (loss_tol, aux_tol, grad_tol) in tols.items():
                g = res.pop(key)
                body = fa.body_for(torch.bfloat16 if key.endswith("bfloat16") else torch.float32, cfg.d_head)
                tag = f"family train parity {arch} ({cfg.n_layers} layers, {key} vs cpu fp32)"
                note = ""
                if cfg.moe:
                    flipped = rec.differing("cpu", key)
                    check(len(rec.routes["cpu"]) == len(rec.routes[key]) > 0, f"{tag}: the MoE ran on both")
                    if key == "cuda":
                        check(not flipped.any(), f"{tag}: {int(flipped.sum())} of {b * s} tokens route "
                              f"differently in some layer (none may: a sound run reads 0)")
                    note = f" routes: {int(flipped.sum())} of {b * s} tokens differ;"
                am, gm = a["metrics"], g["metrics"]
                check(gm["flash_bodies"][body] == gm["flash_launches"] == launches
                      and gm["attn_backward_calls"] == n_bwd,
                      f"{tag}: {launches} flash launches on the {body} body, {n_bwd} backward calls")
                loss_err = abs(gm["loss"] - am["loss"]) / abs(am["loss"])
                aux_err = abs(gm["moe_aux"] - am["moe_aux"]) / max(abs(am["moe_aux"]), 1e-30)
                rels = {n: ((g["grads"][n] - y).norm() / y.norm().clamp_min(1e-30)).item()
                        for n, y in a["grads"].items()}
                worst = max(rels, key=rels.get)
                check(loss_err <= loss_tol,
                      f"{tag}: loss within {loss_tol} relative ({gm['loss']} vs {am['loss']})")
                if cfg.moe:
                    check(am["moe_aux"] > 0 and aux_err <= aux_tol,
                          f"{tag}: moe_aux within {aux_tol} relative ({gm['moe_aux']} vs {am['moe_aux']})")
                check(rels[worst] <= grad_tol,
                      f"{tag}: every gradient leaf within {grad_tol} relative norm ({worst} {rels[worst]:.2e})")
                top = sorted(rels, key=rels.get, reverse=True)[:3]
                notes.append(f"{key}: loss={gm['loss']:.6f} rel_err={loss_err:.3e} moe_aux rel_err="
                             f"{aux_err:.3e};{note} worst grad rel_norm "
                             + ", ".join(f"{n} {rels[n]:.3e}" for n in top) + f"; step={walls[key]:.1f}s")
            check(all(y.abs().max() > 0 for y in a["grads"].values()),
                  f"family train parity {arch}: every CPU gradient non-zero")
            log(f"family train parity {arch} ({cfg.n_layers} layers), B={b} seq={s}: loss cpu fp32="
                f"{a['metrics']['loss']:.6f} over {len(a['grads'])} leaves; " + "; ".join(notes)
                + f"; wall cpu loss+backward={walls['cpu']:.1f}s total {time.perf_counter() - t0:.1f}s")
            del a, res
            gc.collect()
            torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# Phase 14: tensor-parallel serving, two ranks on one card
# ----------------------------------------------------------------------------

TP_BATCH, TP_PROMPT, TP_GEN = 4, 512, 8
TP_ARGS = ["--batch", str(TP_BATCH), "--prompt-len", str(TP_PROMPT), "--gen", str(TP_GEN)]
TP_RUNS = ["llama3.2-3b", "granite-moe-1b-a400m"]
# bf16 logits of the tp 2 run against tp 1's, relative to their largest
# magnitude, while both runs have taken the same tokens. The row-split
# products are summed in fp32 and cast once, but the column-split GEMMs
# and the one-device bf16 GEMMs round their fp32 sums in other orders, so
# hidden states differ by a bf16 rounding here and there, layer after
# layer; the decode merge casts each slice's own softmax to bf16 (JAX's
# rounding, per slice). Readings (tools/tp_readings.py, llama3.2-3b at
# prompt 512, NVIDIA H100 80GB HBM3 at 700 W): a sound run 0.0208-0.0210 of
# the scale at its worst step; bf16 partial sums (GSPMD's rounding) 0.0225;
# decode's merge without its rescale 0.359, and tokens changed where tp 1's
# logits lay 0.34 and 0.75 apart. The tolerance sits 2.9 times above the
# first and 6 times below the last. A greedy token may differ only where
# tp 1's two logits lie within the same tolerance, and a row is compared no
# further after it.
TP_LOGIT_TOL = 6e-2
# The MoE (granite: 32 experts, top 8, random weights) routes chaotically
# in bf16: a change of one bf16 ulp in a few of a layer's inputs flips a few
# routes, a flipped route changes that token's output by its whole scale,
# and attention spreads it to the later tokens, layer after layer. So the
# experts are checked where the routes are still equal: the first MoE
# layer's input (the attention sublayer's output, normed) within
# TP_MOE_INPUT_TOL of its scale at every position, at most
# TP_ROUTE_FLIP_MAX of the tokens routed differently there, and its output
# (the experts' combine, all-reduced over the ranks) within
# TP_MOE_OUTPUT_TOL of its scale on the tokens before the first one routed
# differently (all of them in a sound run). The later
# layers' flips are held to a floor measured in the same run: tp 1 fed tp
# 2's first MoE input, which differs from tp 1's only by the roundings
# there, flips routes in the later layers by itself. tp 2 may flip at most
# TP_FLIPS_OVER_FLOOR more of the prefill's (layer, token) decisions than
# that floor, and at most TP_SECOND_LAYER_FLIPS of the tokens at the second
# MoE layer, the first whose input went through the experts. Logits are
# compared only on rows whose prompt routes equal tp 1's in every layer.
# Readings (tools/tp_readings.py, NVIDIA H100 80GB HBM3 at 700 W): a sound
# run's output lies 0.0038 of its scale from tp 1's (one bf16 ulp at 64),
# flips 0.0049 of the tokens at the second layer and 0.355 of the
# decisions against the floor's 0.357; with the combine's all-reduce
# dropped, or each rank on the other's capacity rows, the output is 0.98
# and 1.48 of its scale off and 0.98-1.0 of the tokens flip at the second
# layer, 0.96 of the decisions in all.
TP_MOE_INPUT_TOL = 2e-2
TP_ROUTE_FLIP_MAX = 0.02
TP_MOE_OUTPUT_TOL = 2e-2
TP_FLIPS_OVER_FLOOR = 0.10
TP_SECOND_LAYER_FLIPS = 0.05
TP_TIMEOUT = 240.0


def tp_dir() -> str:
    path = os.path.join(HERE, "build", "chip_smoke", "tp")
    os.makedirs(path, exist_ok=True)
    return path


def tp_store(name: str) -> str:
    path = os.path.join(tp_dir(), name)
    if os.path.exists(path):
        os.remove(path)
    return path


class FlashShapes:
    """While entered, records each ``ops.flash_attention`` call's (q shape,
    k shape) — the shapes the wrapper launches the kernel at — in
    ``shapes``, and in ``keys`` with its dtype's name and ``causal``."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self.shapes, self.keys, self.real = [], [], ops.flash_attention

        def recording(q, k, v, **kw):
            self.shapes.append((tuple(q.shape), tuple(k.shape)))
            self.keys.append((tuple(q.shape), tuple(k.shape), str(q.dtype).split(".")[1],
                              kw.get("causal", True)))
            return self.real(q, k, v, **kw)

        ops.flash_attention = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.flash_attention = self.real


def tp_serve(argvs, first_input=None, cfgs=None):
    """Run ``serve.main`` on each argv in this process with its counts
    zeroed just before and read just after; returns per run (tokens, info,
    each step's logits, flash shapes, MoE routes: a list of (tokens, k)
    int16 arrays, one per MoE call, or None). ``info`` holds an MoE's first
    input and output (``moe_input``, ``moe_output``); ``first_input``
    replaces that input (``MoeRoutes``). ``cfgs``, a config (or None) per
    argv, is served in place of the argv's ``--arch`` (a depth cut)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    out = []
    for argv, cfg in zip(argvs, cfgs or [None] * len(argvs)):
        info = {}
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with FlashShapes() as fl, MoeRoutes(first_input) as rec:
            ops.reset_launch_counts()
            gen = serve.main(argv, info=info, keep_logits=True, cfg=cfg)
            info["counts"] = ops.launch_counts()
        info["peak_bytes"] -= base  # what the run itself held at its peak
        routes = next(iter(rec.routes.values()), None)
        if routes is not None:
            info["moe_input"] = next(iter(rec.inputs.values())).numpy()
            info["moe_output"] = next(iter(rec.outputs.values())).numpy()
        out.append((gen, info, info.pop("logits"), sorted(set(fl.shapes)),
                    None if routes is None else [r.numpy().astype(np.int16) for r in routes]))
        torch.cuda.empty_cache()
    return out


def tp_rank(rank, argvs, cfgs=None):
    """One rank of phases 14 and 16 (a spawned process): ``tp_serve``, TF32
    off as in the smoke's own process. One small product of each kind the
    runs make comes first, so that cuBLAS's workspaces exist before a run
    reads its base memory, as they do in the smoke's own process (a fresh
    process allocates them at its first product, tens of MB: more than
    whisper-tiny's split layers save a rank)."""
    sys.path.insert(0, SRC)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.ones((64, 64), device="cuda", dtype=torch.bfloat16)
    _ = (a @ a, torch.mm(a, a, out_dtype=torch.float32), a.float() @ a.float(),
         torch.bmm(a[None], a[None]))
    torch.cuda.synchronize()
    del a, _
    return tp_serve(argvs, cfgs=cfgs)


def route_flips(routes1, routes2, b):
    """(share of tokens whose top-k differ at the first MoE layer, share of
    the prefill's (layer, token) decisions that differ, per-call (tokens,)
    differ flags, the prefill's MoE call count)."""
    import numpy as np

    n_layers = sum(r.shape[0] > b for r in routes1)  # the prefill's calls, (B·T, k) each
    differs = [(r1 != r2).any(-1) for r1, r2 in zip(routes1, routes2)]
    return (float(differs[0].mean()), float(np.stack(differs[:n_layers]).mean()), differs,
            n_layers)


def tp_diff(want, got):
    """How far a run's logits, tokens and MoE routes lie from another's
    (``want``), as ``tp_compare`` holds them: a row whose prompt routes
    differ in any layer is not compared; a row is compared no further after
    its token differs (that step's tp 1 logit gap is kept) or its decode
    routes differ."""
    import numpy as np

    gen1, info1, logits1, _, routes1 = want
    gen2, info2, logits2, _, routes2 = got
    b = gen1.shape[0]
    d = dict(scale=max(1.0, float(np.abs(logits1[0]).max())), errs=[], rows=[], ties=[],
             equal=bool((gen1 == gen2).all()))
    live = np.ones(b, bool)
    n_layers, differs = 0, []
    if routes1 is not None:
        d["calls"] = (len(routes1), len(routes2))
        d["first"], d["flips"], differs, n_layers = route_flips(routes1, routes2, b)
        d["by_layer"] = [round(float(x.mean()), 4) for x in differs[:n_layers]]
        x1, x2 = info1["moe_input"], info2["moe_input"]
        d["x_scale"] = max(1.0, float(np.abs(x1).max()))
        d["x_err"] = float(np.abs(x2 - x1).max())
        d["x_differ"] = (int((x2 != x1).sum()), x1.size)
        # A token keeps its capacity slots (so its drops) while every token
        # before it routes alike: the expert queues fill in token order.
        y1, y2 = info1["moe_output"], info2["moe_output"]
        upto = int(np.argmax(differs[0])) if differs[0].any() else differs[0].size
        alike = (np.arange(differs[0].size) < upto).reshape(y1.shape[:-1])
        d["y_scale"] = max(1.0, float(np.abs(y1).max()))
        d["y_err"] = float(np.abs(y2 - y1)[alike].max()) if alike.any() else float("inf")
        live &= ~np.stack(differs[:n_layers]).any(0).reshape(b, -1).any(1)
    for i, (l1, l2) in enumerate(zip(logits1, logits2)):
        if i and differs:  # decode step i - 1's routes
            live &= ~np.stack(differs[n_layers * i:n_layers * (i + 1)]).any(0)
        if not live.any():
            break
        d["errs"].append(float(np.abs(l2[live] - l1[live]).max()))
        d["rows"].append(int(live.sum()))
        for r in np.nonzero(live & (gen1[:, i] != gen2[:, i]))[0]:
            d["ties"].append(abs(float(l1[r, gen1[r, i]] - l1[r, gen2[r, i]])))
            live[r] = False
    return d


def tp_diff_line(d) -> str:
    line = (f"logits max_abs_err per step={[round(e, 5) for e in d['errs']]} (scale "
            f"{d['scale']:.3f}) rows compared per step={d['rows']} tokens changed at tp 1 logit "
            f"gaps={d['ties']} tokens equal={int(d['equal'])}")
    if "first" in d:
        line += (f" first MoE layer: input max_abs_err={d['x_err']:.5f} (scale {d['x_scale']:.3f}; "
                 f"{d['x_differ'][0]} of {d['x_differ'][1]} elements differ), {d['first']:.5f} of "
                 f"tokens route differently, output max_abs_err before the first token routed "
                 f"differently="
                 f"{d['y_err']:.5f} (scale {d['y_scale']:.3f}); prefill decisions differing over "
                 f"all layers={d['flips']:.5f}, by layer={d['by_layer']}")
    return line


def tp_compare(arch, want, got, what, floor=None, tol=TP_LOGIT_TOL):
    """Holds a run's logits and tokens to tp 1's (``want``, ``tp_diff``):
    the MoE's first layer's input, routes and output within
    ``TP_MOE_INPUT_TOL``, ``TP_ROUTE_FLIP_MAX`` and ``TP_MOE_OUTPUT_TOL``,
    its later layers' flips within ``TP_SECOND_LAYER_FLIPS`` and
    ``TP_FLIPS_OVER_FLOOR`` of the ``floor`` run's (``tp_diff`` of tp 1 fed
    this run's first MoE input); every step's logits on the rows compared
    within ``tol`` (``TP_LOGIT_TOL``) of their scale (every step, without an
    MoE); a token that differs only at a near tie of tp 1's logits (within
    the same tolerance). Logs the numbers before it checks them."""
    d = tp_diff(want, got)
    log(f"tp {what} {arch} vs tp 1 (tolerance {tol:.4f} x scale): {tp_diff_line(d)}")
    if "first" in d:
        check(d["calls"][0] == d["calls"][1], f"tp {what} {arch}: as many MoE calls as tp 1")
        check(d["x_err"] <= TP_MOE_INPUT_TOL * d["x_scale"],
              f"tp {what} {arch}: the first MoE layer's input within {TP_MOE_INPUT_TOL} of its scale")
        check(d["first"] <= TP_ROUTE_FLIP_MAX,
              f"tp {what} {arch}: at most {TP_ROUTE_FLIP_MAX} of the tokens route differently "
              "at the first MoE layer")
        check(d["y_err"] <= TP_MOE_OUTPUT_TOL * d["y_scale"],
              f"tp {what} {arch}: the first MoE layer's output within {TP_MOE_OUTPUT_TOL} of its "
              "scale before the first token routed differently")
        check(len(d["by_layer"]) > 1 and d["by_layer"][1] <= TP_SECOND_LAYER_FLIPS,
              f"tp {what} {arch}: at most {TP_SECOND_LAYER_FLIPS} of the tokens route differently "
              "at the second MoE layer")
        check(d["flips"] <= floor["flips"] + TP_FLIPS_OVER_FLOOR,
              f"tp {what} {arch}: prefill decisions differing {d['flips']:.4f} within "
              f"{TP_FLIPS_OVER_FLOOR} of the floor's {floor['flips']:.4f}")
    else:
        check(len(d["errs"]) == len(want[2]), f"tp {what} {arch}: every step compared")
    check(all(e <= tol * d["scale"] for e in d["errs"]),
          f"tp {what} {arch}: logits within {tol:.4f} of their scale")
    check(all(g <= tol * d["scale"] for g in d["ties"]),
          f"tp {what} {arch}: a token differs only at a near tie")


def phase_tp():
    """(a) llama3.2-3b and granite-moe-1b-a400m at full width (bf16) served
    at tp 1 in this process, then by ``launch.serve --tp 2`` as two gloo
    ranks on cuda:0 (spawned; a file store; joined with a timeout): logits
    and tokens against tp 1's (``tp_compare``; granite's later routes
    against tp 1 fed tp 2's first MoE input, run after), every prefill's
    ``flash_attention`` launches on the ``wgmma`` body at the rank's local
    head counts, each rank's peak memory below tp 1's; (b) llama at world 1
    over NCCL through the distributed path: tokens and every step's logits
    bit-equal to tp 1's; (c) with two cards, llama at tp 2 over NCCL on
    cuda:0-1: (a)'s tokens. Returns the ranks' launch counts (both ranks,
    every run of (a)-(c)) and (a)'s infos, arch -> [rank 0's, rank 1's]
    (phase 18 reads their collectives)."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshes

    import numpy as np

    base = {arch: ["--arch", arch] + TP_ARGS for arch in TP_RUNS}
    steps = TP_GEN - 1
    t0 = time.perf_counter()
    ref = dict(zip(TP_RUNS, tp_serve([base[a] for a in TP_RUNS])))
    log(f"tp phase: tp 1 runs {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # (b)'s one NCCL rank runs beside (a)'s two gloo ranks (its process
    # start overlaps theirs); its check is bit-equality, which sharing the
    # card cannot move.
    arch_b = TP_RUNS[0]
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    t0_b = time.perf_counter()
    future_b = pool.submit(meshes.spawn, tp_rank, 1,
                           ([base[arch_b] + ["--dist-backend", "nccl", "--dist-init",
                                             f"file://{tp_store('nccl-1')}"]],),
                           timeout=TP_TIMEOUT)
    t0 = time.perf_counter()
    argvs = [base[a] + ["--tp", "2", "--dist-backend", "gloo",
                        "--dist-init", f"file://{tp_store('gloo-' + a)}"] for a in TP_RUNS]
    ranks = meshes.spawn(tp_rank, 2, (argvs,), timeout=TP_TIMEOUT)
    log(f"tp phase: (a) two gloo ranks on cuda:0, {time.perf_counter() - t0:.1f}s (spawn included)")
    for i, arch in enumerate(TP_RUNS):
        cfg = get_config(arch)
        want = ref[arch]
        floor = None
        if want[4] is not None:  # the MoE's floor: tp 1 fed tp 2's first MoE input
            t1 = time.perf_counter()
            (fed,) = tp_serve([base[arch]], first_input=ranks[0][i][1]["moe_input"])
            floor = tp_diff(want, fed)
            log(f"tp (a) {arch} floor, tp 1 fed tp 2's first MoE layer input "
                f"({time.perf_counter() - t1:.1f}s): {tp_diff_line(floor)}")
            del fed
        h, kv, _ = cfg.padded_heads(2)
        for r, runs in enumerate(ranks):
            got = runs[i]
            gen, info = got[0], got[1]
            add(info["counts"])
            check(gen.shape == want[0].shape, f"tp (a) {arch} rank {r}: ({gen.shape}) tokens")
            check(info["prefill_flash_bodies"].get("wgmma", 0) == cfg.n_layers
                  and sum(info["prefill_flash_bodies"].values()) == cfg.n_layers,
                  f"tp (a) {arch} rank {r}: {cfg.n_layers} prefill flash launches, all wgmma")
            check(sum(info["decode_flash_bodies"].values()) == 0,
                  f"tp (a) {arch} rank {r}: no flash launch in decode")
            b, t = TP_BATCH, TP_PROMPT
            local = ((b, h // 2, t, cfg.d_head), (b, kv // 2, t, cfg.d_head))
            check(got[3] == [local], f"tp (a) {arch} rank {r}: flash at the local heads {got[3]} == {[local]}")
            check(info["peak_bytes"] < want[1]["peak_bytes"],
                  f"tp (a) {arch} rank {r}: peak memory {info['peak_bytes'] / 2**30:.3f} GiB below "
                  f"tp 1's {want[1]['peak_bytes'] / 2**30:.3f}")
            tp_compare(arch, want, got, f"(a) rank {r}", floor)
            if r == 0:
                dec = info["decode_collectives"]
                per_step = {op: [n / steps, nbytes / steps] for op, (n, nbytes) in dec.items()}
                log(f"tp (a) {arch} tp=2 gloo B={b} prompt={t} gen={steps + 1}: "
                    f"prefill_ms={info['prefill_s'] * 1e3:.3f} (tp 1: {want[1]['prefill_s'] * 1e3:.3f}) "
                    f"decode_ms_per_step={info['decode_s'] / steps * 1e3:.3f} "
                    f"(tp 1: {want[1]['decode_s'] / steps * 1e3:.3f}) "
                    f"peak_GiB per rank={[round(x / 2**30, 3) for x in info['peak_bytes_per_rank']]} "
                    f"(tp 1: {want[1]['peak_bytes'] / 2**30:.3f}) flash shapes={got[3]}")
                log(f"tp (a) {arch} collectives per decode step (count, bytes per rank): "
                    + ", ".join(f"{op} {n:.0f} {nb:.0f}" for op, (n, nb) in sorted(per_step.items()))
                    + "; prefill: " + ", ".join(f"{op} {n} {nb}" for op, (n, nb)
                                                in sorted(info["prefill_collectives"].items())))
        check(np.array_equal(ranks[0][i][0], ranks[1][i][0]), f"tp (a) {arch}: both ranks' tokens equal")
    infos = {arch: [runs[i][1] for runs in ranks] for i, arch in enumerate(TP_RUNS)}
    tokens_a = ranks[0][0][0]
    del ranks
    gc.collect()

    arch = arch_b
    (one,) = future_b.result()
    pool.shutdown()
    t_b = time.perf_counter() - t0_b
    gen, info, logits = one[0][:3]
    add(info["counts"])
    check(info["backend"] == "nccl" and info["world"] == 1, "tp (b): the NCCL group of one rank ran")
    check(np.array_equal(gen, ref[arch][0]) and all(
        np.array_equal(a, c) for a, c in zip(logits, ref[arch][2])),
        "tp (b): NCCL at world 1 gives tp 1's tokens and logits bit for bit")
    log(f"tp (b) {arch} NCCL world 1: tokens and {len(logits)} steps' logits bit-equal to the "
        f"non-distributed run; {t_b:.1f}s (spawn included, beside (a)'s ranks)")

    if torch.cuda.device_count() >= 2:
        t0 = time.perf_counter()
        ranks = meshes.spawn(tp_rank, 2, ([base[arch] + ["--tp", "2", "--dist-backend", "nccl",
                                                          "--dist-init", f"file://{tp_store('nccl-2')}"]],),
                             timeout=TP_TIMEOUT)
        for r, runs in enumerate(ranks):
            add(runs[0][1]["counts"])
            check(np.array_equal(runs[0][0], tokens_a),
                  f"tp (c) rank {r}: NCCL on two cards gives (a)'s tokens")
        log(f"tp (c) {arch} NCCL on cuda:0-1: tokens equal (a)'s; "
            f"decode_ms_per_step={ranks[0][0][1]['decode_s'] / steps * 1e3:.3f}; "
            f"{time.perf_counter() - t0:.1f}s")
    else:
        log(f"tp (c): not run: {torch.cuda.device_count()} card(s), two needed")
    return total, infos

# ----------------------------------------------------------------------------
# Phase 15: the partition -> process pipeline over ranks
# ----------------------------------------------------------------------------

# brain_like cut to 0.08 of its scale (a depth cut for the smoke's time
# limit; 0.25 until phase 17 came, 0.15 until phase 18 came: two ranks on
# one card share it, so the batched steps take about twice as long as one
# process's); k, W, z and spread are phase 9's.
RANKS_SCALE = 0.08
RANKS_K, RANKS_W, RANKS_ITERS = 32, 256, 30
RANKS_TIMEOUT = 300.0
# Per-instance stats a sharded run must give as one process does (the walls,
# ``backend`` and ``n_shards`` aside).
RANKS_SAME = ("score_rows", "score_count", "final_w", "lam_final", "assigned", "scan_calls",
              "steps_run", "warmup_steps", "h2d_rows", "h2d_bytes", "modeled_cost_per_score",
              "buffer_rows", "n_buckets", "bucket_rows", "unassigned", "instance")


def ranks_pipeline(edges, n):
    """Spotlight z = 8 through ``partition_stream_batched(backend="shard_map")``,
    then the engine on its assignment: pagerank (30 supersteps) and label
    propagation over ``engine_mesh(k=32)`` on a graph built for that mesh
    (the rank's device holds its slab's edges and messages), the slab
    placement at k = 32 and k = 7, then :func:`ranks_kernel_checks`. Runs
    in this process or on a rank of a process group; each path's counts
    are zeroed just before it and read just after."""
    import numpy as np
    import torch

    from repro_torch.core import AdwiseConfig
    from repro_torch.core.adwise import partition_stream_batched
    from repro_torch.core.spotlight import spread_mask
    from repro_torch.engine import build_partitioned_graph, engine_mesh, label_propagation, pagerank
    from repro_torch.engine.gas import make_superstep
    from repro_torch.graph import EdgeStream
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshes

    z, k = SPOT_Z, RANKS_K
    streams, valid = EdgeStream(edges, n).split_padded(z)
    allowed = np.stack([spread_mask(k, z, i, SPOT_SPREAD) for i in range(z)])
    cfg = AdwiseConfig(k=k, window_max=RANKS_W)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = partition_stream_batched(streams, valid, n, cfg, allowed=allowed, backend="shard_map",
                                   device="cuda")
    torch.cuda.synchronize()
    spot_counts = ops.launch_counts()
    assign = np.concatenate([r.assign for r in res])
    stats = [{key: r.stats[key] for key in RANKS_SAME + ("backend", "n_shards", "wall_time_s",
                                                       "setup_s", "w_trace")} for r in res]
    mesh = engine_mesh(k=k)
    g = build_partitioned_graph(edges, assign, n, k, device="cuda", mesh=mesh)
    pagerank(g, iters=2, mesh=mesh)  # the group's first collective
    mesh.stats.clear()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pr, _ = pagerank(g, iters=RANKS_ITERS, mesh=mesh)
    pr_wall = time.perf_counter() - t0
    pr_counts = ops.launch_counts()
    pr_coll = {op: list(v) for op, v in mesh.stats.items()}
    labels, lp_info = label_propagation(g, mesh=mesh)
    fwd, keep = (lambda a, b, c, d: (a, b)), (lambda st, acc, deg: st)
    occ32 = make_superstep(g, fwd, keep, mesh).slab_occupancy
    mesh7 = engine_mesh(k=7)
    g7 = build_partitioned_graph(edges, assign % 7, n, 7, device="cuda", mesh=mesh7)
    occ7 = make_superstep(g7, fwd, keep, mesh7).slab_occupancy
    held = (g.parts, len(g.msg_src))
    del g7
    # The launches below hold the kernels to their plain versions at this
    # rank's shapes; they come after the counts were read, so count nowhere.
    kern = ranks_kernel_checks(g, pr, streams, n, cfg)
    return dict(world=meshes.world_size(), rank=meshes.rank(), assign=assign, stats=stats,
                spot_counts=spot_counts, pr=pr, pr_wall=pr_wall, pr_counts=pr_counts,
                pr_coll=pr_coll, labels=labels, lp_info=lp_info, occ32=occ32, occ7=occ7,
                held=held, kern=kern)


def ranks_kernel_checks(g, pr, streams, n, cfg):
    """The two kernels at the shapes this rank's run gave them, each held to
    its plain version on the same inputs:

      segment_sum — this rank's slab layout (the messages of its partitions'
        edges, S = |V| segments) with pagerank's messages of the final
        ranks (x_u / deg_u): within the bound of an n-term fp32 sum in any
        order (phase 1's: n·2^-24·sum|x| per segment, n the segment's
        length), and small integers, exact in fp32, equal to the fp64 sum
        and to the plain version;
      window_score_rows_batched — this rank's block of instances (z / n_shards
        of them, each a window of W slots of its own stream over its own
        (|V| + 1)-row tables, R = r_sel rows): bit for bit.

    Returns plain values: the shapes, the verdicts, the largest errors."""
    import numpy as np
    import torch

    from repro_torch.core.driver import resolve_backend
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import mesh as meshes

    dev = g.device
    out = {}
    # segment_sum on the slab.
    lay, src = g.msg_layout, g.msg_src.long()
    seg = lay.seg_ids
    x = torch.as_tensor(pr, device=dev)[:, None]
    data = x[src] / g.degrees[src].clamp_min(1)[:, None]
    got = ops.segment_sum_sorted(data, lay)
    want = ref.segment_sum_ref(data, seg, n)
    idx = seg.long()[:, None]
    exact = torch.zeros((n, 1), dtype=torch.float64, device=dev).scatter_add_(0, idx, data.double())
    mag = torch.zeros((n, 1), dtype=torch.float64, device=dev).scatter_add_(0, idx, data.double().abs())
    runs = torch.bincount(seg.long(), minlength=n).double()[:, None]
    tol = runs * 2.0**-24 * mag
    ints = torch.as_tensor(np.random.default_rng(15).integers(-4, 5, (len(seg), 1)),
                           dtype=torch.float32, device=dev)
    got_i = ops.segment_sum_sorted(ints, lay)
    exact_i = torch.zeros((n, 1), dtype=torch.float64, device=dev).scatter_add_(0, idx, ints.double())
    out["segment_sum"] = dict(
        messages=len(seg), segments=n, longest=int(runs.max().item()) if len(seg) else 0,
        bound=bool(((got.double() - exact).abs() <= tol).all()),
        plain_bound=bool(((want.double() - exact).abs() <= tol).all()),
        ints=bool(torch.equal(got_i, exact_i.float()) and torch.equal(
            got_i, ref.segment_sum_ref(ints, seg, n))),
        max_abs_err=float((got - want).abs().max().item()) if len(seg) else 0.0)
    # window_score_rows_batched on this rank's block of instances.
    z, w, k = streams.shape[0], cfg.window_max, cfg.k
    _, n_shards = resolve_backend("shard_map", z)
    z_r = z // n_shards if n_shards > 1 else z
    lo = meshes.rank() * z_r
    r = cfg.resolve_r_sel()
    rng = np.random.default_rng(16)
    a = max(0, min(1000, streams.shape[1] - w))  # each window: W slots of the instance's stream
    parts = [ws_table_inputs(w, k, n, 7 + i, uv=streams[i, a:a + w]) for i in range(lo, lo + z_r)]
    tb = [torch.as_tensor(np.stack(a), device=dev) for a in zip(*parts)]
    md = torch.full((z_r,), 40, dtype=torch.int32, device=dev)
    rows = torch.as_tensor(np.stack([rng.choice(w, r, replace=False) for _ in range(z_r)]).astype(np.int32),
                           device=dev)
    got = ops.window_score_rows_batched(*tb, md, rows)
    want = ref.window_score_rows_batched_ref(*tb, md, rows)
    out["window_score"] = dict(
        shape=(z_r, r, w, k), table_rows=n + 1, instances=(lo, lo + z_r),
        bit_equal=bool(torch.equal(got.view(torch.int32), want.view(torch.int32))),
        max_abs_err=float((got - want).abs().max().item()))
    return out


def ranks_rank(rank, backend, store, edges, n):
    """One rank of phase 15 (a spawned process): join the group on the
    card, then ``ranks_pipeline``."""
    sys.path.insert(0, SRC)
    import torch

    from repro_torch.launch import mesh as meshes

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))  # two ranks share the host
    meshes.init_ranks(backend, torch.device("cuda"), f"file://{store}")
    return ranks_pipeline(edges, n)


def ranks_store(name: str) -> str:
    path = os.path.join(HERE, "build", "chip_smoke", "ranks")
    os.makedirs(path, exist_ok=True)
    path = os.path.join(path, name)
    if os.path.exists(path):
        os.remove(path)
    return path


def ranks_compare(ref, got, what, world):
    """A rank's run against the one-process run: spotlight bit-equal
    (assignments and per-instance stats) with one ``window_score`` launch a
    batched step; pagerank within rtol 1e-5, label propagation exact, one
    ``segment_sum`` launch and one all-reduce a superstep, the slabs of
    k = 32 and k = 7 placed as the JAX package places them; and both
    kernels held to their plain versions at this rank's own shapes
    (:func:`ranks_kernel_checks`)."""
    import numpy as np

    from repro_torch.engine.gas import engine_mesh_size, slab_placement

    r = got["rank"]
    check(got["world"] == world, f"ranks {what} rank {r}: world {world}")
    check(np.array_equal(got["assign"], ref["assign"]),
          f"ranks {what} rank {r}: spotlight z={SPOT_Z} assignments equal one process's")
    same = all(g[key] == f[key] for g, f in zip(got["stats"], ref["stats"]) for key in RANKS_SAME)
    same = same and all(np.array_equal(g["w_trace"], f["w_trace"])
                        for g, f in zip(got["stats"], ref["stats"]))
    check(same, f"ranks {what} rank {r}: per-instance stats and w_trace equal one process's")
    sharded = world > 1
    want = ("shard_map", world) if sharded else ("vmap", 0)
    check(all((st["backend"], st["n_shards"]) == want for st in got["stats"]),
          f"ranks {what} rank {r}: backend, n_shards = {want}")
    st = got["stats"][0]
    ws = got["spot_counts"]["window_score"]
    check(ws == st["steps_run"] + st["warmup_steps"],
          f"ranks {what} rank {r}: one window_score launch per batched step ({ws} launches, "
          f"{st['steps_run']} + {st['warmup_steps']} steps)")
    check(np.allclose(got["pr"], ref["pr"], rtol=1e-5, atol=0) and np.isfinite(got["pr"]).all(),
          f"ranks {what} rank {r}: pagerank within rtol 1e-5 of one process's")
    check(np.array_equal(got["labels"], ref["labels"]) and got["lp_info"] == ref["lp_info"],
          f"ranks {what} rank {r}: label propagation equals one process's")
    check(got["pr_counts"]["segment_sum"] == RANKS_ITERS,
          f"ranks {what} rank {r}: one segment_sum launch per superstep")
    n_ar = got["pr_coll"].get("all_reduce_sum", [0, 0])[0]
    check(n_ar == (RANKS_ITERS if sharded else 0),
          f"ranks {what} rank {r}: {n_ar} all-reduces in {RANKS_ITERS} supersteps")
    ss, ws_k = got["kern"]["segment_sum"], got["kern"]["window_score"]
    check(ss["bound"] and ss["plain_bound"],
          f"ranks {what} rank {r}: segment_sum on the rank's slab ({ss['messages']} messages, "
          f"S={ss['segments']}) within the fp32 sum bound, as its plain version")
    check(ss["ints"], f"ranks {what} rank {r}: segment_sum on the rank's slab, small integers "
          "equal to the fp64 sum and the plain version")
    check(ws_k["bit_equal"], f"ranks {what} rank {r}: window_score_rows_batched at the rank's "
          f"block (z, R, W, K) = {ws_k['shape']} bit-equal to the plain version")
    size32, size7 = engine_mesh_size(world, None, 32), engine_mesh_size(world, None, 7)
    check(got["occ32"] == slab_placement(32, size32)[1] and got["occ7"] == slab_placement(7, size7)[1],
          f"ranks {what} rank {r}: slab_occupancy k=32 {got['occ32']}, k=7 {got['occ7']}")


def ranks_line(what, runs, ref):
    st = runs[0]["stats"][0]
    steps = st["steps_run"]
    walls = [r["stats"][0]["wall_time_s"] - r["stats"][0]["setup_s"] for r in runs]
    ref_loop = ref["stats"][0]["wall_time_s"] - ref["stats"][0]["setup_s"]
    log(f"ranks {what}: spotlight z={SPOT_Z} wall_s={st['wall_time_s']:.3f} steps={steps} "
        f"us_per_step_per_rank={walls[0] / steps * 1e6:.2f} (one process: "
        f"{ref_loop / steps * 1e6:.2f}) window_score_launches per rank="
        f"{[r['spot_counts']['window_score'] for r in runs]}; pagerank superstep_ms per rank="
        f"{[round(r['pr_wall'] / RANKS_ITERS * 1e3, 3) for r in runs]} (one process: "
        f"{ref['pr_wall'] / RANKS_ITERS * 1e3:.3f}) all_reduce per rank="
        f"{[r['pr_coll'].get('all_reduce_sum') for r in runs]} slab_occupancy k=32 "
        f"{runs[0]['occ32']} k=7 {runs[0]['occ7']} held (parts, messages) per rank="
        f"{[r['held'] for r in runs]}")
    for r in runs:
        ss, wk = r["kern"]["segment_sum"], r["kern"]["window_score"]
        log(f"ranks {what} rank {r['rank']}: segment_sum on its slab messages={ss['messages']} "
            f"S={ss['segments']} longest={ss['longest']} max_abs_err={ss['max_abs_err']} "
            f"(vs plain); window_score_rows_batched (z, R, W, K)={wk['shape']} instances "
            f"{wk['instances']} tables {wk['table_rows']} rows max_abs_err={wk['max_abs_err']} "
            f"bit_equal={wk['bit_equal']}")


def phase_ranks():
    """(a) spotlight z = 8 at brain_like ``RANKS_SCALE``, k = 32, W = 256 through
    ``partition_stream_batched(backend="shard_map")`` on two gloo ranks on
    cuda:0 (spawned; a file store; joined with a timeout), bit-equal to a
    one-process run of the same cut in this process, n_shards 2 and one
    ``window_score`` launch per batched step on each rank; (b) on its
    assignment, pagerank (30 supersteps) within rtol 1e-5 and label
    propagation exact against one process, one ``segment_sum`` launch and
    one all-reduce per superstep a rank, slabs (16, 16) at k = 32 and (4, 3)
    at k = 7; the superstep wall against one process; (c) NCCL at world 1
    (a group of one rank in this process), bit-equal to the run with no
    group; (d) with two cards, (a) and (b) over
    NCCL on cuda:0-1 (logged as not run on one card). Returns the ranks'
    launch counts ((a)-(d), each rank's paths)."""
    import torch

    from repro_torch.graph import make_graph
    from repro_torch.launch import mesh as meshes

    edges, n = make_graph("brain_like", seed=0, scale=RANKS_SCALE)
    log(f"ranks phase: brain_like {RANKS_SCALE}: |V|={n} |E|={len(edges)} k={RANKS_K} "
        f"z={SPOT_Z} W={RANKS_W}")
    total = {}

    def add(run):
        for counts in (run["spot_counts"], run["pr_counts"]):
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v

    t0 = time.perf_counter()
    ref = ranks_pipeline(edges, n)
    log(f"ranks phase: one process {time.perf_counter() - t0:.1f}s")
    check(ref["occ32"] == (RANKS_K,) and ref["pr_counts"]["segment_sum"] == RANKS_ITERS,
          "ranks: the one-process run holds every partition and launches segment_sum a superstep")

    t0 = time.perf_counter()
    runs = meshes.spawn(ranks_rank, 2, ("gloo", ranks_store("gloo-2"), edges, n),
                        timeout=RANKS_TIMEOUT)
    log(f"ranks phase: (a)+(b) two gloo ranks on cuda:0, {time.perf_counter() - t0:.1f}s "
        "(spawn included)")
    for run in runs:
        add(run)
        ranks_compare(ref, run, "(a)+(b) gloo", 2)
    check(runs[0]["occ32"] == (16, 16) and runs[0]["occ7"] == (4, 3),
          "ranks (b): slabs (16, 16) at k=32 and (4, 3) at k=7")
    check([r["held"][0] for r in runs] == [(0, 16), (16, 32)]
          and sum(r["held"][1] for r in runs) == ref["held"][1] == 2 * len(edges),
          "ranks (b): each rank's graph holds its slab's partitions, the slabs every message once")
    import numpy as np

    check(np.array_equal(runs[0]["pr"], runs[1]["pr"]), "ranks (b): both ranks' pagerank bit-equal")
    ranks_line("(a)+(b) two gloo ranks on cuda:0", runs, ref)

    # (c) in this process (no spawn): a group of one rank over NCCL.
    t0 = time.perf_counter()
    meshes.init_ranks("nccl", torch.device("cuda"), f"file://{ranks_store('nccl-1')}")
    try:
        one = ranks_pipeline(edges, n)
    finally:
        torch.distributed.destroy_process_group()
    add(one)
    ranks_compare(ref, one, "(c) NCCL world 1", 1)
    check(np.array_equal(one["pr"], ref["pr"]),
          "ranks (c): NCCL at world 1 gives the no-group pagerank bit for bit")
    log(f"ranks (c) NCCL world 1: spotlight and engine bit-equal to the run with no group; "
        f"{time.perf_counter() - t0:.1f}s")

    if torch.cuda.device_count() >= 2:
        t0 = time.perf_counter()
        runs = meshes.spawn(ranks_rank, 2, ("nccl", ranks_store("nccl-2"), edges, n),
                            timeout=RANKS_TIMEOUT)
        for run in runs:
            add(run)
            ranks_compare(ref, run, "(d) NCCL cuda:0-1", 2)
        ranks_line("(d) NCCL on cuda:0-1", runs, ref)
        log(f"ranks (d): {time.perf_counter() - t0:.1f}s")
    else:
        log(f"ranks (d): not run: {torch.cuda.device_count()} card(s), two needed")
    return total

# ----------------------------------------------------------------------------
# Phase 16: tensor-parallel serving of the RWKV-6, Zamba2 and Whisper families
# ----------------------------------------------------------------------------

TPF_GEN = 8
# (arch, layers kept (None: full depth), batch, prompt): whisper at full
# depth; rwkv6 and zamba2 at full width cut in depth for the smoke's time
# limit (zamba2: two applications of the shared block, after the 6th and
# 12th layers, and a remainder layer after them).
TPF_RUNS = [
    ("whisper-tiny", None, 4, 448),
    ("rwkv6-7b", 4, 4, 512),
    ("zamba2-7b", 13, 4, 512),
]
# (b): each family's full-width layers of ``family_parity_cfg`` in fp32,
# batch 1, prompt 128 (whisper: 64 frames), 3 decode steps; prompt + gen
# divides by 4, so whisper's cross cache (half the length) splits over 2.
TPF_PARITY_PROMPT, TPF_PARITY_GEN = 128, 4
# fp32 logits at tp 2 against tp 1, relative to their largest magnitude:
# the new reductions (the norms' sums of squares over the ranks, the gated
# channel-mix columns, the merged cross-attention) differ from one device's
# only by the order of fp32 sums: readings (tools/tp_family_readings.py,
# NVIDIA H100 80GB HBM3 at 700 W) 1.0e-6 (whisper), 2.1e-6 (rwkv6) and
# 1.1e-5 (zamba2, whose SSD scans run the fp32 sums longest) of the scale.
TPF_PARITY_TOL = 1e-4
# bf16 logits at tp 2 against tp 1's: within TP_LOGIT_TOL of their scale
# (phase 14's), or, for a model whose bf16 run lies further from its own
# fp32 run, within TPF_FLOOR_SHARE of that distance (the largest over the
# steps whose tokens agree; fp32 tp 1 at the same cut runs in this
# process). Readings (tools/tp_family_readings.py, NVIDIA H100 80GB HBM3 at
# 700 W): zamba2 (13 layers) in bf16 at tp 1 lies 1.01-1.26 from its fp32
# run (0.24 of the scale of 5.2), and tp 2 0.27-0.41 from tp 1 (0.077 of
# the scale, against a tolerance of 0.118): its Mamba decays amplify each
# bf16 rounding of the column-split products, as they do tp 1's own;
# whisper's and rwkv6's bf16 runs lie 0.07-0.16 from fp32, and tp 2
# 0.05-0.10 from tp 1 (0.011-0.022 of the scale). Planted faults: the
# norms' sums of squares left unsummed move rwkv6's first logits 1.34
# (0.29 of the scale) and zamba2's 4.77 (0.89); both ranks gating rank 0's
# channel-mix columns moves rwkv6's 5.48; the decode merge without its
# rescale moves whisper's decode logits 0.65-1.42 (0.14-0.30). Each fails
# here; zamba2's merge fault (2 attentions among 13 layers) stays inside
# its bf16 tolerance, and (b) catches it (errors 0.075-0.11, 0.018-0.026
# of the scale), as it catches the others.
TPF_FLOOR_SHARE = 0.5
TPF_TIMEOUT = 300.0


def tpf_cfg(arch, layers=None, dtype=None):
    """``arch``'s config cut to ``layers`` (None: all), in ``dtype``."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    cut = {}
    if layers is not None:
        cut["n_layers"] = layers
    if dtype is not None:
        cut["dtype"] = dtype
    return dataclasses.replace(cfg, **cut)


def tpf_flash(cfg, b, t, tp):
    """(prefill flash launches by body, the (q, k) shapes launched) of one
    rank of ``cfg`` served at ``tp`` (the 'shard' policy: hl and kvl heads
    a rank): whisper's encoder, decoder self- and cross-attention per layer;
    the hybrid's shared block per application; none in RWKV-6."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    h, kv, policy = cfg.padded_heads(tp)
    hl, kvl, dh = h // tp, kv // tp, cfg.d_head
    body = fa.body_for(getattr(torch, cfg.dtype), dh)
    if cfg.family == "encdec":
        te = t // 2
        n = cfg.n_enc_layers + 2 * cfg.n_layers
        shapes = {((b, hl, te, dh), (b, kvl, te, dh)), ((b, hl, t, dh), (b, kvl, t, dh)),
                  ((b, hl, t, dh), (b, kvl, te, dh))}
    elif cfg.family == "hybrid":
        n = cfg.n_layers // cfg.shared_every
        shapes = {((b, hl, t, dh), (b, kvl, t, dh))}
    else:
        n, shapes = 0, set()
    return ({body: n} if n else {}), sorted(shapes), policy


def tpf_merges(cfg) -> int:
    """The decode merges (max all-reduces) a step of ``cfg`` at tp > 1 makes:
    one per attention over a split sequence."""
    if cfg.family == "encdec":
        return 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_every
    return 0


def phase_tp_families():
    """(a) whisper-tiny (full depth, 4 x 448, 224 frames), rwkv6-7b (4 of 32
    layers) and zamba2-7b (13 of 81) at full width, bf16, 4 x 512, 8
    tokens, through ``launch.serve.main`` (a depth-cut config passed in),
    at tp 1 in this process, then at ``--tp 2`` as two gloo ranks on cuda:0
    (spawned; a file store under ``build/chip_smoke/tp``; joined with a
    timeout): logits and tokens against tp 1's (``tp_compare``), each
    prefill's flash launches by body at the rank's local heads (zamba2's
    shared block on ``mma_sync``, whisper's 12 on ``wgmma``), none in
    decode (tp 1's whisper launches 4 a step: its cross-attention), one
    decode merge per attention a step, each rank's peak memory below tp
    1's; prefill ms, decode ms a step, peak GiB a rank and the collectives
    a decode step. (b) In the same ranks, each family's 2 full-width layers
    (``family_parity_cfg``) in fp32, batch 1, prompt 128, against tp 1 in
    this process within ``TPF_PARITY_TOL`` of the logits' scale. (c) With
    two cards, zamba2 at tp 2 over NCCL on cuda:0-1: (a)'s tokens. Returns
    the ranks' launch counts."""
    import gc

    import numpy as np
    import torch

    from repro_torch.launch import mesh as meshes

    runs, cfgs, names = [], [], []
    for arch, layers, b, t in TPF_RUNS:
        runs.append(["--arch", arch, "--batch", str(b), "--prompt-len", str(t),
                     "--gen", str(TPF_GEN)])
        cfgs.append(tpf_cfg(arch, layers))
        names.append(arch)
    for arch, *_ in TPF_RUNS:
        runs.append(["--arch", arch, "--batch", "1", "--prompt-len", str(TPF_PARITY_PROMPT),
                     "--gen", str(TPF_PARITY_GEN)])
        cfgs.append(family_parity_cfg(arch))
        names.append(f"{arch} fp32")
    t0 = time.perf_counter()
    ref = tp_serve(runs, cfgs=cfgs)
    # tp 1 in fp32 at (a)'s cuts: how far each bf16 run lies from it.
    fine = tp_serve(runs[:len(TPF_RUNS)],
                    cfgs=[tpf_cfg(arch, layers, "float32") for arch, layers, *_ in TPF_RUNS])
    log(f"tp families: tp 1 runs {time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    t0 = time.perf_counter()
    argvs = [argv + ["--tp", "2", "--dist-backend", "gloo", "--dist-init",
                     f"file://{tp_store(f'tpf-gloo-{i}')}"] for i, argv in enumerate(runs)]
    ranks = meshes.spawn(tp_rank, 2, (argvs, cfgs), timeout=TPF_TIMEOUT)
    log(f"tp families: two gloo ranks on cuda:0, {time.perf_counter() - t0:.1f}s (spawn included)")
    card = card_line()
    for i, (name, cfg) in enumerate(zip(names, cfgs)):
        want, arch = ref[i], runs[i][1]
        b, t = int(runs[i][3]), int(runs[i][5])
        steps = int(runs[i][7]) - 1
        pre, shapes, policy = tpf_flash(cfg, b, t, 2)
        check(policy == "shard" or cfg.family == "ssm", f"tp families {name}: the shard head policy at tp 2")
        if i < len(TPF_RUNS):
            dec1 = want[1]["decode_flash_bodies"]
            n_cross = cfg.n_layers * steps if cfg.family == "encdec" else 0
            check(sum(dec1.values()) == n_cross,
                  f"tp families (a) {name}: tp 1 decode launches {n_cross} flash (cross-attention)")
        for r, rank_runs in enumerate(ranks):
            got = rank_runs[i]
            gen, info = got[0], got[1]
            add(info["counts"])
            check(gen.shape == want[0].shape, f"tp families {name} rank {r}: ({gen.shape}) tokens")
            bodies = {k: v for k, v in info["prefill_flash_bodies"].items() if v}
            check(bodies == pre, f"tp families {name} rank {r}: prefill flash launches {bodies} == {pre}")
            check(sum(info["decode_flash_bodies"].values()) == 0,
                  f"tp families {name} rank {r}: no flash launch in decode")
            check(got[3] == shapes, f"tp families {name} rank {r}: flash at the local heads {got[3]} == {shapes}")
            merges = info["decode_collectives"].get("all_reduce_max", [0, 0])[0]
            check(merges == tpf_merges(cfg) * steps,
                  f"tp families {name} rank {r}: {merges} decode merges == {tpf_merges(cfg)} a step")
            if i >= len(TPF_RUNS):  # (b): fp32, the fine check
                d = tp_diff(want, got)
                log(f"tp families (b) {name} rank {r} ({cfg.n_layers} layers, B=1 prompt "
                    f"{TPF_PARITY_PROMPT}) vs tp 1 (tolerance {TPF_PARITY_TOL} x scale): logits "
                    f"max_abs_err per step={[f'{e:.3e}' for e in d['errs']]} (scale "
                    f"{d['scale']:.4f}) tokens changed at tp 1 logit gaps={d['ties']} "
                    f"tokens equal={int(d['equal'])}")
                check(len(d["errs"]) == len(want[2]), f"tp families (b) {name}: every step compared")
                check(all(e <= TPF_PARITY_TOL * d["scale"] for e in d["errs"] + d["ties"]),
                      f"tp families (b) {name} rank {r}: logits within {TPF_PARITY_TOL} of their scale")
                continue
            to_fp32 = [tp_diff(fine[i], run) for run in (want, got)]
            bf16_floor = max(to_fp32[0]["errs"])
            tol = max(TP_LOGIT_TOL, TPF_FLOOR_SHARE * bf16_floor / max(1.0, float(np.abs(want[2][0]).max())))
            log(f"tp families (a) {name} rank {r}: distance from tp 1 in fp32 per step while the "
                f"tokens agree: tp 1 bf16 {[round(e, 5) for e in to_fp32[0]['errs']]}, tp 2 bf16 "
                f"{[round(e, 5) for e in to_fp32[1]['errs']]} (scale {to_fp32[0]['scale']:.3f})")
            tp_compare(arch, want, got, f"families (a) rank {r}", tol=tol)
            check(info["peak_bytes"] < want[1]["peak_bytes"],
                  f"tp families (a) {name} rank {r}: peak memory {info['peak_bytes'] / 2**30:.4f} GiB "
                  f"below tp 1's {want[1]['peak_bytes'] / 2**30:.4f}")
            if r == 0:
                per_step = {op: [n / steps, nb / steps]
                            for op, (n, nb) in info["decode_collectives"].items()}
                log(f"tp families (a) {name} ({cfg.n_layers} layers) tp=2 gloo B={b} prompt={t} "
                    f"gen={steps + 1} [{card}]: prefill_ms={info['prefill_s'] * 1e3:.3f} "
                    f"(tp 1: {want[1]['prefill_s'] * 1e3:.3f}) "
                    f"decode_ms_per_step={info['decode_s'] / steps * 1e3:.3f} "
                    f"(tp 1: {want[1]['decode_s'] / steps * 1e3:.3f}) "
                    f"peak_GiB per rank={[round(q[i][1]['peak_bytes'] / 2**30, 4) for q in ranks]} "
                    f"(tp 1: {want[1]['peak_bytes'] / 2**30:.4f}) flash prefill={bodies} "
                    f"(tp 1: {dict((k, v) for k, v in want[1]['prefill_flash_bodies'].items() if v)}) "
                    f"shapes={got[3]}")
                log(f"tp families (a) {name} collectives per decode step (count, bytes per rank): "
                    + ", ".join(f"{op} {n:.0f} {nb:.0f}" for op, (n, nb) in sorted(per_step.items()))
                    + "; prefill: " + ", ".join(f"{op} {n} {nb}" for op, (n, nb)
                                                in sorted(info["prefill_collectives"].items())))
        check(np.array_equal(ranks[0][i][0], ranks[1][i][0]), f"tp families {name}: both ranks' tokens equal")
    tokens_a = ranks[0][names.index("zamba2-7b")][0]
    del ranks, ref
    gc.collect()
    torch.cuda.empty_cache()

    if torch.cuda.device_count() >= 2:
        t0 = time.perf_counter()
        z = names.index("zamba2-7b")
        ranks = meshes.spawn(tp_rank, 2, ([runs[z] + ["--tp", "2", "--dist-backend", "nccl",
                                                      "--dist-init", f"file://{tp_store('tpf-nccl-2')}"]],
                                          [cfgs[z]]), timeout=TPF_TIMEOUT)
        for r, rank_runs in enumerate(ranks):
            add(rank_runs[0][1]["counts"])
            check(np.array_equal(rank_runs[0][0], tokens_a),
                  f"tp families (c) rank {r}: zamba2 over NCCL on two cards gives (a)'s tokens")
        log(f"tp families (c) zamba2 NCCL on cuda:0-1: tokens equal (a)'s; "
            f"decode_ms_per_step={ranks[0][0][1]['decode_s'] / (TPF_GEN - 1) * 1e3:.3f}; "
            f"{time.perf_counter() - t0:.1f}s")
    else:
        log(f"tp families (c): not run: {torch.cuda.device_count()} card(s), two needed")
    return total


# ----------------------------------------------------------------------------
# Phase 17: tensor-parallel + FSDP training, two ranks on one card
# ----------------------------------------------------------------------------

# (a) Llama-3.2-3B at full width cut to 2 of its 28 layers (the phase's
# time: each FSDP step moves every block's bf16 weights through gloo three
# times and the tied embedding's gradient once, ~0.5 GB/s a rank on one
# card), bf16, 2 x 512, 3 steps through ``launch.train.main``.
TPT_LAYERS, TPT_BATCH, TPT_SEQ, TPT_STEPS = 2, 2, 512, 3
TPT_ARGS = ["--arch", "llama3.2-3b", "--batch", str(TPT_BATCH), "--seq", str(TPT_SEQ),
            "--steps", str(TPT_STEPS), "--lr", "3e-4", "--seed", "0"]
# (b) granite-moe-1b-a400m at full width cut to 2 of its 24 layers (gloo
# moves every FSDP gather through the host), fp32, one step at 2 x 512, at a
# capacity factor of 1.0 (its 1.25 leaves 4.6 standard deviations of an
# expert's load at random init before a drop): the plan drops pairs.
TPT_MOE_LAYERS, TPT_MOE_CF = 2, 1.0
TPT_MOE_ARGS = ["--arch", "granite-moe-1b-a400m", "--batch", "2", "--seq", "512", "--steps", "1",
                "--lr", "3e-4", "--seed", "0"]
# (a) also: whisper-tiny at full width and depth (4 encoder and 4 decoder
# layers, 6 heads of 64: 3 a rank under TP), bf16, 8 x 448 with 224 frames
# (phase 13's shape), 3 steps through ``launch.train.main``.
TPT_WHISPER_ARGS = ["--arch", "whisper-tiny", "--batch", "8", "--seq", "448", "--steps",
                    str(TPT_STEPS), "--lr", "3e-4", "--seed", "0"]
# (c) full-width fp32 layers of each at the depth of phases 12 b and 13 c
# (``family_parity_cfg``: 2 layers, internvl 1), ``TPT_GRAD_STEPS`` training steps at 2 x 128 at a constant lr without
# remat (FSDP then gathers each block once; (a) runs the launcher's remat
# path), compared leaf by leaf through sketches (``tpt_sketch``): the first
# step's gradient, and the steps' update. granite takes a second step, which
# reads the moments the first wrote (AdamW on pieces is the same code for
# every family); llama's and internvl's FSDP steps move their fp32
# embeddings' gradients (1.6 and 2.3 GB) through gloo, seconds each. The
# ssm, hybrid and encdec families too: rwkv6 1 layer (its untied fp32
# embedding and head are 2.1 GB) and zamba2 3 layers with the shared block
# after the 2nd, as ``family_parity_cfg`` cuts them; whisper at full depth
# (4 + 4 layers, ``TPT_GRAD_CUTS``).
TPT_GRAD_ARCHS = ["llama3.2-3b", "granite-moe-1b-a400m", "internvl2-26b", "rwkv6-7b", "zamba2-7b",
                  "whisper-tiny"]
TPT_GRAD_STEPS = {"llama3.2-3b": 1, "granite-moe-1b-a400m": 2, "internvl2-26b": 1}
TPT_GRAD_CUTS = {"whisper-tiny": dict(n_layers=4, n_enc_layers=4)}
TPT_GRAD_BATCH, TPT_GRAD_SEQ, TPT_GRAD_LR = 2, 128, 1e-3
TPT_SKETCHES = 4
# fp32 at tp 2 (TP or FSDP) against tp 1 on the card: the losses, the
# gradient's global norm, and each gradient leaf's norm and sketches
# relative to the leaf's norm. Readings: tools/tp_train_readings.py
# (PERF.md §6).
TPT_LOSS_TOL = 1e-5
TPT_GRAD_TOL = 1e-4
# The gradient's global norm (AdamW's clip input), relative: sound 0-1.3e-7;
# a replicated piece counted by every rank that holds it 7.9e-5 (llama's
# norms at (1, 2)) to 0.28.
TPT_NORM_TOL = 1e-5
# Each leaf's update, relative to its norm: AdamW's first step turns an
# element's gradient g into lr·g / (|g| + ε), ±lr whatever its size, so an
# element whose gradient lies near 0 and rounds to the other sign moves its
# update by 2 lr: a share f of them moves the leaf's update by 2√f of its
# norm (the CPU rehearsal at reduced width: up to 2.8e-3, a share of 2e-6).
# The check holds the update to its pieces and their moments (a rank that
# updated the wrong piece, or none, is 1.0 off; one whose moments lie at
# another piece's place is off in the second step), not to its scale:
# AdamW's update is nearly invariant to the gradient's scale, so the clip's
# norm is held by the norm check instead.
TPT_UPDATE_TOL = 1e-2
TPT_TIMEOUT = 420.0
# the meshes of phase 17: (data, model)
TPT_MESHES = [(1, 2), (2, 1)]


def tpt_moe_cfg():
    """(b)'s granite: ``TPT_MOE_LAYERS`` layers, fp32, capacity factor
    ``TPT_MOE_CF``."""
    import dataclasses

    cfg = tpf_cfg("granite-moe-1b-a400m", TPT_MOE_LAYERS, "float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=TPT_MOE_CF))


def tpt_grad_cfg(arch):
    """(c)'s config of ``arch``: full-width fp32 layers at
    ``family_parity_cfg``'s depth, or its ``TPT_GRAD_CUTS``."""
    import dataclasses

    return dataclasses.replace(family_parity_cfg(arch), **TPT_GRAD_CUTS.get(arch, {}))


def tpt_rank_attn(cfg, b, t, dp, tp):
    """((B, Hq, Hkv, Tq, Tk, Dh), causal) of each kind of ``flash_attention``
    launch one rank of a (dp, tp) mesh makes in a training step of ``cfg``
    at batch ``b``, ``t`` tokens (the 'shard' head policy: a rank's heads
    and KV heads; the batch's rows by data coordinate): the causal
    self-attention (over the vlm's patches too; the hybrid's shared block);
    whisper's encoder over its t // 2 frames and cross-attention onto them,
    non-causal; none in RWKV-6."""
    h, kv, _ = cfg.padded_heads(tp)
    lead = (b // dp, h // tp, kv // tp)
    t += cfg.vlm_patches if cfg.family == "vlm" else 0
    if cfg.family == "ssm":
        return []
    out = [(lead + (t, t, cfg.d_head), True)]
    if cfg.family == "encdec":
        te = t // 2
        out += [(lead + (te, te, cfg.d_head), False), (lead + (t, te, cfg.d_head), False)]
    return out


def tpt_flash_shapes():
    """(tag, (B, Hq, Hkv, Tq, Tk, Dh), dtype name, causal) of each kind of
    ``flash_attention`` launch a run of phase 17 makes at one rank, each
    once: (a) llama and whisper in bf16 at 2 x 512 and 8 x 448, (b) granite
    in fp32 at 2 x 512, (c) each of its archs in fp32 at 2 x 128
    (``tpt_rank_attn``), at tp 1 (the (d) runs' shapes) and on each of
    ``TPT_MESHES``."""
    runs = [("(a) llama3.2-3b", tpf_cfg("llama3.2-3b", TPT_LAYERS), TPT_BATCH, TPT_SEQ),
            ("(a) whisper-tiny", tpf_cfg("whisper-tiny"), 8, 448),
            ("(b) granite-moe-1b-a400m", tpt_moe_cfg(), 2, 512)]
    runs += [(f"(c) {arch}", tpt_grad_cfg(arch), TPT_GRAD_BATCH, TPT_GRAD_SEQ)
             for arch in TPT_GRAD_ARCHS]
    out, seen = [], set()
    for tag, cfg, b, t in runs:
        for dp, tp in [(1, 1)] + TPT_MESHES:
            for shape, causal in tpt_rank_attn(cfg, b, t, dp, tp):
                if (shape, cfg.dtype, causal) not in seen:
                    seen.add((shape, cfg.dtype, causal))
                    out.append((f"tp train {tag} ({dp}, {tp}) rank", shape, cfg.dtype, causal))
    return out


def tpt_sketch(name, t, whole, idx, k=TPT_SKETCHES):
    """(Σ t², the k sketches Σ t · (u_1 ⊗ ... ⊗ u_n)[idx]) of a piece ``t``
    at index ``idx`` of a leaf of shape ``whole``, fp32 on the card; the
    u_d ~ N(0, 1) of each dim are drawn whole from a generator seeded by
    (name, sketch, dim), so the ranks' pieces of a leaf sum to the whole
    leaf's sketch. A sketch of a difference has the spread of its norm: a
    leaf whose sketches lie within e·‖g‖ of another's differs from it by
    about e of its norm."""
    import zlib

    import torch

    x = t.detach().float()
    out = [float(x.square().sum())]
    for j in range(k):
        y = x
        for d in reversed(range(x.dim())):
            gen = torch.Generator(device=x.device).manual_seed(zlib.crc32(f"{name}/{j}/{d}".encode()))
            u = torch.randn(whole[d], generator=gen, device=x.device)[idx[d]]
            y = y @ u
        out.append(float(y))
    return out


def tpt_state_sketch(model, shard=None, before=None):
    """name -> (gradient sketch, parameter sketch) of every parameter of
    ``model`` (``tpt_sketch``): its pieces under a ``shard`` (the counted
    ones only), the whole leaves otherwise. With ``before`` (the parameters
    before the step, whole) the second is the update's sketch, its norm
    exact."""
    out = {}
    for name, p in model.named_parameters():
        if shard is not None and not shard.counted(name):
            continue
        whole, idx = model.tp_layout.get(name, (tuple(p.shape), tuple(slice(0, n) for n in p.shape)))
        x = p.detach().float() if before is None else p.detach().float() - before[name]
        out[name] = (tpt_sketch(name, p.grad, whole, idx) if p.grad is not None else None,
                     tpt_sketch(name, x, whole, idx))
    return out


def tpt_train(argv, cfg):
    """``launch.train.main(argv, info, cfg=cfg)`` in this process (a rank or
    the smoke's own), its counts zeroed just before and read just after,
    the flash launches' (q, k) shapes and each MoE call's routes (this
    rank's rows), expert loads and the first call's output recorded, and
    the bytes of the state the rank holds (``info["state_bytes"]``: params,
    m, v, residual). Returns (losses, info, the MoE record)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import layers

    info, rec = {}, {"routes": [], "loads": [], "outputs": []}
    real_moe = layers.moe_ffn

    def recording_moe(params, x, **kw):
        out = real_moe(params, x, **kw)
        logits = x.detach().reshape(-1, x.shape[-1]).float() @ params["router"].detach()
        top = torch.sort(torch.softmax(logits, -1), dim=-1, descending=True, stable=True).indices
        rec["routes"].append(top[:, :kw["top_k"]].sort(-1).values.cpu().numpy())
        rec["loads"].append(out[2].detach().cpu().numpy())
        if not rec["outputs"]:
            rec["outputs"].append(out[0].detach().float().cpu().numpy())
        return out

    real_build = train.build_state

    def build(*a, **kw):  # the bytes of the state the rank holds
        model, state = real_build(*a, **kw)
        info["state_bytes"] = {k: sum(t.numel() * t.element_size() for t in tree.values())
                               for k, tree in (("params", state["params"]), ("m", state["opt"]["m"]),
                                               ("v", state["opt"]["v"]),
                                               ("residual", state["residual"]))}
        return model, state

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    layers.moe_ffn, train.build_state = recording_moe, build
    try:
        with FlashShapes() as fl:
            ops.reset_launch_counts()
            losses = train.main(argv, info=info, cfg=cfg)
            info["counts"] = ops.launch_counts()
    finally:
        layers.moe_ffn, train.build_state = real_moe, real_build
    if info["peak_bytes"] is not None:
        info["peak_bytes"] -= base  # what the run itself held at its peak
    info["flash_shapes"] = sorted(set(fl.shapes))
    info["flash_keys"] = sorted(set(fl.keys))
    info.pop("grad_flags", None)
    torch.cuda.empty_cache()
    return losses, info, rec


def tpt_step(cfg, tp=None):
    """``TPT_GRAD_STEPS[cfg.name]`` (else 1) training steps on ``cfg`` at a
    constant lr (``TPT_GRAD_LR``) on the first 2 x 128 batches of
    ``SyntheticTokens``, each ``launch.train.make_step``'s without remat:
    ``lm.loss_fn`` + ``backward()`` + ``lm.reduce_grads`` +
    ``optim.adamw.adamw_update``; with no process group at ``tp`` None, else
    on this rank's train shard of a (world / tp, tp) mesh of the group
    already joined. Returns (the losses, info: the first step's
    collectives, the steps' launch counts and flash launches
    (``flash_keys``), the first gradient's global norm
    (``optim.adamw.global_norm`` on this rank's pieces: the function AdamW's
    clip calls) and each leaf's sketches — the first step's gradient's, and
    the steps' update's, the latter as the difference of the parameters'
    sketches over ranks (no copy of the parameters: both ranks' state
    shares the card), with its exact norm on one rank — each step's wall
    (host clock to the loss's sync) and the peak memory the call added, an
    empty MoE record). A second step reads the moments the first wrote."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshes
    from repro_torch.launch import sharding, train
    from repro_torch.models import lm
    from repro_torch.models.tp import NO_SHARD
    from repro_torch.optim import adamw

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    shard = NO_SHARD
    if tp is not None:
        shard = sharding.shard_for(cfg, meshes.make_local_mesh(tp, "cuda"), mode="train")
    rows, shard = sharding.rank_rows(shard, TPT_GRAD_BATCH)
    model, state = train.build_state(cfg, dev, tp or 1, 0, shard)
    params = state["params"]
    sharded = shard if shard.mesh.size > 1 else None
    before = (tpt_state_sketch(model, sharded) if sharded is not None
              else {n: p.detach().float().clone() for n, p in params.items()})
    data = SyntheticTokens(cfg, ShapeConfig("tpt", TPT_GRAD_SEQ, TPT_GRAD_BATCH, "train"), seed=0)
    walls = []

    def step(i):
        t0 = time.perf_counter()
        batch = {k: torch.as_tensor(v[rows]).to(dev) for k, v in data.batch_at(i).items()}
        for p in params.values():
            p.grad = None
        loss, _ = lm.loss_fn(model, cfg, batch, tp=tp or 1, remat=False, shard=shard)
        loss.backward()
        lm.reduce_grads(model, shard)
        adamw.adamw_update({n: p.grad for n, p in params.items()}, state["opt"], params,
                           TPT_GRAD_LR, shard=shard)
        loss = loss.item()  # the device sync that ends the step
        walls.append(time.perf_counter() - t0)
        return loss

    with FlashShapes() as fl:
        ops.reset_launch_counts()
        coll0 = {op: list(v) for op, v in shard.stats.items()}
        losses = [step(0)]
        info = dict(collectives={op: [n - coll0.get(op, [0, 0])[0], b - coll0.get(op, [0, 0])[1]]
                                 for op, (n, b) in shard.stats.items()
                                 if n - coll0.get(op, [0, 0])[0]})
        info["grad_norm"] = float(adamw.global_norm({n: p.grad for n, p in params.items()}, shard))
        first = {n: g for n, (g, _) in tpt_state_sketch(model, sharded).items()}
        losses += [step(i) for i in range(1, TPT_GRAD_STEPS.get(cfg.name, 1))]
        info["counts"] = ops.launch_counts()
    info["flash_keys"] = sorted(set(fl.keys))
    info["step_s"], info["peak_bytes"] = walls, torch.cuda.max_memory_allocated() - base
    if sharded is None:
        after = {n: x for n, (_, x) in tpt_state_sketch(model, before=before).items()}
    else:
        after = {n: [float("nan")] + [a - b for a, b in zip(x[1:], before[n][1][1:])]
                 for n, (_, x) in tpt_state_sketch(model, sharded).items()}
    info["sketch"] = {n: (first[n], after[n]) for n in after}
    del model, state, params, before
    torch.cuda.empty_cache()
    return losses, info, {}


def tpt_jobs(tp, backend, store):
    """The runs of one rank of phase 17 at ``--tp tp`` (world 2): (a)'s
    llama and whisper and (b) through the launcher, then each of (c), as
    (kind, argv or tp, cfg)."""
    dist = ["--tp", str(tp), "--dist-backend", backend, "--dist-init", f"file://{store}"]
    jobs = [("main", TPT_ARGS + dist, tpf_cfg("llama3.2-3b", TPT_LAYERS)),
            ("main", TPT_WHISPER_ARGS + dist, tpf_cfg("whisper-tiny")),
            ("main", TPT_MOE_ARGS + dist, tpt_moe_cfg())]
    jobs += [("step", tp, tpt_grad_cfg(arch)) for arch in TPT_GRAD_ARCHS]
    return jobs


def tpt_run(job):
    kind, arg, cfg = job
    return tpt_train(arg, cfg) if kind == "main" else tpt_step(cfg, arg)


def tpt_rank(rank, jobs, go=None):
    """One rank of phase 17 (a spawned process): cuBLAS's workspaces taken
    first (``tp_rank``), the modules a training step imports at its first
    call imported, its group joined as the first job's argv says (the
    launcher then joins it as it is); then, when the file ``go`` exists
    (the smoke's own runs are done: a rank starts while they run), one step
    of a reduced model over the group (its first-call costs), then each
    job (``tpt_run``)."""
    sys.path.insert(0, SRC)
    import importlib

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshes

    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.ones((64, 64), device="cuda", dtype=torch.bfloat16)
    _ = (a @ a, torch.mm(a, a, out_dtype=torch.float32), a.float() @ a.float(),
         torch.bmm(a[None], a[None]))
    torch.cuda.synchronize()
    del a, _
    for name in ("torch.utils.checkpoint", "torch.distributed.tensor", "torch._dynamo"):
        importlib.import_module(name)
    argv0 = jobs[0][1]
    backend = argv0[argv0.index("--dist-backend") + 1]
    meshes.init_ranks(backend, torch.device("cuda"), argv0[argv0.index("--dist-init") + 1])
    while go is not None and not os.path.exists(go):
        time.sleep(0.05)
    if go is not None and open(go).read() == "stop":  # the smoke failed before phase 17
        return []
    t0 = time.perf_counter()
    tpt_step(get_config("llama3.2-3b").reduced(), torch.distributed.get_world_size())
    walls = [time.perf_counter() - t0]
    out = []
    for job in jobs:
        t0 = time.perf_counter()
        out.append(tpt_run(job))
        walls.append(time.perf_counter() - t0)
    out[0][1]["walls_s"] = walls  # the warm-up step's, then each job's
    return out


def tpt_grad_check(arch, want, runs, what):
    """Holds the ranks' summed sketches (``tpt_state_sketch``) of every
    gradient leaf to tp 1's within ``TPT_GRAD_TOL`` of the leaf's norm (the
    norm too), and of every update within ``TPT_UPDATE_TOL`` of the
    update's norm. Returns the worst relative errors (gradients,
    updates)."""
    import numpy as np

    worst = [0.0, 0.0]
    for name in sorted(want):
        check(any(name in r for r in runs), f"tp train (c) {arch} {what}: {name} held by a rank")
        for j, tol in ((0, TPT_GRAD_TOL), (1, TPT_UPDATE_TOL)):
            ref = np.array(want[name][j])
            got = sum(np.array(r[name][j]) for r in runs if name in r)
            norm = np.sqrt(ref[0])
            err = float(np.abs(got[1:] - ref[1:]).max())
            if j == 0:
                err = max(err, abs(np.sqrt(max(got[0], 0.0)) - norm))
            rel = err / norm if err else 0.0
            worst[j] = max(worst[j], rel)
            check(rel <= tol, f"tp train (c) {arch} {what}: {('gradient', 'update')[j]} of {name} "
                              f"within {tol} of its norm ({rel:.3e})")
    return worst


def tpt_moe_check(want, got, dp, what):
    """(b): the ranks' MoE record against tp 1's: routes of every call (the
    data ranks' rows concatenated), expert loads (the plan's, over the
    whole batch: so its dropped pairs), the first call's output. Returns
    the numbers it read."""
    import numpy as np

    cfg = tpt_moe_cfg()
    recs = [g[2] for g in got]
    n_calls = len(want["routes"])
    check(all(len(r["routes"]) == n_calls for r in recs), f"tp train (b) {what}: as many MoE calls as tp 1")
    routes = ([np.concatenate([r["routes"][i] for r in recs]) for i in range(n_calls)]
              if dp > 1 else recs[0]["routes"])
    flips = sum(int((a != b).any(-1).sum()) for a, b in zip(routes, want["routes"]))
    loads_equal = all(np.array_equal(r["loads"][i], want["loads"][i])
                      for r in recs for i in range(n_calls))
    n_tok = 2 * 512
    cap = int(cfg.moe.capacity_factor * n_tok * cfg.moe.top_k / cfg.moe.n_experts)
    cap = max(8, -(-cap // 8) * 8)
    drops = [int(np.maximum(load - cap, 0).sum()) for load in want["loads"]]
    out1 = want["outputs"][0]
    outs = np.concatenate([r["outputs"][0] for r in recs]) if dp > 1 else recs[0]["outputs"][0]
    y_err = float(np.abs(outs - out1).max())
    y_scale = max(1.0, float(np.abs(out1).max()))
    check(flips == 0, f"tp train (b) {what}: every MoE call routes every token as tp 1 ({flips} differ)")
    check(loads_equal, f"tp train (b) {what}: every MoE call's expert loads (so its dropped pairs) "
                       "equal tp 1's")
    check(sum(drops) > 0, f"tp train (b) {what}: pairs were dropped")
    check(y_err <= TPT_GRAD_TOL * y_scale,
          f"tp train (b) {what}: the first MoE layer's output within {TPT_GRAD_TOL} of its scale")
    return dict(calls=n_calls, flips=flips, loads_equal=loads_equal, cap=cap, drops=drops,
                y_err=y_err, y_scale=y_scale)


def tpt_start():
    """Phase 17's two ranks spawned ahead of the phase (a background thread
    joins them with a timeout): their processes, imports and gloo group
    get ready while other work runs, and they wait for ``tpt_release``.
    Returns what ``phase_tp_train`` takes."""
    from repro_torch.launch import mesh as meshes

    store, go = tp_store("tpt-gloo"), tp_store("tpt-go")
    jobs = [tpt_jobs(tp, "gloo", store) for _, tp in TPT_MESHES]
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(meshes.spawn, tpt_rank, 2,
                         ([job for mesh_jobs in jobs for job in mesh_jobs], go),
                         timeout=TPT_TIMEOUT)
    return dict(jobs=jobs, go=go, pool=pool, future=future, t0=time.perf_counter())


def tpt_release(pending, run: bool = True) -> None:
    """Lets the ranks of ``tpt_start`` run their jobs, or (``run`` False)
    return at once."""
    with open(pending["go"], "w") as f:
        f.write("run" if run else "stop")


def phase_tp_train(pending=None):
    """(a) Llama-3.2-3B (2 of 28 layers, full width, bf16, 2 x 512, 3 steps)
    through ``launch.train.main`` at tp 1 in this process, in fp32 at tp 1
    (the bf16 floor), then as two gloo ranks on cuda:0 at ``--tp 2`` (mesh
    (1, 2), TP) and ``--tp 1`` (mesh (2, 1), FSDP) (spawned; a file store
    under ``build/chip_smoke/tp``; one group for both meshes, its ranks
    started while tp 1 runs; joined with a timeout): step ms,
    tokens/s, peak a rank, collectives a step; flash launches a step by
    body, ``wgmma`` at 12 local heads under TP; losses equal on both ranks
    and within the bf16 run's distance from fp32 of tp 1's; the same for
    whisper-tiny (full width and depth, bf16, 8 x 448, 224 frames, 3 steps;
    wgmma at 3 local heads under TP: encoder, self- and cross-attention).
    (b)
    granite-moe-1b-a400m (2 of 24 layers, full width, fp32, capacity factor
    1.0), one step at 2 x 512, at tp 1 and in the same ranks (EP on (1, 2), the whole-batch
    plan on (2, 1)): every MoE call's routes and expert loads (so its
    dropped pairs) equal to tp 1's, the loss within ``TPT_LOSS_TOL``. (c)
    Full-width fp32 layers of llama, granite, internvl, rwkv6, zamba2 and
    whisper at ``tpt_grad_cfg``'s depths, a training step at 2 x 128
    (``tpt_step``; granite two): the losses, the gradient's global norm,
    every gradient leaf and each leaf's update against tp 1's (sketches);
    every flash launch of the ranks and of (d) at a shape phase 5 holds to
    the plain version. (d) NCCL at world 1: (a)'s losses and
    (c)'s llama sketches bit-equal to the run with no group (in this
    process, while the ranks start); with two cards, (a) at tp 2 over NCCL
    on cuda:0-1. ``pending``: the ranks ``tpt_start`` spawned ahead (else
    they are spawned here). Returns the ranks' launch counts, with (d)'s,
    and (a)'s infos, mesh -> [llama's, whisper's], each [rank 0's, rank
    1's] (phase 18 reads them)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.launch import mesh as meshes
    from repro_torch.models import lm

    card = card_line()
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # The ranks start (their processes and imports, on the host) before this
    # process runs tp 1 (in the smoke, while phase 16 runs: ``tpt_start``);
    # they touch the card once the file `go` says so.
    t0 = time.perf_counter()
    pending = pending or tpt_start()
    jobs, go, pool, spawned = pending["jobs"], pending["go"], pending["pool"], pending["future"]
    try:
        llama, whisper = tpf_cfg("llama3.2-3b", TPT_LAYERS), tpf_cfg("whisper-tiny")
        ref_a = tpt_train(TPT_ARGS, llama)
        fine_a = tpt_train(TPT_ARGS, tpf_cfg("llama3.2-3b", TPT_LAYERS, "float32"))
        ref_w = tpt_train(TPT_WHISPER_ARGS, whisper)
        fine_w = tpt_train(TPT_WHISPER_ARGS, tpf_cfg("whisper-tiny", None, "float32"))
        ref_b = tpt_train(TPT_MOE_ARGS, tpt_moe_cfg())
        ref_c = {arch: tpt_step(tpt_grad_cfg(arch)) for arch in TPT_GRAD_ARCHS}
        log(f"tp train: tp 1 runs {time.perf_counter() - t0:.1f}s")
        # (d) here too, while the ranks start: a group of one rank over NCCL
        t1 = time.perf_counter()
        meshes.init_ranks("nccl", torch.device("cuda"), f"file://{tp_store('tpt-nccl-1')}")
        try:
            one = [tpt_run(("main", TPT_ARGS + ["--dist-backend", "nccl"], llama)),
                   tpt_run(("step", 1, family_parity_cfg("llama3.2-3b")))]
        finally:
            torch.distributed.destroy_process_group()
        t_nccl = time.perf_counter() - t1
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        tpt_release(pending)
        ranks = spawned.result()
        pool.shutdown()
    log(f"tp train: meshes {TPT_MESHES} as two gloo ranks on cuda:0 (one group), "
        f"{time.perf_counter() - pending['t0']:.1f}s from their spawn (tp 1's runs and "
        f"anything before the phase included), {time.perf_counter() - t0:.1f}s in this phase")
    floor = max(abs(a - b) for a, b in zip(ref_a[0], fine_a[0]))
    loss_tol = max(floor, 1e-4)
    floor_w = max(abs(a - b) for a, b in zip(ref_w[0], fine_w[0]))
    n_jobs = len(jobs[0])
    runs = {mesh: [rank_runs[i * n_jobs:(i + 1) * n_jobs] for rank_runs in ranks]
            for i, mesh in enumerate(TPT_MESHES)}
    walls = ranks[0][0][1]["walls_s"]
    log("tp train: rank 0's walls (s): warm-up step " + f"{walls[0]:.1f}, then "
        + ", ".join(f"{mesh} {what} {w:.1f}" for (mesh, what), w in zip(
            [(m, w) for m in TPT_MESHES for w in ["(a)", "(a) whisper", "(b)"]
             + [f"(c) {a}" for a in TPT_GRAD_ARCHS]],
            walls[1:])))
    launched = set()  # (q shape, k shape, dtype, causal) of the ranks' and (d)'s flash launches
    infos = {mesh: [[rank_runs[j][1] for rank_runs in ranks] for j in (0, 1)]
             for mesh, ranks in runs.items()}
    for (dp, tp), ranks in runs.items():
        what = f"({dp}, {tp})"
        for rank_runs in ranks:
            for _, info, _ in rank_runs:
                add(info["counts"])
                launched.update(info["flash_keys"])
        # (a): llama, whisper
        for j, cfg, ref, fine, tol, b, t in ((0, llama, ref_a, fine_a, loss_tol, TPT_BATCH, TPT_SEQ),
                                            (1, whisper, ref_w, fine_w, max(floor_w, 1e-4), 8, 448)):
            arch = cfg.name
            n = lm.attention_calls(cfg)[0]
            local = sorted(((bq, hq, tq, dh), (bq, hkv, tk, dh))
                           for (bq, hq, hkv, tq, tk, dh), _ in tpt_rank_attn(cfg, b, t, dp, tp))
            for r, rank_runs in enumerate(ranks):
                losses, info, _ = rank_runs[j]
                check(info["rank_losses"] == [losses, losses],
                      f"tp train (a) {arch} {what} rank {r}: the losses equal on both ranks")
                check(len(losses) == TPT_STEPS and np.isfinite(losses).all(),
                      f"tp train (a) {arch} {what}: finite losses")
                diff = max(abs(x - y) for x, y in zip(losses, ref[0]))
                check(diff <= tol, f"tp train (a) {arch} {what}: losses within the bf16 run's distance "
                                   f"from fp32 of tp 1's ({diff:.5f} <= {tol:.5f})")
                check(all(bd.get("wgmma", 0) == n and sum(bd.values()) == n for bd in info["flash_bodies"]),
                      f"tp train (a) {arch} {what} rank {r}: {n} flash launches a step, all wgmma")
                check(info["flash_shapes"] == local,
                      f"tp train (a) {arch} {what} rank {r}: flash at {info['flash_shapes']} == {local}")
                ops = set(info["collectives"][0]) - {"world_all_reduce_sum"}  # the clip's norm
                need, allowed = (({"all_reduce_sum"}, {"all_reduce_sum", "all_gather"}) if tp > 1 else
                                 ({"data_all_gather", "data_reduce_scatter"},
                                  {"data_all_gather", "data_reduce_scatter", "data_all_reduce_sum"}))
                check(all(c == info["collectives"][0] for c in info["collectives"])
                      and need <= ops <= allowed,
                      f"tp train (a) {arch} {what} rank {r}: the same collectives every step, over "
                      f"the mesh's groups only ({sorted(ops)})")
                check(all(p < ref[1]["peak_bytes"] for p in info["peak_bytes_per_rank"]),
                      f"tp train (a) {arch} {what}: each rank's peak memory below tp 1's")
                if r == 0:
                    coll = info["collectives"][-1]
                    log(f"tp train (a) {arch} ({cfg.n_layers} layers) mesh {what} gloo B={b} seq={t} "
                        f"[{card}]: losses={[round(x, 5) for x in losses]} (tp 1: "
                        f"{[round(x, 5) for x in ref[0]]}; fp32: {[round(x, 5) for x in fine[0]]}; "
                        f"bf16 floor {tol:.5f}) step_ms={[round(x * 1e3, 3) for x in info['step_s']]} "
                        f"(tp 1: {[round(x * 1e3, 3) for x in ref[1]['step_s']]}) tokens_per_s="
                        f"{b * t / min(info['step_s']):.1f} (tp 1: {b * t / min(ref[1]['step_s']):.1f}) "
                        f"peak_GiB per rank={[round(x / 2**30, 3) for x in info['peak_bytes_per_rank']]} "
                        f"(tp 1: {ref[1]['peak_bytes'] / 2**30:.3f}) flash a step="
                        f"{info['flash_bodies'][-1]} shapes={info['flash_shapes']}")
                    log(f"tp train (a) {arch} mesh {what} collectives a step (count, bytes a rank): "
                        + ", ".join(f"{op} {n_} {nb}" for op, (n_, nb) in sorted(coll.items())))
        # (b)
        got = [rank_runs[2] for rank_runs in ranks]
        m = tpt_moe_check(ref_b[2], got, dp, what)
        loss_b = got[0][0][0]
        log(f"tp train (b) granite-moe-1b-a400m ({TPT_MOE_LAYERS} layers, fp32) mesh {what}: "
            f"loss={loss_b:.6f} (tp 1: {ref_b[0][0]:.6f}) MoE calls={m['calls']} tokens routed "
            f"differently={m['flips']} loads equal={int(m['loads_equal'])} dropped pairs a call (tp 1, "
            f"capacity {m['cap']}): {m['drops']}; first MoE output max_abs_err={m['y_err']:.3e} (scale "
            f"{m['y_scale']:.3f}); step_ms={got[0][1]['step_s'][0] * 1e3:.1f} (tp 1: "
            f"{ref_b[1]['step_s'][0] * 1e3:.1f}) peak_GiB per rank="
            f"{[round(x / 2**30, 3) for x in got[0][1]['peak_bytes_per_rank']]}")
        check(all(g[0] == got[0][0] for g in got), f"tp train (b) {what}: the loss equal on both ranks")
        check(abs(loss_b - ref_b[0][0]) <= TPT_LOSS_TOL * abs(ref_b[0][0]),
              f"tp train (b) {what}: the loss within {TPT_LOSS_TOL} of tp 1's")
        # (c)
        for i, arch in enumerate(TPT_GRAD_ARCHS):
            out = [rank_runs[3 + i] for rank_runs in ranks]
            losses, losses1 = out[0][0], ref_c[arch][0]
            check(len(losses) == len(losses1) == TPT_GRAD_STEPS.get(arch, 1),
                  f"tp train (c) {arch} {what}: {TPT_GRAD_STEPS.get(arch, 1)} steps run")
            check(all(o[0] == losses for o in out), f"tp train (c) {arch} {what}: the losses equal on both ranks")
            for j, (loss, loss1) in enumerate(zip(losses, losses1)):
                check(abs(loss - loss1) <= TPT_LOSS_TOL * abs(loss1),
                      f"tp train (c) {arch} {what}: step {j} loss {loss:.6f} within {TPT_LOSS_TOL} of "
                      f"tp 1's {loss1:.6f}")
            norm, norm1 = out[0][1]["grad_norm"], ref_c[arch][1]["grad_norm"]
            norm_err = abs(norm - norm1) / norm1
            check(all(o[1]["grad_norm"] == norm for o in out),
                  f"tp train (c) {arch} {what}: the gradient's global norm equal on both ranks")
            check(norm_err <= TPT_NORM_TOL, f"tp train (c) {arch} {what}: the gradient's global norm "
                                            f"{norm:.6f} within {TPT_NORM_TOL} of tp 1's {norm1:.6f}")
            worst = tpt_grad_check(arch, ref_c[arch][1]["sketch"], [o[1]["sketch"] for o in out], what)
            layers = tpt_grad_cfg(arch).n_layers
            step_s, step1_s = out[0][1]["step_s"], ref_c[arch][1]["step_s"]
            tokens = TPT_GRAD_BATCH * TPT_GRAD_SEQ
            log(f"tp train (c) {arch} ({layers} layers, fp32, {len(losses)} steps) mesh {what} [{card}]: "
                f"losses={[round(x, 6) for x in losses]} (tp 1 {[round(x, 6) for x in losses1]}) global norm "
                f"{norm:.6f} (tp 1 {norm1:.6f}, relative error {norm_err:.3e}); worst gradient / update "
                f"error over {len(ref_c[arch][1]['sketch'])} leaves, relative to the leaf's norm: "
                f"{worst[0]:.3e} / {worst[1]:.3e}; step_ms={[round(x * 1e3, 3) for x in step_s]} (tp 1: "
                f"{[round(x * 1e3, 3) for x in step1_s]}) tokens_per_s={tokens / min(step_s):.1f} (tp 1: "
                f"{tokens / min(step1_s):.1f}) peak_GiB per rank="
                f"{[round(o[1]['peak_bytes'] / 2**30, 3) for o in out]} (tp 1: "
                f"{ref_c[arch][1]['peak_bytes'] / 2**30:.3f}); collectives a step (count, bytes a rank): "
                + ", ".join(f"{op} {n_} {nb}" for op, (n_, nb) in sorted(out[0][1]["collectives"].items())))
    del runs
    gc.collect()
    torch.cuda.empty_cache()

    # (d), run above
    for _, info, _ in one:
        add(info["counts"])
        launched.update(info["flash_keys"])
    held = {((b, hq, tq, dh), (b, hkv, tk, dh), dtype, causal)
            for _, (b, hq, hkv, tq, tk, dh), dtype, causal in tpt_flash_shapes()}
    check(launched <= held, f"tp train: every flash launch at a shape phase 5 held to the plain "
                            f"version (not held: {sorted(launched - held)})")
    log(f"tp train: flash launched at {len(launched)} (q, k, dtype, causal) keys, each held in phase 5")
    check(one[0][1]["backend"] == "nccl" and one[0][1]["world"] == 1,
          "tp train (d): the NCCL group of one rank ran")
    check(one[0][0] == ref_a[0], "tp train (d): NCCL at world 1 gives tp 1's losses bit for bit")
    check(one[1][1]["sketch"] == ref_c["llama3.2-3b"][1]["sketch"]
          and one[1][1]["grad_norm"] == ref_c["llama3.2-3b"][1]["grad_norm"],
          "tp train (d): NCCL at world 1 gives tp 1's gradients, norm and update bit for bit (sketches)")
    log(f"tp train (d) NCCL world 1: (a)'s losses and (c)'s llama sketches bit-equal to the run with "
        f"no group; {t_nccl:.1f}s")
    if torch.cuda.device_count() >= 2:
        t0 = time.perf_counter()
        store = tp_store("tpt-nccl-2")
        ranks = meshes.spawn(tpt_rank, 2, ([("main", TPT_ARGS + ["--tp", "2", "--dist-backend", "nccl",
                                                                 "--dist-init", f"file://{store}"],
                                             llama)],), timeout=TPT_TIMEOUT)
        for r, rank_runs in enumerate(ranks):
            add(rank_runs[0][1]["counts"])
            diff = max(abs(a - b) for a, b in zip(rank_runs[0][0], ref_a[0]))
            check(diff <= loss_tol, f"tp train (d) rank {r}: NCCL on two cards within the bf16 floor")
        log(f"tp train (d) NCCL on cuda:0-1: losses={ranks[0][0][0]} step_ms="
            f"{[round(s * 1e3, 3) for s in ranks[0][0][1]['step_s']]}; {time.perf_counter() - t0:.1f}s")
    else:
        log(f"tp train (d) NCCL across two cards: not run: {torch.cuda.device_count()} card(s)")
    return total, infos


# ----------------------------------------------------------------------------
# Phase 18: the dry run, held to phases 14 and 17's runs
# ----------------------------------------------------------------------------

# (b) cells of the dry run's CLI at production size (rank 0 of the (16, 16)
# mesh): a dense training cell and an SSM decode cell.
DRY_CELLS = [("llama3.2-3b", "train_4k"), ("rwkv6-7b", "decode_32k")]
# (a) A phase-17 rank's measured peak (``peak_bytes``: its run's
# ``max_memory_allocated`` above what it held before) against the dry run's
# live peak (argument + temp) plus the fp32 residual the launcher allocates
# beside the state (the dry run's state is JAX's, which has none). Read
# from the 8 ranks of phase 17 (a) (llama and whisper, both meshes;
# NVIDIA H100 80GB HBM3 at 700 W): 1.0005-1.0048, the excess the
# allocator's 512-byte rounding and what gloo stages. The bound's floor:
# a run holds at least its live tensors; its ceiling sits 4 x above the
# largest excess read, and far below the 1.19-1.22 a prediction without
# the residual reads.
DRY_PEAK_RATIO = (1.0, 1.02)


def dry_rank(cfg, kind, mesh, rank, inputs, mode, cache_len=None):
    """``launch.dryrun.dry_run_rank`` of rank ``rank`` of a (data, model)
    ``mesh`` in ``mode``: one ``kind`` step on meta stand-ins of the whole
    batch's ``inputs`` (name -> (shape, torch dtype)) and a cache of
    ``cache_len`` positions."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.sharding import rank_coords

    m = MeshShape(("data", "model"), tuple(mesh))
    c = rank_coords(m, rank)
    meta = {k: torch.empty(shape, dtype=dt, device="meta") for k, (shape, dt) in inputs.items()}
    b, t = inputs["tokens"][0]
    shape = ShapeConfig(f"dry-{kind}", cache_len or t, b, kind)
    return dryrun.dry_run_rank(cfg, shape, m, tuple(c[a] for a in m.axis_names), mode=mode,
                               inputs=meta, cache_len=cache_len)


def phase_dryrun(train_read, tp_infos, tpt_infos):
    """(a) The dry run (``launch.dryrun``, meta tensors, shards in counting
    mode) of every rank phases 14 and 17 ran, held to what the ranks
    measured: phase 17 (a)'s llama (2 layers, bf16, 2 x 512) and whisper
    (8 x 448) on (1, 2) and (2, 1) — each training step's collectives by
    op, count and bytes equal the launcher's, the parameter and AdamW
    bytes (``alias``) equal the pieces the rank held, and the predicted
    live peak (+ the launcher's residual) against the measured peak
    (``DRY_PEAK_RATIO``); phase 14 (a)'s llama and granite at tp 2 (4 x
    512, 8 generated) — the prefill's collectives, and the decode's over
    its 7 steps. (b) The CLI on ``DRY_CELLS`` at production size: status
    ok, no card memory allocated at any point and no kernel launched in
    the phase. (c) The dry run's FLOPs of phase 11 (b)'s step (full-width
    Llama-3.2-3B, 1 x 4,096, tp 1) over its measured median wall: the
    achieved rate, beside phase 11's share of the bf16 peak from
    ``model_flops``."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun

    card = card_line()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0, counts0, meta0 = torch.cuda.memory_allocated(), ops.launch_counts(), fa.META_CALLS
    i32, f32 = torch.int32, torch.float32

    # (a) phase 17: training steps
    t0 = time.perf_counter()
    runs = ((tpf_cfg("llama3.2-3b", TPT_LAYERS), TPT_BATCH, TPT_SEQ),
            (tpf_cfg("whisper-tiny"), 8, 448))
    ratios = []
    for (dp, tp), mesh_infos in tpt_infos.items():
        for (cfg, b, t), infos in zip(runs, mesh_infos):
            inputs = {"tokens": ((b, t + 1), i32)}
            if cfg.family == "encdec":
                inputs["frames"] = ((b, max(t // 2, 1), cfg.d_model), f32)
            for r, info in enumerate(infos):
                rec = dry_rank(cfg, "train", (dp, tp), r, inputs, "train")
                what = f"dry run (a) {cfg.name} ({dp}, {tp}) rank {r}"
                check(all(c == rec["collectives"] for c in info["collectives"]),
                      f"{what}: every training step's collectives equal the dry run's "
                      f"({sorted(rec['collectives'].items())})")
                sb, bpd = info["state_bytes"], rec["bytes_per_device"]
                held = sb["params"] + sb["m"] + sb["v"] + 4  # + AdamW's int32 step
                check(bpd["alias"] == held, f"{what}: params and moments {bpd['alias']} B == the "
                                            f"pieces the rank held, {held} B")
                live = bpd["argument"] + bpd["temp"]
                ratio = info["peak_bytes"] / (live + sb["residual"])
                ratios.append(ratio)
                log(f"{what} [{card}]: collectives a step {sorted(rec['collectives'].items())}; "
                    f"argument={bpd['argument']} temp={bpd['temp']} peak(JAX's formula)={bpd['peak']} "
                    f"live peak={live} + residual {sb['residual']} = {live + sb['residual']} B; "
                    f"measured peak {info['peak_bytes']} B, ratio {ratio:.4f}; "
                    f"flops={rec['hlo_flops']:.6e} bytes={rec['hlo_bytes']:.6e} "
                    f"pass {rec['compile_s']:.2f}s")
                check(DRY_PEAK_RATIO[0] <= ratio <= DRY_PEAK_RATIO[1],
                      f"{what}: measured peak / (live peak + residual) {ratio:.4f} within "
                      f"{DRY_PEAK_RATIO}")
    t_a17 = time.perf_counter() - t0

    # (a) phase 14: prefill and decode steps
    t0 = time.perf_counter()
    steps = TP_GEN - 1
    for arch, infos in tp_infos.items():
        cfg = get_config(arch)
        kw = dict(mode="serve", cache_len=TP_PROMPT + TP_GEN)
        for r, info in enumerate(infos):
            pre = dry_rank(cfg, "prefill", (1, 2), r, {"tokens": ((TP_BATCH, TP_PROMPT), i32)}, **kw)
            dec = dry_rank(cfg, "decode", (1, 2), r, {"tokens": ((TP_BATCH, 1), i32)}, **kw)
            got_pre = {op: v for op, v in info["prefill_collectives"].items() if v[0]}
            got_dec = {op: v for op, v in info["decode_collectives"].items() if v[0]}
            want_dec = {op: [n * steps, nb * steps] for op, (n, nb) in dec["collectives"].items()}
            what = f"dry run (a) {arch} tp 2 rank {r}"
            check(got_pre == pre["collectives"], f"{what}: the prefill's collectives equal the dry run's")
            check(got_dec == want_dec, f"{what}: the decode's collectives equal {steps} x the dry "
                                       "run's step")
            log(f"{what} [{card}]: prefill {sorted(pre['collectives'].items())}; decode step "
                f"{sorted(dec['collectives'].items())}; prefill flops={pre['hlo_flops']:.6e} "
                f"bytes={pre['hlo_bytes']:.6e}, decode step flops={dec['hlo_flops']:.6e} "
                f"bytes={dec['hlo_bytes']:.6e}")
    t_a14 = time.perf_counter() - t0

    # (b) production cells through the CLI
    path = os.path.join(HERE, "build", "chip_smoke", "dryrun.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    walls = []
    for arch, shape in DRY_CELLS:
        t0 = time.perf_counter()
        rc = dryrun.main(["--arch", arch, "--shape", shape, "--out", path])
        walls.append(time.perf_counter() - t0)
        with open(path) as f:
            rec = json.load(f)[-1]
        check(rc == 0 and rec["status"] == "ok", f"dry run (b) {arch} {shape}: status ok")
        bpd = rec["bytes_per_device"]
        log(f"dry run (b) {arch} x {shape} x 1pod (rank 0 of {rec['n_chips']}) [{card}]: wall {walls[-1]:.2f}s "
            f"(pass {rec['compile_s']:.2f}s) hlo_flops={rec['hlo_flops']:.6e} "
            f"hlo_bytes={rec['hlo_bytes']:.6e} collective_bytes={rec['collective_bytes']} "
            f"model_flops={rec['model_flops']:.6e} useful_flops_ratio={rec['useful_flops_ratio']:.4f} "
            f"t_compute={rec['t_compute_s']:.6f}s t_memory={rec['t_memory_s']:.6f}s "
            f"t_collective={rec['t_collective_s']:.6f}s dominant={rec['dominant']} bytes_per_device={bpd}")

    # (c) the achieved rate of phase 11's step
    cfg = get_config("llama3.2-3b")
    t0 = time.perf_counter()
    rec = dry_rank(cfg, "train", (1, 1), 0, {"tokens": ((1, TRAIN_SEQ + 1), i32)}, "train")
    t_c = time.perf_counter() - t0
    rate = rec["hlo_flops"] / train_read["step_s"]
    check(0 < rate <= BF16_OPS_PER_S, f"dry run (c): the achieved rate {rate:.4e} FLOP/s within the "
                                      "bf16 peak")
    log(f"dry run (c) llama3.2-3b train 1 x {TRAIN_SEQ} tp 1 [{card}]: hlo_flops={rec['hlo_flops']:.6e} "
        f"(model_flops 6*N*tokens {rec['model_flops']:.6e}) over phase 11's median step "
        f"{train_read['step_s'] * 1e3:.3f} ms = {rate / 1e12:.3f} TFLOP/s, "
        f"{rate / BF16_OPS_PER_S:.4f} of the bf16 peak (phase 11's bf16_peak_share from its "
        f"model_flops: {train_read['bf16_peak_share']:.4f}); pass {t_c:.2f}s")

    torch.cuda.synchronize()
    check(torch.cuda.memory_allocated() == alloc0 and torch.cuda.max_memory_allocated() == alloc0,
          f"dry run: no card memory allocated in the phase ({alloc0} B before, "
          f"{torch.cuda.memory_allocated()} after, peak {torch.cuda.max_memory_allocated()})")
    check(ops.launch_counts() == counts0, "dry run: no kernel launched in the phase")
    check(fa.META_CALLS > meta0, "dry run: flash_attention's meta branch credited the kernel's work")
    log(f"dry run: phase walls (a) phase 17 {t_a17:.1f}s, phase 14 {t_a14:.1f}s; (b) "
        f"{', '.join(f'{w:.1f}s' for w in walls)}; (c) {t_c:.1f}s; peak ratios "
        f"{min(ratios):.4f}-{max(ratios):.4f}")


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
    pending = None
    try:
        log(card_line())
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        from repro_torch.kernels import _build, ops
        from repro_torch.kernels import flash_attention as fa_mod
        from repro_torch.kernels import segment_sum as ss_mod
        from repro_torch.kernels import window_score as ws_mod

        t0 = time.perf_counter()
        secs = _build.build()
        log(f"build: {time.perf_counter() - t0:.2f}s wall ({', '.join(f'{k} {v:.2f}s' for k, v in secs.items())})")
        for name, text in _build.BUILD_LOGS.items():
            for ln in text.splitlines():
                entry = re.search(r"entry function '\w*?([a-z_]+_kernel\w{0,36})", ln)
                if entry:
                    log(f"ptxas {name}: kernel {entry.group(1)}")
                elif any(w in ln.lower() for w in ("registers", "spill", "error", "warning")):
                    log(f"ptxas {name}: {ln.strip()}")

        from repro_torch.graph import make_graph

        edges, n = make_graph("brain_like", seed=0, scale=1.0)
        log(f"graph brain_like scale=1.0: |V|={n} |E|={len(edges)}")
        t0 = time.perf_counter()
        kernel_rows = phase_kernels(edges, n)
        log(f"phase 1 (kernels vs plain): {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        counts, rd_z1 = phase_main_path(edges, n, k=32, window_max=256)
        log(f"phase 2 (main path): {time.perf_counter() - t0:.1f}s launches={counts}")
        for name in ("window_score", "segment_sum"):
            check(counts[name] > 0, f"{name} launched on the main path")
        t0 = time.perf_counter()
        phase_cpu_parity(k=32)
        log(f"phase 3 (cuda vs cpu): {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        phase_profile(k=32)
        log(f"phase 4 (profile of the step): {time.perf_counter() - t0:.1f}s")

        t0 = time.perf_counter()
        kernel_rows["flash_attention"] = phase_flash()
        log(f"phase 5 (flash_attention vs plain): {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        serve_counts = phase_serve()
        log(f"phase 6 (LM serving): {time.perf_counter() - t0:.1f}s launches={serve_counts}")
        check(serve_counts["flash_attention"] > 0, "flash_attention launched on the serving path")
        counts["flash_attention"] = serve_counts["flash_attention"]
        t0 = time.perf_counter()
        phase_lm_parity()
        log(f"phase 7 (LM cuda vs cpu): {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        cmp_counts, restream_res, cmp_res = phase_comparison(k=32)
        log(f"phase 8 (comparison set): {time.perf_counter() - t0:.1f}s launches={cmp_counts}")
        for name in ("window_score", "segment_sum"):
            check(cmp_counts[name] > 0, f"{name} launched on the comparison set's path")
            counts[name] += cmp_counts[name]
        t0 = time.perf_counter()
        spot_edges, spot_n = make_graph("brain_like", seed=0, scale=SPOT_SCALE)
        spot_counts, spot = phase_spotlight(spot_edges, spot_n, k=32, window_max=256, rd_z1=rd_z1)
        t_a = time.perf_counter() - t0
        phase_spotlight_sweep(k=32)
        t_b = time.perf_counter() - t0 - t_a
        phase_spotlight_parity(k=32)
        t_cd = time.perf_counter() - t0 - t_a - t_b
        phase_tracing(k=32, untraced=restream_res)
        log(f"phase 9 (spotlight and tracing): {time.perf_counter() - t0:.1f}s "
            f"(a {t_a:.1f}s, b {t_b:.1f}s, c+d {t_cd:.1f}s) launches={spot_counts}")
        for name in ("window_score", "segment_sum"):
            check(spot_counts[name] > 0, f"{name} launched on the spotlight path")
            counts[name] += spot_counts[name]
        t0 = time.perf_counter()
        ooc_counts = phase_oocore(spot_edges, spot_n, 32, 256, spot, cmp_res)
        log(f"phase 10 (out-of-core): {time.perf_counter() - t0:.1f}s launches={ooc_counts}")
        for name in ("window_score", "segment_sum"):
            check(ooc_counts[name] > 0, f"{name} launched on the out-of-core path")
            counts[name] += ooc_counts[name]
        t0 = time.perf_counter()
        attn = phase_train_attention()
        t_a = time.perf_counter() - t0
        train_counts, train_read = phase_train(attn)
        t_b = time.perf_counter() - t0 - t_a
        phase_train_parity()
        t_c = time.perf_counter() - t0 - t_a - t_b
        phase_train_launcher()
        log(f"phase 11 (LM training): {time.perf_counter() - t0:.1f}s (a {t_a:.1f}s, b {t_b:.1f}s, "
            f"c {t_c:.1f}s) launches={train_counts}")
        check(train_counts["flash_attention"] > 0, "flash_attention launched on the training path")
        counts["flash_attention"] += train_counts["flash_attention"]
        t0 = time.perf_counter()
        fam_counts = phase_families()
        t_a = time.perf_counter() - t0
        phase_families_parity()
        log(f"phase 12 (LM families): {time.perf_counter() - t0:.1f}s (a {t_a:.1f}s, "
            f"b {time.perf_counter() - t0 - t_a:.1f}s) launches={fam_counts}")
        check(fam_counts["flash_attention"] > 0, "flash_attention launched on the families' path")
        counts["flash_attention"] += fam_counts["flash_attention"]
        t0 = time.perf_counter()
        phase_train_attention(FAMILY_TRAIN_ATTN_SHAPES)
        t_a = time.perf_counter() - t0
        fam_train_counts = phase_family_train()
        t_b = time.perf_counter() - t0 - t_a
        phase_family_train_parity()
        log(f"phase 13 (LM families, training): {time.perf_counter() - t0:.1f}s (a {t_a:.1f}s, "
            f"b {t_b:.1f}s, c {time.perf_counter() - t0 - t_a - t_b:.1f}s) launches={fam_train_counts}")
        check(fam_train_counts["flash_attention"] > 0, "flash_attention launched on the families' training path")
        counts["flash_attention"] += fam_train_counts["flash_attention"]
        t0 = time.perf_counter()
        tp_counts, tp_infos = phase_tp()
        log(f"phase 14 (tensor-parallel serving): {time.perf_counter() - t0:.1f}s launches={tp_counts}")
        check(tp_counts["flash_attention"] > 0, "flash_attention launched on the tensor-parallel path")
        counts["flash_attention"] += tp_counts["flash_attention"]
        t0 = time.perf_counter()
        rank_counts = phase_ranks()
        log(f"phase 15 (partition -> process over ranks): {time.perf_counter() - t0:.1f}s "
            f"launches={rank_counts}")
        for name in ("window_score", "segment_sum"):
            check(rank_counts[name] > 0, f"{name} launched on the ranks' path")
            counts[name] += rank_counts[name]
        pending = tpt_start()  # phase 17's ranks get ready while phase 16 runs
        t0 = time.perf_counter()
        tpf_counts = phase_tp_families()
        log(f"phase 16 (tensor-parallel serving, the other families): {time.perf_counter() - t0:.1f}s "
            f"launches={tpf_counts}")
        check(tpf_counts["flash_attention"] > 0, "flash_attention launched on the families' tensor-parallel path")
        counts["flash_attention"] += tpf_counts["flash_attention"]
        t0 = time.perf_counter()
        tpt_counts, tpt_infos = phase_tp_train(pending)
        pending = None
        log(f"phase 17 (tensor-parallel + FSDP training): {time.perf_counter() - t0:.1f}s "
            f"launches={tpt_counts}")
        check(tpt_counts["flash_attention"] > 0, "flash_attention launched on the sharded training path")
        counts["flash_attention"] += tpt_counts["flash_attention"]
        t0 = time.perf_counter()
        phase_dryrun(train_read, tp_infos, tpt_infos)
        log(f"phase 18 (the dry run, held to phases 14 and 17): {time.perf_counter() - t0:.1f}s")
        sources = {"window_score": ws_mod, "segment_sum": ss_mod, "flash_attention": fa_mod}
        kernels = []
        for name, row in kernel_rows.items():
            kernels.append(dict(
                name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
                replaces=sources[name].REPLACES, launches=counts[name],
                max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"], shape=row["shape"],
                **{key: row[key] for key in ("body", "launch_floor_ms", "kernels_per_call",
                                             "batched_z8_ms", "batched_z8_plain_ms",
                                             "batched_z8_bound_ms")
                   if key in row},
            ))
        log(f"checks passed: {len(CHECKS)}; total {time.perf_counter() - t_start:.1f}s")
        log(json.dumps({"kernels": kernels}))
    except Exception:
        traceback.print_exc()
        if pending is not None:  # phase 17's ranks, started ahead, return at once
            tpt_release(pending, run=False)
            pending["pool"].shutdown()
        print(f"chip_smoke: FAILED after {len(CHECKS)} passing checks", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
