#!/usr/bin/env python3
"""Time ``torch.profiler``'s ``key_averages()`` against the raw-record
readers the smoke uses, on one NVIDIA GPU, and check both give the same
totals:

    python3 tools/time_profile_readers.py

(a) 100 edges of ADWISE at W = 256 (``chip_smoke.py`` phase 4's run, ~360
steps of ~250 kernels) profiled with CUDA activity and with CPU + CUDA
activity: the session's wall, ``key_averages()`` filtered to the device's
kernels as ``repro_torch.kernels.device_kernels`` filtered it before, and
``device_kernels`` (summed from the raw records) — count and µs by name.
(b) One training step of Llama-3.2-3B at full width cut to 4 layers (bf16,
1 × 2,048) under CPU + CUDA activity: each ``record_function`` range's
``device_time_total`` from ``key_averages()`` against
``chip_smoke.range_device_us``. Exits 1 if any total differs by more than
1e-6 of itself."""
import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

RANGES = ("flash_attention_backward", "adamw_update")


def close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-6 * max(abs(a), abs(b), 1e-9)


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import AdwiseConfig, partition_stream
    from repro_torch.data import SyntheticTokens
    from repro_torch.graph import make_graph
    from repro_torch.kernels import CUPTI_RECORDS, _build, device_kernels
    from repro_torch.launch import train

    if not torch.cuda.is_available():
        print("time_profile_readers: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.build()
    ok = True

    edges, n = make_graph("brain_like", seed=0, scale=0.005)
    edges = edges[:100]
    cfg = AdwiseConfig(k=32, window_max=256)
    partition_stream(edges, n, cfg, device="cuda")  # warm
    for acts in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]) * 2:
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            partition_stream(edges, n, cfg, device="cuda")
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        old = {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in CUPTI_RECORDS
               and not getattr(e, "is_user_annotation", False)}
        t2 = time.perf_counter()
        new = {e.key: (e.count, e.self_device_time_total) for e in device_kernels(prof)}
        t3 = time.perf_counter()
        same = old.keys() == new.keys() and all(
            old[k][0] == new[k][0] and close(old[k][1], new[k][1]) for k in old)
        ok &= same
        print(f"(a) ADWISE 100 edges, activities {'+'.join(a.name for a in acts)} [{card}]: "
              f"session {t1 - t0:.2f}s key_averages {t2 - t1:.2f}s device_kernels {t3 - t2:.3f}s "
              f"kernels {sum(c for c, _ in new.values())} busy_us {sum(u for _, u in new.values()):.1f} "
              f"equal={same}", flush=True)

    arch = dataclasses.replace(get_config("llama3.2-3b"), n_layers=4)
    model, state = train.build_state(arch, torch.device("cuda"), seed=0)
    step = train.make_step(model, arch, lambda s: 1e-3)
    data = SyntheticTokens(arch, ShapeConfig("cli", 2048, 1, "train"), seed=0)
    batch = {"tokens": torch.as_tensor(data.batch_at(0)["tokens"]).cuda()}
    step(state, batch)  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    old = {e.key: e.device_time_total for e in prof.key_averages()
           if e.key in RANGES and e.device_type != DeviceType.CUDA}
    t1 = time.perf_counter()
    new = chip_smoke.range_device_us(prof, RANGES)
    t2 = time.perf_counter()
    same = all(close(old.get(k, 0.0), new[k]) for k in RANGES)
    ok &= same
    print(f"(b) llama3.2-3b 4 layers, 1 x 2048, one step [{card}]: key_averages {t1 - t0:.2f}s "
          f"range_device_us {t2 - t1:.3f}s; device us by range: key_averages "
          + ", ".join(f"{k} {old.get(k, 0.0):.3f}" for k in RANGES) + "; raw records "
          + ", ".join(f"{k} {new[k]:.3f}" for k in RANGES) + f"; equal={same}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
