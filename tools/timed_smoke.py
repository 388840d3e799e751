#!/usr/bin/env python3
"""Run ``chip_smoke.py`` with every log line stamped with the seconds since
start, and the walls of its heaviest calls logged (``train.build_state``,
``lm.loss_fn``, a training step, ``chip_smoke.family_models``; those over
0.5 s), to see where the smoke's time goes:

    python3 tools/timed_smoke.py > timed.log 2>&1     # one card, as chip_smoke.py

The smoke's own checks and output are unchanged; the lines of its spawned
ranks are not stamped."""
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
import chip_smoke  # noqa: E402

T0 = time.perf_counter()
_real = chip_smoke.log


def log(msg):
    _real(f"[{time.perf_counter() - T0:8.1f}] {msg}")


def timed(mod, name):
    fn = getattr(mod, name)

    @functools.wraps(fn)
    def wrap(*a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        dt = time.perf_counter() - t
        if dt > 0.5:
            log(f"  timing {name}: {dt:.2f}s")
        return out

    setattr(mod, name, wrap)


if __name__ == "__main__":
    import torch

    from repro_torch.launch import train
    from repro_torch.models import lm

    chip_smoke.log = log
    log(f"  timing torch threads={torch.get_num_threads()} cpu_count={os.cpu_count()} "
        f"affinity={len(os.sched_getaffinity(0))}")
    timed(train, "build_state")
    timed(lm, "loss_fn")
    timed(chip_smoke, "family_models")
    _mk = train.make_step

    def make_step(*a, **kw):
        step = _mk(*a, **kw)

        def timed_step(*sa, **skw):
            t = time.perf_counter()
            out = step(*sa, **skw)
            if time.perf_counter() - t > 0.5:
                log(f"  timing step: {time.perf_counter() - t:.2f}s")
            return out
        return timed_step

    train.make_step = make_step
    sys.exit(chip_smoke.main())
