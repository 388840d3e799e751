"""Training launcher of the port: AdamW steps on synthetic tokens under the
fault-tolerant loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --seq 4096 --batch 1 --steps 10                      # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --steps 30 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt --device cpu

Counterpart of ``repro.launch.train``: the same flags (plus ``--device``),
data from ``SyntheticTokens``, weights from a ``torch.Generator`` seeded with
``--seed``, the state keys ``params``, ``opt`` (``m``, ``v``, ``step``) and
``residual`` (the fp32 error-feedback buffer, allocated as in JAX whether
or not ``--grad-compress`` is on), the checkpoint manager, the
fault-tolerant loop, the straggler monitor and optional top-k gradient
compression; the same printed lines, and it returns the losses. A step is
``lm.loss_fn`` + ``backward()`` (blocks and CE chunks rematerialised) →
optional ``topk_compress_allreduce`` → ``adamw_update``, which updates the
parameters and moments in place. Every family trains; the vlm's patches
and whisper's frames come with each batch, as ``SyntheticTokens`` draws
them. One device: ``--tp`` above 1 exits naming ROADMAP.md item 15c.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch import compat
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticTokens
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule, topk_compress_allreduce
from repro_torch.runtime import FaultTolerantLoop, StepFailure, StragglerMonitor

__all__ = ["build_state", "make_step", "history_info", "main"]


def build_state(cfg, device, tp: int = 1, seed: int = 0):
    """(model, state): an :class:`~repro_torch.models.lm.LM` with random
    weights from ``seed`` and gradients on, and the train state
    ``dict(params, opt, residual)`` whose ``params`` are the model's own
    parameters (by name)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = lm.init_params(cfg, gen, tp=tp)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    residual = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    return model, dict(params=params, opt=adamw_init(params), residual=residual)


def make_step(model, cfg, lr_fn, compress: float = 0.0, tp: int = 1):
    """``step(state, batch) -> (state, metrics)``: one training step, in
    place on ``state``. The gradients stay in the parameters' ``.grad``
    until the next step starts. ``metrics`` holds ``loss``, ``ce`` and
    ``moe_aux`` (host floats: the step ends in a device sync), and the
    ``flash_attention`` kernel launches it made (``flash_launches``; by body,
    ``flash_bodies``) and its backward calls."""

    def step(state, batch):
        params = state["params"]
        for p in params.values():
            p.grad = None
        launches0, backward0 = ops.launch_counts()["flash_attention"], fa.BACKWARD_CALLS
        bodies0 = dict(fa.LAUNCHES_BY_BODY)
        loss, metrics = lm.loss_fn(model, cfg, batch, tp=tp)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        if compress > 0:
            grads, _ = topk_compress_allreduce(grads, state["residual"], None, compress)
        adamw_update(grads, state["opt"], params, lr_fn(state["opt"]["step"]))
        # staticcheck: disable=SC003 the step hands host metrics to the loop, as JAX's step_fn does
        out = {k: v.item() for k, v in dict(metrics, loss=loss).items()}
        out["flash_launches"] = ops.launch_counts()["flash_attention"] - launches0
        out["flash_bodies"] = {b: fa.LAUNCHES_BY_BODY[b] - bodies0[b] for b in fa.BODIES}
        out["attn_backward_calls"] = fa.BACKWARD_CALLS - backward0
        return state, out

    return step


def _grad_flags(params) -> dict:
    """name -> (every gradient element finite, some element non-zero)."""
    flags = torch.stack([
        torch.stack([torch.isfinite(p.grad).all(), (p.grad != 0).any()])
        if p.grad is not None else torch.zeros(2, dtype=torch.bool, device=p.device)
        for p in params.values()
    ]).cpu().tolist()
    return {n: tuple(f) for n, f in zip(params, flags)}


def history_info(history) -> dict:
    """The per-step lists of :func:`main`'s ``info`` from the metrics of the
    steps run, in order (each a :func:`make_step` metrics dict with its
    ``step_time_s``)."""
    return {key: [m[k] for m in history] for key, k in (
        ("losses", "loss"), ("moe_aux", "moe_aux"), ("step_s", "step_time_s"),
        ("flash_launches", "flash_launches"), ("flash_bodies", "flash_bodies"),
        ("attn_backward_calls", "attn_backward_calls"))}


def main(argv=None, info: Optional[dict] = None):
    """Run the launcher on ``argv``; returns the losses, one per step run.

    A dict passed as ``info`` receives the run's measurements: ``losses``
    and ``moe_aux`` per step, ``step_s`` (each step's wall, host clock
    around a step that ends in a device sync), ``flash_launches``,
    ``flash_bodies`` (the launches by kernel body, a dict) and
    ``attn_backward_calls`` per step,
    ``grad_flags`` of the first step run (see :func:`_grad_flags`),
    ``tokens_per_step``, ``n_params``, ``start_step``, the loop's
    ``retries`` and ``restores`` and, on the card, ``peak_bytes``.
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compress", type=float, default=0.0,
                    help="top-k compression ratio (0 = exact reduction)")
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="simulate a transient failure at this step (testing)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.tp != 1:
        ap.exit(2, "repro_torch.launch.train: --tp > 1 is not ported (tensor-parallel and "
                   "FSDP training); see ROADMAP.md port queue 1, item 15c\n")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = compat.resolve_device(args.device)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    model, state = build_state(cfg, dev, args.tp, args.seed)
    n_params = sum(p.numel() for p in state["params"].values())
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M device={dev}")

    data = SyntheticTokens(cfg, shape, seed=args.seed)
    lr_fn = cosine_schedule(args.lr, max(args.steps // 10, 1), args.steps)
    step_inner = make_step(model, cfg, lr_fn, args.grad_compress, args.tp)

    ckpt = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    start_step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        _, manifest = ckpt.restore(state)
        start_step = manifest["step"]
        print(f"resumed from step {start_step}")

    def step_fn(state, batch):
        state, metrics = step_inner(state, batch)
        if info is not None and "grad_flags" not in info:
            info["grad_flags"] = _grad_flags(state["params"])
        return state, metrics

    def save_fn(step, state):
        if ckpt:
            ckpt.save(step, state, meta=dict(arch=cfg.name))

    def restore_fn():
        if ckpt is None:
            raise RuntimeError("restore requires --ckpt-dir")
        st, manifest = ckpt.restore(state)
        return st, manifest["step"]

    def failure_hook(step):
        if step == args.inject_failure_at:
            args.inject_failure_at = -1  # fire once
            raise StepFailure("transient", "injected test failure")

    monitor = StragglerMonitor(hosts=1)
    loop = FaultTolerantLoop(
        step_fn, save_fn, restore_fn, ckpt_every=args.ckpt_every,
        failure_hook=failure_hook,
    )

    def batches(step):
        return {k: torch.as_tensor(v).to(dev) for k, v in data.batch_at(step).items()}

    state, history = loop.run(state, batches, start_step, args.steps)
    if ckpt:
        ckpt.wait()
    for step, m in history[:3] + history[-3:]:
        print(f"step {step:5d} loss={m['loss']:.4f} t={m['step_time_s']*1e3:.0f}ms "
              f"flash_launches={m['flash_launches']} attn_backward={m['attn_backward_calls']}")
        monitor.observe(np.array([m["step_time_s"]]))
    losses = [m["loss"] for _, m in history]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    print(
        f"done: steps={loop.stats.steps_done} retries={loop.stats.retries} "
        f"restores={loop.stats.restores} loss {losses[0]:.4f} -> {losses[-1]:.4f}"
        + (f" peak_mem_GiB={peak / 2**30:.3f}" if peak is not None else "")
    )
    if info is not None:
        info.update(
            history_info([m for _, m in history]),
            tokens_per_step=args.batch * args.seq,
            n_params=n_params,
            peak_bytes=peak,
            start_step=start_step,
            retries=loop.stats.retries,
            restores=loop.stats.restores,
        )
    return losses


if __name__ == "__main__":
    main()
