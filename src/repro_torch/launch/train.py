"""Training launcher of the port: AdamW steps on synthetic tokens under the
fault-tolerant loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --seq 4096 --batch 1 --steps 10                      # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --reduced --steps 30 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch llama3.2-3b --tp 2 --seq 512 --batch 2 --steps 3 --dist-backend gloo

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
them.

Over ranks (every family): under torchrun (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``) or in a process group already initialised,
N = D·T ranks train on a (data=D, model=T) mesh (``--tp T``; ``--tp 1`` at
N > 1 is pure FSDP), joined as ``launch.serve`` joins them
(``launch.mesh.join_ranks``: ``--dist-backend``, ``--dist-init``). Each
rank draws the whole model from the seed and keeps its FSDP + TP piece
of every leaf (``launch.sharding.param_specs(mode="train")``); the AdamW
moments and the residual are laid out alike (``opt_specs``). It draws each batch whole and
keeps its rows (``batch_specs``). A step is the sharded ``loss_fn`` (the
whole batch's loss, equal on every rank) + ``backward()`` + the data-group
sum of the gradients of leaves not split over data
(``lm.reduce_grads``) + the sharded top-k + AdamW on the pieces: the
update JAX's ``value_and_grad(loss_fn(tp=T))`` + ``adamw_update`` makes
over the whole batch. Rank 0 prints and writes checkpoints (whole leaves,
the single-host layout); every rank returns the losses.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import compat
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticTokens
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import mesh as meshes
from repro_torch.launch import sharding
from repro_torch.models import lm
from repro_torch.models.tp import NO_SHARD, Shard
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule, topk_compress_allreduce
from repro_torch.dist import rank_mesh
from repro_torch.runtime import FaultTolerantLoop, StepFailure, StragglerMonitor

__all__ = ["build_state", "device_step", "make_step", "history_info", "main"]


def build_state(cfg, device, tp: int = 1, seed: int = 0, shard: Shard = NO_SHARD):
    """(model, state): an :class:`~repro_torch.models.lm.LM` with random
    weights from ``seed`` and gradients on, and the train state
    ``dict(params, opt, residual)`` whose ``params`` are the model's own
    parameters (by name). Under a train ``shard`` every leaf is drawn whole
    and the rank keeps its piece; the moments and the residual are pieces
    of the same shapes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = lm.init_params(cfg, gen, tp=tp, shard=shard)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    residual = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    return model, dict(params=params, opt=adamw_init(params), residual=residual)


def _collectives(before: dict, after: dict) -> dict:
    return {op: [n - before.get(op, [0, 0])[0], b - before.get(op, [0, 0])[1]]
            for op, (n, b) in after.items() if n - before.get(op, [0, 0])[0]}


def device_step(model, cfg, state, batch, lr_fn, compress: float = 0.0, tp: int = 1,
                shard: Shard = NO_SHARD) -> dict:
    """The device part of one training step, in place on ``state``:
    ``lm.loss_fn`` + ``backward()`` + ``lm.reduce_grads`` + optional
    ``topk_compress_allreduce`` + ``adamw_update`` at ``lr_fn(step)``.
    Returns the metrics as 0-dim tensors (``loss``, ``ce``, ``moe_aux``),
    unread: nothing here waits for the device, so it runs on ``meta``
    tensors too (``launch.dryrun.make_train_step``)."""
    params = state["params"]
    for p in params.values():
        p.grad = None
    loss, metrics = lm.loss_fn(model, cfg, batch, tp=tp, shard=shard)
    loss.backward()
    lm.reduce_grads(model, shard)
    grads = {n: p.grad for n, p in params.items()}
    if compress > 0:
        grads, _ = topk_compress_allreduce(grads, state["residual"], None, compress, shard=shard)
    adamw_update(grads, state["opt"], params, lr_fn(state["opt"]["step"]), shard=shard)
    return dict(metrics, loss=loss)


def make_step(model, cfg, lr_fn, compress: float = 0.0, tp: int = 1, shard: Shard = NO_SHARD):
    """``step(state, batch) -> (state, metrics)``: one training step, in
    place on ``state``. The gradients stay in the parameters' ``.grad``
    until the next step starts. ``metrics`` holds ``loss``, ``ce`` and
    ``moe_aux`` (host floats: the step ends in a device sync), and the
    ``flash_attention`` kernel launches it made (``flash_launches``; by body,
    ``flash_bodies``) and its backward calls. Under a ``shard`` (``batch``
    holds the rank's rows; the shard says whether they are its share) the
    step runs over the ranks, and ``metrics["collectives"]`` holds the
    step's collectives (op -> [count, bytes this rank sent]). The device
    work is :func:`device_step`'s; the host reads are here."""

    def step(state, batch):
        launches0, backward0 = ops.launch_counts()["flash_attention"], fa.BACKWARD_CALLS
        bodies0 = dict(fa.LAUNCHES_BY_BODY)
        coll0 = {op: list(v) for op, v in shard.stats.items()}
        metrics = device_step(model, cfg, state, batch, lr_fn, compress, tp, shard)
        # staticcheck: disable=SC003 the step hands host metrics to the loop, as JAX's step_fn does
        out = {k: v.item() for k, v in metrics.items()}
        out["flash_launches"] = ops.launch_counts()["flash_attention"] - launches0
        out["flash_bodies"] = {b: fa.LAUNCHES_BY_BODY[b] - bodies0[b] for b in fa.BODIES}
        out["attn_backward_calls"] = fa.BACKWARD_CALLS - backward0
        out["collectives"] = _collectives(coll0, shard.stats)
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
        ("attn_backward_calls", "attn_backward_calls"), ("collectives", "collectives"))}


def _pieces(model, shard: Shard) -> Optional[dict]:
    """The checkpoint's layout over ranks: every state leaf's whole shape
    and each rank's index of it (``CheckpointManager(pieces=)``)."""
    if shard is NO_SHARD:
        return None
    shapes = {n: model.tp_layout[n][0] for n, _ in model.named_parameters()}
    index = sharding.piece_indices(shard, shapes)
    return {f"{tree}/{n}": (shapes[n], index[n]) for n in shapes
            for tree in ("params", "opt/m", "opt/v", "residual")}


def main(argv=None, info: Optional[dict] = None, cfg=None):
    """Run the launcher on ``argv``; returns the losses, one per step run.
    ``cfg`` (an ``ArchConfig``), if given, is trained in place of
    ``--arch``'s (``--reduced`` is then ignored): a model cut in depth, or
    in another dtype.

    A dict passed as ``info`` receives the run's measurements: ``losses``
    and ``moe_aux`` per step, ``step_s`` (each step's wall, host clock
    around a step that ends in a device sync), ``flash_launches``,
    ``flash_bodies`` (the launches by kernel body, a dict) and
    ``attn_backward_calls`` per step,
    ``grad_flags`` of the first step run (see :func:`_grad_flags`),
    ``tokens_per_step``, ``n_params``, ``start_step``, the loop's
    ``retries`` and ``restores`` and, on the card, ``peak_bytes``. It also
    gets ``tp``, ``world``, ``backend`` and the head ``policy`` (None with
    no process group), ``collectives`` per step (op -> [count, bytes this
    rank sent]), ``peak_bytes_per_rank`` and ``rank_losses``, every rank's
    losses in rank order.
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
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--dist-init", default="env://")
    args = ap.parse_args(argv)

    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    dev = compat.resolve_device(args.device)
    owns_group = not dist.is_initialized()
    shard, dev, world = meshes.join_ranks(ap, args, cfg, dev, mode="train")
    try:
        return _train(args, cfg, dev, shard, world, info)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, cfg, dev, shard: Shard, world: int, info: Optional[dict]):
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    lead = shard is NO_SHARD or dist.get_rank() == 0

    rows, shard = sharding.rank_rows(shard, args.batch)
    model, state = build_state(cfg, dev, args.tp, args.seed, shard)
    n_params = sum(int(np.prod(model.tp_layout[n][0])) if n in model.tp_layout else p.numel()
                   for n, p in state["params"].items())
    if lead:
        print(f"arch={cfg.name} params={n_params/1e6:.2f}M device={dev}"
              + (f" tp={args.tp} world={world} {shard.backend}" if shard is not NO_SHARD else ""))

    data = SyntheticTokens(cfg, shape, seed=args.seed)
    lr_fn = cosine_schedule(args.lr, max(args.steps // 10, 1), args.steps)
    step_inner = make_step(model, cfg, lr_fn, args.grad_compress, args.tp, shard)

    ckpt = (CheckpointManager(args.ckpt_dir, keep=3, pieces=_pieces(model, shard))
            if args.ckpt_dir else None)
    start_step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        _, manifest = ckpt.restore(state)
        start_step = manifest["step"]
        if lead:
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
        return {k: torch.as_tensor(v[rows]).to(dev) for k, v in data.batch_at(step).items()}

    state, history = loop.run(state, batches, start_step, args.steps)
    if ckpt:
        ckpt.wait()
    for step, m in history[:3] + history[-3:]:
        if lead:
            print(f"step {step:5d} loss={m['loss']:.4f} t={m['step_time_s']*1e3:.0f}ms "
                  f"flash_launches={m['flash_launches']} attn_backward={m['attn_backward_calls']}")
        monitor.observe(np.array([m["step_time_s"]]))
    losses = [m["loss"] for _, m in history]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    if lead:
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
            tp=args.tp,
            world=world,
            backend=shard.backend,
            policy=shard.policy if shard is not NO_SHARD else None,
            peak_bytes_per_rank=None if peak is None else meshes.per_rank(peak, dev, shard),
            rank_losses=rank_mesh("losses").gather_objects(losses),
        )
    return losses


if __name__ == "__main__":
    main()
