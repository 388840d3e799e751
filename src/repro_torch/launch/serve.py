"""Serving launcher of the port: batched prefill + greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        --batch 4 --prompt-len 2048 --gen 64            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
        --batch 8 --prompt-len 448 --gen 16             # any family: moe, ssm, ...
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch llama3.2-3b --tp 2 --batch 4 --prompt-len 2048 --gen 64  # two cards

Counterpart of ``repro.launch.serve``, for every family: the same flags
(plus ``--device``, ``--dist-backend`` and ``--dist-init``), the inputs of
``family_inputs`` from ``np.random.default_rng(seed)``, weights from a
``torch.Generator`` seeded with ``--seed``, the same printed lines, and it
returns the generated (B, gen) int32 array. The decode loop (``decode``)
is eager torch, one ``forward_cached`` call per token.

Tensor parallelism (every family): under torchrun (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` in the environment) or in a process group
already initialised, N = D·T ranks serve on a (data=D, model=T) mesh
(``--tp T``). Each rank makes its device current (``cuda:{LOCAL_RANK %
device_count}``) before it allocates anything, joins the group
(``--dist-backend``: ``nccl`` on ``cuda``, ``gloo`` on ``cpu`` by default;
``--dist-init``: ``env://``, or ``file://<path>`` for a file store),
draws the whole model from the seed as the one-device run draws it and
keeps its shard, draws the inputs (the prompts, then whisper's frames or
the vlm's patches) from one numpy generator in JAX's order and keeps its
rows of the batch when the data axis divides it. Rank 0 prints; every rank
returns the whole batch's tokens. Any cache length, frame count and head
count serves: a sequence ``--tp`` does not divide is laid out over
⌈S / tp⌉ · tp positions, and an SSM mixer whose heads it does not divide
runs whole on every rank (``launch.sharding``). With no process group
``--tp`` above 1 exits naming the cause, as do a world size that ``--tp``
does not divide and NCCL asked to put two ranks on one device.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import compat
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import mesh as meshes
from repro_torch.launch import sharding
from repro_torch.models import lm
from repro_torch.models.tp import NO_SHARD, Shard


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def family_inputs(cfg, batch: int, prompt_len: int, rng: np.random.Generator, dev):
    """The launcher's inputs, drawn from ``rng`` in the JAX package's order:
    the prompts (B, T) int32, then whisper's stub frame embeddings
    (B, max(T // 2, 1), D) or the vlm's stub patch embeddings
    (B, vlm_patches, D), N(0, 1) in the model's dtype. Returns (prompts,
    the keyword inputs of the prefill's ``forward_cached``, the position
    offset of decode: ``vlm_patches`` in the vlm, whose cache holds the
    patches before the text, else 0)."""
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (batch, prompt_len)), dtype=torch.int32,
    ).to(dev)
    dt = getattr(torch, cfg.dtype)
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = torch.as_tensor(
            rng.normal(size=(batch, max(prompt_len // 2, 1), cfg.d_model)),
        ).to(device=dev, dtype=dt)
    if cfg.family == "vlm":
        kw["patches"] = torch.as_tensor(
            rng.normal(size=(batch, cfg.vlm_patches, cfg.d_model)),
        ).to(device=dev, dtype=dt)
    return prompts, kw, (cfg.vlm_patches if cfg.family == "vlm" else 0)


def decode(model, cfg, cache, tok: torch.Tensor, pos: int, steps: int, tp: int = 1,
           shard: Shard = NO_SHARD, keep: Optional[list] = None):
    """``steps`` greedy decode steps from the tokens ``tok`` (B, 1) at
    position ``pos``, one ``forward_cached`` call each. Returns the tokens
    chosen (a list of (B, 1) int32), the last step's logits (B, V), None
    when ``steps`` is 0, and the cache. A list passed as ``keep`` receives
    each step's logits (B, V)."""
    outs, last = [], None
    for i in range(steps):
        logits, cache = lm.forward_cached(model, cfg, cache, tok, pos + i, tp=tp, shard=shard)
        last = logits[:, -1]
        if keep is not None:
            keep.append(last)
        tok = last.argmax(dim=-1, keepdim=True).to(torch.int32)
        outs.append(tok)
    return outs, last, cache


def _whole_batch(x: torch.Tensor, shard: Shard, batch: int) -> torch.Tensor:
    """The batch's rows from every data rank (``x`` holds this rank's)."""
    if x.shape[0] == batch:
        return x
    parts = [torch.empty_like(x) for _ in range(shard.dp)]
    dist.all_gather(parts, x.contiguous(), group=shard.data_group)
    return torch.cat(parts)


def _phase(before: dict, after: dict) -> dict:
    return {op: [n - before.get(op, [0, 0])[0], b - before.get(op, [0, 0])[1]]
            for op, (n, b) in after.items()}


def _snapshot(shard: Shard) -> dict:
    return {op: list(v) for op, v in shard.stats.items()}


def main(argv=None, info: Optional[dict] = None, keep_logits: bool = False, cfg=None):
    """Run the launcher on ``argv``; returns the generated tokens (B, gen).
    ``cfg`` (an ``ArchConfig``), if given, is served in place of
    ``--arch``'s (``--reduced`` is then ignored): a model cut in depth, or
    in another dtype.

    A dict passed as ``info`` receives the run's measurements: the prefill
    and decode walls (s, host clock around work ended by a device
    synchronise), the kernel launches of each phase (``prefill_launches``,
    ``decode_launches``) and the ``flash_attention`` launches of each phase
    by kernel body (``prefill_flash_bodies``, ``decode_flash_bodies``),
    whether the prefill's and the last decode step's logits were all
    finite, and, on the card, the peak device memory (bytes). It also gets
    ``tp``, ``world``, ``backend`` and the head ``policy`` (None without a
    process group), the
    collectives of each phase (``prefill_collectives``,
    ``decode_collectives``: op -> [count, bytes this rank sent]) and the
    peak memory of every rank (``peak_bytes_per_rank``). With
    ``keep_logits`` it gets ``logits``: each step's last-position logits
    (B, V) as fp32 numpy arrays, the prefill's first.
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--tp", type=int, default=1)
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
    shard, dev, world = meshes.join_ranks(ap, args, cfg, dev)
    try:
        return _serve(args, cfg, dev, shard, world, info, keep_logits)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _serve(args, cfg, dev, shard: Shard, world: int, info: Optional[dict], keep_logits: bool):
    tp, b = args.tp, args.batch
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    model = lm.init_params(cfg, gen, tp=tp, shard=shard)
    max_seq = args.prompt_len + args.gen
    cache = lm.init_cache(cfg, b, max_seq, tp=tp, device=dev, shard=shard)
    prompts, kw, offset = family_inputs(cfg, b, args.prompt_len, rng, dev)
    rows, shard = sharding.rank_rows(shard, b)
    prompts, kw = prompts[rows], {k: v[rows] for k, v in kw.items()}
    kept = [] if keep_logits else None

    _sync(dev)
    counts0, bodies0, coll0 = ops.launch_counts(), dict(fa.LAUNCHES_BY_BODY), _snapshot(shard)
    t0 = time.perf_counter()
    logits, cache = lm.forward_cached(model, cfg, cache, prompts, 0, tp=tp, shard=shard, **kw)
    first = logits[:, -1]
    if kept is not None:
        kept.append(first)
    tok = first.argmax(dim=-1, keepdim=True).to(torch.int32)
    del logits
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    counts1, bodies1, coll1 = ops.launch_counts(), dict(fa.LAUNCHES_BY_BODY), _snapshot(shard)

    t0 = time.perf_counter()
    outs, last, cache = decode(model, cfg, cache, tok, offset + args.prompt_len, args.gen - 1,
                               tp=tp, shard=shard, keep=kept)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    counts2, bodies2, coll2 = ops.launch_counts(), dict(fa.LAUNCHES_BY_BODY), _snapshot(shard)

    last = first if last is None else last
    gen_tokens = _whole_batch(torch.cat([tok] + outs, dim=1), shard, b).cpu().numpy()
    tokens = b * (args.gen - 1)
    if shard is NO_SHARD or dist.get_rank() == 0:
        print("generated:", gen_tokens[:, :12].tolist())
        print(
            f"prefill {b}x{args.prompt_len} in {t_prefill*1e3:.1f} ms; "
            f"decode {tokens} tok in {t_decode*1e3:.1f} ms "
            f"({tokens/max(t_decode,1e-9):.1f} tok/s)"
            + (f" [tp={tp} world={world} {shard.backend}]" if shard is not NO_SHARD else "")
        )
    if info is not None:
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
        info.update(
            prefill_s=t_prefill,
            decode_s=t_decode,
            decode_tokens=tokens,
            prefill_launches={k: counts1[k] - counts0[k] for k in counts0},
            decode_launches={k: counts2[k] - counts1[k] for k in counts0},
            prefill_flash_bodies={k: bodies1[k] - bodies0[k] for k in bodies0},
            decode_flash_bodies={k: bodies2[k] - bodies1[k] for k in bodies0},
            logits_finite=bool(torch.isfinite(first).all() and torch.isfinite(last).all()),
            peak_bytes=peak,
            tp=tp,
            world=world,
            backend=shard.backend,
            policy=shard.policy if shard is not NO_SHARD else None,
            prefill_collectives=_phase(coll0, coll1),
            decode_collectives=_phase(coll1, coll2),
            peak_bytes_per_rank=None if peak is None else meshes.per_rank(peak, dev, shard),
        )
        if kept is not None:
            info["logits"] = [_whole_batch(x, shard, b).float().cpu().numpy() for x in kept]
    return gen_tokens


if __name__ == "__main__":
    main()
