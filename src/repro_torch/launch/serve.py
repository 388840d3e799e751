"""Serving launcher of the port: batched prefill + greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        --batch 4 --prompt-len 2048 --gen 64            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
        --batch 8 --prompt-len 448 --gen 16             # any family: moe, ssm, ...
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu

Counterpart of ``repro.launch.serve``, for every family: the same flags
(plus ``--device``), the inputs of ``family_inputs`` from
``np.random.default_rng(seed)``, weights from a ``torch.Generator`` seeded
with ``--seed``, the same printed lines, and it returns the generated
(B, gen) int32 array. One device: ``--tp`` above 1 exits naming its
ROADMAP.md item. The decode loop (``decode``) is eager torch, one
``forward_cached`` call per token.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import compat
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import lm


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


def decode(model, cfg, cache, tok: torch.Tensor, pos: int, steps: int):
    """``steps`` greedy decode steps from the tokens ``tok`` (B, 1) at
    position ``pos``, one ``forward_cached`` call each. Returns the tokens
    chosen (a list of (B, 1) int32), the last step's logits (B, V), None
    when ``steps`` is 0, and the cache."""
    outs, last = [], None
    for i in range(steps):
        logits, cache = lm.forward_cached(model, cfg, cache, tok, pos + i)
        last = logits[:, -1]
        tok = last.argmax(dim=-1, keepdim=True).to(torch.int32)
        outs.append(tok)
    return outs, last, cache


def main(argv=None, info: Optional[dict] = None):
    """Run the launcher on ``argv``; returns the generated tokens (B, gen).

    A dict passed as ``info`` receives the run's measurements: the prefill
    and decode walls (s, host clock around work ended by a device
    synchronise), the kernel launches of each phase (``prefill_launches``,
    ``decode_launches``) and the ``flash_attention`` launches of each phase
    by kernel body (``prefill_flash_bodies``, ``decode_flash_bodies``),
    whether the prefill's and the last decode step's logits were all
    finite, and, on the card, the peak device memory (bytes).
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
    args = ap.parse_args(argv)
    if args.tp != 1:
        ap.exit(2, "repro_torch.launch.serve: --tp > 1 is not ported (one device); see "
                   "ROADMAP.md port queue 1, item 15 (multi-device LM)\n")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = compat.resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    model = lm.init_params(cfg, gen)
    max_seq = args.prompt_len + args.gen
    cache = lm.init_cache(cfg, args.batch, max_seq, device=dev)
    prompts, kw, offset = family_inputs(cfg, args.batch, args.prompt_len, rng, dev)

    _sync(dev)
    counts0, bodies0 = ops.launch_counts(), dict(fa.LAUNCHES_BY_BODY)
    t0 = time.perf_counter()
    logits, cache = lm.forward_cached(model, cfg, cache, prompts, 0, **kw)
    first = logits[:, -1]
    tok = first.argmax(dim=-1, keepdim=True).to(torch.int32)
    del logits
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    counts1, bodies1 = ops.launch_counts(), dict(fa.LAUNCHES_BY_BODY)

    t0 = time.perf_counter()
    outs, last, cache = decode(model, cfg, cache, tok, offset + args.prompt_len, args.gen - 1)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    counts2, bodies2 = ops.launch_counts(), dict(fa.LAUNCHES_BY_BODY)

    last = first if last is None else last
    gen_tokens = torch.cat([tok] + outs, dim=1).cpu().numpy()
    print("generated:", gen_tokens[:, :12].tolist())
    tokens = args.batch * (args.gen - 1)
    print(
        f"prefill {args.batch}x{args.prompt_len} in {t_prefill*1e3:.1f} ms; "
        f"decode {tokens} tok in {t_decode*1e3:.1f} ms "
        f"({tokens/max(t_decode,1e-9):.1f} tok/s)"
    )
    if info is not None:
        info.update(
            prefill_s=t_prefill,
            decode_s=t_decode,
            decode_tokens=tokens,
            prefill_launches={k: counts1[k] - counts0[k] for k in counts0},
            decode_launches={k: counts2[k] - counts1[k] for k in counts0},
            prefill_flash_bodies={k: bodies1[k] - bodies0[k] for k in bodies0},
            decode_flash_bodies={k: bodies2[k] - bodies1[k] for k in bodies0},
            logits_finite=bool(torch.isfinite(first).all() and torch.isfinite(last).all()),
            peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        )
    return gen_tokens


if __name__ == "__main__":
    main()
