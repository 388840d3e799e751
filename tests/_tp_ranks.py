"""Rank functions of the tensor-parallel tests, run in processes that
``repro_torch.launch.mesh.spawn`` starts. This module imports only the port
(no ``jax``, no ``repro``), so a rank starts quickly and the card machine,
which has no JAX, imports it too.

Each rank joins a gloo group through a file store (no ports), so several
tests can run at once.
"""
import numpy as np
import torch


def serve_rank(rank, argv):
    """``launch.serve.main(argv)`` on this rank: (tokens, info without the
    logits, each step's logits)."""
    torch.set_num_threads(1)
    from repro_torch.launch import serve

    info = {}
    gen = serve.main(argv, info=info, keep_logits=True)
    logits = info.pop("logits")
    return gen, info, logits


def forward_rank(rank, cfg, tp, params, batch, max_seq, prompts, extras, tokens, store, device,
                 ep_override=None):
    """Prefill ``prompts`` (the whole batch; the rank takes its rows, and
    its rows of each of ``extras``: whisper's frames, the vlm's patches) and
    decode ``tokens`` (one (B, 1) array a step) on a sharded model carried
    from the JAX ``params`` (tp-padded numpy leaves). Returns the rank's
    mesh coordinates, its rows, each step's logits (its rows, whole vocab),
    its cache pieces, its collective counts (``stats``: op -> [count,
    bytes]) and each step's (``step_stats``, the prefill's first)."""
    torch.set_num_threads(1)
    from repro_torch import convert
    from repro_torch.launch import mesh as meshes
    from repro_torch.launch.sharding import batch_rows, shard_for
    from repro_torch.models import lm

    _, _, dev = meshes.init_ranks("gloo", torch.device(device), f"file://{store}")
    shard = shard_for(cfg, meshes.make_local_mesh(tp, dev.type), ep_override=ep_override)
    model = convert.lm_params_from_numpy(params, cfg, dev, tp=tp, shard=shard)
    cache = lm.init_cache(cfg, batch, max_seq, tp=tp, device=dev, shard=shard)
    rows = batch_rows(shard, batch)
    kw = {k: torch.from_numpy(v[rows]).to(dev) for k, v in extras.items()}
    step_stats = []

    def counted(*args, **kw_):
        before = {k: list(v) for k, v in shard.stats.items()}
        out = lm.forward_cached(*args, tp=tp, shard=shard, **kw_)
        step_stats.append({k: [n - before.get(k, [0, 0])[0], nb - before.get(k, [0, 0])[1]]
                           for k, (n, nb) in shard.stats.items()})
        return out

    logits, cache = counted(model, cfg, cache, torch.from_numpy(prompts[rows]).to(dev), 0, **kw)
    steps = [logits.float().cpu().numpy()]
    offset = cfg.vlm_patches if cfg.family == "vlm" else 0
    for i, tok in enumerate(tokens):
        logits, cache = counted(model, cfg, cache, torch.from_numpy(tok[rows]).to(dev),
                                offset + prompts.shape[1] + i)
        steps.append(logits.float().cpu().numpy())
    return dict(coords=shard.coord, rows=(rows.start, rows.stop), logits=steps,
                cache=convert.cache_to_numpy(cache), stats={k: list(v) for k, v in shard.stats.items()},
                step_stats=step_stats, shapes={n: tuple(p.shape) for n, p in model.named_parameters()})


def cache_rank(rank, cfg, tp, cache, store):
    """The rank's part of a whole cache (numpy) through
    ``convert.cache_from_numpy(shard=)``, back as numpy, with its mesh
    coordinates."""
    from repro_torch import convert
    from repro_torch.launch import mesh as meshes
    from repro_torch.launch.sharding import shard_for

    meshes.init_ranks("gloo", torch.device("cpu"), f"file://{store}")
    shard = shard_for(cfg, meshes.make_local_mesh(tp, "cpu"))
    part = convert.cache_from_numpy(cache, "cpu", shard=shard)
    return shard.coord, convert.cache_to_numpy(part)


def failing_rank(rank, bad):
    """Raises on rank ``bad``; the others return their rank."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def hanging_rank(rank, bad, seconds):
    """Sleeps ``seconds`` on rank ``bad`` (a rank that never answers)."""
    import time

    if rank == bad:
        time.sleep(seconds)
    return rank
