"""The dry run of a rank that a rank test ran: ``launch.dryrun.dry_run_rank``
on ``meta`` tensors with the rank's config, (data, model) mesh,
coordinates, mode and the shapes of its inputs, and the collectives it
counts, to hold against what the rank counted over gloo. This module
imports only the port (no ``jax``, no ``repro``).
"""
import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.sharding import rank_coords


def counted(stats):
    """``stats`` (op -> [count, bytes]) without the ops counted 0 times
    (``launch.serve`` keeps them; the dry run and ``launch.train`` drop
    them)."""
    return {op: list(v) for op, v in stats.items() if v[0]}


def times(stats, n):
    """``stats`` over ``n`` equal steps."""
    return {op: [c * n, b * n] for op, (c, b) in stats.items()}


def collectives(cfg, mesh, coords, kind, inputs, *, mode, cache_len=None, ep=None):
    """The dry run's collectives (op -> [count, bytes this rank sent]) of
    one ``kind`` step ('train', 'prefill' or 'decode') of the rank at
    ``coords`` (a dict of its mesh coordinates, or its rank) on ``mesh``
    ((data, model) sizes), in ``mode`` ('train' or 'serve'), on the whole
    batch's ``inputs`` (arrays, or (shape, numpy dtype) pairs: ``tokens``
    and whisper's ``frames`` or the vlm's ``patches``) and a cache of
    ``cache_len`` positions."""
    mesh = MeshShape(("data", "model"), tuple(mesh))
    if not isinstance(coords, dict):
        coords = rank_coords(mesh, coords)
    meta = {}
    for k, v in inputs.items():
        shape, dtype = (v.shape, v.dtype) if hasattr(v, "shape") else v
        meta[k] = torch.empty(tuple(shape), device="meta",
                              dtype=torch.from_numpy(np.empty(0, dtype)).dtype)
    b = meta["tokens"].shape[0]
    shape = ShapeConfig(f"rank-{kind}", cache_len or meta["tokens"].shape[1], b, kind)
    rec = dryrun.dry_run_rank(cfg, shape, mesh, tuple(coords[a] for a in mesh.axis_names),
                              mode=mode, ep_override=ep, inputs=meta, cache_len=cache_len)
    return rec["collectives"]


def without_clip(coll):
    """A train step's collectives without AdamW's clip (``global_norm``'s
    one world all-reduce of the per-leaf sums): those of ``loss_fn`` +
    ``backward`` + ``reduce_grads``."""
    out = dict(coll)
    clip = out.pop("world_all_reduce_sum", [1, 0])
    assert clip[0] == 1, coll
    return out
