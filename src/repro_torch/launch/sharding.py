"""Sharding rules of the port (counterpart of ``repro.launch.sharding``):
DP/FSDP + TP (+ EP/SP) specs for the model's parameters, the optimizer
state, a batch and the KV cache.

Policy (mesh axes ('pod',)? + ('data', 'model')), the JAX package's:
  * batch        → ('pod','data')  (DP)
  * weights      → FSDP-shard the non-parallel dim over ('pod','data') AND
                   TP-shard the parallel dim over 'model' (mode='train');
                   TP only in mode='serve'
  * attn heads   → 'model' when divisible (policy from
                   ``ArchConfig.padded_heads``: 'shard'/'shard_q'/'pad'/
                   'replicate')
  * MoE experts  → 'model' on the expert dim when n_experts % tp == 0 (EP,
                   granite), else 'model' on d_ff inside each expert (grok)
  * KV cache     → batch over ('pod','data') when divisible, sequence over
                   'model' (flash-decoding style: the softmax over the split
                   axis is merged across ranks)
  * SSM state    → heads over 'model', batch over ('pod','data') if divisible

Two departures from the JAX rules, both where the port's ranks run what
JAX runs as one program (its ``serve --tp T`` builds a mesh and never
uses it, so its specs only place data):
  * an ssm / hybrid mixer whose heads tp does not divide (RWKV-6's ``att``
    and ``cm``, Mamba-2's ``mamba``) is replicated over 'model': every
    rank runs it whole, with no collective, where the JAX rules would split
    its columns off head boundaries;
  * a cache sequence split over 'model' is laid out over ⌈S / tp⌉ · tp
    positions (:func:`_cache_index`): the KV caches are padded (positions
    past ``max_seq`` are never written, and the decode merge gives them
    weight 0), a cross-attention K/V sequence is cut at the same bounds but
    holds only its frames.

A spec is a plain tuple with one entry per dimension: an axis name, a tuple
of names (split over them in order, major to minor) or None (replicated) —
what the JAX package's ``PartitionSpec`` holds. A mesh is anything with
``.shape`` (axis -> size) and ``.axis_names``: a
:class:`repro_torch.launch.mesh.MeshShape`, or the mesh the JAX rules take.

Parameters are named as the port names them (``blocks.3.attn.wq``) and
matched on the JAX leaf path (``models.names.jax_leaf``: ``blocks/attn/
wq``). A JAX ``blocks`` / ``enc_blocks`` leaf is stacked along a leading
layer axis that a port parameter does not have, so the port's spec of layer
i is the JAX spec of the stacked leaf without its leading entry (always
None). :func:`local_slice` turns a spec into the index of a full tensor
that one rank holds.

``to_shardings`` has no counterpart: a ``NamedSharding`` places an array
on devices under GSPMD, and the port places nothing implicitly. Here the
launcher resolves the layout: :func:`shard_for` gives a rank its
``models.tp.Shard``, which carries the index of its slice of every
parameter and cache leaf; the model allocates those slices
(``models.lm.LM(shard=)``, ``init_cache(shard=)``) and calls the explicit
collectives of the ``Shard``.
"""
from __future__ import annotations

import fnmatch
import functools
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.models.names import jax_leaf, tree_map_with_path
from repro_torch.models.tp import MeshShape, Shard

__all__ = [
    "param_specs",
    "batch_specs",
    "cache_specs",
    "cache_spec",
    "opt_specs",
    "fsdp_axes",
    "local_slice",
    "local_shape",
    "tree_map_with_path",
    "shard_for",
    "rank_coords",
    "piece_indices",
    "batch_rows",
    "rank_rows",
]

Spec = Tuple[Any, ...]


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _dp(mesh):
    ax = fsdp_axes(mesh)
    return ax if len(ax) > 1 else ax[0]


def _rules(cfg: ArchConfig, mesh, tp: int, ep_override=None):
    F = _dp(mesh)  # FSDP axes for weight sharding
    _, _, policy = cfg.padded_heads(tp)
    kv_shard = "model" if policy == "shard" else None
    q_shard = "model" if policy in ("shard", "shard_q", "pad") else None
    # An SSM mixer splits by heads, or not at all (module docstring).
    mix = "model" if cfg.n_heads % tp == 0 else None
    ep = cfg.moe is not None and cfg.moe.n_experts % tp == 0
    if ep_override is not None:
        ep = ep_override
    # (pattern, base_spec) — first match wins; leading stack dims padded later.
    return [
        # Embed: vocab over 'model' only (its d_model dim over 'data' would
        # compete with the batch dim for the data axis).
        ("embed", ("model", None)),
        ("head", (F, "model")),
        ("vit_proj", (F, None)),
        # Attention projections.
        ("*attn/wq", (F, q_shard)),
        ("*attn/wk", (F, kv_shard)),
        ("*attn/wv", (F, kv_shard)),
        ("*attn/wo", (q_shard, F)),
        ("*attn/bq", (q_shard,)),
        ("*attn/bk", (kv_shard,)),
        ("*attn/bv", (kv_shard,)),
        # Dense MLP.
        ("*mlp/w_gate", (F, "model")),
        ("*mlp/w_up", (F, "model")),
        ("*mlp/w_down", ("model", F)),
        # MoE.
        ("*moe/router", (F, None)),
        ("*moe/w_gate", ("model", F, None) if ep else (None, F, "model")),
        ("*moe/w_up", ("model", F, None) if ep else (None, F, "model")),
        ("*moe/w_down", ("model", None, F) if ep else (None, "model", F)),
        # RWKV-6 time-mix / channel-mix.
        ("*att/wr", (F, mix)),
        ("*att/wk", (F, mix)),
        ("*att/wv", (F, mix)),
        ("*att/wg", (F, mix)),
        ("*att/wo", (mix, F)),
        ("*att/w_a", (F, None)),
        ("*att/w_b", (None, F)),
        ("*att/u", (mix, None)),
        ("*cm/wk", (F, mix)),
        ("*cm/wv", (mix, F)),
        ("*cm/wr", (F, mix)),
        # Mamba-2: head-aligned TP (z/x out dims are head-major H·P; dt is H).
        # B/C are shared across heads — replicated.
        ("*mamba/w_z", (F, mix)),
        ("*mamba/w_x", (F, mix)),
        ("*mamba/w_B", (F, None)),
        ("*mamba/w_C", (F, None)),
        ("*mamba/w_dt", (F, mix)),
        ("*mamba/a_log", (mix,)),
        ("*mamba/dt_bias", (mix,)),
        ("*mamba/d_skip", (mix,)),
        ("*mamba/norm", (mix,)),
        ("*mamba/w_out", (mix, F)),
        # Everything small (norms, mixes, decays, biases): replicated.
        ("*", ()),
    ]


def _axes_size(entry, axis_sizes: Mapping[str, int]) -> int:
    axes = entry if isinstance(entry, tuple) else (entry,)
    return int(np.prod([axis_sizes[a] for a in axes]))


def _match(path: str, shape, rules, axis_sizes) -> Spec:
    for pat, spec in rules:
        if fnmatch.fnmatch(path, pat) or fnmatch.fnmatch(path, "*/" + pat):
            base = tuple(spec)
            if len(base) > len(shape):  # 1-D bias matched by 2-D-ish rule
                base = base[-len(shape):] if len(shape) else ()
            full = list((None,) * (len(shape) - len(base)) + base)
            # A dimension the axes do not divide is replicated (e.g. granite's
            # vocab 49,155 over 16 ranks: the embedding is replicated).
            for i, ax in enumerate(full):
                if ax is not None and shape[i] % _axes_size(ax, axis_sizes) != 0:
                    full[i] = None
            return tuple(full)
    return ()


def _drop_fsdp(spec: Spec, mesh) -> Spec:
    fs = set(fsdp_axes(mesh))
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a not in fs)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(None if entry in fs else entry)
    return tuple(out)


def _named_shapes(params) -> Dict[str, Tuple[int, ...]]:
    if hasattr(params, "named_parameters"):
        return {n: tuple(p.shape) for n, p in params.named_parameters()}
    return {n: tuple(getattr(p, "shape", p)) for n, p in params.items()}


def param_specs(cfg: ArchConfig, mesh, tp: int, params, mode: str = "train",
                ep_override=None) -> Dict[str, Spec]:
    """The spec of each parameter, by its port name. ``params`` is an
    ``LM`` (any device, ``meta`` included) or a mapping of port names to
    tensors or shapes.

    mode='train': FSDP+TP (fully sharded params — the optimizer must fit).
    mode='serve': TP only — weights replicated across the data axes. A
    decode step reads every weight once per token, so FSDP sharding would
    gather the whole model every step."""
    if mode not in ("train", "serve"):
        raise ValueError(f"repro_torch.launch.sharding.param_specs: mode {mode!r}")
    rules = _rules(cfg, mesh, tp, ep_override=ep_override)
    axis_sizes = dict(mesh.shape)
    out = {}
    for name, shape in _named_shapes(params).items():
        key, layer = jax_leaf(name)
        path = key.replace(".", "/")
        if layer is None:
            spec = _match(path, shape, rules, axis_sizes)
        else:  # JAX's stacked leaf, then its per-layer part
            stacked = _match(path, (1,) + shape, rules, axis_sizes)
            if stacked[0] is not None:
                raise ValueError(f"param_specs: {path} would split the layer axis: {stacked}")
            spec = stacked[1:]
        out[name] = _drop_fsdp(spec, mesh) if mode == "serve" else spec
    return out


def opt_specs(cfg: ArchConfig, mesh, tp: int, opt_shape: Any, pspecs: Dict[str, Spec]) -> Dict:
    """AdamW moments inherit the parameter specs; the step is replicated."""
    return dict(m=pspecs, v=pspecs, step=())


def _dp_size(mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in fsdp_axes(mesh)]))


def batch_specs(cfg: ArchConfig, mesh, batch_shape: Any) -> Any:
    """Each batch leaf's leading (batch) dim over the data axes when they
    divide it, the rest replicated."""
    dp, dp_size = _dp(mesh), _dp_size(mesh)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        lead = dp if shape[0] % dp_size == 0 else None
        return (lead,) + (None,) * (len(shape) - 1)

    return tree_map_with_path(one, batch_shape)


def batch_rows(shard: Shard, batch: int) -> slice:
    """This rank's rows of a batch of ``batch`` rows, as :func:`batch_specs`
    places a batch: its share by data coordinate when the data axes divide
    the batch, else all."""
    rows = {"rows": np.broadcast_to(np.int8(0), (batch,))}
    spec = batch_specs(None, shard.mesh, rows)["rows"]
    return local_slice((batch,), spec, shard.mesh, shard.coord)[0]


def rank_rows(shard: Shard, batch: int) -> Tuple[slice, Shard]:
    """(this rank's rows of the batch (:func:`batch_rows`), the shard told
    whether they are its share: ``Shard.with_rows``, so that the MoE plans
    over the whole batch)."""
    rows = batch_rows(shard, batch)
    return rows, shard.with_rows(rows.stop - rows.start < batch)


def cache_spec(cfg: ArchConfig, mesh, tp: int, path: str, shape) -> Spec:
    """The spec of one cache leaf at ``path`` ("kv/0", "s", ...): the KV
    cache's sequence over 'model', its batch over the data axes when they
    divide it; SSM states' heads over 'model' (when tp divides the heads);
    token-shift carries by batch only."""
    dp, dp_size = _dp(mesh), _dp_size(mesh)
    shp = tuple(shape)
    if path.startswith("kv") or path.startswith("xkv"):
        if len(shp) == 5:  # (L, B, KV, S, Dh): sequence over 'model'.
            bdim = dp if shp[1] % dp_size == 0 else None
            return (None, bdim, None, "model", None)
        # per-application leaf (B, KV, S, Dh) — hybrid shared-attn caches.
        bdim = dp if shp[0] % dp_size == 0 else None
        return (bdim, None, "model", None)
    bdim = dp if shp[1] % dp_size == 0 else None
    if path.startswith("s"):
        # (L, B, H, N, P): heads over 'model'.
        return (None, bdim, "model" if cfg.n_heads % tp == 0 else None, None, None)
    if path.startswith("lx"):
        return (None, bdim, None)
    return (None,) * len(shp)


def cache_specs(cfg: ArchConfig, mesh, tp: int, cache_shape: Any) -> Any:
    """:func:`cache_spec` of every leaf of a cache (the same structure of
    dicts, tuples and lists; leaves with ``.shape``)."""
    return tree_map_with_path(lambda p, leaf: cache_spec(cfg, mesh, tp, p, leaf.shape),
                              cache_shape)


def local_slice(shape, spec: Spec, mesh, coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """The index of the part of a ``shape`` tensor that the rank at mesh
    coordinates ``coords`` (axis -> coordinate) holds under ``spec``. A
    dimension split over several axes is split over them in order, major to
    minor, as JAX lays it out; a dimension the axes do not divide raises."""
    sizes = dict(mesh.shape)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            out.append(slice(0, dim))
            continue
        idx, total = 0, 1
        for ax in entry if isinstance(entry, tuple) else (entry,):
            idx, total = idx * sizes[ax] + coords[ax], total * sizes[ax]
        if dim % total:
            raise ValueError(f"local_slice: dimension {dim} does not split over {entry} ({total})")
        n = dim // total
        out.append(slice(idx * n, (idx + 1) * n))
    return tuple(out)


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of every rank's part of a ``shape`` tensor under ``spec``."""
    coords = {ax: 0 for ax in mesh.axis_names}
    return tuple(s.stop - s.start for s in local_slice(shape, spec, mesh, coords))


def _cache_index(cfg: ArchConfig, mesh, tp: int, coords: Mapping[str, int], path: str,
                 shape) -> Tuple[slice, ...]:
    """The index of the rank's piece of the cache leaf at ``path`` (whole
    ``shape``): a dim split over 'model' is laid out over its length
    rounded up to a multiple of tp, so a KV piece may reach past the whole
    length (the rank allocates it, padded); a cross-attention K/V piece
    (``xkv``) is cut at the whole length (the last ranks hold fewer
    positions, or none)."""
    spec = cache_spec(cfg, mesh, tp, path, shape)
    padded = tuple(-(-n // tp) * tp if entry == "model" else n for n, entry in zip(shape, spec))
    idx = local_slice(padded, spec, mesh, coords)
    if path.startswith("xkv"):
        idx = tuple(slice(min(i.start, n), min(i.stop, n)) for i, n in zip(idx, shape))
    return idx


def shard_for(cfg: ArchConfig, mesh, backend: Optional[str] = None,
              ep_override: Optional[bool] = None,
              coords: Optional[Tuple[int, ...]] = None, mode: str = "serve") -> Shard:
    """The :class:`~repro_torch.models.tp.Shard` of this rank: its place on
    ``mesh``, the head policy at the mesh's model size, and the layout —
    the spec and index of its piece of each parameter (:func:`param_specs`
    in ``mode``: 'serve', TP only, or 'train', FSDP over the data axes
    too) and the index of each cache leaf (:func:`cache_spec`).

    ``mesh`` is a ``DeviceMesh`` with axes ("data", "model")
    (``launch.mesh.make_local_mesh``), whose coordinates and groups the
    shard takes; or a :class:`~repro_torch.models.tp.MeshShape` with the
    rank's ``coords``, a shard with no process group: it can allocate and
    fill pieces, and it is in counting mode (``Shard.counting``: its
    collectives are counted and shaped, never issued; what
    ``launch.dryrun`` runs a rank's step with)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.models import lm

    if isinstance(mesh, MeshShape):
        shape, groups = mesh, dict(model_group=None, data_group=None, counting=True)
    else:
        shape = mesh_shape(mesh)
        coords = tuple(int(c) for c in mesh.get_coordinate())
        groups = dict(model_group=mesh.get_group("model"), data_group=mesh.get_group("data"))
        backend = backend or dist.get_backend()
    tp = shape.shape["model"]
    coord = dict(zip(shape.axis_names, coords))
    whole = lm.LM(cfg, tp, device="meta")
    specs = param_specs(cfg, shape, tp, whole, mode=mode, ep_override=ep_override)
    index = {name: local_slice(p.shape, specs[name], shape, coord)
             for name, p in whole.named_parameters()}
    return Shard(mesh=shape, coords=tuple(coords), policy=cfg.padded_heads(tp)[2], backend=backend,
                 ep_override=ep_override, mode=mode, param_index=index, param_spec=specs,
                 cache_index=functools.partial(_cache_index, cfg, shape, tp, coord), **groups)


def rank_coords(mesh, rank: int) -> Dict[str, int]:
    """The mesh coordinates of ``rank``: its row-major position on the
    mesh, as ``launch.mesh.make_local_mesh`` lays the ranks out."""
    coords, rest = {}, rank
    for ax, n in reversed(list(zip(mesh.axis_names, mesh.sizes))):
        coords[ax], rest = rest % n, rest // n
    return coords


def piece_indices(shard: Shard, shapes: Mapping[str, Tuple[int, ...]]) -> Dict[str, list]:
    """Every rank's index of its piece of each parameter (whole shapes
    ``shapes``, by name) under ``shard``'s layout, in rank order."""
    mesh = shard.mesh
    coords = [rank_coords(mesh, r) for r in range(mesh.size)]
    return {name: [local_slice(shape, shard.param_spec[name], mesh, c) for c in coords]
            for name, shape in shapes.items()}
