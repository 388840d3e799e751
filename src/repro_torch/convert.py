"""State carried across between the two packages, as numpy arrays.

The partitioner has no weights: its state is the ADWISE scan carry and the
partitioned graph. The LM side has weights, a KV cache and, in training, an
optimizer state. These functions turn their fields, taken out of either
package as numpy arrays, into the port's types and back, so a test can
start both packages from the same state.

A bfloat16 leaf of the JAX package arrives as an ``ml_dtypes.bfloat16``
numpy array, which ``torch.tensor`` rejects; it goes through float32,
which holds every bfloat16 value exactly, both ways.

The port's carry keeps a scatter-dump row W on the three lazy-traversal
caches (``cached_rcs``, ``cached_ver_u``, ``cached_ver_v``), where the JAX
step pads and slices per step; :func:`carry_from_numpy` adds it and
:func:`carry_to_numpy` strips it, so the numpy side always has the JAX
package's shapes.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core.adwise import Carry
from repro_torch.configs.base import ArchConfig
from repro_torch.engine import partitioned
from repro_torch.launch import sharding
from repro_torch.models import lm
from repro_torch.models.names import jax_leaf, jax_leaves
from repro_torch.models.tp import NO_SHARD, Shard

__all__ = [
    "carry_from_numpy",
    "carry_to_numpy",
    "partitioned_graph_from_numpy",
    "lm_params_from_numpy",
    "lm_params_to_numpy",
    "opt_state_from_numpy",
    "opt_state_to_numpy",
    "cache_from_numpy",
    "cache_to_numpy",
    "whole_leaves",
]

_PADDED = {"cached_rcs": 0.0, "cached_ver_u": -1, "cached_ver_v": -1}
_DTYPES = {
    "replicas": torch.bool, "win_valid": torch.bool, "last_grew": torch.bool,
    "lam": torch.float32, "cached_rcs": torch.float32, "theta": torch.float32,
    "sum_g": torch.float32, "avg_g_prev": torch.float32,
    "budget_left": torch.float32, "lat_ema": torch.float32,
    "cost_per_score": torch.float32, "base_cost": torch.float32,
}


def carry_from_numpy(fields: Dict[str, np.ndarray], device=None) -> Carry:
    """A port :class:`~repro_torch.core.adwise.Carry` on ``device`` from the
    JAX ``Carry``'s fields (one instance, no batch axis) as numpy arrays.
    The step advances a stack of instances: pass
    ``stack_instances([carry])`` for a batch of one."""
    dev = compat.resolve_device(device)
    missing = set(Carry._fields) - set(fields)
    if missing:
        raise KeyError(f"carry_from_numpy: missing fields {sorted(missing)}")
    out = {}
    for name in Carry._fields:
        a = np.asarray(fields[name])
        if name in _PADDED:
            pad = np.full((1,) + a.shape[1:], _PADDED[name], a.dtype)
            a = np.concatenate([a, pad])
        dtype = _DTYPES.get(name, torch.int32)
        out[name] = torch.tensor(a, device=dev).to(dtype)
    return Carry(**out)


def carry_to_numpy(carry: Carry) -> Dict[str, np.ndarray]:
    """The carry's fields as numpy arrays, in the JAX ``Carry``'s shapes."""
    out = {}
    for name, t in zip(Carry._fields, carry):
        a = t.detach().cpu().numpy()
        out[name] = a[:-1] if name in _PADDED else a
    return out


def partitioned_graph_from_numpy(
    edges: np.ndarray,  # (k, e_max, 2) int
    evalid: np.ndarray,  # (k, e_max) bool
    replicas: np.ndarray,  # (V, k) bool
    masters: np.ndarray,  # (V,) int
    degrees: np.ndarray,  # (V,) int
    num_vertices: int,
    k: int,
    device=None,
) -> partitioned.PartitionedGraph:
    """A port PartitionedGraph from the JAX ``PartitionedGraph``'s fields
    (builds the destination-sorted message layout the engine gathers with)."""
    return partitioned.from_arrays(
        np.asarray(edges, np.int32), np.asarray(evalid, bool),
        np.asarray(replicas, bool), np.asarray(masters, np.int32),
        np.asarray(degrees, np.int32), num_vertices, k,
        compat.resolve_device(device),
    )


def _as_torch(a, dtype: torch.dtype | None, device) -> torch.Tensor:
    """A numpy leaf as a tensor; bfloat16 (by name, so no ``ml_dtypes``
    import is needed) goes through float32, and so does any leaf when
    ``dtype`` is given."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        dtype = dtype or torch.bfloat16
        a = a.astype(np.float32)
    elif dtype is not None:
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a, order="C"))  # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def _leaves(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _per_param(tree: Mapping[str, Any], model: lm.LM, cfg: ArchConfig, what: str
               ) -> Dict[str, np.ndarray]:
    """name -> numpy array of each of ``model``'s parameters, read from a
    nested dict in the JAX ``init_params`` layout (stacked ``blocks`` and
    ``enc_blocks`` leaves split per layer). Every leaf must be present with
    the port's shape, and nothing else may be: a missing, extra or
    mis-shaped leaf raises. A sharded model's leaves are read whole and
    cut to the rank's part (``LM.tp_layout``)."""
    src = _leaves(tree)
    want = {name: jax_leaf(name) for name, _ in model.named_parameters()}
    missing = {key for key, _ in want.values()} - set(src)
    extra = set(src) - {key for key, _ in want.values()}
    if missing or extra:
        raise KeyError(f"{what}: missing leaves {sorted(missing)}, unexpected {sorted(extra)}")
    out = {}
    for name, p in model.named_parameters():
        key, layer = want[name]
        a = np.asarray(src[key])
        if layer is not None:
            n = cfg.n_enc_layers if key.startswith("enc_blocks.") else cfg.n_layers
            if a.shape[0] != n:
                raise ValueError(f"{what}: {key} stacks {a.shape[0]} layers, the config {n}")
            a = a[layer]
        full, idx = model.tp_layout.get(name, (tuple(p.shape), None))
        if tuple(a.shape) != full:
            raise ValueError(
                f"{what}: {name} has shape {tuple(a.shape)}, expected {full}"
            )
        out[name] = a if idx is None else a[idx]
    return out


@torch.no_grad()
def lm_params_from_numpy(
    params: Mapping[str, Any], cfg: ArchConfig, device=None, tp: int = 1,
    shard: Shard = NO_SHARD,
) -> lm.LM:
    """The port's :class:`~repro_torch.models.lm.LM` on ``device`` from the
    nested dict of JAX ``lm.init_params`` leaves as numpy arrays, for every
    family.

    The stacked ``blocks`` and ``enc_blocks`` leaves (leading axis = layer)
    are split per layer; ``shared``, ``vit_proj`` and ``enc_ln_f`` are
    unstacked. Every leaf must be present with the port's shape, and nothing
    else may be: a missing, extra or mis-shaped leaf raises. Each leaf lands
    in its parameter's dtype, which is the JAX leaf's: the leaves the JAX
    package keeps in fp32 in a bf16 model (the MoE router, RWKV-6's ``w0``
    ``w_a`` ``w_b`` ``u`` ``ln_x``, Mamba-2's ``a_log`` ``dt_bias``
    ``d_skip`` ``norm``) stay fp32, unrounded.

    ``tp`` is the model-parallel degree the JAX parameters were drawn for
    (their heads padded by ``ArchConfig.padded_heads(tp)``); under a
    ``shard`` of that degree each parameter receives the rank's slice of its
    leaf, as ``launch.sharding.param_specs(mode="serve")`` places it.
    """
    model = lm.LM(cfg, tp, device=device, shard=shard)
    arrays = _per_param(params, model, cfg, "lm_params_from_numpy")
    for name, p in model.named_parameters():
        p.copy_(_as_torch(arrays[name], p.dtype, p.device))
    return model


def _nest(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, a in flat.items():
        *parents, leaf = key.split(".")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = a
    return out


def _numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_params_to_numpy(params: "lm.LM | Mapping[str, torch.Tensor]") -> Dict[str, Any]:
    """The JAX ``init_params`` layout (nested dict; per-layer leaves stacked
    into ``blocks`` / ``enc_blocks`` along a leading layer axis) as numpy
    arrays, from an
    :class:`~repro_torch.models.lm.LM` or a mapping of its parameter names
    to tensors or numpy arrays (its gradients, an optimizer moment, the
    whole leaves of :func:`whole_leaves`); bfloat16 comes out as float32
    (exact)."""
    named = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else params
    flat = {}
    for key, names in jax_leaves(named).items():
        layers = [jax_leaf(n)[1] for n in names]
        if layers == [None]:
            flat[key] = _numpy(named[names[0]])
        elif layers == list(range(len(names))):
            flat[key] = np.stack([_numpy(named[n]) for n in names])
        else:
            raise ValueError(f"lm_params_to_numpy: {key} has layers {layers}")
    return _nest(flat)


def opt_state_from_numpy(opt: Mapping[str, Any], model: lm.LM, cfg: ArchConfig
                         ) -> Dict[str, Any]:
    """The port's AdamW state (``repro_torch.optim.adamw_init``'s layout:
    fp32 ``m`` and ``v`` by parameter name, a 0-dim int32 ``step``) on the
    model's device, from the JAX ``adamw_init`` / ``adamw_update`` state as
    numpy arrays (``m`` and ``v`` in the ``init_params`` layout)."""
    dev = model.embed.device
    moments = {}
    for k in ("m", "v"):
        arrays = _per_param(opt[k], model, cfg, f"opt_state_from_numpy[{k}]")
        moments[k] = {n: _as_torch(a, torch.float32, dev) for n, a in arrays.items()}
    step = torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32, device=dev)
    return dict(m=moments["m"], v=moments["v"], step=step)


def opt_state_to_numpy(opt: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's AdamW state in the JAX layout, as numpy arrays."""
    return dict(m=lm_params_to_numpy(opt["m"]), v=lm_params_to_numpy(opt["v"]),
                step=np.asarray(int(opt["step"]), np.int32))


def _map_tree(tree: Any, fn) -> Any:
    """``fn`` applied to every leaf of a tree of dicts, tuples and lists,
    which keep their types."""
    if isinstance(tree, Mapping):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn) for v in tree)
    return fn(tree)


def cache_from_numpy(cache: Mapping[str, Any], device=None, shard: Shard = NO_SHARD) -> lm.Cache:
    """A port cache on ``device`` from the JAX ``init_cache`` /
    ``forward_cached`` cache of any family as numpy arrays, in the same
    structure (dicts, tuples and lists kept: dense / moe / vlm ``kv=(k, v)``;
    ssm ``s``, ``lx_att``, ``lx_cm``; hybrid ``s`` and a ``kv`` list of
    (k, v) pairs; encdec ``kv`` and ``xkv``), each leaf in its own dtype
    (the fp32 SSM states of a bf16 model stay fp32).

    Under a ``shard`` each leaf is cut to the rank's part
    (``shard.cache_index``, from ``launch.sharding.cache_spec``), a KV
    piece that reaches past the sequence's end padded with zeros; a rank's
    cache goes back with :func:`cache_to_numpy`, and the ranks' parts tile
    the whole (``launch.sharding.local_slice``)."""
    dev = compat.resolve_device(device)
    if shard.mesh.size > 1:
        cache = sharding.tree_map_with_path(
            lambda path, a: _cache_piece(np.asarray(a), shard.cache_index(path, np.shape(a))),
            cache)
    return _map_tree(cache, lambda a: _as_torch(a, None, dev))


def _cache_piece(a: np.ndarray, idx) -> np.ndarray:
    """``a[idx]``, zeros where ``idx`` reaches past ``a``'s end."""
    piece = a[idx]
    short = [(0, (i.stop - i.start) - n) for i, n in zip(idx, piece.shape)]
    return np.pad(piece, short) if any(p for _, p in short) else piece


def cache_to_numpy(cache: lm.Cache) -> Dict[str, Any]:
    """The cache as numpy arrays in the JAX layout and structure; a bfloat16
    leaf comes out as float32 (exact)."""
    return _map_tree(cache, _numpy)


def whole_leaves(ranks: Sequence[Tuple[Mapping[str, Any], Mapping[str, Tuple[tuple, tuple]]]]
                 ) -> Dict[str, np.ndarray]:
    """Whole leaves by name from the ranks' pieces: one (pieces, layout) per
    rank, ``pieces`` a name -> array (or tensor) mapping of the rank's part
    of each leaf (its parameters, gradients, moments or residual) and
    ``layout`` name -> (whole shape, index), as ``LM.tp_layout`` gives it.
    Every element must be covered, and a piece several ranks hold must be
    equal on each of them; either fault raises naming the leaf. The result
    goes to the JAX layout with :func:`lm_params_to_numpy`."""
    out: Dict[str, np.ndarray] = {}
    seen: Dict[str, np.ndarray] = {}
    for pieces, layout in ranks:
        for name, piece in pieces.items():
            a = _numpy(piece)
            shape, idx = layout[name]
            if name not in out:
                out[name] = np.zeros(tuple(shape), a.dtype)
                seen[name] = np.zeros(tuple(shape), bool)
            idx = tuple(idx)
            held = seen[name][idx]
            if held.any() and not np.array_equal(out[name][idx][held], a[held]):
                raise ValueError(f"whole_leaves: {name}: ranks hold different values of one piece")
            out[name][idx] = a
            seen[name][idx] = True
    for name, cover in seen.items():
        if not cover.all():
            raise ValueError(f"whole_leaves: {name}: {int((~cover).sum())} elements held by no rank")
    return out
