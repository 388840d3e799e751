"""Tensor-parallel context of the port's LM: where a rank sits on the mesh,
and the collectives of its ``model`` group.

The JAX package gets its collectives from GSPMD, which inserts them where
the sharding specs meet; here they are explicit. A :class:`Shard` is built
once per served model by the launcher (``launch.sharding.shard_for``),
which resolves the layout there: the index of the rank's slice of every
parameter (``param_index``) and of every cache leaf (``cache_index``). The
model layer (``models.lm``, ``models.layers``) reads the layout and calls
the collectives, and imports nothing of ``launch``:

  all_reduce(x, op)   — sum or max over the ``model`` group
  all_gather(x, dim)  — the ranks' pieces concatenated along ``dim``, in
                        ``model`` coordinate order (the list form of
                        ``torch.distributed.all_gather``, then ``cat``)

Each call adds one to ``stats[op][0]`` and the tensor's bytes (this rank's
input) to ``stats[op][1]``, so a launcher reports collectives per phase.

:data:`NO_SHARD` is the one-device context (tp 1): it issues no collective
and no extra operation, so every path that does not ask for a shard runs
as it did. A shard with a ``model`` axis of size 1 (e.g. one rank) is
treated the same way by the layers.

Both backends take CUDA tensors directly: NCCL does, and gloo runs
``all_reduce`` and the list form of ``all_gather`` on them by staging
through the host itself (checked on an H100 with two ranks on one card),
so no host buffer is managed here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["MeshShape", "Shard", "NO_SHARD"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

Index = Tuple[slice, ...]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind it (what the
    sharding rules read; ``launch.mesh`` exports it)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"MeshShape: axes {self.axis_names} and sizes {self.sizes} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class Shard:
    """A rank's place on a (data..., model) mesh and its collectives.

    ``mesh`` gives the axis sizes, ``coords`` this rank's coordinate on
    each axis (in ``mesh.axis_names`` order); ``model_group`` is the
    process group of the ranks that share this rank's data coordinates;
    ``policy`` is the attention head policy at this mesh's model degree
    (``ArchConfig.padded_heads``); ``ep_override`` the sharding rules'
    choice between expert and d_ff splitting of an MoE (None: experts when
    tp divides them, as ``launch.sharding.param_specs`` decides).

    ``param_index`` maps each parameter's name (``blocks.3.attn.wq``) to the
    index of the whole leaf this rank holds; ``cache_index(path, shape)``
    gives the index of a whole cache leaf at ``path`` ("kv/0"). Both come
    from ``launch.sharding``'s rules."""

    mesh: MeshShape = MeshShape(("data", "model"), (1, 1))
    coords: Tuple[int, ...] = (0, 0)
    policy: str = "shard"
    model_group: Any = None
    data_group: Any = None
    backend: str | None = None
    ep_override: bool | None = None
    param_index: Mapping[str, Index] = dataclasses.field(default_factory=dict, compare=False,
                                                         repr=False)
    cache_index: Optional[Callable[[str, Tuple[int, ...]], Index]] = dataclasses.field(
        default=None, compare=False, repr=False)
    stats: Dict[str, list] = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def coord(self) -> Dict[str, int]:
        return dict(zip(self.mesh.axis_names, self.coords))

    @property
    def tp(self) -> int:
        return self.mesh.shape.get("model", 1)

    @property
    def model_rank(self) -> int:
        return self.coord.get("model", 0)

    @property
    def dp(self) -> int:
        """The size of the data axes together (``pod`` and ``data``)."""
        return self.mesh.size // self.tp

    def _count(self, op: str, x: torch.Tensor) -> None:
        entry = self.stats.setdefault(op, [0, 0])
        entry[0] += 1
        entry[1] += x.numel() * x.element_size()

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced (``sum`` or ``max``) over the model group, in place;
        returned. At tp 1, ``x`` itself."""
        if self.tp == 1:
            return x
        self._count(f"all_reduce_{op}", x)
        dist.all_reduce(x, op=_OPS[op], group=self.model_group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The model group's pieces of ``x`` concatenated along ``dim`` in
        model coordinate order. At tp 1, ``x`` itself."""
        if self.tp == 1:
            return x
        self._count("all_gather", x)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.tp)]
        dist.all_gather(parts, x, group=self.model_group)
        return torch.cat(parts, dim=dim)


NO_SHARD = Shard()

