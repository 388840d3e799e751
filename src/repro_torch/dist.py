"""Rank plumbing of the partitioner and the engine: a 1-D mesh over the
ranks of a ``torch.distributed`` process group, and the few collectives the
sharded spotlight scan and the sharded supersteps need.

  world_size(), rank()              — of the default process group; 1 and 0
                                      when none is initialised
  RankMesh, rank_mesh(axis_name, n) — a 1-D mesh over the first ``n`` ranks
                                      (all by default), with the JAX
                                      package's axis names (``parts`` for the
                                      engine, ``instances`` for spotlight)
  barrier(), shared_tmpdir(prefix)  — every rank waits for every other; a
                                      temporary directory made by rank 0,
                                      its path given to every rank (both
                                      plain calls with a world of 1)

This module imports only torch: the partition and processing layers
(``core``, ``engine``) take their ranks from here, not from ``launch``,
which joins the group (``launch.mesh.init_ranks``) and re-exports these
names. Nothing here touches a device or a process group when it is
imported.
"""
from __future__ import annotations

import dataclasses
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "world_size",
    "rank",
    "RankMesh",
    "rank_mesh",
    "barrier",
    "shared_tmpdir",
]


def world_size() -> int:
    """Ranks of the default process group; 1 when none is initialised."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default process group; 0 when none is
    initialised."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


_REDUCE = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A 1-D mesh over the first ``size`` ranks of the default process group
    (JAX's 1-D device meshes: ``("parts",)`` of the engine, ``("instances",)``
    of spotlight). Host-side: it holds the shape and this process's place,
    no device.

    ``coord`` is this rank's position on the axis, or None for a rank past
    the mesh (a mesh capped below the world size). The collectives run over
    the whole default group, so every rank, in the mesh or not, ends with
    the same values: a rank past the mesh holds no work and adds the
    reduction's identity. With a world of 1 they issue nothing and return
    their input. Each call adds one to ``stats[op][0]`` and this rank's
    bytes to ``stats[op][1]``."""

    axis_name: str
    size: int
    coord: Optional[int]
    world: int
    stats: Dict[str, List[int]] = dataclasses.field(default_factory=dict, compare=False)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (self.axis_name,)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_name: self.size}

    def _count(self, op: str, nbytes: int) -> None:
        entry = self.stats.setdefault(op, [0, 0])
        entry[0] += 1
        entry[1] += int(nbytes)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced (``sum``, ``min`` or ``max``) over the ranks, in
        place; returned. With a world of 1, ``x`` itself."""
        if self.world == 1:
            return x
        self._count(f"all_reduce_{op}", x.numel() * x.element_size())
        dist.all_reduce(x, op=_REDUCE[op])
        return x

    def any(self, flag: bool) -> bool:
        """True when ``flag`` is true on some rank."""
        if self.world == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=_comm_device())
        return bool(self.all_reduce(t, "max").item())

    def gather_values(self, values: Sequence[float]) -> "torch.Tensor":
        """(world, len(values)) float64 on the host: every rank's values,
        in rank order."""
        if self.world == 1:
            return torch.tensor([list(values)], dtype=torch.float64)
        t = torch.tensor([list(values)], dtype=torch.float64, device=_comm_device())
        self._count("all_gather", t.numel() * 8)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t)
        return torch.cat(parts).cpu()

    def gather_objects(self, obj: Any) -> List[Any]:
        """Every rank's picklable ``obj``, in rank order."""
        if self.world == 1:
            return [obj]
        self._count("all_gather_object", 0)
        out: List[Any] = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


def _comm_device() -> torch.device:
    """Where a host value goes for a collective: the current card under
    NCCL, which takes only CUDA tensors, else the host."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def rank_mesh(axis_name: str, n: Optional[int] = None) -> RankMesh:
    """A :class:`RankMesh` named ``axis_name`` over the first ``n`` ranks of
    the default process group (all when ``n`` is None; at least one, at
    most the world). With no process group: one rank, world 1."""
    world = world_size()
    size = world if n is None else max(1, min(int(n), world))
    r = rank()
    return RankMesh(axis_name, size, r if r < size else None, world)


def barrier() -> None:
    """Every rank of the default process group waits for every other (a
    one-element all-reduce, which both backends run); nothing with a world
    of 1."""
    rank_mesh("barrier").any(False)


def shared_tmpdir(prefix: str) -> str:
    """A new temporary directory made by rank 0, its path given to every
    rank (the ranks share one host's file system)."""
    path = tempfile.mkdtemp(prefix=prefix) if rank() == 0 else None
    return rank_mesh("tmpdir").gather_objects(path)[0]
