"""Tensor-parallel and fully-sharded context of the port's LM: where a rank
sits on the mesh, and the collectives of its ``model`` and ``data`` groups.

The JAX package gets its collectives from GSPMD, which inserts them where
the sharding specs meet; here they are explicit. A :class:`Shard` is built
once per model by the launcher (``launch.sharding.shard_for``), which
resolves the layout there: the index of the rank's piece of every
parameter (``param_index``), its spec (``param_spec``) and the index of
every cache leaf (``cache_index``). The model layer (``models.lm``,
``models.layers``) reads the layout and calls the collectives, and imports
nothing of ``launch``.

Serving (``param_spec`` from ``param_specs(mode="serve")``, under
``torch.no_grad``):

  all_reduce(x, op)   — sum or max over the ``model`` group, in place
  all_gather(x, dim)  — the ranks' pieces concatenated along ``dim``, in
                        ``model`` coordinate order

Training (``mode="train"``: each leaf FSDP-split over ``data`` as well)
takes the same calls under autograd, where each has the backward its use
needs, plus three more. A rank computes its rows of the batch; the loss is
the mean of the data ranks' losses (:meth:`Shard.data_mean`, whose
backward hands each rank 1/dp of the gradient), so every sum of gradients
over the data group below is a plain sum:

  all_reduce(x)       — (a) a sum of partials feeding replicated compute
                        (row-split products, the MoE combine, the
                        vocab-split embedding): backward the identity
  enter(x)            — (b) a tensor every model rank holds whole entering
                        compute split over the model group (a column-split
                        projection's input): forward the identity, backward
                        the sum of its gradient over the model group
  all_gather(x, dim)  — (c) the vocab-split logits: backward the rank's
                        slice
  gather_rows(x)      — the data ranks' rows concatenated in data
                        coordinate order (what the MoE plans over):
                        backward the sum over the data group, the rank's
                        slice of it
  fsdp_gather(ts, dims) — (d) leaves gathered over the data group along
                        their FSDP dims into their serve-layout pieces, one
                        collective per dtype: backward a reduce-scatter
                        (sum) of their gradients
  data_sum(ts)        — gradients of leaves not split over data summed
                        over the data group (after backward)

Each call adds one to ``stats[op][0]`` and the bytes of this rank's tensor
to ``stats[op][1]``: the model group's ops are named as in serving
(``all_reduce_sum``, ``all_reduce_max``, ``all_gather``, counted in
forward and backward alike), the data group's ``data_all_gather``,
``data_all_reduce_sum`` and ``data_reduce_scatter``, the whole world's
``world_all_reduce_sum`` and ``world_all_gather``.

A shard in counting mode (``counting=True``: what
``launch.sharding.shard_for`` builds from a shape-only mesh, which has no
process group) makes the same calls with the same counts and bytes and
returns results of the right shapes, but issues nothing: an all-reduce
returns its input as it is, a gather or a reduce-scatter its buffers
unfilled. The dry run (``launch.dryrun``) runs a rank's step on ``meta``
tensors that way.

:data:`NO_SHARD` is the one-device context (tp 1): it issues no collective
and no extra operation, so every path that does not ask for a shard runs
as it did. A shard with a ``model`` axis of size 1 is treated the same way
by the layers, and a data axis of size 1 issues no data collective.

Both backends take CUDA tensors directly: NCCL does, and gloo runs these
collectives on them by staging through the host itself (checked on an
H100 with two ranks on one card, reduce-scatter included), so no host
buffer is managed here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["MeshShape", "Shard", "NO_SHARD"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

Index = Tuple[slice, ...]
Spec = Tuple[Any, ...]


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


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _grad_on(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


@dataclasses.dataclass(frozen=True)
class Shard:
    """A rank's place on a (data, model) mesh and its collectives.

    ``mesh`` gives the axis sizes, ``coords`` this rank's coordinate on
    each axis (in ``mesh.axis_names`` order); ``model_group`` is the
    process group of the ranks that share this rank's data coordinate,
    ``data_group`` of those that share its model coordinate; ``policy`` is
    the attention head policy at this mesh's model degree
    (``ArchConfig.padded_heads``); ``ep_override`` the sharding rules'
    choice between expert and d_ff splitting of an MoE (None: experts when
    tp divides them, as ``launch.sharding.param_specs`` decides).

    ``param_index`` maps each parameter's name (``blocks.3.attn.wq``) to the
    index of the whole leaf this rank holds, ``param_spec`` to its spec
    (the axis names each dim is split over); ``mode`` says which rules gave
    them: "serve" (TP only) or "train" (FSDP over ``data`` too, where a
    layer sees a leaf only after :meth:`fsdp_gather`). ``cache_index(path,
    shape)`` gives the index of a whole cache leaf at ``path`` ("kv/0").
    All come from ``launch.sharding``'s rules.

    ``rows_split`` says that the rows the model is given are this rank's
    share of a batch split over the data axes (``launch.sharding.
    batch_specs``), not all of them: the MoE then plans over the whole
    batch (:meth:`gather_rows`), as one device does. ``with_rows`` sets it.

    ``counting`` puts the shard in counting mode (module docstring): its
    collectives are counted and shaped but not issued."""

    mesh: MeshShape = MeshShape(("data", "model"), (1, 1))
    coords: Tuple[int, ...] = (0, 0)
    policy: str = "shard"
    model_group: Any = None
    data_group: Any = None
    backend: str | None = None
    ep_override: bool | None = None
    mode: str = "serve"
    rows_split: bool = False
    counting: bool = False
    param_index: Mapping[str, Index] = dataclasses.field(default_factory=dict, compare=False,
                                                         repr=False)
    param_spec: Mapping[str, Spec] = dataclasses.field(default_factory=dict, compare=False,
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

    @property
    def data_rank(self) -> int:
        return self.coord.get("data", 0)

    def with_rows(self, rows_split: bool) -> "Shard":
        """This shard, told whether its rows are its share of the batch
        (the same groups, layout and ``stats``)."""
        split = bool(rows_split and self.dp > 1)
        return self if split == self.rows_split else dataclasses.replace(self, rows_split=split)

    # -- the layout --------------------------------------------------------

    def fsdp_dim(self, name: str) -> Optional[int]:
        """The dim of parameter ``name`` split over the data axes (train
        mode), or None: the leaf is whole over ``data``."""
        if self.mode != "train" or self.dp == 1:
            return None
        for i, entry in enumerate(self.param_spec.get(name, ())):
            if any(a != "model" for a in _axes(entry)):
                return i
        return None

    def counted(self, name: str) -> bool:
        """Whether this rank's piece of ``name`` is the one counted among
        the ranks that hold the same piece (coordinate 0 on every axis the
        leaf's spec does not split it over)."""
        named = {a for entry in self.param_spec.get(name, ()) for a in _axes(entry)}
        return all(c == 0 for ax, c in self.coord.items() if ax not in named)

    def whole_numel(self, name: str, local_numel: int) -> int:
        """The element count of the whole leaf ``name`` whose piece here has
        ``local_numel`` elements."""
        sizes = self.mesh.shape
        n = local_numel
        for entry in self.param_spec.get(name, ()):
            for a in _axes(entry):
                n *= sizes[a]
        return n

    # -- accounting --------------------------------------------------------

    def _count(self, op: str, x: torch.Tensor) -> None:
        entry = self.stats.setdefault(op, [0, 0])
        entry[0] += 1
        entry[1] += x.numel() * x.element_size()

    def _group(self, axis: str):
        return {"model": self.model_group, "data": self.data_group}.get(axis)

    def _size(self, axis: str) -> int:
        return {"model": self.tp, "data": self.dp}.get(axis, self.mesh.size)

    def _prefix(self, axis: str) -> str:
        return "" if axis == "model" else f"{axis}_"

    def _all_reduce(self, x: torch.Tensor, op: str, axis: str) -> torch.Tensor:
        self._count(f"{self._prefix(axis)}all_reduce_{op}", x)
        if not self.counting:
            dist.all_reduce(x, op=_OPS[op], group=self._group(axis))
        return x

    def _all_gather(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        self._count(f"{self._prefix(axis)}all_gather", x)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self._size(axis))]
        if not self.counting:
            dist.all_gather(parts, x, group=self._group(axis))
        return torch.cat(parts, dim=dim)

    # -- the model group ---------------------------------------------------

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced (``sum`` or ``max``) over the model group: in place
        (and returned) with no autograd history; under autograd a sum is a
        new tensor whose backward is the identity (a). At tp 1, ``x``
        itself."""
        if self.tp == 1:
            return x
        if op == "sum" and _grad_on(x):
            return _SumForward.apply(x, self)
        return self._all_reduce(x, op, "model")

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The model group's pieces of ``x`` concatenated along ``dim`` in
        model coordinate order; under autograd the backward keeps the
        rank's slice (c). At tp 1, ``x`` itself."""
        if self.tp == 1:
            return x
        if _grad_on(x):
            return _GatherAlong.apply(x, self, dim, "model", False)
        return self._all_gather(x, dim, "model")

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (whole on every model rank) entering compute split over the
        model group: the identity, whose backward sums the gradient over
        the model group (b). With no autograd history or at tp 1, ``x``."""
        if self.tp == 1 or not _grad_on(x):
            return x
        return _SumBackward.apply(x, self)

    # -- the data group ----------------------------------------------------

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The data ranks' rows of ``x`` concatenated along dim 0 in data
        coordinate order, when ``rows_split``; else ``x``. Under autograd
        the backward is the sum over the data group, the rank's rows of
        it."""
        if not self.rows_split or self.dp == 1:
            return x
        if _grad_on(x):
            return _GatherAlong.apply(x, self, 0, "data", True)
        return self._all_gather(x, 0, "data")

    def row_offset(self, n_local: int) -> int:
        """The first row of this rank's ``n_local`` rows in what
        :meth:`gather_rows` returns."""
        return self.data_rank * n_local if self.rows_split and self.dp > 1 else 0

    def data_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the data group (the loss of the whole
        batch from each rank's share of it); the backward hands each rank
        1/dp of the gradient. At dp 1, ``x``."""
        if self.dp == 1:
            return x
        return _DataMean.apply(x, self)

    def fsdp_gather(self, pieces: Sequence[torch.Tensor], dims: Sequence[Optional[int]]
                    ) -> List[torch.Tensor]:
        """Each piece gathered over the data group along its dim (in data
        coordinate order) — the leaf's serve-layout piece; a dim None is
        returned as it is. One all-gather per dtype among the gathered;
        under autograd the backward reduce-scatters (sums) the gradients,
        one per dtype."""
        idx = [i for i, d in enumerate(dims) if d is not None]
        if self.dp == 1 or not idx:
            return list(pieces)
        sel = [pieces[i] for i in idx]
        sel_dims = tuple(dims[i] for i in idx)
        if torch.is_grad_enabled() and any(p.requires_grad for p in sel):
            out = _FsdpGather.apply(self, sel_dims, *sel)
        else:
            out = _fsdp_gather(self, sel, sel_dims)
        res = list(pieces)
        for i, t in zip(idx, out):
            res[i] = t
        return res

    @torch.no_grad()
    def data_sum(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sums each tensor over the data group, in place: one all-reduce
        per dtype over the tensors packed flat. At dp 1, nothing."""
        if self.dp == 1:
            return
        for group in _by_dtype(tensors).values():
            flat = torch.cat([t.reshape(-1) for t in group])
            self._all_reduce(flat, "sum", "data")
            off = 0
            for t in group:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    # -- the world ---------------------------------------------------------

    def world_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over every rank of the mesh, in place. On one rank,
        ``x``."""
        if self.mesh.size == 1:
            return x
        return self._all_reduce(x, "sum", "world")

    def world_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
        order. On one rank, ``x``."""
        if self.mesh.size == 1:
            return x
        return self._all_gather(x, 0, "world")


def _by_dtype(tensors) -> Dict[torch.dtype, list]:
    out: Dict[torch.dtype, list] = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


def _reduce_scatter(shard: Shard, buf: torch.Tensor) -> torch.Tensor:
    """This rank's row of ``buf`` (dp, n) summed over the data group."""
    shard._count("data_reduce_scatter", buf)
    out = torch.empty(buf.shape[1:], dtype=buf.dtype, device=buf.device)
    if not shard.counting:
        scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        scatter(out, buf.reshape(-1), group=shard.data_group)
    return out


def _fsdp_gather(shard: Shard, pieces, dims) -> List[torch.Tensor]:
    dp = shard.dp
    out: List[Optional[torch.Tensor]] = [None] * len(pieces)
    order = {id(p): i for i, p in enumerate(pieces)}
    for group in _by_dtype(pieces).values():
        flat = torch.cat([p.reshape(-1) for p in group])
        shard._count("data_all_gather", flat)
        buf = torch.empty((dp, flat.numel()), dtype=flat.dtype, device=flat.device)
        if not shard.counting:
            gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
            gather(buf.reshape(-1), flat, group=shard.data_group)
        off = 0
        for p in group:
            i, n = order[id(p)], p.numel()
            out[i] = torch.cat([buf[r, off:off + n].view(p.shape) for r in range(dp)], dim=dims[i])
            off += n
    return out  # type: ignore[return-value]


class _FsdpGather(torch.autograd.Function):
    """(d): pieces → their gathers over the data group; backward: the
    gradients' chunks by data coordinate, reduce-scattered (summed)."""

    @staticmethod
    def forward(ctx, shard, dims, *pieces):
        ctx.shard, ctx.dims = shard, dims
        ctx.meta = [(p.shape, p.dtype, p.device) for p in pieces]
        return tuple(_fsdp_gather(shard, pieces, dims))

    @staticmethod
    def backward(ctx, *grads):
        shard, dims, dp = ctx.shard, ctx.dims, ctx.shard.dp
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        groups: Dict[torch.dtype, list] = {}
        for i, (shape, dtype, _) in enumerate(ctx.meta):
            groups.setdefault(dtype, []).append(i)
        for dtype, members in groups.items():
            rows = []
            for i in members:
                shape, _, device = ctx.meta[i]
                g = grads[i]
                if g is None:
                    g = torch.zeros((dp,) + tuple(shape), dtype=dtype, device=device)
                    rows.append(g.reshape(dp, -1))
                else:
                    chunks = g.to(dtype).chunk(dp, dim=dims[i])
                    rows.append(torch.stack([c.reshape(-1) for c in chunks]))
            mine = _reduce_scatter(shard, torch.cat(rows, dim=1))
            off = 0
            for i in members:
                shape = ctx.meta[i][0]
                n = int(torch.Size(shape).numel())
                out[i] = mine[off:off + n].view(shape)
                off += n
        return (None, None) + tuple(out)


class _SumForward(torch.autograd.Function):
    """(a): all-reduce (sum) over the model group forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, shard):
        return shard._all_reduce(x.clone(), "sum", "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """(b): identity forward, all-reduce (sum) over the model group
    backward."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard._all_reduce(g.contiguous().clone(), "sum", "model"), None


class _GatherAlong(torch.autograd.Function):
    """(c) and the MoE's rows: all-gather along ``dim``; backward the
    rank's slice, of the gradient summed over the group first when
    ``summed``."""

    @staticmethod
    def forward(ctx, x, shard, dim, axis, summed):
        ctx.shard, ctx.dim, ctx.axis, ctx.summed, ctx.n = shard, dim, axis, summed, x.shape[dim]
        return shard._all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        shard, axis = ctx.shard, ctx.axis
        if ctx.summed:
            g = shard._all_reduce(g.contiguous().clone(), "sum", axis)
        r = shard.model_rank if axis == "model" else shard.data_rank
        return g.narrow(ctx.dim, r * ctx.n, ctx.n), None, None, None, None


class _DataMean(torch.autograd.Function):
    """The mean over the data group; backward 1/dp of the gradient."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.dp = shard.dp
        return shard._all_reduce(x.detach().clone(), "sum", "data") / shard.dp

    @staticmethod
    def backward(ctx, g):
        return g / ctx.dp, None


NO_SHARD = Shard()
