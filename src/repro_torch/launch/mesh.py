"""Meshes of the port (counterpart of ``repro.launch.mesh``), and the
process plumbing a mesh of ranks needs.

JAX lays a mesh over devices; here a mesh is laid over the ranks of a
``torch.distributed`` process group, one process per rank:

  MeshShape                         — a frozen, shape-only mesh: ``.shape``
                                      (axis -> size, in order) and
                                      ``.axis_names``; what the sharding rules
                                      read, and the duck type a shape-only
                                      mesh passes to the JAX package's rules
                                      (defined in ``models.tp``, whose
                                      ``Shard`` holds one)
  make_production_mesh(multi_pod=)  — the production meshes as MeshShapes:
                                      (data=16, model=16) or (pod=2, 16, 16);
                                      nothing allocates 256 devices
  make_local_mesh(model_parallel)   — a ``DeviceMesh`` (data=world // tp,
                                      model=tp) over the ranks of the
                                      initialised default process group
  mesh_shape(mesh)                  — a ``DeviceMesh``'s MeshShape
  world_size(), rank(), barrier(),  — re-exported from ``repro_torch.dist``,
  shared_tmpdir(prefix),              the rank plumbing of the partitioner
  RankMesh, rank_mesh(axis_name, n)   and the engine (a 1-D mesh over the
                                      first ``n`` ranks, with the JAX
                                      package's axis names ``parts`` and
                                      ``instances``), which imports nothing
                                      of ``launch``
  init_ranks(backend, device)       — this process's rank from the launcher's
                                      environment (``RANK``, ``WORLD_SIZE``,
                                      ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, as
                                      torchrun sets them): its device set
                                      before anything is allocated, then the
                                      default process group
  join_ranks(ap, args, cfg, device, — a launcher's (shard, device, world):
             mode)                    its flags read (``--tp``,
                                      ``--dist-backend``, ``--dist-init``),
                                      the group joined, the mesh built and
                                      this rank's ``Shard`` of ``mode``
  per_rank(value, device, shard)    — an int from every rank, in rank order
  spawn(fn, world, args)            — ``fn(rank, *args)`` in ``world``
                                      spawned processes with that
                                      environment; returns their results in
                                      rank order, or raises naming the rank
                                      that raised or hung

Nothing here touches a device or a process group when it is imported.
"""
from __future__ import annotations

import os
import queue
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist import RankMesh, barrier, rank, rank_mesh, shared_tmpdir, world_size
from repro_torch.models.tp import MeshShape

__all__ = [
    "MODEL_PARALLEL",
    "MeshShape",
    "make_production_mesh",
    "make_local_mesh",
    "mesh_shape",
    "world_size",
    "rank",
    "RankMesh",
    "rank_mesh",
    "barrier",
    "shared_tmpdir",
    "init_ranks",
    "join_ranks",
    "per_rank",
    "spawn",
]

MODEL_PARALLEL = 16  # TP degree of the production meshes


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: (data=16, model=16) = 256 chips.
    Multi-pod: (pod=2, data=16, model=16) = 512 chips."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, MODEL_PARALLEL))
    return MeshShape(("data", "model"), (16, MODEL_PARALLEL))


def make_local_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape (world // model_parallel, model_parallel),
    axes ("data", "model"), over the ranks of the default process group,
    which must be initialised (:func:`init_ranks`); its groups are taken
    with ``mesh.get_group("model")`` / ``mesh.get_group("data")``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("repro_torch.launch.mesh.make_local_mesh: no process group; "
                           "initialise one first (init_ranks, or run under torchrun)")
    world = dist.get_world_size()
    if model_parallel < 1 or world % model_parallel != 0:
        raise ValueError(f"repro_torch.launch.mesh.make_local_mesh: world size {world} is not "
                         f"a multiple of the model-parallel degree {model_parallel}")
    return init_device_mesh(device_type, (world // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))


def mesh_shape(mesh) -> MeshShape:
    """The :class:`MeshShape` of a ``DeviceMesh`` (or of anything with
    ``mesh_dim_names`` and a ``shape`` tuple)."""
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(int(s) for s in mesh.shape))


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def init_ranks(backend: str, device: torch.device, init_method: str = "env://"
               ) -> Tuple[int, int, torch.device]:
    """Join the default process group as the launcher's environment says
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``).
    Returns (rank, world size, this rank's device).

    On the card the device is ``cuda:{LOCAL_RANK % device_count}``, made
    current (and CUDA initialised) before the group exists and before
    anything is allocated. NCCL refuses two ranks on one device, so asking
    for ``nccl`` with more local ranks than devices raises; ``gloo`` takes
    them (its collectives stage CUDA tensors through the host). A group that
    is already initialised is joined as it is."""
    rank, world = _env_int("RANK", 0), _env_int("WORLD_SIZE", 1)
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"repro_torch.launch.mesh.init_ranks: backend {backend!r} is not "
                         "'nccl' or 'gloo'")
    if device.type == "cuda":
        n_dev = torch.cuda.device_count()
        if backend == "nccl" and local_world > n_dev:
            raise RuntimeError(
                f"repro_torch.launch.mesh.init_ranks: NCCL cannot put {local_world} ranks on "
                f"{n_dev} CUDA device(s) (two ranks on one device); use --dist-backend gloo")
        device = torch.device("cuda", local_rank % n_dev)
        torch.cuda.set_device(device)
        torch.cuda.init()
    elif backend == "nccl":
        raise ValueError("repro_torch.launch.mesh.init_ranks: NCCL needs CUDA tensors; "
                         "use gloo with --device cpu")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"repro_torch.launch.mesh.init_ranks: the process group runs "
                           f"{dist.get_backend()}, not {backend}")
    return dist.get_rank(), dist.get_world_size(), device


def join_ranks(ap, args, cfg, device: torch.device, mode: str = "serve"):
    """(shard, device, world) of a launcher's run: its environment read, the
    device made current, the group joined (``args.dist_backend``: NCCL on
    ``cuda``, gloo on ``cpu`` by default; ``args.dist_init``), the (data,
    model) mesh of ``args.tp`` built, and this rank's ``Shard`` in ``mode``
    ('serve', or 'train': ``launch.sharding.shard_for``). With no process
    group (none initialised, no ``WORLD_SIZE``): (NO_SHARD, device, 1), and
    ``--tp`` must be 1. Exits through ``ap`` (code 2) naming what it
    refuses."""
    from repro_torch.launch import sharding
    from repro_torch.models.tp import NO_SHARD

    who = f"repro_torch.launch.{mode}"
    if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        if args.tp != 1:
            ap.exit(2, f"{who}: --tp > 1 needs a process group: run it under "
                       "torchrun (RANK / WORLD_SIZE / LOCAL_RANK) with world size a multiple of "
                       "--tp\n")
        return NO_SHARD, device, 1
    world = dist.get_world_size() if dist.is_initialized() else int(os.environ["WORLD_SIZE"])
    if world % args.tp:
        ap.exit(2, f"{who}: world size {world} is not a multiple of "
                   f"--tp {args.tp}\n")
    backend = args.dist_backend or ("nccl" if device.type == "cuda" else "gloo")
    _, world, device = init_ranks(backend, device, args.dist_init)
    mesh = make_local_mesh(args.tp, device.type)
    return sharding.shard_for(cfg, mesh, backend, mode=mode), device, world


def per_rank(value: int, device: torch.device, shard) -> list:
    """``value`` from every rank, in rank order (``[value]`` under
    ``NO_SHARD``)."""
    from repro_torch.models.tp import NO_SHARD

    if shard is NO_SHARD:
        return [value]
    parts = [torch.zeros(1, dtype=torch.int64, device=device) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, torch.tensor([value], dtype=torch.int64, device=device))
    return [int(p) for p in parts]


def _child(rank: int, fn: Callable, world: int, args: Sequence[Any], out) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    try:
        out.put((rank, fn(rank, *args)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence[Any] = (), timeout: float = 120.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world`` processes on this host
    (``torch.multiprocessing.start_processes``, ``spawn`` start method:
    ``fn`` and ``args`` are pickled, so ``fn`` is a module-level function)
    with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set
    as torchrun sets them. Returns the ranks' results in rank order.

    A rank that raises or dies fails the whole run (``start_processes``
    terminates the others: a rank waiting in a collective for a dead peer
    never returns), and so does a run with ranks that have not answered
    when ``timeout`` seconds have passed. RuntimeError names the rank, with
    its traceback."""
    import torch.multiprocessing as mp

    out = mp.get_context("spawn").Queue()
    ctx = mp.start_processes(_child, (fn, world, tuple(args), out), nprocs=world, join=False,
                             daemon=True, start_method="spawn")
    results: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        # join raises as soon as a rank has raised or died
        while not (ctx.join(timeout=0, grace_period=2) and len(results) == world):
            if time.monotonic() > deadline:
                missing = [r for r in range(world) if r not in results]
                raise RuntimeError(f"repro_torch.launch.mesh.spawn: ranks {missing} of {world} "
                                   f"gave no result within {timeout:.0f} s")
            try:  # drained while the ranks run: a rank exits once its result is read
                rank, value = out.get(timeout=0.5)
                results[rank] = value
            except queue.Empty:
                pass
    except mp.ProcessRaisedException as e:
        raise RuntimeError(f"repro_torch.launch.mesh.spawn: rank {e.error_index} raised:\n{e}") from None
    except mp.ProcessExitedException as e:
        raise RuntimeError(f"repro_torch.launch.mesh.spawn: rank {e.error_index} died with no result "
                           f"(exit code {e.exit_code})") from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(5)
            if p.is_alive():
                p.kill()
        out.close()
    return [results[r] for r in range(world)]
