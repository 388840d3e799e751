"""Multi-pod dry run of the port (counterpart of ``repro.launch.dryrun``):
per-rank bytes, FLOPs and collectives of every (arch × shape × mesh) cell,
with no card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out results/dryrun.json

The JAX package proves a distribution config by compiling each cell for 512
placeholder CPU devices and reading XLA's ``memory_analysis``,
``cost_analysis`` and the collectives of the optimized HLO. The port has no
compiler to ask. It runs the launchers' own step (:func:`make_train_step`,
:func:`make_decode_step`, :func:`make_prefill_step`) for **one rank** of the
production mesh (``launch.mesh.make_production_mesh``: (data=16, model=16),
or (pod=2, 16, 16)) on ``meta`` tensors, with the rank's
``models.tp.Shard`` in counting mode (its collectives are counted and
shaped, never issued), and reads the same quantities from that run:

  * FLOPs: ``torch.utils.flop_counter`` over every dispatched op, plus the
    ``flash_attention`` kernel's own work over the tiles it runs, which the
    op's ``meta`` branch credits (``kernels.flash_attention.kernel_flops``:
    a causal call skips the tiles above the diagonal);
  * bytes accessed: the input and output bytes of every dispatched op (a
    view and an empty allocation move none), the kernel's inputs and output
    once — exact for eager PyTorch, which fuses nothing;
  * peak: the live bytes of the storages the pass allocates, at their
    most (freed as the pass drops them);
  * collectives: the shard's counts (op -> [count, bytes this rank sent]).

This is the one entry point of the port that takes no ``--device``: it
computes on ``meta``, which allocates nothing, launches nothing and never
touches a card (nor needs one).

A record has the JAX package's keys, each read as follows:

  status, n_chips, cost_exact   — as JAX's ('ok' / 'skipped' with its
                                  reason / 'error'); cost_exact is False
                                  where no meta pass ran
  lower_s, compile_s            — 0.0, and the wall of the meta pass (s)
  hlo_flops, hlo_bytes          — the rank's counted FLOPs and bytes accessed;
                                  there is no HLO here, the names are kept so
                                  that what reads JAX's artifact reads this
  collective_bytes              — JAX's dict (``all-reduce``, ``all-gather``,
                                  ``reduce-scatter``, ``total``) in per-device
                                  output bytes (:func:`collective_bytes`)
  collectives                   — the shard's raw counts, as the launchers
                                  report them (``launch.train``'s
                                  ``collectives``, ``launch.serve``'s
                                  ``prefill_collectives``): the one key JAX's
                                  record lacks
  model_flops                   — JAX's formulas: 6·N_active·tokens (train),
                                  2·N_active·B (decode), 2·N_active·B·T
                                  (prefill), over the whole mesh
  useful_flops_ratio            — model_flops / (hlo_flops · n_chips)
  t_compute_s, t_memory_s,      — hlo_flops / PEAK_FLOPS, hlo_bytes / HBM_BW,
  t_collective_s, dominant        collective total / LINK_BW, the largest
  bytes_per_device              — from the rank's local shapes: ``argument``
                                  (params + AdamW m, v and step + the batch's
                                  rows in train; params + cache + the inputs'
                                  rows otherwise, decode's position included),
                                  ``alias`` (the state the step updates in
                                  place, as JAX donates params and opt or the
                                  cache), ``output`` (that state and the
                                  step's new outputs: the metrics, the next
                                  token or the last position's logits),
                                  ``temp`` (the pass's peak above the argument
                                  bytes) and ``peak`` = temp + argument −
                                  alias, as JAX computes it

:func:`run_cell` reports rank 0 (coordinate 0 on every axis) of a
production cell, in mode "serve" (TP-only weights) for a non-train cell
under ``--serve-sharding``, else "train" (FSDP + TP). :func:`dry_run_rank`,
which it calls, takes any config (reduced, or cut in depth), shape, mesh,
coordinates and mode, and the global inputs and cache length where they
are not the shape's; the tests and the smoke dry-run every rank of a small
mesh with it. Multi-pod and ``--scan-only`` cells run no meta pass, as
JAX skips its unrolled compile for them: ``argument``, ``alias`` and
``output`` come from the specs, the cost fields and ``temp`` / ``peak``
are None.

The roofline constants are one H100 SXM's; a 256- or 512-card mesh spans
nodes of 8 cards whose links between nodes are slower than NVLink, which
``LINK_BW`` does not model.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import weakref
from typing import Any, Dict, Optional

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import flop_counter
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data import make_batch_spec
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import sharding as shg
from repro_torch.launch.mesh import MODEL_PARALLEL, make_production_mesh
from repro_torch.launch.train import device_step
from repro_torch.models import lm
from repro_torch.models.tp import NO_SHARD, Shard
from repro_torch.optim import adamw_init, cosine_schedule

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "collective_bytes", "make_train_step",
           "make_decode_step", "make_prefill_step", "cell_supported", "dry_run_rank", "run_cell",
           "main"]

# Roofline denominators: one H100 SXM (NVIDIA's H100 data sheet).
PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s (chip_smoke.py's BF16_OPS_PER_S)
HBM_BW = 3.35e12  # HBM3, B/s
LINK_BW = 450e9  # NVLink 4, B/s each way (the data sheet's 900 GB/s counts both)

# Collective op of a shard's counts -> (JAX's HLO op, the group its output spans).
_COLLECTIVE_OPS = {
    "all_reduce_sum": ("all-reduce", None), "all_reduce_max": ("all-reduce", None),
    "data_all_reduce_sum": ("all-reduce", None), "world_all_reduce_sum": ("all-reduce", None),
    "all_gather": ("all-gather", "model"), "data_all_gather": ("all-gather", "data"),
    "world_all_gather": ("all-gather", "world"), "data_reduce_scatter": ("reduce-scatter", "data"),
}
_JAX_OPS = ("all-reduce", "all-gather", "reduce-scatter")


def collective_bytes(stats: Dict[str, list], mesh) -> dict:
    """JAX's collective dict from a shard's ``stats`` (op -> [count, bytes
    this rank sent]) on ``mesh``: per-device output bytes of each kind —
    an all-reduce's output is its input, an all-gather's the input times
    its group's size (model, data or every rank), a reduce-scatter's the
    input over its group's size — and their ``total``."""
    sizes = dict(mesh.shape)
    tp = sizes.get("model", 1)
    group = {"model": tp, "data": mesh.size // tp, "world": mesh.size}
    out = dict.fromkeys(_JAX_OPS, 0)
    for op, (_, nbytes) in stats.items():
        kind, axis = _COLLECTIVE_OPS[op]
        if kind == "all-gather":
            nbytes *= group[axis]
        elif kind == "reduce-scatter":
            nbytes //= group[axis]
        out[kind] += nbytes
    out["total"] = sum(out[k] for k in _JAX_OPS)
    return out


# ----------------------------------------------------------------------------
# Step builders (the launchers' steps)
# ----------------------------------------------------------------------------

def make_train_step(cfg: ArchConfig, tp: int, unroll: bool = False, batch_axes=None,
                    shard: Shard = NO_SHARD):
    """``train_step(model, opt, batch) -> (params, opt, metrics)``:
    ``launch.train.device_step`` — ``loss_fn`` → ``backward`` →
    ``reduce_grads`` → ``adamw_update`` under ``cosine_schedule(3e-4, 100,
    10_000)``, as JAX's — in place on the model's parameters and ``opt``,
    on ``shard``'s rank. ``unroll`` and ``batch_axes`` are JAX's
    signature: the port's layers are a Python loop (always unrolled), and a
    rank's rows follow ``launch.sharding.rank_rows`` (the shard says whether
    they are its share)."""
    lr_fn = cosine_schedule(3e-4, 100, 10_000)

    def train_step(model, opt, batch):
        params = dict(model.named_parameters())
        metrics = device_step(model, cfg, dict(params=params, opt=opt), batch, lr_fn, tp=tp,
                              shard=shard)
        return params, opt, metrics

    return train_step


def make_decode_step(cfg: ArchConfig, tp: int, unroll: bool = False, batch_axes=None,
                     shard: Shard = NO_SHARD):
    """``serve_step(model, cache, tokens, pos) -> (next tokens (B, 1)
    int32, cache)``: one ``forward_cached`` step, then the argmax
    (``unroll`` and ``batch_axes``: :func:`make_train_step`)."""

    def serve_step(model, cache, tokens, pos):
        logits, cache = lm.forward_cached(model, cfg, cache, tokens, pos, tp=tp, shard=shard)
        next_tok = logits[:, -1].argmax(dim=-1).to(torch.int32)
        return next_tok[:, None], cache

    return serve_step


def make_prefill_step(cfg: ArchConfig, tp: int, unroll: bool = False, batch_axes=None,
                      shard: Shard = NO_SHARD):
    """``prefill_step(model, cache, tokens, frames=None, patches=None) ->
    (the last position's logits (B, 1, V), cache)``: ``forward_cached``
    from position 0 (``unroll`` and ``batch_axes``: :func:`make_train_step`)."""

    def prefill_step(model, cache, tokens, frames=None, patches=None):
        kw = {}
        if frames is not None:
            kw["frames"] = frames
        if patches is not None:
            kw["patches"] = patches
        logits, cache = lm.forward_cached(model, cfg, cache, tokens, 0, tp=tp, shard=shard, **kw)
        return logits[:, -1:], cache

    return prefill_step


def cell_supported(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.supports_long:
        return False, "full-attention arch: 500k decode needs sub-quadratic mixer"
    return True, ""


# ----------------------------------------------------------------------------
# The meta pass
# ----------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tree_bytes(tree: Any) -> int:
    return sum(_nbytes(t) for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor))


_aten = torch.ops.aten


def _bmm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """``flop_counter``'s bmm count for every overload: ``bmm.dtype`` (the
    card's fp32-result product, ``models.layers._fp32_product``) passes its
    dtype third, where the stock formula takes ``out_shape``."""
    return flop_counter.bmm_flop(a_shape, b_shape)


# Allocations that write nothing: they hold memory but move no bytes.
_EMPTY = {_aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
          _aten.new_empty_strided}


class _Meter(TorchDispatchMode):
    """While entered: the bytes every dispatched op reads and writes
    (``bytes``: its tensor inputs and outputs; a view and an empty
    allocation move none) and the live bytes of the storages the ops
    allocate (``live``; each freed when its storage is), with their most
    (``peak``)."""

    def __init__(self):
        super().__init__()
        self.bytes = self.live = self.peak = 0
        self._held: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view and func.overloadpacket not in _EMPTY:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        known = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in known or key in self._held:
                continue  # a view, an in-place result, or a storage already held
            self._held[key] = st.nbytes()
            self.live += self._held[key]
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _global_inputs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The whole batch's stand-ins a step of ``shape`` takes (JAX's specs):
    ``data.make_batch_spec`` (with the extra label token in train), or the
    (B, 1) int32 tokens of a decode step."""
    if shape.kind == "decode":
        return {"tokens": _meta((shape.global_batch, 1), torch.int32)}
    return make_batch_spec(cfg, shape, extra_token=shape.kind == "train")


def dry_run_rank(cfg: ArchConfig, shape: ShapeConfig, mesh, coords=None, *, mode: str = "train",
                 ep_override=None, cost: bool = True,
                 inputs: Optional[Dict[str, torch.Tensor]] = None,
                 cache_len: Optional[int] = None) -> dict:
    """The dry run of one rank: the record fields of the module docstring
    (``status`` 'ok' and on; no arch or shape name) for the rank at
    ``coords`` (a tuple in ``mesh.axis_names`` order; default all 0) of
    ``mesh`` (a :class:`~repro_torch.launch.mesh.MeshShape`, any size),
    its ``Shard`` in ``mode`` ('train': FSDP + TP; 'serve': TP only).

    ``inputs`` (meta tensors) replaces the whole batch ``shape`` gives
    (``tokens`` (B, S + 1) in train, (B, T) in prefill, (B, 1) in decode;
    whisper's ``frames``, the vlm's ``patches``); ``cache_len`` the cache's
    length (default ``shape.seq_len``; decode writes its last position and
    reads the whole cache, as it does wherever it writes). With ``cost``
    False no pass runs (the specs' fields only)."""
    t0 = time.perf_counter()
    kind = shape.kind
    tp = mesh.shape["model"]
    coords = tuple(coords) if coords is not None else (0,) * len(mesh.axis_names)
    inputs = dict(inputs) if inputs is not None else _global_inputs(cfg, shape)
    cache_len = shape.seq_len if cache_len is None else cache_len
    b = inputs["tokens"].shape[0]
    shard = shg.shard_for(cfg, mesh, ep_override=ep_override, coords=coords, mode=mode)
    rows, shard = shg.rank_rows(shard, b)
    local = {k: _meta((rows.stop - rows.start,) + tuple(v.shape[1:]), v.dtype)
             for k, v in inputs.items()}

    model = lm.LM(cfg, tp, device="meta", shard=shard)
    params = _tree_bytes(list(model.parameters()))
    n_active = cfg.active_param_count()
    if kind == "train":
        model.requires_grad_(True)
        opt = adamw_init(dict(model.named_parameters()))
        alias = params + _tree_bytes(opt)
        argument = alias + _tree_bytes(local)
        output = alias + 3 * 4  # the metrics: loss, ce, moe_aux (fp32)
        model_flops = 6 * n_active * b * (inputs["tokens"].shape[1] - 1)
    else:
        cache = lm.init_cache(cfg, b, cache_len, tp=tp, device="meta", shard=shard)
        alias = _tree_bytes(cache)
        argument = params + alias + _tree_bytes(local)
        rows_l = rows.stop - rows.start
        if kind == "decode":
            argument += 4  # the position, an int32 scalar
            output = alias + rows_l * 4
            model_flops = 2 * n_active * b
        else:
            output = alias + rows_l * cfg.vocab * torch.finfo(getattr(torch, cfg.dtype)).bits // 8
            model_flops = 2 * n_active * b * inputs["tokens"].shape[1]
    rec: Dict[str, Any] = dict(status="ok", cost_exact=bool(cost), n_chips=int(mesh.size),
                               lower_s=0.0)
    bpd = dict(argument=argument, output=output, alias=alias, temp=None, peak=None)
    if not cost:
        rec.update(compile_s=time.perf_counter() - t0, hlo_flops=None, hlo_bytes=None,
                   collective_bytes=None, collectives=None, model_flops=float(model_flops),
                   useful_flops_ratio=None, t_compute_s=None, t_memory_s=None,
                   t_collective_s=None, dominant=None, bytes_per_device=bpd)
        return rec

    kw: Dict[str, torch.Tensor] = {}
    if kind == "train":
        step, args = make_train_step(cfg, tp, shard=shard), (model, opt, local)
    elif kind == "decode":
        pos = cache_len - 1 + (cfg.vlm_patches if cfg.family == "vlm" else 0)
        step, args = make_decode_step(cfg, tp, shard=shard), (model, cache, local["tokens"], pos)
    else:
        kw = {k: v for k, v in local.items() if k != "tokens"}
        step, args = make_prefill_step(cfg, tp, shard=shard), (model, cache, local["tokens"])
    fa_flops0, fa_bytes0 = fa.META_FLOPS, fa.META_BYTES
    t1 = time.perf_counter()
    with FlopCounterMode(display=False, custom_mapping={_aten.bmm: _bmm_flop}) as flops_mode, \
            _Meter() as meter:
        step(*args, **kw)
    wall = time.perf_counter() - t1
    flops = float(flops_mode.get_total_flops() + fa.META_FLOPS - fa_flops0)
    nbytes = float(meter.bytes + fa.META_BYTES - fa_bytes0)
    stats = {op: list(v) for op, v in shard.stats.items() if v[0]}  # a new shard's: the step's
    coll = collective_bytes(stats, mesh)
    t_comp, t_mem, t_coll = flops / PEAK_FLOPS, nbytes / HBM_BW, coll["total"] / LINK_BW
    dominant = max([("compute", t_comp), ("memory", t_mem), ("collective", t_coll)],
                   key=lambda kv: kv[1])[0]
    bpd.update(temp=meter.peak, peak=meter.peak + argument - alias)
    rec.update(compile_s=wall, hlo_flops=flops, hlo_bytes=nbytes, collective_bytes=coll,
               collectives=stats, model_flops=float(model_flops),
               useful_flops_ratio=float(model_flops / (flops * mesh.size)) if flops else None,
               t_compute_s=t_comp, t_memory_s=t_mem, t_collective_s=t_coll, dominant=dominant,
               bytes_per_device=bpd)
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             serve_sharding: bool = False, ep_override=None, scan_only: bool = False) -> dict:
    """The record of one production cell: rank 0 of the (16, 16) mesh, or
    of (2, 16, 16) with ``multi_pod`` (no meta pass, as with
    ``scan_only``), at tp ``MODEL_PARALLEL``."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    rec = dict(arch=arch, shape=shape_name, multi_pod=multi_pod, serve_sharding=serve_sharding)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert mesh.shape["model"] == MODEL_PARALLEL
    mode = "serve" if (serve_sharding and shape.kind != "train") else "train"
    rec.update(dry_run_rank(cfg, shape, mesh, mode=mode, ep_override=ep_override,
                            cost=not (multi_pod or scan_only)))
    if verbose:
        bpd = rec["bytes_per_device"]
        cost = (f"flops={rec['hlo_flops']:.3g} bytes={rec['hlo_bytes']:.3g} "
                f"coll={rec['collective_bytes']['total']:.3g} dominant={rec['dominant']} "
                f"temp/dev={bpd['temp'] / 1e9:.2f}GB" if rec["cost_exact"] else "no meta pass")
        print(f"[{arch} × {shape_name} × {'2pod' if multi_pod else '1pod'}] OK "
              f"pass={rec['compile_s']:.1f}s {cost} arg/dev={bpd['argument'] / 1e9:.2f}GB")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--serve-sharding", action="store_true",
                    help="TP-only (replicated-over-data) weights for serving cells")
    ap.add_argument("--no-ep", action="store_true",
                    help="force expert-ff TP instead of expert parallelism (MoE)")
    ap.add_argument("--scan-only", action="store_true",
                    help="skip the meta pass (specs' bytes only; cost fields None)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                for mp in meshes:
                    cells.append((arch, shape, mp))
    else:
        for mp in meshes:
            cells.append((args.arch, args.shape, mp))

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
        done = {(r["arch"], r["shape"], r["multi_pod"]) for r in results}
        cells = [c for c in cells if c not in done]

    for arch, shape, mp in cells:
        try:
            rec = run_cell(arch, shape, mp, serve_sharding=args.serve_sharding,
                           ep_override=False if args.no_ep else None, scan_only=args.scan_only)
        except Exception as e:  # record the failure — it is a bug to fix
            rec = dict(arch=arch, shape=shape, multi_pod=mp,
                       status="error", error=f"{type(e).__name__}: {e}")
            print(f"[{arch} × {shape} × {'2pod' if mp else '1pod'}] FAIL {rec['error']}")
        results.append(rec)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"dry-run: {n_ok} ok, {n_skip} skipped (documented), {n_err} errors")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
