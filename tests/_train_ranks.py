"""Rank functions of the sharded-training tests, run in processes that
``repro_torch.launch.mesh.spawn`` starts. This module imports only the port
(no ``jax``, no ``repro``), so a rank starts quickly.

Each rank joins a gloo group through a file store (no ports), builds its
train shard on a (data, model) mesh, carries the whole JAX weights to its
pieces, takes its rows of the whole batch and returns numpy: its losses,
its pieces of every gradient (and, after AdamW steps, of the parameters,
moments and residual), its layout (``LM.tp_layout``) and its collectives.
"""
import numpy as np
import torch


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _delta(before, after):
    return {op: [n - before.get(op, [0, 0])[0], b - before.get(op, [0, 0])[1]]
            for op, (n, b) in after.items() if n - before.get(op, [0, 0])[0]}


def train_rank(rank, tp, store, cases):
    """Each case (a dict): ``cfg``, ``params`` (JAX's tp-padded leaves,
    numpy), ``batch`` (the whole batch, numpy), optional ``ep``
    (``ep_override``), ``remat`` (default True), ``steps`` (whole batches of
    AdamW steps after the gradient step, each run by ``launch.train.
    make_step`` from a zero optimizer state, each step's collectives kept)
    with ``compress`` and ``lr``. Returns one dict per case."""
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as meshes
    from repro_torch.launch.sharding import shard_for

    meshes.init_ranks("gloo", torch.device("cpu"), f"file://{store}")
    mesh = meshes.make_local_mesh(tp, "cpu")
    out = []
    for case in cases:
        kind = case.get("kind", "train")
        if kind == "compress_group":
            out.append(_compress_group(case))
            continue
        cfg = case["cfg"]
        mode = case.get("mode", "serve" if kind == "prefill" else "train")
        shard = shard_for(cfg, mesh, ep_override=case.get("ep"), mode=mode)
        fn = {"train": _one_case, "prefill": _prefill, "pieces": _pieces_case}[kind]
        out.append(fn(shard, tp, case))
    return out


def _prefill(shard, tp, case):
    """``forward_cached``'s prefill of ``prompts`` (whole) on the rank's
    rows (the shard's ``mode``: the case's, else 'serve'): its logits."""
    from repro_torch import convert
    from repro_torch.launch.sharding import rank_rows
    from repro_torch.models import lm

    cfg, prompts = case["cfg"], case["prompts"]
    b = prompts.shape[0]
    rows, shard = rank_rows(shard, b)
    model = convert.lm_params_from_numpy(case["params"], cfg, "cpu", tp=tp, shard=shard)
    cache = lm.init_cache(cfg, b, case["max_seq"], tp=tp, device="cpu", shard=shard)
    before = {op: list(v) for op, v in shard.stats.items()}
    logits, _ = lm.forward_cached(model, cfg, cache, torch.from_numpy(prompts[rows]), 0, tp=tp,
                                  shard=shard)
    return dict(coords=shard.coord, rows=(rows.start, rows.stop), logits=_np(logits),
                stats=_delta(before, shard.stats))


def _compress_group(case):
    """``topk_compress_allreduce`` over the world group on this rank's own
    gradients and residual (``case["grads"][rank]``, by name)."""
    import torch.distributed as dist

    from repro_torch.optim import topk_compress_allreduce

    r = dist.get_rank()
    grads = {n: torch.from_numpy(a) for n, a in case["grads"][r].items()}
    res = {n: torch.from_numpy(a.copy()) for n, a in case["residual"][r].items()}
    out, res = topk_compress_allreduce(grads, res, dist.group.WORLD, case["ratio"])
    return dict(out={n: _np(t) for n, t in out.items()}, residual={n: _np(t) for n, t in res.items()})


def _pieces_case(shard, tp, case):
    """The rank's pieces of whole gradients and residual (``case["grads"]``,
    ``case["residual"]``: port names, whole shapes) through the sharded
    top-k (``ratio``) and ``global_norm``: its pieces of the selection and
    the residual, its layout, and the norm."""
    from repro_torch.models import lm
    from repro_torch.optim import global_norm, topk_compress_allreduce

    model = lm.LM(case["cfg"], tp, device="cpu", shard=shard)
    layout = dict(model.tp_layout)
    grads = {n: torch.from_numpy(np.ascontiguousarray(a[layout[n][1]]))
             for n, a in case["grads"].items()}
    res = {n: torch.from_numpy(np.ascontiguousarray(a[layout[n][1]]))
           for n, a in case["residual"].items()}
    norm = global_norm(grads, shard).item()
    out, res = topk_compress_allreduce(grads, res, None, case["ratio"], shard=shard)
    return dict(norm=norm, layout=layout, out={n: _np(t) for n, t in out.items()},
                residual={n: _np(t) for n, t in res.items()})


def launcher_rank(rank, store, runs):
    """``launch.train.main`` on each argv of ``runs`` in one gloo group (a
    file store): per run (losses, info)."""
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as meshes
    from repro_torch.launch import train

    meshes.init_ranks("gloo", torch.device("cpu"), f"file://{store}")
    out = []
    for argv in runs:
        info = {}
        losses = train.main(argv + ["--device", "cpu", "--dist-backend", "gloo"], info=info)
        info.pop("grad_flags", None)
        out.append((losses, info))
    return out


def _one_case(shard, tp, case):
    from repro_torch import convert
    from repro_torch.launch import train
    from repro_torch.launch.sharding import rank_rows
    from repro_torch.models import lm
    from repro_torch.optim import cosine_schedule

    cfg = case["cfg"]
    b = case["batch"]["tokens"].shape[0]
    rows, shard = rank_rows(shard, b)
    model = convert.lm_params_from_numpy(case["params"], cfg, "cpu", tp=tp, shard=shard)
    model.requires_grad_(True)

    def local(batch):
        return {k: torch.from_numpy(np.asarray(v)[rows]) for k, v in batch.items()}

    before = {op: list(v) for op, v in shard.stats.items()}
    loss, aux = lm.loss_fn(model, cfg, local(case["batch"]), tp=tp, remat=case.get("remat", True),
                           shard=shard)
    loss.backward()
    lm.reduce_grads(model, shard)
    res = dict(coords=shard.coord, rows=(rows.start, rows.stop), loss=loss.item(),
               ce=aux["ce"].item(), moe_aux=aux["moe_aux"].item(),
               grads={n: _np(p.grad) for n, p in model.named_parameters()},
               layout=dict(model.tp_layout), stats=_delta(before, shard.stats),
               shapes={n: tuple(p.shape) for n, p in model.named_parameters()})
    if case.get("steps"):
        params = dict(model.named_parameters())
        res0 = convert._per_param(case["residual"], model, cfg, "residual")
        state = dict(params=params, opt=convert.opt_state_from_numpy(case["opt"], model, cfg),
                     residual={n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in res0.items()})
        lr_fn = cosine_schedule(case.get("lr", 1e-2), 1, 10)
        step = train.make_step(model, cfg, lr_fn, case.get("compress", 0.0), tp, shard)
        losses, step_grads, step_coll = [], [], []
        for batch in case["steps"]:
            metrics = step(state, local(batch))[1]
            losses.append(metrics["loss"])
            step_coll.append(metrics["collectives"])
            step_grads.append({n: _np(p.grad) for n, p in params.items()})
        res.update(step_losses=losses, step_grads=step_grads, step_collectives=step_coll,
                   params={n: _np(p) for n, p in params.items()},
                   m={n: _np(t) for n, t in state["opt"]["m"].items()},
                   v={n: _np(t) for n, t in state["opt"]["v"].items()},
                   residual={n: _np(t) for n, t in state["residual"].items()},
                   state_shapes={k: {n: tuple(t.shape) for n, t in state[k].items()}
                                 for k in ("params", "residual")}
                   | {k: {n: tuple(t.shape) for n, t in state["opt"][k].items()}
                      for k in ("m", "v")},
                   step=int(state["opt"]["step"]))
    return res


def train_and_params(argv, cfg=None):
    """``launch.train.main(argv, cfg=cfg)`` in this process: (losses, the
    model's parameters after the run as numpy, by name)."""
    from repro_torch.launch import train

    real, held = train.build_state, {}

    def build(*a, **kw):
        held["model"], state = real(*a, **kw)
        return held["model"], state

    train.build_state = build
    try:
        losses = train.main(argv, cfg=cfg)
    finally:
        train.build_state = real
    return losses, {n: _np(p) for n, p in held["model"].named_parameters()}


def card_train_rank(rank, store, argv, cfg):
    """:func:`train_and_params` on a rank of an NCCL group on the card (a
    file store)."""
    from repro_torch.launch import mesh as meshes

    meshes.init_ranks("nccl", torch.device("cuda"), f"file://{store}")
    return train_and_params(argv + ["--dist-backend", "nccl", "--dist-init", f"file://{store}"], cfg)
