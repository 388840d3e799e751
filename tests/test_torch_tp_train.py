"""Tensor-parallel + FSDP training of the port against the JAX package, on
the CPU.

Ranks are separate processes (``repro_torch.launch.mesh.spawn``), joined in
a gloo group through a file store (no ports), each on a (data, model) mesh
from ``launch.mesh.make_local_mesh`` with its train shard
(``launch.sharding.shard_for(mode="train")``: every leaf FSDP-split over
``data`` and TP-split over ``model`` as ``param_specs(mode="train")``
places it). Reduced fp32 models (2 of their 4 layers) are carried from
JAX's tp-padded ``init_params(..., tp=T)`` to each rank's pieces, each rank
takes its rows of a seed-made batch, and the ranks' pieces are assembled
into whole leaves (``convert.whole_leaves``, which also checks that pieces
held by several ranks agree). The reference is the one-device JAX function
over the whole batch: ``jax.value_and_grad(repro.models.lm.loss_fn(...,
tp=T))`` and ``repro.optim.adamw_update`` (the JAX launcher's own mesh path
fails on this JAX version, ROADMAP.md §3), with the bounds of
``tests/test_torch_train.py``: the loss within 1e-5, every gradient leaf
within 1e-4 relative norm.

One spawn per mesh runs all of that mesh's cases in turn, in a background
thread, while this process computes the JAX references; each test reads
its case's result. Every spawn is joined with a timeout, so a hung
collective fails the test instead of holding the suite.
"""
import concurrent.futures
import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine_schedule
from repro.optim import topk_compress_allreduce as jtopk
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.launch import mesh as meshes
from repro_torch.launch import sharding, train
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import lm
from repro_torch.optim import global_norm, topk_compress_allreduce

import _dry
import _train_ranks

SPAWN_TIMEOUT = 240.0
N_LAYERS = 2
SEQ = 17
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
GRANITE = "granite-moe-1b-a400m"
# Granite's reduced config routes 2 of 4 experts at a capacity factor of 8
# (no drops); at 1.0 its 2 x 17-token rows overflow the experts.
DROPS = {"moe": "cf1"}

# (id, arch, changes to its reduced config, (data, model) mesh,
# ep_override, batch rows)
MODEL_CASES = [
    ("shard_q-1x4", "qwen1.5-0.5b", {}, (1, 4), None, 2),
    ("pad-1x3", "llama3.2-3b", {"n_heads": 4}, (1, 3), None, 2),
    ("dense-1x2", "qwen1.5-0.5b", {}, (1, 2), None, 2),
    ("tied-1x2", "llama3.2-3b", {}, (1, 2), None, 2),
    ("moe-ep-1x2", GRANITE, DROPS, (1, 2), None, 2),
    ("moe-dff-1x2", GRANITE, DROPS, (1, 2), False, 2),
    ("vlm-1x2", "internvl2-26b", {}, (1, 2), None, 2),
    ("dense-2x1", "qwen1.5-0.5b", {}, (2, 1), None, 4),
    ("dense-2x1-rows-replicated", "qwen1.5-0.5b", {}, (2, 1), None, 3),
    ("moe-2x1", GRANITE, DROPS, (2, 1), None, 4),
    ("vlm-2x1", "internvl2-26b", {}, (2, 1), None, 4),
    ("dense-2x2", "qwen1.5-0.5b", {}, (2, 2), None, 4),
    ("moe-ep-2x2", GRANITE, DROPS, (2, 2), None, 4),
]
POLICY = {"shard_q-1x4": "shard_q", "pad-1x3": "pad", "dense-1x2": "shard"}
# AdamW steps after a JAX step: (id, mesh, compress)
STEP_CASES = [
    ("adamw-1x2", (1, 2), 0.0),
    ("adamw-compress-1x2", (1, 2), 0.1),
    ("adamw-2x1", (2, 1), 0.0),
    ("adamw-compress-2x2", (2, 2), 0.1),
]
# The MoE fault's repair: a prefill of granite with drops over a data axis.
PREFILL_CASES = [("prefill-2x1", (2, 1)), ("prefill-2x2", (2, 2))]
# The same prefill on the train layout (FSDP + TP pieces: JAX's default
# layout for a serving cell of its dry run), each block gathered first.
TRAIN_LAYOUT_PREFILL_CASES = [("prefill-train-layout-2x1", (2, 1)),
                              ("prefill-train-layout-2x2", (2, 2))]
MESHES = [(1, 4), (1, 3), (1, 2), (2, 1), (2, 2)]
LAUNCH_ARGV = ["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "4", "--batch", "4", "--seq", "16",
               "--lr", "1e-2", "--seed", "3"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf_items(tree):
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield ".".join(p.key for p in path), np.asarray(a)


def _get(tree, dotted):
    for k in dotted.split("."):
        tree = tree[k]
    return tree


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@functools.lru_cache(maxsize=None)
def _configs(arch, changes_key):
    changes = dict(changes_key)
    jbase = jax_get_config(arch).reduced()
    if changes.get("moe") == "cf1":
        changes["moe"] = dataclasses.replace(jbase.moe, capacity_factor=1.0)
    jcfg = dataclasses.replace(jbase, n_layers=N_LAYERS, **changes)
    kw = dict(jcfg.__dict__)
    if jcfg.moe is not None:
        kw["moe"] = MoEConfig(**jcfg.moe.__dict__)
    return jcfg, ArchConfig(**kw)


def _key(changes):
    return tuple(sorted(changes.items()))


@functools.lru_cache(maxsize=None)
def _params(arch, changes_key, tp, seed=0):
    jcfg, _ = _configs(arch, changes_key)
    return _np_tree(jlm.init_params(jcfg, jax.random.PRNGKey(seed), tp=tp))


def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, SEQ + 1)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(size=(b, cfg.vlm_patches, cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _value_and_grad(arch, changes_key, tp):
    jcfg, _ = _configs(arch, changes_key)
    return jax.jit(jax.value_and_grad(partial(jlm.loss_fn, cfg=jcfg, tp=tp, remat=False),
                                      has_aux=True))


def _jax_grads(arch, changes, tp, params, batch):
    (loss, aux), grads = _value_and_grad(arch, _key(changes), tp)(
        params, batch={k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in aux.items()}, _np_tree(grads)


# -- the cases each spawn runs ----------------------------------------------

def _model_case(case):
    name, arch, changes, (dp, tp), ep, b = case
    _, cfg = _configs(arch, _key(changes))
    return dict(cfg=cfg, params=_params(arch, _key(changes), tp), batch=_batch(cfg, b, 1), ep=ep)


@functools.lru_cache(maxsize=None)
def _jax_state(tp, compress):
    """JAX's state after one step of qwen (params, opt, residual) and the
    two batches the next steps take."""
    jcfg, cfg = _configs("qwen1.5-0.5b", ())
    params = jlm.init_params(jcfg, jax.random.PRNGKey(3), tp=tp)
    vg = _value_and_grad("qwen1.5-0.5b", (), tp)
    b0 = _batch(cfg, 4, 10)
    (_, _), g0 = vg(params, batch={"tokens": jnp.asarray(b0["tokens"])})
    res = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    if compress:
        g0, res = jtopk(g0, res, None, compress)
    st = jadamw_init(params)
    params, st = jadamw_update(g0, st, params, jcosine_schedule(1e-2, 1, 10)(st["step"]))
    return params, st, res, [_batch(cfg, 4, s) for s in (11, 12)]


def _step_case(case):
    _, (dp, tp), compress = case
    params, st, res, steps = _jax_state(tp, compress)
    _, cfg = _configs("qwen1.5-0.5b", ())
    return dict(cfg=cfg, params=_np_tree(params), batch=steps[0], opt=_np_tree(st),
                residual=_np_tree(res), steps=steps, compress=compress, lr=1e-2)


def _prefill_inputs():
    _, cfg = _configs(GRANITE, _key(DROPS))
    rng = np.random.default_rng(5)
    return rng.integers(0, cfg.vocab, (4, 24)).astype(np.int32)


def _prefill_case(case):
    _, (dp, tp) = case
    _, cfg = _configs(GRANITE, _key(DROPS))
    return dict(kind="prefill", cfg=cfg, params=_params(GRANITE, _key(DROPS), tp),
                prompts=_prefill_inputs(), max_seq=32)


def _extra_cases(mesh):
    """The (1, 2) spawn also runs the compression and norm cases; the
    (2, 1) spawn the dense case without remat (its collective counts)."""
    if mesh == (2, 1):
        dense = _model_case(next(c for c in MODEL_CASES if c[0] == "dense-2x1"))
        return [("no-remat", dict(dense, remat=False))]
    if mesh != (1, 2):
        return []
    _, cfg = _configs("qwen1.5-0.5b", ())
    g, r = _compress_inputs()
    whole_g = convert._per_param(g, lm.LM(cfg, 2, device="meta"), cfg, "grads")
    whole_r = convert._per_param(r, lm.LM(cfg, 2, device="meta"), cfg, "residual")
    return [("compress-group", dict(kind="compress_group", grads=_group_inputs()[0],
                                    residual=_group_inputs()[1], ratio=0.1)),
            ("pieces", dict(kind="pieces", cfg=cfg, grads=whole_g, residual=whole_r, ratio=0.05))]


def _mesh_cases(mesh):
    cases = [(c[0], _model_case(c)) for c in MODEL_CASES if c[3] == mesh]
    cases += [(c[0], _step_case(c)) for c in STEP_CASES if c[1] == mesh]
    cases += [(c[0], _prefill_case(c)) for c in PREFILL_CASES if c[1] == mesh]
    cases += [(c[0], dict(_prefill_case(c), mode="train"))
              for c in TRAIN_LAYOUT_PREFILL_CASES if c[1] == mesh]
    return cases + _extra_cases(mesh)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """mesh -> a future of (case ids, every rank's results), and
    "launcher" -> (its checkpoint directory, a future of the launcher's
    runs over two ranks, ``launcher_rank``); the spawns run two at a time in
    background threads."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
    futures = {}

    def run(mesh, ids, cases, store):
        return ids, meshes.spawn(_train_ranks.train_rank, mesh[0] * mesh[1],
                                 (mesh[1], store, list(cases)), timeout=SPAWN_TIMEOUT)

    for mesh in MESHES:  # each spawn starts as soon as its inputs are built
        ids, cases = zip(*_mesh_cases(mesh))
        futures[mesh] = pool.submit(run, mesh, ids, cases,
                                    str(tmp_path_factory.mktemp("store") / "s"))
    ckpt = tmp_path_factory.mktemp("ckpt")
    store = str(tmp_path_factory.mktemp("store") / "s")
    futures["launcher"] = (ckpt, pool.submit(
        meshes.spawn, _train_ranks.launcher_rank, 2, (store, _launcher_runs(ckpt)),
        timeout=SPAWN_TIMEOUT))
    yield futures
    pool.shutdown(wait=True)


def _results(spawned, mesh, case_id):
    ids, ranks = spawned[mesh].result()
    i = ids.index(case_id)
    return [r[i] for r in ranks]


def _whole(results, key):
    return convert.lm_params_to_numpy(
        convert.whole_leaves([(r[key], r["layout"]) for r in results]))


def _assert_grads(got, want, what):
    assert {k for k, _ in _leaf_items(got)} == {k for k, _ in _leaf_items(want)}
    for key, w in _leaf_items(want):
        g = _get(got, key)
        assert g.shape == w.shape, (what, key)
        assert _rel(g, w) <= GRAD_TOL, (what, key, _rel(g, w))


# -- (2) loss and gradients ---------------------------------------------------

@pytest.mark.parametrize("case", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_loss_and_grads_match_jax(case, spawned):
    """Loss, ce and moe_aux within 1e-5 of JAX's value_and_grad(loss_fn(...,
    tp=T)) over the whole batch, equal on every rank; every assembled
    gradient leaf (its pieces equal wherever ranks share one) within 1e-4
    relative norm; each rank's pieces in the train layout; the dry run of
    each rank's training step, AdamW's clip aside, counts the collectives
    the rank issued (op, count and bytes)."""
    name, arch, changes, (dp, tp), ep, b = case
    inputs = _model_case(case)
    jloss, jaux, jgrads = _jax_grads(arch, changes, tp, inputs["params"], inputs["batch"])
    results = _results(spawned, (dp, tp), name)
    cfg = inputs["cfg"]
    if name in POLICY:
        assert cfg.padded_heads(tp)[2] == POLICY[name]
    for r in results:
        assert (r["loss"], r["ce"], r["moe_aux"]) == (results[0]["loss"], results[0]["ce"],
                                                       results[0]["moe_aux"])
        lo, hi = r["rows"]
        assert hi - lo == (b // dp if b % dp == 0 else b)
        dry = _dry.collectives(cfg, (dp, tp), r["coords"], "train", inputs["batch"], mode="train",
                               ep=ep)
        assert r["stats"] == _dry.without_clip(dry), r["coords"]
    np.testing.assert_allclose(results[0]["loss"], jloss, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(results[0]["ce"], jaux["ce"], rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(results[0]["moe_aux"], jaux["moe_aux"], rtol=LOSS_TOL, atol=LOSS_TOL)
    if cfg.moe is not None:
        assert jaux["moe_aux"] > 0
    _assert_grads(_whole(results, "grads"), jgrads, name)


def test_pad_heads_get_jax_gradients(spawned):
    """Under the 'pad' policy the padded heads' ``wo`` rows are zero, and
    their gradients are JAX's: zero for the padded heads' q columns, the
    JAX values (not zero) for their ``wo`` rows."""
    case = next(c for c in MODEL_CASES if c[0] == "pad-1x3")
    inputs = _model_case(case)
    _, _, jgrads = _jax_grads(case[1], case[2], 3, inputs["params"], inputs["batch"])
    got = _whole(_results(spawned, (1, 3), "pad-1x3"), "grads")
    cfg = inputs["cfg"]
    n_real = cfg.n_heads * cfg.d_head
    pad_wo = got["blocks"]["attn"]["wo"][:, n_real:]
    np.testing.assert_allclose(pad_wo, jgrads["blocks"]["attn"]["wo"][:, n_real:],
                               rtol=GRAD_TOL, atol=1e-7)
    assert np.abs(pad_wo).max() > 0
    assert np.abs(got["blocks"]["attn"]["wq"][..., n_real:]).max() == 0
    assert np.abs(jgrads["blocks"]["attn"]["wq"][..., n_real:]).max() == 0


# -- (4) layouts ---------------------------------------------------------------

@pytest.mark.parametrize("case", [c for c in MODEL_CASES if c[0] in
                                  ("dense-2x2", "moe-ep-2x2", "vlm-2x1", "moe-dff-1x2")],
                         ids=lambda c: c[0])
def test_every_rank_holds_the_train_layout(case, spawned):
    """Each rank's parameter pieces have ``local_shape(param_specs(mode=
    "train"))``: FSDP over data and TP over model, as JAX places them."""
    name, arch, changes, (dp, tp), ep, b = case
    _, cfg = _configs(arch, _key(changes))
    mesh = MeshShape(("data", "model"), (dp, tp))
    whole = lm.LM(cfg, tp, device="meta")
    specs = sharding.param_specs(cfg, mesh, tp, whole, mode="train", ep_override=ep)
    for r in _results(spawned, (dp, tp), name):
        for n, p in whole.named_parameters():
            assert r["shapes"][n] == sharding.local_shape(p.shape, specs[n], mesh), n
    if dp > 1:
        assert any("data" in str(s) for s in specs.values())


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_state_pieces_follow_opt_specs(case, spawned):
    """Params, m, v and the residual of every rank are pieces of the train
    layout (``opt_specs``: the moments inherit the params' specs)."""
    name, (dp, tp), _ = case
    _, cfg = _configs("qwen1.5-0.5b", ())
    mesh = MeshShape(("data", "model"), (dp, tp))
    whole = lm.LM(cfg, tp, device="meta")
    specs = sharding.param_specs(cfg, mesh, tp, whole, mode="train")
    ospecs = sharding.opt_specs(cfg, mesh, tp, None, specs)
    for r in _results(spawned, (dp, tp), name):
        for n, p in whole.named_parameters():
            want = sharding.local_shape(p.shape, specs[n], mesh)
            assert r["state_shapes"]["params"][n] == want
            assert r["state_shapes"]["residual"][n] == want
            for k in ("m", "v"):
                assert r["state_shapes"][k][n] == sharding.local_shape(p.shape, ospecs[k][n], mesh)


# -- (3) AdamW steps -------------------------------------------------------------

@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_adamw_steps_match_jax(case, spawned):
    """Two steps of ``launch.train.make_step`` over the ranks from JAX's
    state after one step. Each step's loss within 1e-5 of repro's
    value_and_grad over the whole batch (equal on every rank) and its
    reduced gradient, assembled, within 1e-4 relative norm of JAX's; then
    repro's top-k (with ``--grad-compress``) and ``adamw_update`` applied to
    that reduced gradient give the assembled params, m, v and residual
    within 1e-6 (the bound of test_torch_train.py's
    test_adamw_update_matches_jax; the selection and residual bit for
    bit). Each step continues from JAX's state. Without compression (the
    dry run's step has none, as JAX's) each step's collectives are those
    the dry run of the rank counts, AdamW's clip included."""
    name, (dp, tp), compress = case
    params, st, res, steps = _jax_state(tp, compress)
    vg = _value_and_grad("qwen1.5-0.5b", (), tp)
    jlr = jcosine_schedule(1e-2, 1, 10)
    results = _results(spawned, (dp, tp), name)
    _, cfg = _configs("qwen1.5-0.5b", ())
    for r in results:
        assert r["step_losses"] == results[0]["step_losses"]
        assert r["step"] == 3
        if not compress:
            dry = _dry.collectives(cfg, (dp, tp), r["coords"], "train", steps[0], mode="train")
            assert r["step_collectives"] == [dry] * len(steps), r["coords"]
    for i, b in enumerate(steps):
        (loss, _), jg = vg(params, batch={"tokens": jnp.asarray(b["tokens"])})
        np.testing.assert_allclose(results[0]["step_losses"][i], float(loss), rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        grads = convert.whole_leaves([(r["step_grads"][i], r["layout"]) for r in results])
        g = convert.lm_params_to_numpy(grads)
        _assert_grads(g, _np_tree(jg), f"{name} step {i}")
        g = jax.tree.map(jnp.asarray, g)
        if compress:
            g, res = jtopk(g, res, None, compress)
        params, st = jadamw_update(g, st, params, jlr(st["step"]))
    got_p = _whole(results, "params")
    for key, want in _leaf_items(_np_tree(params)):
        np.testing.assert_allclose(_get(got_p, key), want, rtol=1e-6, atol=1e-6, err_msg=key)
    for k, atol in (("m", 1e-7), ("v", 1e-9)):
        got = _whole(results, k)
        for key, want in _leaf_items(_np_tree(st[k])):
            np.testing.assert_allclose(_get(got, key), want, rtol=1e-6, atol=atol, err_msg=(k, key))
    if compress:
        got = _whole(results, "residual")
        for key, want in _leaf_items(_np_tree(res)):
            np.testing.assert_array_equal(_get(got, key), want, err_msg=("residual", key))


# -- (1) the MoE planned over the whole batch --------------------------------------

@pytest.mark.parametrize("case", PREFILL_CASES, ids=[c[0] for c in PREFILL_CASES])
def test_moe_prefill_plans_over_the_whole_batch(case, spawned):
    """Granite (capacity factor 1.0: pairs are dropped) prefilled over a
    data axis of 2: every rank's logits within 1e-5 of the scale of JAX's
    ``forward_cached(..., tp=T)`` over the whole batch. A plan over each
    rank's rows alone (the fault) drops other pairs: the same model over
    the half batch lies far outside the bound, so it would fail here. The
    dry run of each rank's prefill counts its collectives."""
    name, (dp, tp) = case
    jcfg, cfg = _configs(GRANITE, _key(DROPS))
    params = _params(GRANITE, _key(DROPS), tp)
    prompts = _prefill_inputs()
    b, t = prompts.shape
    cache = jlm.init_cache(jcfg, b, 32, tp=tp)
    want, _ = jlm.forward_cached(params, jcfg, cache, jnp.asarray(prompts), jnp.int32(0), tp=tp)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    results = _results(spawned, (dp, tp), name)
    for r in results:
        lo, hi = r["rows"]
        assert hi - lo == b // dp
        np.testing.assert_allclose(r["logits"], want[lo:hi], rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=f"{name} rank {r['coords']}")
        assert r["stats"]["data_all_gather"][0] == cfg.n_layers
        assert r["stats"] == _dry.collectives(cfg, (dp, tp), r["coords"], "prefill",
                                              {"tokens": prompts}, mode="serve", cache_len=32)
    half = convert.lm_params_from_numpy(params, cfg, "cpu", tp=tp)
    per_rank = lm.forward_cached(half, cfg, lm.init_cache(cfg, b // dp, 32, tp=tp, device="cpu"),
                                 torch.from_numpy(prompts[:b // dp]), 0, tp=tp)[0].numpy()
    assert np.abs(per_rank - want[:b // dp]).max() > 1e-2 * scale


@pytest.mark.parametrize("case", TRAIN_LAYOUT_PREFILL_CASES,
                         ids=[c[0] for c in TRAIN_LAYOUT_PREFILL_CASES])
def test_prefill_on_the_train_layout_matches_jax(case, spawned):
    """Granite's prefill (pairs dropped) on ranks that hold the train
    layout's FSDP + TP pieces: each block's pieces gathered over data
    before it runs, the head's before the logits. Every rank's logits
    within 1e-5 of the scale of JAX's ``forward_cached(..., tp=T)`` over the
    whole batch; its collectives those the dry run of the rank counts in
    mode 'train' (one data gather a block, the head's and the router
    logits')."""
    name, (dp, tp) = case
    jcfg, cfg = _configs(GRANITE, _key(DROPS))
    params = _params(GRANITE, _key(DROPS), tp)
    prompts = _prefill_inputs()
    want, _ = jlm.forward_cached(params, jcfg, jlm.init_cache(jcfg, prompts.shape[0], 32, tp=tp),
                                 jnp.asarray(prompts), jnp.int32(0), tp=tp)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    for r in _results(spawned, (dp, tp), name):
        lo, hi = r["rows"]
        np.testing.assert_allclose(r["logits"], want[lo:hi], rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=f"{name} rank {r['coords']}")
        assert r["stats"]["data_all_gather"][0] == 2 * cfg.n_layers + 1
        assert r["stats"] == _dry.collectives(cfg, (dp, tp), r["coords"], "prefill",
                                              {"tokens": prompts}, mode="train", cache_len=32)


# -- (5) compression, (6) the global norm ---------------------------------------

def _tie_grid(a):
    return (np.round(a * 4) / 4).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _compress_inputs():
    """Whole gradients and residual of reduced qwen at tp 2 (JAX layout),
    on a coarse grid so that ties at the threshold occur."""
    params = _params("qwen1.5-0.5b", (), 2)
    rng = np.random.default_rng(21)
    g = jax.tree.map(lambda p: _tie_grid(rng.normal(size=p.shape)), params)
    r = jax.tree.map(lambda p: _tie_grid(rng.normal(size=p.shape) * 0.5), params)
    return g, r


@functools.lru_cache(maxsize=None)
def _group_inputs():
    """Two ranks' own gradients and residuals (port names, flat leaves)."""
    rng = np.random.default_rng(22)
    shapes = {"a": (40,), "b": (8, 9), "c": (3, 5, 2)}
    grads = [{n: _tie_grid(rng.normal(size=s)) for n, s in shapes.items()} for _ in range(2)]
    res = [{n: _tie_grid(rng.normal(size=s) * 0.5) for n, s in shapes.items()} for _ in range(2)]
    return grads, res


def test_compress_group_matches_jax_axis_name(spawned):
    """``topk_compress_allreduce(group=)`` over two ranks equals
    ``jax.vmap(partial(topk_compress_allreduce, axis_name="dp"),
    axis_name="dp")``: each rank selects on its own gradient and residual
    (ties kept), the selections are averaged over the group; the residuals
    stay the rank's own."""
    grads, res = _group_inputs()
    stack = lambda trees: {k: jnp.stack([t[k] for t in trees]) for k in trees[0]}  # noqa: E731
    f = jax.vmap(partial(jtopk, axis_name="dp", ratio=0.1), axis_name="dp")
    jout, jres = f(stack(grads), stack(res))
    for r, got in enumerate(_results(spawned, (1, 2), "compress-group")):
        for k in grads[0]:
            np.testing.assert_allclose(got["out"][k], np.asarray(jout[k][r]), rtol=1e-7, atol=0)
            np.testing.assert_array_equal(got["residual"][k], np.asarray(jres[k][r]))


def test_sharded_selection_equals_whole_leaf_selection(spawned):
    """On sharded leaves (qwen's train layout at tp 2) the selection is the
    whole leaf's: the assembled selection and residual equal JAX's
    ``topk_compress_allreduce(axis_name=None)`` on the whole tree, bit for
    bit, ties at the threshold kept."""
    g, r = _compress_inputs()
    jout, jres = jtopk(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r), None, 0.05)
    results = _results(spawned, (1, 2), "pieces")
    for key in ("out", "residual"):
        got = _whole(results, key)
        want = _np_tree(jout if key == "out" else jres)
        for k, w in _leaf_items(want):
            np.testing.assert_array_equal(_get(got, k), w, err_msg=(key, k))
    n_ties = sum(int((np.abs(np.asarray(v)) == np.abs(np.asarray(v)).max()).sum() > 1)
                 for v in jax.tree.leaves(g))
    assert n_ties > 0


def test_global_norm_over_pieces(spawned):
    """``global_norm(pieces, shard)`` on every rank equals the whole tree's
    (repro's ``global_norm``), each replicated piece counted once."""
    from repro.optim import global_norm as jglobal_norm

    g, _ = _compress_inputs()
    want = float(jglobal_norm(jax.tree.map(jnp.asarray, g)))
    for r in _results(spawned, (1, 2), "pieces"):
        assert r["norm"] == pytest.approx(want, rel=1e-6)
    _, cfg = _configs("qwen1.5-0.5b", ())
    whole = convert._per_param(g, lm.LM(cfg, 2, device="meta"), cfg, "grads")
    assert global_norm({n: torch.from_numpy(a) for n, a in whole.items()}).item() == \
        pytest.approx(want, rel=1e-6)


# -- (8) collective counts --------------------------------------------------------

def test_data_gathers_per_block(spawned):
    """The FSDP gathers of a step: each block's leaves in one gather (one
    dtype), twice under remat (the forward and the recompute) and once
    without, plus the head's; one reduce-scatter per block and the head in
    the backward, one data all-reduce of the leaves not split over data and
    one of the loss. A (1, 2) mesh makes no data collective."""
    n = N_LAYERS
    remat = _results(spawned, (2, 1), "dense-2x1")[0]["stats"]
    assert remat["data_all_gather"][0] == 2 * n + 1
    assert remat["data_reduce_scatter"][0] == n + 1
    assert remat["data_all_reduce_sum"][0] == 2
    one = _results(spawned, (2, 1), "no-remat")[0]["stats"]
    assert one["data_all_gather"][0] == n + 1
    assert one["data_reduce_scatter"][0] == n + 1
    tp_only = _results(spawned, (1, 2), "dense-1x2")[0]["stats"]
    assert not any(op.startswith("data_") for op in tp_only)
    moe = _results(spawned, (2, 1), "moe-2x1")[0]["stats"]
    assert moe["data_all_gather"][0] == 2 * n + 1 + 2 * n  # + the plan's router logits
    assert moe["data_all_reduce_sum"][0] == 2 + n  # + the logits' gradient


# -- (7) the launcher -------------------------------------------------

def _launcher_runs(ckpt):
    """Over two gloo ranks: ``--tp 2``, ``--tp 1`` (pure FSDP), ``--tp 2``
    with checkpoints every 2 steps and a failure injected at step 3, and a
    resume of that run for 2 steps."""
    return [LAUNCH_ARGV + ["--tp", "2"], LAUNCH_ARGV + ["--tp", "1"],
            LAUNCH_ARGV + ["--tp", "2", "--ckpt-dir", str(ckpt), "--ckpt-every", "2",
                           "--inject-failure-at", "3"],
            ["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "2", "--batch", "4", "--seq", "16",
             "--tp", "2", "--ckpt-dir", str(ckpt), "--resume"]]


@pytest.fixture(scope="module")
def launched(spawned):
    """World 1 in this process, and the runs of :func:`_launcher_runs`."""
    ckpt, fut = spawned["launcher"]
    info1 = {}
    want = train.main(LAUNCH_ARGV + ["--device", "cpu"], info=info1)
    return want, info1, fut.result(), ckpt


@pytest.mark.parametrize("run", [0, 1], ids=["tp2-world2", "tp1-world2"])
def test_launcher_over_two_ranks_gives_world1_losses(run, launched):
    """``launch.train --tp 2`` and ``--tp 1`` (FSDP) at world 2: world 1's
    losses within 1e-5, the same on both ranks (``rank_losses``), rank 0's
    info with the run's tp, world, backend, policy and collectives, each
    step's as the dry run of the rank counts them."""
    want, info1, ranks, _ = launched
    tp = (2, 1)[run]
    cfg = get_config("qwen1.5-0.5b").reduced()
    for rank, (losses, info) in enumerate(r[run] for r in ranks):
        dry = _dry.collectives(cfg, (2 // tp, tp), rank, "train", {"tokens": ((4, 17), np.int32)},
                               mode="train")
        assert info["collectives"] == [dry] * 4, rank
        np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-5)
        assert info["rank_losses"] == [losses, losses]
        assert (info["tp"], info["world"], info["backend"]) == (tp, 2, "gloo")
        assert info["policy"] == "shard"
        assert len(info["collectives"]) == 4
        ops = info["collectives"][0]
        assert ("all_gather" in ops) == (tp == 2) and ("data_reduce_scatter" in ops) == (tp == 1)
    assert (info1["tp"], info1["world"], info1["backend"], info1["collectives"]) == \
        (1, 1, None, [{}] * 4)


def test_launcher_checkpoints_whole_leaves_and_resumes(launched):
    """The run with a failure injected retries it and gives the uninterrupted
    run's losses; its checkpoints (rank 0's) hold whole leaves under tp 1's
    keys and shapes (qwen at tp 2: the 'shard' policy pads nothing); a run
    resumed from them starts at step 4 with every rank's pieces restored."""
    want, _, ranks, ckpt = launched
    for r in ranks:
        (plain, _), (failed, info), (resumed, rinfo) = r[0], r[2], r[3]
        np.testing.assert_allclose(failed, plain, rtol=1e-6, atol=1e-6)
        assert info["retries"] == 1 and info["restores"] == 0
        assert rinfo["start_step"] == 4 and len(resumed) == 2 and np.isfinite(resumed).all()
    steps = {p.name for p in ckpt.iterdir()}
    assert {"step_000000002", "step_000000004"} <= steps
    _, state1 = train.build_state(get_config("qwen1.5-0.5b").reduced(), "cpu", seed=3)
    want_shapes = {}
    for tree, leaves in (("params", state1["params"]), ("residual", state1["residual"]),
                         ("opt/m", state1["opt"]["m"]), ("opt/v", state1["opt"]["v"])):
        want_shapes.update({f"{tree}/{n}": tuple(t.shape) for n, t in leaves.items()})
    want_shapes["opt/step"] = ()
    with np.load(ckpt / "step_000000004" / "arrays.npz") as z:
        assert {k: z[k].shape for k in z.files} == want_shapes
