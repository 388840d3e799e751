"""Tensor-parallel + FSDP training of the RWKV-6 (ssm), Zamba2 (hybrid) and
Whisper (encdec) families against the JAX package, on the CPU.

As ``tests/test_torch_tp_train.py`` holds the dense, MoE and VLM families:
ranks are processes spawned by ``repro_torch.launch.mesh.spawn`` into a
gloo group through a file store (no ports), each with its train shard
(``launch.sharding.shard_for(mode="train")``) of a (data, model) mesh;
reduced fp32 models in JAX's tp-padded ``init_params(..., tp=T)`` layout
are carried to each rank's pieces, each rank takes its rows of a seed-made
batch (whisper's frames follow its token rows), and the ranks' gradient
pieces are assembled into whole leaves (``convert.whole_leaves``, which
also checks that pieces held by several ranks agree). The reference is
``jax.value_and_grad(repro.models.lm.loss_fn(..., tp=T, remat=False))``
over the whole batch: the loss within 1e-5, every gradient leaf within
1e-4 relative norm. RWKV-6 runs 2 layers, Zamba2 3 (one application of the
shared block and a one-layer remainder; a 5-layer case applies it twice),
Whisper 2 encoder and 2 decoder layers; Whisper at tp 3 takes the 'pad'
head policy, and RWKV-6 at tp 3 (4 heads) runs its mixers replicated.

One spawn per mesh runs all of that mesh's cases in turn, in a background
thread, while this process computes the JAX references; every spawn is
joined with a timeout.
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
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import mesh as meshes
from repro_torch.launch import sharding, train
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import lm

import _dry
import _train_ranks
from test_torch_tp_train import (LOSS_TOL, _assert_grads, _get, _leaf_items, _np_tree,
                                 _results, _whole)

SPAWN_TIMEOUT = 240.0
SEQ = 17
N_FRAMES = 9
LAYERS = {"ssm": 2, "hybrid": 3, "encdec": 2}
# RWKV-6 with 4 heads of 48 (D 192, d_ff 384, vocab 513): at tp 3 the JAX
# rules would split its columns off head boundaries (192 / 3 = 64); the
# port's replicate the mixers (launch.sharding) and split the vocab.
WIDE_SSM = {"d_model": 192, "d_head": 48, "d_ff": 384, "vocab": 513}

# (id, arch, changes to its reduced config, (data, model) mesh, batch rows)
MODEL_CASES = [
    ("ssm-1x2", "rwkv6-7b", {}, (1, 2), 2),
    ("ssm-2x1", "rwkv6-7b", {}, (2, 1), 4),
    ("ssm-2x2", "rwkv6-7b", {}, (2, 2), 4),
    ("ssm-replicated-1x3", "rwkv6-7b", WIDE_SSM, (1, 3), 2),
    ("hybrid-1x2", "zamba2-7b", {}, (1, 2), 2),
    ("hybrid-2x1", "zamba2-7b", {}, (2, 1), 4),
    ("hybrid-2x2", "zamba2-7b", {}, (2, 2), 4),
    ("hybrid-two-applications-2x1", "zamba2-7b", {"n_layers": 5}, (2, 1), 4),
    ("encdec-1x2", "whisper-tiny", {}, (1, 2), 2),
    ("encdec-2x1", "whisper-tiny", {}, (2, 1), 4),
    ("encdec-2x2", "whisper-tiny", {}, (2, 2), 4),
    ("encdec-pad-1x3", "whisper-tiny", {}, (1, 3), 2),
]
POLICY = {"hybrid-1x2": "shard", "encdec-1x2": "shard", "encdec-pad-1x3": "pad"}
# One AdamW step after the gradient step: (id, arch, mesh)
STEP_CASES = [("adamw-hybrid-2x2", "zamba2-7b", (2, 2))]
MESHES = [(1, 2), (2, 1), (2, 2), (1, 3)]
LAUNCH_ARGV = ["--arch", "whisper-tiny", "--reduced", "--steps", "3", "--batch", "4", "--seq", "16",
               "--lr", "1e-2", "--seed", "5"]


def _key(changes):
    return tuple(sorted(changes.items()))


@functools.lru_cache(maxsize=None)
def _configs(arch, changes_key):
    jbase = jax_get_config(arch).reduced()
    changes = dict(n_layers=LAYERS[jbase.family]) | dict(changes_key)
    jcfg = dataclasses.replace(jbase, **changes)
    return jcfg, ArchConfig(**dict(jcfg.__dict__))


def _heads(arch, changes_key, tp):
    """The (padded) head counts at ``tp``: all that tp changes in the JAX
    model (``model_dims``), so equal heads share the references below."""
    return _configs(arch, changes_key)[0].padded_heads(tp)[:2]


def _params(arch, changes_key, tp):
    return _params_at(arch, changes_key, _heads(arch, changes_key, tp), tp)


@functools.lru_cache(maxsize=None)
def _params_at(arch, changes_key, heads, tp):
    """Weights in JAX's ``init_params(..., tp=T)`` layout (heads padded for
    tp, a padded head's ``wo`` rows zero), drawn by the port's
    ``init_params`` from a seed (JAX's eager draw of the SSM models takes
    seconds): both packages compute on these same weights."""
    _, cfg = _configs(arch, changes_key)
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), tp=tp)
    return convert.lm_params_to_numpy(model)


def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, SEQ + 1)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, N_FRAMES, cfg.d_model)).astype(np.float32)
    return out


def _value_and_grad(arch, changes_key, tp):
    return _value_and_grad_at(arch, changes_key, _heads(arch, changes_key, tp), tp)


@functools.lru_cache(maxsize=None)
def _value_and_grad_at(arch, changes_key, heads, tp):
    jcfg, _ = _configs(arch, changes_key)
    return jax.jit(jax.value_and_grad(partial(jlm.loss_fn, cfg=jcfg, tp=tp, remat=False),
                                      has_aux=True))


def _jax_grads(arch, changes, tp, params, batch):
    (loss, aux), grads = _value_and_grad(arch, _key(changes), tp)(
        params, batch={k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in aux.items()}, _np_tree(grads)


def _model_case(case):
    _, arch, changes, (dp, tp), b = case
    _, cfg = _configs(arch, _key(changes))
    return dict(cfg=cfg, params=_params(arch, _key(changes), tp), batch=_batch(cfg, b, 1))


def _step_inputs(case):
    """JAX's state before the step (params, AdamW state, residual) and the
    step's batch."""
    _, arch, (dp, tp) = case
    _, cfg = _configs(arch, ())
    params = _params(arch, (), tp)
    st = _np_tree(jadamw_init(jax.tree.map(jnp.asarray, params)))  # zero moments, step 0
    res = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), params)
    return cfg, params, st, res, _batch(cfg, 4, 7)


def _step_case(case):
    cfg, params, st, res, batch = _step_inputs(case)
    return dict(cfg=cfg, params=params, batch=batch, opt=st, residual=res, steps=[batch], lr=1e-2)


def _mesh_cases(mesh):
    cases = [(c[0], _model_case(c)) for c in MODEL_CASES if c[3] == mesh]
    return cases + [(c[0], _step_case(c)) for c in STEP_CASES if c[2] == mesh]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """mesh -> a future of (case ids, every rank's results), and
    "launcher" -> (its checkpoint directory, a future of the launcher's
    runs over two ranks); the spawns run three at a time in background
    threads."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=3)
    futures = {}

    def run(mesh, ids, cases, store):
        return ids, meshes.spawn(_train_ranks.train_rank, mesh[0] * mesh[1],
                                 (mesh[1], store, list(cases)), timeout=SPAWN_TIMEOUT)

    for mesh in MESHES:
        ids, cases = zip(*_mesh_cases(mesh))
        futures[mesh] = pool.submit(run, mesh, ids, cases,
                                    str(tmp_path_factory.mktemp("store") / "s"))
    store = str(tmp_path_factory.mktemp("store") / "s")
    ckpt = tmp_path_factory.mktemp("ckpt")
    runs = [LAUNCH_ARGV + ["--tp", "2"], LAUNCH_ARGV + ["--tp", "1"],
            LAUNCH_ARGV + ["--tp", "2", "--ckpt-dir", str(ckpt), "--ckpt-every", "3"],
            LAUNCH_ARGV + ["--steps", "1", "--tp", "2", "--ckpt-dir", str(ckpt), "--resume"]]
    futures["launcher"] = (ckpt, pool.submit(meshes.spawn, _train_ranks.launcher_rank, 2,
                                             (store, runs), timeout=SPAWN_TIMEOUT))
    yield futures
    pool.shutdown(wait=True)


@pytest.mark.parametrize("case", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_loss_and_grads_match_jax(case, spawned):
    """Loss and ce within 1e-5 of JAX's value_and_grad(loss_fn(..., tp=T))
    over the whole batch, equal on every rank; every assembled gradient leaf
    (its pieces equal wherever ranks share one) within 1e-4 relative
    norm; the dry run of each rank's training step, AdamW's clip aside,
    counts the collectives the rank issued (op, count and bytes)."""
    name, arch, changes, (dp, tp), b = case
    inputs = _model_case(case)
    jloss, jaux, jgrads = _jax_grads(arch, changes, tp, inputs["params"], inputs["batch"])
    results = _results(spawned, (dp, tp), name)
    if name in POLICY:
        assert inputs["cfg"].padded_heads(tp)[2] == POLICY[name]
    for r in results:
        assert (r["loss"], r["ce"]) == (results[0]["loss"], results[0]["ce"])
        lo, hi = r["rows"]
        assert hi - lo == b // dp
        dry = _dry.collectives(inputs["cfg"], (dp, tp), r["coords"], "train", inputs["batch"],
                               mode="train")
        assert r["stats"] == _dry.without_clip(dry), r["coords"]
    np.testing.assert_allclose(results[0]["loss"], jloss, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(results[0]["ce"], jaux["ce"], rtol=LOSS_TOL, atol=LOSS_TOL)
    _assert_grads(_whole(results, "grads"), jgrads, name)


@pytest.mark.parametrize("name", ["ssm-2x2", "hybrid-2x2", "encdec-2x2", "ssm-replicated-1x3"])
def test_every_rank_holds_the_train_layout(name, spawned):
    """Each rank's pieces have ``local_shape(param_specs(mode="train"))``:
    FSDP over data, the mixers by heads and attention by its policy over
    model; at tp 3 (4 heads) every mixer leaf whole over model, where the
    JAX rules would split 192 columns into 64."""
    case = next(c for c in MODEL_CASES if c[0] == name)
    _, arch, changes, (dp, tp), _ = case
    _, cfg = _configs(arch, _key(changes))
    mesh = MeshShape(("data", "model"), (dp, tp))
    whole = lm.LM(cfg, tp, device="meta")
    specs = sharding.param_specs(cfg, mesh, tp, whole, mode="train")
    for r in _results(spawned, (dp, tp), name):
        for n, p in whole.named_parameters():
            assert r["shapes"][n] == sharding.local_shape(p.shape, specs[n], mesh), n
    if cfg.family in ("ssm", "hybrid"):
        mixers = [n for n in specs if any(f".{m}." in n for m in ("att", "cm", "mamba"))]
        split = [n for n in mixers if "model" in specs[n]]
        if cfg.n_heads % tp:
            assert mixers and not split and "model" in specs["embed"]
        else:
            assert split


def test_collectives_of_a_step(spawned):
    """A step's collectives: with a data axis, each block's leaves gathered
    in one collective (one dtype) twice under remat (forward, recompute),
    the hybrid's shared block once for all its applications and the head
    once; one reduce-scatter for each; one data all-reduce of the leaves
    not split over data and one of the loss. A mixer that runs replicated
    (tp 3, 4 heads) issues no model collective: only the vocab-split
    embedding's sum and the CE's gathers and sums remain."""
    for name, blocks in (("hybrid-2x1", 3), ("hybrid-two-applications-2x1", 5),
                         ("ssm-2x1", 2), ("encdec-2x1", 4)):
        case = next(c for c in MODEL_CASES if c[0] == name)
        _, cfg = _configs(case[1], _key(case[2]))
        shared = int(cfg.family == "hybrid")
        stats = _results(spawned, case[3], name)[0]["stats"]
        assert stats["data_all_gather"][0] == 2 * blocks + shared + 1, name
        assert stats["data_reduce_scatter"][0] == blocks + shared + 1, name
        assert stats["data_all_reduce_sum"][0] == 2, name
        assert not any(op in stats for op in ("all_gather", "all_reduce_sum")), name
    n_chunks = len(range(0, SEQ, -(-SEQ // 8)))  # lm._chunked_ce's chunks
    stats = _results(spawned, (1, 3), "ssm-replicated-1x3")[0]["stats"]
    assert {op: n for op, (n, _) in stats.items()} == {
        "all_reduce_sum": 1 + n_chunks, "all_gather": 2 * n_chunks}


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_adamw_step_matches_jax(case, spawned):
    """One step of ``launch.train.make_step`` over the ranks from JAX's
    initial state: the loss within 1e-5 of JAX's, the reduced gradient
    within 1e-4 relative norm, and repro's ``adamw_update`` applied to that
    reduced gradient gives the assembled params, m and v within 1e-6 (the
    bounds of tests/test_torch_tp_train.py); the step's collectives are
    those the dry run of the rank counts, AdamW's clip included."""
    name, arch, (dp, tp) = case
    cfg, params, st, _, batch = _step_inputs(case)
    results = _results(spawned, (dp, tp), name)
    (loss, _), jg = _value_and_grad(arch, (), tp)(
        jax.tree.map(jnp.asarray, params), batch={k: jnp.asarray(v) for k, v in batch.items()})
    for r in results:
        assert r["step_losses"] == results[0]["step_losses"] and r["step"] == 1
        dry = _dry.collectives(cfg, (dp, tp), r["coords"], "train", batch, mode="train")
        assert r["step_collectives"] == [dry], r["coords"]
    np.testing.assert_allclose(results[0]["step_losses"][0], float(loss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    grads = convert.lm_params_to_numpy(
        convert.whole_leaves([(r["step_grads"][0], r["layout"]) for r in results]))
    _assert_grads(grads, _np_tree(jg), name)
    jst = jax.tree.map(jnp.asarray, st)
    want_p, want_st = jax.jit(jadamw_update)(jax.tree.map(jnp.asarray, grads), jst,
                                             jax.tree.map(jnp.asarray, params),
                                             jcosine_schedule(1e-2, 1, 10)(jst["step"]))
    got_p = _whole(results, "params")
    for key, want in _leaf_items(_np_tree(want_p)):
        np.testing.assert_allclose(_get(got_p, key), want, rtol=1e-6, atol=1e-6, err_msg=key)
    for k, atol in (("m", 1e-7), ("v", 1e-9)):
        got = _whole(results, k)
        for key, want in _leaf_items(_np_tree(want_st[k])):
            np.testing.assert_allclose(_get(got, key), want, rtol=1e-6, atol=atol,
                                       err_msg=(k, key))


@pytest.mark.parametrize("run", [0, 1], ids=["tp2-world2", "tp1-world2"])
def test_launcher_over_two_ranks_gives_world1_losses(run, spawned):
    """``launch.train --tp 2`` and ``--tp 1`` (FSDP) of whisper at world 2:
    world 1's losses within 1e-5, the same on both ranks, rank 0's info
    with the run's tp, world, backend, policy and collectives, each step's
    as the dry run of the rank counts them."""
    want = train.main(LAUNCH_ARGV + ["--device", "cpu"])
    tp = (2, 1)[run]
    cfg = get_config("whisper-tiny").reduced()
    inputs = {"tokens": ((4, 17), np.int32), "frames": ((4, 8, cfg.d_model), np.float32)}
    for rank, ranks in enumerate(spawned["launcher"][1].result()):
        losses, info = ranks[run]
        dry = _dry.collectives(cfg, (2 // tp, tp), rank, "train", inputs, mode="train")
        assert info["collectives"] == [dry] * 3, rank
        np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-5)
        assert info["rank_losses"] == [losses, losses]
        assert (info["tp"], info["world"], info["backend"], info["policy"]) == \
            (tp, 2, "gloo", "shard")
        assert len(info["collectives"]) == 3
        ops = info["collectives"][0]
        assert ("all_gather" in ops) == (tp == 2) and ("data_reduce_scatter" in ops) == (tp == 1)


def test_launcher_checkpoints_whole_leaves_and_resumes(spawned):
    """Whisper at ``--tp 2`` over two ranks writes (rank 0) a checkpoint
    of whole leaves under tp 1's names and shapes (the 'shard' policy pads
    nothing), and a run resumed from it starts at step 3 with every rank's
    pieces restored, the same loss on both ranks."""
    ckpt, fut = spawned["launcher"]
    for ranks in fut.result():
        (plain, _), (saved, info), (resumed, rinfo) = ranks[0], ranks[2], ranks[3]
        np.testing.assert_allclose(saved, plain, rtol=1e-6, atol=1e-6)
        assert rinfo["start_step"] == 3 and len(resumed) == 1 and np.isfinite(resumed).all()
        assert rinfo["rank_losses"] == [resumed, resumed]
    _, state1 = train.build_state(get_config("whisper-tiny").reduced(), "cpu", seed=5)
    want_shapes = {"opt/step": ()}
    for tree, leaves in (("params", state1["params"]), ("residual", state1["residual"]),
                         ("opt/m", state1["opt"]["m"]), ("opt/v", state1["opt"]["v"])):
        want_shapes.update({f"{tree}/{n}": tuple(t.shape) for n, t in leaves.items()})
    with np.load(ckpt / "step_000000003" / "arrays.npz") as z:
        assert {k: z[k].shape for k in z.files} == want_shapes
