"""The port's training substrates against the JAX package, on the CPU:
the synthetic data pipeline (bit-equal batches), the checkpoint manager
(torch trees, bf16 bit-exact, in-place restore), the fault-tolerant loop,
the straggler monitor and elastic mesh planning — mirrors of
``tests/test_substrates.py``, plus equality with ``repro``'s decisions on
the same inputs."""
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.runtime import StragglerMonitor as JStragglerMonitor
from repro.runtime import plan_mesh as jplan_mesh
from repro.runtime import replan_after_failure as jreplan
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticTokens
from repro_torch.runtime import (
    FaultTolerantLoop,
    StepFailure,
    StragglerMonitor,
    plan_mesh,
    replan_after_failure,
)


# ----------------------------------------------------------------------------
# Data pipeline
# ----------------------------------------------------------------------------

def _both(arch, seq, batch, seed, shard=(0, 1)):
    ours = SyntheticTokens(get_config(arch).reduced(), ShapeConfig("t", seq, batch, "train"),
                           seed=seed, shard=shard)
    ref = JSyntheticTokens(jax_get_config(arch).reduced(), JShapeConfig("t", seq, batch, "train"),
                           seed=seed, shard=shard)
    return ours, ref


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3.2-3b", "whisper-tiny", "internvl2-26b"])
def test_batches_bit_equal_to_repro(arch):
    """Tokens (and the encdec frames, the vlm patches) equal bit for bit."""
    ours, ref = _both(arch, 24, 4, seed=5)
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


@settings(deadline=None, max_examples=30)
@given(st.integers(1, 64), st.sampled_from([1, 2, 4, 8]), st.integers(0, 2**31 - 1),
       st.integers(0, 10**6), st.integers(0, 3))
def test_batches_bit_equal_property(seq, batch, seed, step, shard_pick):
    count = [c for c in (1, 2, 4) if batch % c == 0][shard_pick % 3 if batch >= 4 else 0]
    idx = shard_pick % count
    ours, ref = _both("qwen1.5-0.5b", seq, batch, seed, (idx, count))
    np.testing.assert_array_equal(ours.batch_at(step)["tokens"], ref.batch_at(step)["tokens"])


def test_data_deterministic_and_resumable():
    cfg = get_config("qwen1.5-0.5b").reduced()
    shape = ShapeConfig("t", 32, 8, "train")
    a = SyntheticTokens(cfg, shape, seed=3).batch_at(7)
    b = SyntheticTokens(cfg, shape, seed=3).batch_at(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = SyntheticTokens(cfg, shape, seed=4).batch_at(7)
    assert (a["tokens"] != c["tokens"]).any()


def test_data_shards_disjoint_and_consistent():
    """Shard i of 4 equals rows [i*b/4, (i+1)*b/4) of the global batch."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    shape = ShapeConfig("t", 16, 8, "train")
    full = SyntheticTokens(cfg, shape, seed=0, shard=(0, 1)).batch_at(3)["tokens"]
    parts = [SyntheticTokens(cfg, shape, seed=0, shard=(i, 4)).batch_at(3)["tokens"]
             for i in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts, axis=0), full)


def test_data_zipf_skew_and_iteration():
    cfg = get_config("qwen1.5-0.5b").reduced()
    data = SyntheticTokens(cfg, ShapeConfig("t", 256, 16, "train"), seed=0)
    toks = data.batch_at(0)["tokens"]
    assert toks.shape == (16, 257) and toks.dtype == np.int32
    assert toks.min() >= 0 and toks.max() < cfg.vocab
    it = iter(data)
    np.testing.assert_array_equal(next(it)["tokens"], toks)
    np.testing.assert_array_equal(next(it)["tokens"], data.batch_at(1)["tokens"])


# ----------------------------------------------------------------------------
# Checkpoint manager
# ----------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"embed": torch.randn(6, 4, generator=g).to(torch.bfloat16),
                   "blocks.0.attn.wq": torch.randn(4, 4, generator=g)},
        "opt": {"m": {"embed": torch.randn(6, 4, generator=g)},
                "step": torch.tensor(7, dtype=torch.int32)},
        "residual": {"embed": torch.randn(6, 4, generator=g)},
    }


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _leaves(tree[k], f"{prefix}/{k}")


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


@pytest.mark.parametrize("async_write", [True, False])
def test_checkpoint_roundtrip_bitexact(tmp_path, async_write):
    """bf16, fp32 and int32 leaves come back bit for bit (a bf16 NaN
    payload and -0.0 included), in their own dtypes, into the template."""
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_write=async_write)
    tree = _tree()
    tree["params"]["embed"][0, :3] = torch.tensor([float("nan"), -0.0, 1e-40]).to(torch.bfloat16)
    saved = _clone(tree)
    ckpt.save(10, tree, meta={"x": 1})
    ckpt.wait()
    template = _tree(seed=1)
    restored, manifest = ckpt.restore(template)
    assert restored is template
    for (key, a), (_, b) in zip(_leaves(saved), _leaves(restored)):
        assert a.dtype == b.dtype, key
        bits = {torch.bfloat16: torch.int16}.get(a.dtype)
        assert torch.equal(a.view(bits), b.view(bits)) if bits else torch.equal(a, b), key
    assert manifest["step"] == 10 and manifest["meta"]["x"] == 1
    assert manifest["dtypes"]["params/embed"] == "bfloat16"
    assert manifest["shapes"]["opt/step"] == []


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-7b"])
def test_checkpoint_roundtrip_of_a_bf16_family_model(tmp_path, arch):
    """A bf16 family model's train state — bf16 weights beside the fp32
    leaves JAX keeps (the MoE router; Mamba-2's ``a_log`` and its other
    decay leaves), fp32 moments and residual — comes back bit for bit, each
    leaf in its own dtype, into a state built from another seed."""
    import dataclasses

    from repro_torch.launch import train

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    _, state = train.build_state(cfg, "cpu", seed=0)
    fp32 = {"granite-moe-1b-a400m": "blocks.0.moe.router", "zamba2-7b": "blocks.0.mamba.a_log"}[arch]
    assert state["params"][fp32].dtype == torch.float32
    assert state["params"]["embed"].dtype == torch.bfloat16
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for n, p in state["params"].items():  # values bf16 cannot hold in the fp32 leaves
            p.copy_(torch.randn(p.shape, generator=g))
        for tree in (state["opt"]["m"], state["opt"]["v"], state["residual"]):
            for t in tree.values():
                t.copy_(torch.randn(t.shape, generator=g))
    state["opt"]["step"].fill_(5)
    saved = _clone(state)
    ckpt = CheckpointManager(str(tmp_path), keep=1, async_write=False)
    ckpt.save(5, state)
    _, template = train.build_state(cfg, "cpu", seed=1)
    restored, manifest = ckpt.restore(template)
    assert manifest["dtypes"][f"params/{fp32}"] == "float32"
    assert manifest["dtypes"]["params/embed"] == "bfloat16"
    for (key, a), (_, b) in zip(_leaves(saved), _leaves(restored)):
        assert a.dtype == b.dtype, key
        bits = {torch.bfloat16: torch.int16}.get(a.dtype)
        assert torch.equal(a.view(bits), b.view(bits)) if bits else torch.equal(a, b), key


def test_checkpoint_save_then_inplace_update_restores_saved_values(tmp_path):
    """save() takes its host copy before it returns: updating the tensors in
    place right after (as the train step does) cannot reach the file."""
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    tree = _tree()
    saved = _clone(tree)
    ckpt.save(1, tree)
    for _, t in _leaves(tree):
        t.add_(1)  # in place, while the writer may still run
    ckpt.restore(tree)
    for (key, a), (_, b) in zip(_leaves(saved), _leaves(tree)):
        assert torch.equal(a, b), key


def test_checkpoint_keep_k_and_latest(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    tree = {"a": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        ckpt.save(s, tree)
    assert ckpt.all_steps() == [3, 4]
    assert ckpt.latest_step() == 4


def test_checkpoint_ignores_partial_writes(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3, async_write=False)
    tree = {"a": torch.zeros(3)}
    ckpt.save(5, tree)
    os.makedirs(tmp_path / "step_000000009.tmp-999", exist_ok=True)
    assert ckpt.latest_step() == 5


def test_checkpoint_restore_refuses_a_wrong_shape_and_an_empty_root(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "a"), keep=3, async_write=False)
    with pytest.raises(FileNotFoundError):
        ckpt.restore({"a": torch.zeros(3)})
    ckpt.save(1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="a:"):
        ckpt.restore({"a": torch.zeros(4)})
    with pytest.raises(TypeError, match="not a tensor"):
        ckpt.save(2, {"a": np.zeros(3)})


# ----------------------------------------------------------------------------
# Runtime: fault tolerance, elasticity, stragglers
# ----------------------------------------------------------------------------

def _mini_loop(failures):
    state = {"x": 0.0}
    saved = {}

    def step_fn(st_, batch):
        return {"x": st_["x"] + 1.0}, {"loss": 1.0 / (st_["x"] + 1.0)}

    def save_fn(step, st_):
        saved["ckpt"] = (step, dict(st_))

    def restore_fn():
        step, st_ = saved["ckpt"]
        return dict(st_), step

    fired = set()

    def failure_hook(step):
        if step in failures and step not in fired:
            fired.add(step)
            raise StepFailure(failures[step], f"injected at {step}")

    loop = FaultTolerantLoop(step_fn, save_fn, restore_fn, ckpt_every=2,
                             failure_hook=failure_hook)
    save_fn(0, state)
    return loop, loop.run(state, lambda s: None, 0, 10)


def test_fault_loop_transient_retry():
    loop, (state, hist) = _mini_loop({3: "transient"})
    assert loop.stats.retries == 1
    assert loop.stats.restores == 0
    assert len(hist) == 10 and state["x"] == 10.0


def test_fault_loop_fatal_restores():
    loop, (state, hist) = _mini_loop({5: "fatal"})
    assert loop.stats.restores == 1
    assert state["x"] == 10.0


def test_fault_loop_nan_skips_batch():
    state = {"x": 0.0}
    saved = {}

    def step_fn(st_, batch):
        loss = float("nan") if batch == 4 else 1.0
        return {"x": st_["x"] + 1.0}, {"loss": loss}

    def save_fn(step, st_):
        saved["ckpt"] = (step, dict(st_))

    def restore_fn():
        return dict(saved["ckpt"][1]), saved["ckpt"][0]

    loop = FaultTolerantLoop(step_fn, save_fn, restore_fn, ckpt_every=2)
    save_fn(0, state)
    state, hist = loop.run(state, lambda s: s, 0, 10)
    assert loop.stats.skipped_data_steps == 1
    assert loop.stats.restores == 1


def test_fault_loop_nan_after_an_inplace_step_restores_every_tensor(tmp_path):
    """The port's step updates its tensors in place before the loss is
    checked: a NaN step has already changed them, and the loop's restore
    (the checkpoint manager copying into the live tensors) must undo it.
    The state ends as if the poisoned batch had been skipped."""
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    state = {"params": {"w": torch.zeros(4)}, "opt": {"step": torch.tensor(0)}}

    def step_fn(st_, batch):
        st_["params"]["w"].add_(float(batch))  # in place, as the train step
        st_["opt"]["step"].add_(1)
        return st_, {"loss": float("nan") if batch == 4 else 1.0}

    loop = FaultTolerantLoop(step_fn, lambda s, st_: ckpt.save(s, st_),
                             lambda: (ckpt.restore(state)[0], ckpt.latest_step()),
                             ckpt_every=2)
    ckpt.save(0, state)
    out, hist = loop.run(state, lambda s: s, 0, 6)
    assert out is state and loop.stats.restores == 1 and loop.stats.skipped_data_steps == 1
    # Batch 4's update (w += 4, step += 1) is undone by the restore to the
    # step-4 checkpoint, the batch skipped: w = 0 + 1 + 2 + 3 + 5.
    assert state["params"]["w"].tolist() == [11.0] * 4
    assert int(state["opt"]["step"]) == 5 and [s for s, _ in hist] == [0, 1, 2, 3, 5]


def test_elastic_plan_and_replan():
    plan = plan_mesh(512, model_parallel=16, pods=2)
    assert plan.shape == (2, 16, 16) and plan.chips == 512
    new = replan_after_failure(plan, lost_chips=3, global_batch=256)
    assert new is not None
    assert new.chips < plan.chips
    assert new.model == 16
    assert 256 % (new.pod * new.data) == 0
    assert new.grad_accum * new.pod * new.data >= plan.pod * plan.data


@settings(deadline=None, max_examples=50)
@given(st.sampled_from([16, 32, 64, 128, 256, 512, 1024]), st.sampled_from([1, 2, 4, 8, 16]),
       st.sampled_from([1, 2]), st.integers(0, 600), st.sampled_from([64, 256, 1000]))
def test_elastic_plans_equal_repro(chips, mp, pods, lost, batch):
    if chips // pods // mp < 1:
        return
    plan, jplan = plan_mesh(chips, mp, pods), jplan_mesh(chips, mp, pods)
    assert (plan.pod, plan.data, plan.model, plan.grad_accum) == \
        (jplan.pod, jplan.data, jplan.model, jplan.grad_accum)
    new, jnew = replan_after_failure(plan, lost, batch), jreplan(jplan, lost, batch)
    assert (new is None) == (jnew is None)
    if new is not None:
        assert (new.pod, new.data, new.model, new.grad_accum, new.shape, new.axes) == \
            (jnew.pod, jnew.data, jnew.model, jnew.grad_accum, jnew.shape, jnew.axes)


def test_straggler_monitor_rebalances_and_evicts():
    mon = StragglerMonitor(hosts=4, microbatches_per_host=4, evict_after=3)
    times = np.array([1.0, 1.0, 1.0, 1.0])
    decision = None
    for step in range(20):
        t = times.copy() * mon.alloc / 4
        t[2] *= 2.5
        decision = mon.observe(t)
    assert decision.flagged_host == 2
    assert decision.evict
    assert mon.alloc[2] < 4 and mon.alloc.sum() == 16


def test_straggler_decisions_equal_repro():
    """The same timing trace through both monitors: the same decision at
    every step."""
    rng = np.random.default_rng(3)
    mon, jmon = (cls(hosts=6, microbatches_per_host=3, evict_after=4)
                 for cls in (StragglerMonitor, JStragglerMonitor))
    for step in range(60):
        t = rng.gamma(4.0, 0.25, size=6) * (1 + 2.0 * (np.arange(6) == step // 20))
        a, b = mon.observe(t), jmon.observe(t)
        assert (a.flagged_host, a.evict) == (b.flagged_host, b.evict), step
        np.testing.assert_array_equal(a.microbatch_alloc, b.microbatch_alloc)
