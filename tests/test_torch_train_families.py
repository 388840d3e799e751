"""Training of the port's LM families (moe, vlm, encdec, ssm, hybrid) against
the JAX package, on the CPU, in fp32.

Each family's ``reduced()`` model (granite-moe-1b-a400m, internvl2-26b,
whisper-tiny, rwkv6-7b, zamba2-7b) is built from the JAX ``init_params``
weights carried across by ``repro_torch.convert``, and ``lm.loss_fn`` is
held to ``jax.value_and_grad(repro.models.lm.loss_fn)`` built with no mesh
(the JAX train CLI fails on this JAX version, ROADMAP.md queue 3), with
remat on and off, on a batch of 2 × 70 tokens (+ whisper's 35 frames, the
vlm's 8 patches): 70 positions cross RWKV-6's 32-token chunks and
Mamba-2's 64-token chunk, and 35 frames is a Tk no tile divides.

Tolerances, from a measurement of this file's inputs:

* ``loss``, ``ce`` and ``moe_aux`` within 1e-5 (measured: 0 for the
  attention families, 4.8e-7 for rwkv6);
* the attention families' gradient leaves, each layer of a stacked JAX leaf
  on its own (``names.jax_leaf``), within ``GRAD_TOL`` = 1e-4 relative
  norm, the dense family's tolerance (measured: at most 2.9e-6, granite's
  ``wk``);
* the SSM families' gradient leaves within ``SSM_GRAD_TOL`` = 1e-4 of the
  leaf's largest element (|got − want| <= 1e-4 · max |want|). Their scans
  multiply by exp(±Σ log w) over a chunk (tests/test_torch_families.py), and
  Mamba-2's ``dt_bias`` gradient sums those products over every position:
  the port is 4.4e-5 of the scale from JAX there, and JAX's own fp32
  gradient is 2.8e-5 from an fp64 evaluation of the same model. Every other
  SSM leaf is within 7.1e-6 (rwkv6's ``wk``).

In bf16 each family's step is held to the JAX package's own bf16 step:
both are measured against JAX's fp32 step from the same (bf16) weights,
and the port may be at most ``BF16_LEAF_RATIO`` = 3 times as far as JAX on
any gradient leaf (measured: at most 2.15, zamba2's ``a_log``; the others
<= 1.40) and ``BF16_LOSS_RATIO`` = 3 times on the loss (measured: at most
1.21, rwkv6). A bf16 step is far from fp32 by nature in two families: 1 in
5 of granite's (token, slot) routes differ, and Mamba-2's ``dt_bias`` and
``d_skip`` gradients sum many cancelling terms (JAX's own bf16 gradients
sit 0.24-0.28 from its fp32 ones there).

Also here: the MoE with drops (capacity factor 1.0; ``reduced()`` is
drop-free), the attention backward calls per step, one whole step (loss,
backward, AdamW) against ``repro.optim.adamw_update``, ``global_norm`` and
top-k over each family's tree, AdamW on the fp32 leaves of a bf16 model,
the conversions of every family's params and AdamW state, the vlm's fp32
patches in a bf16 model, and ``launch.train.main --device cpu`` for every
family.
"""
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
from repro.optim import global_norm as jglobal_norm
from repro.optim import topk_compress_allreduce as jtopk
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.models.names import jax_leaf
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule, global_norm
from repro_torch.optim import topk_compress_allreduce

torch.set_num_threads(1)

FAMILIES = ["granite-moe-1b-a400m", "internvl2-26b", "whisper-tiny", "rwkv6-7b", "zamba2-7b"]
B, S = 2, 70
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
SSM_GRAD_TOL = 1e-4
BF16_LEAF_RATIO = 3.0
BF16_LOSS_RATIO = 3.0


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _get(tree, dotted):
    for k in dotted.split("."):
        tree = tree[k]
    return tree


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _configs(arch, **changes):
    jcfg = jax_get_config(arch).reduced()
    if changes:
        jcfg = type(jcfg)(**{**jcfg.__dict__, **changes})
    return jcfg, type(get_config(arch))(**jcfg.__dict__)


def _model(cfg, params):
    model = convert.lm_params_from_numpy(_np_tree(params), cfg, device="cpu")
    model.requires_grad_(True)
    return model


def _batch(cfg, seed=1, b=B, s=S):
    """Tokens (B, S+1), and whisper's frames or the vlm's patches, in fp32 as
    the data pipeline yields them."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, s // 2, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.normal(size=(b, cfg.vlm_patches, cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, remat, capacity_factor=None):
    """(jcfg, cfg, params, batch, (loss, aux), grads) of the JAX reference
    at seed 0 on ``_batch``; computed once per case for the whole file."""
    changes = {}
    if capacity_factor is not None:
        changes["moe"] = type(jax_get_config(arch).reduced().moe)(4, 2, capacity_factor)
    jcfg, cfg = _configs(arch, **changes)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    (loss, aux), grads = jax.value_and_grad(partial(jlm.loss_fn, cfg=jcfg, remat=remat),
                                            has_aux=True)(
        params, batch={k: jnp.asarray(v) for k, v in batch.items()})
    return jcfg, cfg, params, batch, (float(loss), {k: float(v) for k, v in aux.items()}), \
        _np_tree(grads)


def _per_layer(tree):
    """(port parameter name, array) of every leaf, stacked leaves split per
    layer — the port's names."""
    flat = convert._leaves(tree)
    for key, a in flat.items():
        head = key.split(".", 1)[0]
        if head in ("blocks", "enc_blocks"):
            for i in range(a.shape[0]):
                yield key.replace(head, f"{head}.{i}", 1), a[i]
        else:
            yield key, a


def _assert_grads_close(cfg, got, want):
    """Every leaf of ``want`` (the JAX layout) per layer against ``got``
    (port names -> arrays), at the family's tolerance."""
    names = set()
    for name, w in _per_layer(want):
        names.add(name)
        g = got[name]
        assert g.shape == w.shape, name
        if cfg.family in ("ssm", "hybrid"):
            err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= SSM_GRAD_TOL, (name, err)
        else:
            assert _rel(g, w) <= GRAD_TOL, (name, _rel(g, w))
    assert names == set(got)


def _port_loss_and_grads(model, cfg, batch, remat):
    for p in model.parameters():
        p.grad = None
    ops.reset_launch_counts()
    loss, aux = lm.loss_fn(model, cfg, {k: _t(v) for k, v in batch.items()}, remat=remat)
    loss.backward()
    grads = {n: p.grad.detach().float().numpy() for n, p in model.named_parameters()}
    return loss, aux, grads


# ----------------------------------------------------------------------------
# loss_fn and its gradients against the JAX package
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch, remat):
    """loss, ce and moe_aux within 1e-5 of JAX, every gradient leaf at the
    family's tolerance (module docstring), each attention differentiated
    through the Function once per step, no kernel launched on the CPU."""
    jcfg, cfg, params, batch, (jloss, jaux), jgrads = _jax_loss_and_grads(arch, remat)
    model = _model(cfg, params)
    loss, aux, grads = _port_loss_and_grads(model, cfg, batch, remat)
    assert fa.BACKWARD_CALLS == lm.attention_calls(cfg)[1]
    assert ops.launch_counts()["flash_attention"] == 0  # CPU tensors: the plain version
    assert set(aux) == set(jaux) == {"ce", "moe_aux"}
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_TOL, atol=LOSS_TOL)
    for k in ("ce", "moe_aux"):
        np.testing.assert_allclose(aux[k].item(), jaux[k], rtol=LOSS_TOL, atol=LOSS_TOL)
    assert (aux["moe_aux"].item() > 0) == bool(cfg.moe)
    _assert_grads_close(cfg, grads, jgrads)
    # Every parameter is reached: the patch projection, the encoder, the
    # shared block and the fp32 leaves included.
    zero = [n for n, g in grads.items() if not np.abs(g).max() > 0]
    assert not zero, zero


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_step_is_as_close_to_fp32_as_jaxs(arch):
    """A bf16 model's loss and gradients (the fp32 leaves in fp32, as in
    JAX) against JAX's fp32 step from the same weights, each no farther than
    the tolerance ratios (module docstring) times JAX's own bf16 step: a
    fault of a family's bf16 path (a leaf rounded that JAX keeps in fp32, an
    activation cast too early) shows as a gap JAX does not have."""
    jcfg16, cfg16 = _configs(arch, dtype="bfloat16")
    jcfg32, _ = _configs(arch, dtype="float32")
    params16 = jlm.init_params(jcfg16, jax.random.PRNGKey(0))
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params16)
    batch = _batch(cfg16)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = {}
    for tag, jcfg, params in (("bf16", jcfg16, params16), ("fp32", jcfg32, params32)):
        (loss, _), grads = jax.value_and_grad(partial(jlm.loss_fn, cfg=jcfg, remat=True),
                                              has_aux=True)(params, batch=jbatch)
        ref[tag] = float(loss), dict(_per_layer(_np_tree(grads)))
    model = _model(cfg16, params16)
    assert model.embed.dtype == torch.bfloat16
    loss, _, grads = _port_loss_and_grads(model, cfg16, batch, remat=True)
    jloss32, jgrads32 = ref["fp32"]
    jloss16, jgrads16 = ref["bf16"]
    port_err, jax_err = abs(loss.item() - jloss32), abs(jloss16 - jloss32)
    assert port_err <= BF16_LOSS_RATIO * jax_err, (port_err, jax_err)
    assert set(grads) == set(jgrads32)
    for name, want in jgrads32.items():
        want = want.astype(np.float64)
        port = _rel(grads[name].astype(np.float64), want)
        jax_own = _rel(jgrads16[name].astype(np.float64), want)
        assert port <= BF16_LEAF_RATIO * jax_own, (name, port, jax_own)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", FAMILIES)
def test_attention_calls_counts_a_steps_attentions(arch, remat, monkeypatch):
    """``lm.attention_calls`` against one ``loss_fn`` + ``backward()``: its
    first count is the step's ``ops.flash_attention`` calls (each one kernel
    launch on the card, the recomputation under remat included), its second
    the Function's backward calls."""
    cfg = get_config(arch).reduced()
    model = lm.init_params(cfg, torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    calls = []
    real = ops.flash_attention

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    ops.reset_launch_counts()
    loss, _ = lm.loss_fn(model, cfg, {k: _t(v) for k, v in _batch(cfg).items()}, remat=remat)
    loss.backward()
    assert (len(calls), fa.BACKWARD_CALLS) == lm.attention_calls(cfg, remat)


@pytest.mark.parametrize("arch, n_layers, want", [
    ("llama3.2-3b", None, (56, 28)),
    ("granite-moe-1b-a400m", None, (48, 24)),
    ("whisper-tiny", None, (24, 12)),  # 4 encoder layers, 4 decoder layers of 2
    ("internvl2-26b", 6, (12, 6)),
    ("zamba2-7b", 39, (6, 6)),  # the shared block, not rematerialised
    ("zamba2-7b", None, (13, 13)),
    ("rwkv6-7b", 12, (0, 0)),
])
def test_attention_calls_at_full_width(arch, n_layers, want):
    """The counts the card's full-width training runs are held to (the
    phases 11 and 13 of ``chip_smoke.py``), from the published configs."""
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    assert lm.attention_calls(cfg) == want


@pytest.mark.parametrize("remat", [True, False])
def test_moe_with_drops_matches_jax(remat, monkeypatch):
    """Granite at capacity factor 1.0: some (token, slot) pairs overflow to
    the dump row in every layer; loss, aux and gradients as above."""
    jcfg, cfg, params, batch, (jloss, jaux), jgrads = _jax_loss_and_grads(
        "granite-moe-1b-a400m", remat, capacity_factor=1.0)
    model = _model(cfg, params)
    loads = []
    real = lm.L.moe_ffn

    def recording(*a, **kw):
        out = real(*a, **kw)
        loads.append(out[2])
        return out

    monkeypatch.setattr(lm.L, "moe_ffn", recording)
    loss, aux, grads = _port_loss_and_grads(model, cfg, batch, remat)
    cap = max(8, -(-int(1.0 * B * S * cfg.moe.top_k / cfg.moe.n_experts) // 8) * 8)
    assert all((ld > cap).any() for ld in loads[:cfg.n_layers]), (cap, loads)
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(aux["moe_aux"].item(), jaux["moe_aux"], rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    _assert_grads_close(cfg, grads, jgrads)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_logits_match_jax(arch):
    """Logits (text positions only for the vlm) and the aux loss of
    ``forward_train`` against JAX's, within 1e-5 of the logits' scale; the
    hidden states have the model's width."""
    jcfg, cfg = _configs(arch)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(2))
    model = _model(cfg, params)
    batch = _batch(cfg, seed=3, s=37)
    batch["tokens"] = batch["tokens"][:, :-1]
    jlog, jaux = jlm.forward_train(params, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                   remat=False)
    with torch.no_grad():
        logits, aux = lm.forward_train(model, cfg, {k: _t(v) for k, v in batch.items()})
        hidden, _ = lm.forward_train(model, cfg, {k: _t(v) for k, v in batch.items()},
                                     return_hidden=True)
    assert logits.shape == (B, 37, cfg.vocab) and hidden.shape == (B, 37, cfg.d_model)
    scale = max(1.0, float(np.abs(jlog).max()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------------
# One whole step against the JAX package's
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_jax(arch):
    """From the same params and moments (random, non-zero, carried by
    ``convert.opt_state_from_numpy``; the step counter at 1): one
    ``make_step`` against JAX's value_and_grad + ``adamw_update``. Loss within
    1e-5; each param within 1e-4 (1 % of lr); each leaf's update within 1e-2
    relative norm and the moments within 1e-4 relative norm, as the dense
    family's step test holds them (tests/test_torch_train.py)."""
    jcfg, cfg, params, batch, (jloss, _), jgrads = _jax_loss_and_grads(arch, True)
    rng = np.random.default_rng(4)
    jst = dict(m=jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-3).astype(np.float32),
                              _np_tree(params)),
               v=jax.tree.map(lambda a: (rng.random(size=a.shape) * 1e-6).astype(np.float32),
                              _np_tree(params)),
               step=np.int32(1))
    start = _np_tree(params)
    model = _model(cfg, params)
    state = dict(params=dict(model.named_parameters()),
                 opt=convert.opt_state_from_numpy(jst, model, cfg),
                 residual={n: torch.zeros(p.shape) for n, p in model.named_parameters()})
    step = train.make_step(model, cfg, cosine_schedule(1e-2, 1, 10))
    state, metrics = step(state, {k: _t(v) for k, v in batch.items()})

    want, jst = jadamw_update(jax.tree.map(jnp.asarray, jgrads),
                              jax.tree.map(jnp.asarray, jst), jax.tree.map(jnp.asarray, start),
                              jcosine_schedule(1e-2, 1, 10)(jnp.int32(1)))
    np.testing.assert_allclose(metrics["loss"], jloss, rtol=1e-5, atol=1e-5)
    assert metrics["attn_backward_calls"] == lm.attention_calls(cfg)[1]
    assert metrics["flash_launches"] == 0 and not any(metrics["flash_bodies"].values())
    got_p = convert.lm_params_to_numpy(model)
    got_o = convert.opt_state_to_numpy(state["opt"])
    for key, w in convert._leaves(_np_tree(want)).items():
        got, before = _get(got_p, key), _get(start, key)
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-4, err_msg=key)
        assert _rel(got - before, w - before) <= 1e-2, (key, _rel(got - before, w - before))
    for k in ("m", "v"):
        for key, w in convert._leaves(_np_tree(jst[k])).items():
            assert _rel(_get(got_o[k], key), w) <= 1e-4, (k, key)
    assert int(got_o["step"]) == int(jst["step"]) == 2


# ----------------------------------------------------------------------------
# optim/, convert.py and checkpoints over each family's tree
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_global_norm_and_topk_match_jax_on_family_trees(arch):
    """``global_norm`` over the port's names in the JAX tree's order (1e-6),
    and top-k selection over the stacked ``blocks`` / ``enc_blocks`` leaves
    (each JAX leaf's layers selected together) equal to ``repro``'s, on the
    gradients of the reference step (rounded to a grid so that ties at the
    threshold occur)."""
    jcfg, cfg, params, _, _, jgrads = _jax_loss_and_grads(arch, True)
    model = _model(cfg, params)
    assert global_norm(dict(model.named_parameters())).item() == pytest.approx(
        float(jglobal_norm(params)), rel=1e-6)
    grid = jax.tree.map(lambda a: np.round(a / 1e-4) * 1e-4, jgrads)
    jout, jres = jtopk(jax.tree.map(jnp.asarray, grid),
                       jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), grid), None, 0.05)
    grads = dict(_per_layer(grid))
    res = {n: torch.zeros(a.shape) for n, a in grads.items()}
    out, res = topk_compress_allreduce({n: _t(a) for n, a in grads.items()}, res, None, 0.05)
    got_out, got_res = convert.lm_params_to_numpy(out), convert.lm_params_to_numpy(res)
    for key, w in convert._leaves(_np_tree(jout)).items():
        np.testing.assert_array_equal(_get(got_out, key), w, err_msg=key)
    for key, w in convert._leaves(_np_tree(jres)).items():
        np.testing.assert_array_equal(_get(got_res, key), w, err_msg=key)


FP32_LEAVES = {
    "granite-moe-1b-a400m": ["blocks.moe.router"],
    "rwkv6-7b": ["blocks.att.w0", "blocks.att.w_a", "blocks.att.w_b", "blocks.att.u",
                 "blocks.att.ln_x"],
    "zamba2-7b": ["blocks.mamba.a_log", "blocks.mamba.dt_bias", "blocks.mamba.d_skip",
                  "blocks.mamba.norm"],
}


@pytest.mark.parametrize("arch", sorted(FP32_LEAVES))
def test_adamw_on_the_fp32_leaves_of_a_bf16_model(arch):
    """AdamW on a bf16 model's tree: the fp32 leaves stay fp32 and equal
    JAX's update of the same tree within 1e-6, the bf16 leaves within one
    bf16 ulp (2^-7 relative: both update in fp32 and round once, and an fp32
    result one bit apart may round to the neighbouring bf16 value; plus
    1e-8 for results near zero, about the fp32 rounding of an lr-sized
    update), two steps."""
    jcfg, cfg = _configs(arch, dtype="bfloat16")
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(5))
    params = _np_tree(jp)
    model = convert.lm_params_from_numpy(params, cfg, device="cpu")
    named = dict(model.named_parameters())
    jst, st = jadamw_init(jp), adamw_init(named)
    rng = np.random.default_rng(6)
    for _ in range(2):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        tg = {n: _t(a).to(named[n].dtype) for n, a in _per_layer(g)}
        jg = jax.tree.map(lambda a, p: jnp.asarray(a, p.dtype), g, jp)
        jp, jst = jadamw_update(jg, jst, jp, jnp.float32(1e-2))
        adamw_update(tg, st, named, 1e-2)
    got = convert._leaves(convert.lm_params_to_numpy(model))
    for key, w in convert._leaves(_np_tree(jp)).items():
        w = np.asarray(w, np.float32)
        if key in FP32_LEAVES[arch]:
            assert named[key.replace("blocks.", "blocks.0.", 1)].dtype == torch.float32
            np.testing.assert_allclose(got[key], w, rtol=1e-6, atol=1e-7, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], w, rtol=2.0**-7, atol=1e-8, err_msg=key)


@pytest.mark.parametrize("arch", FAMILIES)
def test_state_conversions_round_trip_every_family(arch):
    """Params and the AdamW state of each family's tree (``enc_blocks``,
    ``shared``, ``vit_proj`` included) through ``convert`` both ways, bit for
    bit, the moments on every parameter name."""
    jcfg, cfg = _configs(arch)
    params = _np_tree(jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    model = convert.lm_params_from_numpy(params, cfg, device="cpu")
    back = convert.lm_params_to_numpy(model)
    flat = convert._leaves(params)
    assert set(convert._leaves(back)) == set(flat)
    for key, w in flat.items():
        np.testing.assert_array_equal(_get(back, key), w, err_msg=key)
    rng = np.random.default_rng(0)
    jst = dict(m=jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params),
               v=jax.tree.map(lambda a: rng.random(size=a.shape).astype(np.float32), params),
               step=np.int32(3))
    opt = convert.opt_state_from_numpy(jst, model, cfg)
    assert set(opt["m"]) == set(opt["v"]) == {n for n, _ in model.named_parameters()}
    back = convert.opt_state_to_numpy(opt)
    for k in ("m", "v"):
        for key, w in convert._leaves(jst[k]).items():
            np.testing.assert_array_equal(_get(back[k], key), w, err_msg=key)
    assert int(back["step"]) == 3


# ----------------------------------------------------------------------------
# The vlm's fp32 patches in a bf16 model
# ----------------------------------------------------------------------------

def _bf16_vlm():
    jcfg, cfg = _configs("internvl2-26b", dtype="bfloat16")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(7))
    model = convert.lm_params_from_numpy(_np_tree(jparams), cfg, device="cpu")
    patches = _batch(cfg, seed=8, s=12)["patches"]
    assert patches.dtype == np.float32 and model.vit_proj.dtype == torch.bfloat16
    return jcfg, cfg, jparams, model, patches


def test_bf16_vlm_patch_prefix_within_bf16_rounding_of_jax():
    """fp32 patches against a bf16 ``vit_proj``: both packages multiply in
    fp32 and round to bf16 once, so the prefixes agree within one bf16 ulp
    (2^-7 relative: the fp32 sums may round to neighbouring bf16 values)."""
    jcfg, cfg, jparams, model, patches = _bf16_vlm()
    want = (jnp.asarray(patches) @ jparams["vit_proj"]).astype(jnp.bfloat16)
    got = lm._patch_prefix(model, _t(patches), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), w, rtol=2.0**-7, atol=1e-6)
    assert np.mean(got.float().numpy() == w) > 0.99


@pytest.mark.parametrize("path", ["forward_cached", "loss_fn"])
def test_bf16_vlm_takes_fp32_patches(path):
    """A bf16 vlm served and trained on the fp32 patches the data pipeline
    yields: finite logits of the text positions, a finite loss whose
    gradient reaches ``vit_proj``."""
    jcfg, cfg, jparams, model, patches = _bf16_vlm()
    tokens = np.random.default_rng(9).integers(0, cfg.vocab, (B, 13)).astype(np.int32)
    if path == "forward_cached":
        cache = lm.init_cache(cfg, B, 16, device="cpu")
        logits, _ = lm.forward_cached(model, cfg, cache, _t(tokens[:, :12]), 0,
                                      patches=_t(patches))
        assert logits.shape == (B, 12, cfg.vocab) and logits.dtype == torch.bfloat16
        assert torch.isfinite(logits).all()
    else:
        model.requires_grad_(True)
        loss, aux = lm.loss_fn(model, cfg, {"tokens": _t(tokens), "patches": _t(patches)})
        loss.backward()
        assert np.isfinite(loss.item()) and aux["moe_aux"].item() == 0.0
        assert model.vit_proj.grad.dtype == torch.bfloat16
        assert torch.isfinite(model.vit_proj.grad).all() and model.vit_proj.grad.abs().max() > 0


# ----------------------------------------------------------------------------
# The launcher
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_train_cli_runs_every_family(arch, capsys):
    """``launch.train.main --device cpu``: two finite losses, every gradient
    at the first step finite and non-zero, the backward calls per step, no
    kernel launch (by body too)."""
    info = {}
    losses = train.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
                         "--seq", "16", "--lr", "1e-2", "--device", "cpu"], info=info)
    cfg = get_config(arch).reduced()
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert info["attn_backward_calls"] == [lm.attention_calls(cfg)[1]] * 2
    assert info["flash_launches"] == [0, 0]
    assert info["flash_bodies"] == [dict.fromkeys(fa.BODIES, 0)] * 2
    assert info["grad_flags"] and all(f and nz for f, nz in info["grad_flags"].values())
    assert {jax_leaf(n)[0].split(".")[0] for n in info["grad_flags"]} >= {
        "moe": {"blocks"}, "vlm": {"vit_proj"}, "encdec": {"enc_blocks", "enc_ln_f"},
        "ssm": {"blocks"}, "hybrid": {"shared"}}[cfg.family]
    assert "done: steps=2" in capsys.readouterr().out
