"""The port's LM training path against the JAX package, on the CPU.

Held against ``repro`` on the same numpy inputs, in fp32, at ``reduced()``
of qwen1.5-0.5b (QKV bias, untied head, GQA 4/2) and llama3.2-3b (tied
embeddings, GQA 4/2), with weights carried across by
``repro_torch.convert``:

* ``flash_attention`` under autograd (``FlashAttentionFn``): its q/k/v
  gradients against autograd through the plain version (1e-5; the card
  forward has no autograd history of its own, so without the Function the
  attention weights would get no gradient there) and against
  ``jax.grad`` of the JAX package's ``_blocked_softmax_attn`` (1e-5);
* ``loss_fn`` within 1e-5 of ``jax.value_and_grad(repro.models.lm.loss_fn)``
  and every gradient leaf within 1e-4 relative norm (the reference step is
  built from ``repro.models.lm.loss_fn`` + ``repro.optim`` directly, with
  no mesh: the JAX train CLI fails on this JAX version, ROADMAP.md queue 3);
* ``adamw_update``, ``cosine_schedule``, ``global_norm`` and
  ``topk_compress_allreduce`` within 1e-6 of ``repro.optim``;
* one whole train step (loss, backward, optional compression, AdamW) from
  the same params and moments, within 1e-5 on the params;
* the launcher, mirroring the JAX train-CLI tests (``tests/test_system.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from functools import partial
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine_schedule
from repro.optim import global_norm as jglobal_norm
from repro.optim import topk_compress_allreduce as jtopk
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.optim import (
    adamw_init, adamw_update, cosine_schedule, global_norm, topk_compress_allreduce,
)

torch.set_num_threads(1)

ARCHS = ["qwen1.5-0.5b", "llama3.2-3b"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaf_items(tree):
    """(dotted path, array) of every leaf of a nested dict."""
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield ".".join(p.key for p in path), np.asarray(a)


def _get(tree, dotted):
    for k in dotted.split("."):
        tree = tree[k]
    return tree


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _both_models(arch, seed=0):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    params = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    model = convert.lm_params_from_numpy(_np_tree(params), cfg, device="cpu")
    model.requires_grad_(True)
    return jcfg, params, cfg, model


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


# ----------------------------------------------------------------------------
# flash_attention under autograd
# ----------------------------------------------------------------------------

# b, hq, hkv, tq, tk, dh, causal: GQA groups 1-3, prefill, Tq < Tk, ragged
# blocks, non-causal (Tk % 128 == 0).
FN_SHAPES = [
    (2, 6, 2, 37, 37, 16, True), (1, 4, 4, 33, 45, 8, True), (1, 3, 1, 70, 70, 32, True),
    (2, 4, 2, 20, 128, 8, False),
]


def _qkv(shape, seed, dtype=torch.float32):
    b, hq, hkv, tq, tk, dh, _ = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(dtype).requires_grad_(True)
            for sh in ((b, hq, tq, dh), (b, hkv, tk, dh), (b, hkv, tk, dh))]


@pytest.mark.parametrize("q_block", [512, 16])
@pytest.mark.parametrize("shape", FN_SHAPES)
def test_attention_function_grads_match_autograd_through_plain(monkeypatch, shape, q_block):
    """The Function's forward is the plain version bit for bit on the CPU,
    and its blocked backward's dq/dk/dv are within 1e-5 of autograd through
    the plain version (fp32; they differ in summation order only), for
    blocks of 512 rows (one block here) and of 16 (several, with a ragged
    last one)."""
    monkeypatch.setattr(fa, "BACKWARD_Q_BLOCK", q_block)
    causal = shape[-1]
    q, k, v = _qkv(shape, 1)
    dout = torch.from_numpy(np.random.default_rng(2).normal(size=q.shape).astype(np.float32))
    want_out = ref.flash_attention_ref(q, k, v, causal=causal, scale=0.3)
    want = torch.autograd.grad(want_out, (q, k, v), dout)
    before = fa.BACKWARD_CALLS
    out = ops.flash_attention(q, k, v, causal=causal, scale=0.3)
    assert out.grad_fn is not None and torch.equal(out, want_out)
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert fa.BACKWARD_CALLS - before == 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


def test_attention_function_grads_in_bf16():
    """bf16 in and out: the gradients are computed in fp32 and rounded once
    to bf16, as autograd through the plain version rounds them; they agree
    within one bf16 ulp (2^-7 relative)."""
    q, k, v = _qkv((1, 6, 2, 40, 40, 32, True), 3, torch.bfloat16)
    dout = torch.from_numpy(np.random.default_rng(4).normal(size=q.shape).astype(np.float32))
    dout = dout.to(torch.bfloat16)
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v), (q, k, v), dout)
    got = torch.autograd.grad(ops.flash_attention(q, k, v), (q, k, v), dout)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=2.0**-7, atol=2.0**-7)


@pytest.mark.parametrize("shape", FN_SHAPES[:3])
def test_attention_function_grads_match_jax_blocked_softmax(shape):
    """dq/dk/dv against ``jax.grad`` of the JAX training path's attention,
    ``_blocked_softmax_attn`` (q pre-scaled, as the layers pass it), 1e-5."""
    b, hq, hkv, tq, tk, dh, causal = shape
    q, k, v = _qkv(shape, 5)
    dout = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    offset = tk - tq  # the port aligns causality to the end of KV

    def f(q_, k_, v_):
        out = JL._blocked_softmax_attn(q_, k_, v_, causal, offset, q_block=16)
        return jnp.sum(out * dout)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(t.detach().numpy()) for t in (q, k, v)))
    got = torch.autograd.grad(ops.flash_attention(q, k, v, causal=causal, scale=1.0),
                              (q, k, v), _t(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_serving_under_no_grad_builds_no_graph():
    q, k, v = _qkv(FN_SHAPES[0], 7)
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
    assert out.grad_fn is None and not out.requires_grad


# ----------------------------------------------------------------------------
# forward_train, loss_fn, _chunked_ce against the JAX package
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    """loss_fn within 1e-5 of jax.value_and_grad(repro lm.loss_fn), aux
    keys equal, every gradient leaf within 1e-4 relative norm; attention is
    differentiated through the Function once per layer."""
    jcfg, params, cfg, model = _both_models(arch)
    toks = _tokens(cfg, 2, 33, 1)
    (jloss, jaux), jgrads = jax.value_and_grad(
        partial(jlm.loss_fn, cfg=jcfg, remat=remat), has_aux=True
    )(params, batch={"tokens": jnp.asarray(toks)})
    ops.reset_launch_counts()
    loss, aux = lm.loss_fn(model, cfg, {"tokens": _t(toks)}, remat=remat)
    loss.backward()
    assert fa.BACKWARD_CALLS == cfg.n_layers
    assert ops.launch_counts()["flash_attention"] == 0  # CPU tensors: the plain version
    assert set(aux) == set(jaux) == {"ce", "moe_aux"}
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux["ce"].item(), float(jaux["ce"]), rtol=1e-5, atol=1e-5)
    assert aux["moe_aux"].item() == float(jaux["moe_aux"]) == 0.0
    grads = convert.lm_params_to_numpy({n: p.grad for n, p in model.named_parameters()})
    jg = _np_tree(jgrads)
    assert {k for k, _ in _leaf_items(grads)} == {k for k, _ in _leaf_items(jg)}
    for key, want in _leaf_items(jg):
        got = _get(grads, key)
        assert got.shape == want.shape, key
        assert _rel(got, want) <= 1e-4, (key, _rel(got, want))
    for w in ("wq", "wk", "wv"):
        assert (np.abs(grads["blocks"]["attn"][w]).reshape(cfg.n_layers, -1).max(1) > 0).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_logits_match_jax(arch):
    jcfg, params, cfg, model = _both_models(arch, seed=2)
    toks = _tokens(cfg, 2, 17, 3)
    jlog, jaux = jlm.forward_train(params, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    with torch.no_grad():
        logits, aux = lm.forward_train(model, cfg, {"tokens": _t(toks)})
        hidden, _ = lm.forward_train(model, cfg, {"tokens": _t(toks)}, return_hidden=True)
    assert logits.shape == (2, 17, cfg.vocab) and hidden.shape == (2, 17, cfg.d_model)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), rtol=1e-5, atol=1e-5)
    assert aux.item() == float(jaux) == 0.0


@pytest.mark.parametrize("s,n_chunks", [(13, 8), (32, 8), (5, 8), (16, 3)])
def test_chunked_ce_matches_jax(s, n_chunks):
    """Chunks of ⌈S/n⌉ (a ragged last one; n > S caps at S), fp32 logits,
    the gold logit by gather against JAX's one-hot sum: 1e-6."""
    rng = np.random.default_rng(s)
    hidden = rng.normal(size=(3, s, 24)).astype(np.float32)
    head = (rng.normal(size=(24, 50)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 50, (3, s)).astype(np.int32)
    want = jlm._chunked_ce(jnp.asarray(hidden), jnp.asarray(head), jnp.asarray(labels),
                           n_chunks=n_chunks)
    for remat in (True, False):
        got = lm._chunked_ce(_t(hidden), _t(head), _t(labels), n_chunks=n_chunks, remat=remat)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)


def test_forward_train_refuses_other_families():
    """Nothing is refused any more: a reduced MoE model (built as serving
    builds it) trains, with finite logits of the right shape and two finite
    losses (tests/test_torch_train_families.py holds every family to JAX)."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    model = lm.init_params(cfg, torch.Generator().manual_seed(0))
    logits, aux = lm.forward_train(model, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    assert logits.shape == (1, 4, cfg.vocab) and torch.isfinite(logits).all()
    assert aux.item() > 0  # the MoE's auxiliary loss
    losses = [lm.loss_fn(model, cfg, {"tokens": _t(_tokens(cfg, 2, 9, s))})[0].item()
              for s in (1, 2)]
    assert np.isfinite(losses).all()


# ----------------------------------------------------------------------------
# Optimizer
# ----------------------------------------------------------------------------

def _tree(rng, shapes, scale=1.0):
    return {n: (rng.normal(size=s) * scale).astype(np.float32) for n, s in shapes.items()}


OPT_SHAPES = {"a": (4, 3), "b": (7,), "c": (2, 2, 5)}


@pytest.mark.parametrize("clip_norm", [1e9, 1.0, 0.05])
@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_update_matches_jax(clip_norm, steps):
    """AdamW steps from the same params within 1e-6 of repro.optim's, with
    the clip off, on and cutting hard; the moments and step too."""
    rng = np.random.default_rng(steps)
    p = _tree(rng, OPT_SHAPES)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    jst, tst = jadamw_init(jp), adamw_init(tp)
    for i in range(steps):
        g = _tree(rng, OPT_SHAPES, 0.3)
        jp, jst = jadamw_update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp,
                                jnp.float32(1e-2), clip_norm=clip_norm)
        out, tst2 = adamw_update({k: _t(v) for k, v in g.items()}, tst, tp, 1e-2,
                                 clip_norm=clip_norm)
        assert out is tp and tst2 is tst  # in place
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tst["m"][k].numpy(), np.asarray(jst["m"][k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tst["v"][k].numpy(), np.asarray(jst["v"][k]), rtol=1e-6, atol=1e-9)
    assert int(tst["step"]) == int(jst["step"]) == steps and tst["step"].dtype == torch.int32


def test_adamw_matches_reference_step():
    """The JAX package's closed-form check of one step (mirror)."""
    rng = np.random.default_rng(0)
    p = {"w": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))}
    g = {"w": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)) * 0.01}
    w0 = p["w"].numpy().copy()
    st_ = adamw_init(p)
    lr, b1, b2, eps, wd = 1e-2, 0.9, 0.95, 1e-8, 0.1
    adamw_update(g, st_, p, lr, clip_norm=1e9, weight_decay=wd)
    m = (1 - b1) * g["w"].numpy()
    v = (1 - b2) * g["w"].numpy() ** 2
    mh, vh = m / (1 - b1), v / (1 - b2)
    expect = w0 - lr * (mh / (np.sqrt(vh) + eps) + wd * w0)
    np.testing.assert_allclose(p["w"].numpy(), expect, rtol=1e-5)
    assert int(st_["step"]) == 1


def test_adamw_clips_global_norm():
    p = {"w": torch.zeros(10)}
    adamw_update({"w": torch.full((10,), 100.0)}, adamw_init(p), p, 1.0, clip_norm=1.0,
                 weight_decay=0.0)
    assert p["w"].abs().max().item() <= 1.0 + 1e-5


def test_adamw_keeps_bf16_params_and_fp32_moments():
    """A bf16 parameter is updated in fp32 and rounded once, as JAX's
    astype(p.dtype): equal to the JAX step on the same bf16 values."""
    rng = np.random.default_rng(9)
    p32 = rng.normal(size=(6, 5)).astype(np.float32)
    g32 = rng.normal(size=(6, 5)).astype(np.float32)
    tp = {"w": _t(p32).to(torch.bfloat16)}
    jp = {"w": jnp.asarray(p32, jnp.bfloat16)}
    st_ = adamw_init(tp)
    assert st_["m"]["w"].dtype == torch.float32
    adamw_update({"w": _t(g32).to(torch.bfloat16)}, st_, tp, 1e-2)
    jp, _ = jadamw_update({"w": jnp.asarray(g32, jnp.bfloat16)}, jadamw_init(jp), jp,
                          jnp.float32(1e-2))
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(tp["w"].float().numpy(), np.asarray(jp["w"], np.float32),
                               rtol=2.0**-8, atol=0)


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 5), (0, 3), (7, 7)])
def test_cosine_schedule_matches_jax(warmup, total):
    """Within 1e-6 relative, or 1e-7 of the base rate where the cosine nears
    -1: there 1 + cos cancels, and one fp32 ulp of cos (6e-8), which torch's
    and XLA's cos may differ by, is all that is left."""
    base = 1e-3
    lr, jlr = cosine_schedule(base, warmup, total), jcosine_schedule(base, warmup, total)
    for s in range(0, total + 3):
        want = float(jlr(jnp.int32(s)))
        assert float(lr(torch.tensor(s, dtype=torch.int32))) == pytest.approx(want, rel=1e-6, abs=1e-7 * base)
        assert float(lr(s)) == pytest.approx(want, rel=1e-6, abs=1e-7 * base)


def test_cosine_schedule_shape():
    lr = cosine_schedule(1e-3, 10, 100)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1e-3) < 1e-9
    assert float(lr(100)) < 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_global_norm_matches_jax_on_the_lm_tree(arch):
    """Port parameter names, summed in the JAX tree's order: 1e-6."""
    jcfg, params, cfg, model = _both_models(arch)
    want = float(jglobal_norm(params))
    got = global_norm(dict(model.named_parameters())).item()
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("ratio", [0.25, 0.05, 1.0])
def test_topk_compression_matches_jax(ratio):
    """Selection and residual equal to repro's (ties at the threshold kept:
    the inputs are rounded to a coarse grid so they occur)."""
    rng = np.random.default_rng(11)
    g = {k: np.round(v * 4) / 4 for k, v in _tree(rng, {"a": (40,), "b": (8, 9)}).items()}
    r = {k: np.round(v * 4) / 4 for k, v in _tree(rng, {"a": (40,), "b": (8, 9)}, 0.5).items()}
    jout, jres = jtopk({k: jnp.asarray(v) for k, v in g.items()},
                       {k: jnp.asarray(v) for k, v in r.items()}, None, ratio)
    res = {k: _t(v) for k, v in r.items()}
    out, res2 = topk_compress_allreduce({k: _t(v) for k, v in g.items()}, res, None, ratio)
    assert res2 is res
    for k in g:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
        np.testing.assert_array_equal(res[k].numpy(), np.asarray(jres[k]))


@settings(deadline=None, max_examples=25)
@given(st.integers(1, 300), st.floats(0.01, 1.0), st.integers(0, 2**31 - 1))
def test_topk_selection_property(n, ratio, seed):
    """Any size, ratio and data: equal to repro's selection and residual."""
    rng = np.random.default_rng(seed)
    g = np.round(rng.normal(size=n) * 3).astype(np.float32)
    jout, jres = jtopk({"w": jnp.asarray(g)}, {"w": jnp.zeros(n, jnp.float32)}, None, ratio)
    out, res = topk_compress_allreduce({"w": _t(g)}, {"w": torch.zeros(n)}, None, ratio)
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(jout["w"]))
    np.testing.assert_array_equal(res["w"].numpy(), np.asarray(jres["w"]))


def test_topk_compression_error_feedback_recovers_sum():
    """Over many steps, compressed updates + residual = exact sum (mirror)."""
    rng = np.random.default_rng(5)
    gsum = np.zeros(64, np.float32)
    csum = np.zeros(64, np.float32)
    residual = {"w": torch.zeros(64)}
    for _ in range(60):
        g = rng.normal(size=64).astype(np.float32)
        gsum += g
        out, residual = topk_compress_allreduce({"w": _t(g)}, residual, None, ratio=0.25)
        csum += out["w"].numpy()
    np.testing.assert_allclose(csum + residual["w"].numpy(), gsum, rtol=1e-4)


def test_topk_compression_refuses_a_reduction_group():
    """A reduction group needs a process group (tests/test_torch_tp_train.py
    runs the group path over ranks against JAX's ``axis_name`` path)."""
    with pytest.raises(ValueError, match="initialised process group"):
        topk_compress_allreduce({"w": torch.ones(3)}, {"w": torch.zeros(3)}, "data")


# ----------------------------------------------------------------------------
# One train step against the JAX package's
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [0.0, 0.1])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, compress):
    """From the same params, moments (a JAX state after one step, carried by
    convert.opt_state_from_numpy) and residual: one port step (make_step)
    against repro's value_and_grad + topk + adamw_update. Loss within 1e-5;
    each param within 1e-4 (1 % of lr, the size of an update) and each
    leaf's update (params after − before) within 1e-2 relative norm: an
    element's update is lr·m̂/(√v̂+ε), whose relative error is its
    gradient's, and an element whose gradient is near zero in both steps
    has a large one (the gradients agree within 1e-4 relative norm per
    leaf, 2e-6 in practice; the update of the same gradients within 1e-6,
    test_adamw_update_matches_jax). Moments and residual within 1e-4
    relative norm, the gradients' own tolerance."""
    jcfg, params, cfg, model = _both_models(arch, seed=3)
    toks = [_tokens(cfg, 2, 17, s) for s in (10, 11)]
    lr_fn = cosine_schedule(1e-2, 1, 10)
    jlr = jcosine_schedule(1e-2, 1, 10)
    vg = jax.value_and_grad(partial(jlm.loss_fn, cfg=jcfg), has_aux=True)

    # A first JAX step gives non-zero moments and residual to start from.
    (_, _), g0 = vg(params, batch={"tokens": jnp.asarray(toks[0])})
    res0 = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    if compress:
        g0, res0 = jtopk(g0, res0, None, compress)
    jst = jadamw_init(params)
    params, jst = jadamw_update(g0, jst, params, jlr(jst["step"]))

    start = _np_tree(params)
    model = convert.lm_params_from_numpy(start, cfg, device="cpu")
    model.requires_grad_(True)
    names = dict(model.named_parameters())
    state = dict(
        params=names,
        opt=convert.opt_state_from_numpy(_np_tree(jst), model, cfg),
        residual={n: _t(a) for n, a in convert._per_param(_np_tree(res0), model, cfg,
                                                          "residual").items()},
    )
    step = train.make_step(model, cfg, lr_fn, compress)
    state, metrics = step(state, {"tokens": _t(toks[1])})

    (jloss, _), g1 = vg(params, batch={"tokens": jnp.asarray(toks[1])})
    if compress:
        g1, res0 = jtopk(g1, res0, None, compress)
    params, jst = jadamw_update(g1, jst, params, jlr(jst["step"]))
    np.testing.assert_allclose(metrics["loss"], float(jloss), rtol=1e-5, atol=1e-5)
    assert metrics["attn_backward_calls"] == cfg.n_layers and metrics["flash_launches"] == 0
    got_p = convert.lm_params_to_numpy(model)
    got_o = convert.opt_state_to_numpy(state["opt"])
    for key, want in _leaf_items(_np_tree(params)):
        got, before = _get(got_p, key), _get(start, key)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=key)
        assert _rel(got - before, want - before) <= 1e-2, (key, _rel(got - before, want - before))
    for k in ("m", "v"):
        for key, want in _leaf_items(_np_tree(jst[k])):
            got = _get(got_o[k], key)
            assert _rel(got, want) <= 1e-4, (k, key, _rel(got, want))
    assert int(got_o["step"]) == int(jst["step"]) == 2
    if compress:
        res = convert.lm_params_to_numpy(state["residual"])
        for key, want in _leaf_items(_np_tree(res0)):
            assert _rel(_get(res, key), want) <= 1e-4, key


def test_state_conversions_round_trip():
    jcfg, params, cfg, model = _both_models("qwen1.5-0.5b")
    back = convert.lm_params_to_numpy(model)
    for key, want in _leaf_items(_np_tree(params)):
        np.testing.assert_array_equal(_get(back, key), want)
    rng = np.random.default_rng(0)
    jst = dict(m=jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params),
               v=jax.tree.map(lambda a: rng.random(size=a.shape).astype(np.float32), params),
               step=np.int32(7))
    opt = convert.opt_state_from_numpy(_np_tree(jst), model, cfg)
    assert set(opt["m"]) == {n for n, _ in model.named_parameters()}
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 7
    back = convert.opt_state_to_numpy(opt)
    for k in ("m", "v"):
        for key, want in _leaf_items(_np_tree(jst[k])):
            np.testing.assert_array_equal(_get(back[k], key), want)


# ----------------------------------------------------------------------------
# The launcher (mirrors of tests/test_system.py's train-CLI tests)
# ----------------------------------------------------------------------------

def test_train_cli_loss_decreases(tmp_path):
    info = {}
    losses = train.main([
        "--arch", "qwen1.5-0.5b", "--reduced", "--steps", "25",
        "--batch", "8", "--seq", "32", "--lr", "1e-2",
        "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu",
    ], info=info)
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert info["losses"] == losses and len(info["step_s"]) == 25
    assert info["attn_backward_calls"] == [4] * 25 and info["flash_launches"] == [0] * 25
    assert all(finite and nonzero for finite, nonzero in info["grad_flags"].values())
    assert info["peak_bytes"] is None and info["tokens_per_step"] == 8 * 32


def test_train_cli_resume_continues(tmp_path):
    train.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "10",
                "--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
                "--ckpt-every", "5", "--device", "cpu"])
    losses = train.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "5",
                         "--batch", "4", "--seq", "16",
                         "--ckpt-dir", str(tmp_path / "ck"), "--resume", "--device", "cpu"])
    assert len(losses) == 5


def test_resume_from_a_checkpoint_is_bit_exact(tmp_path):
    """Six steps in one run, against three steps, a checkpoint, a fresh state
    restored from it and three more: the same losses and final params, bit
    for bit (one thread: the same kernels in the same order). Params,
    moments, step and residual all resume."""
    cfg = get_config("llama3.2-3b").reduced()
    lr_fn = cosine_schedule(1e-2, 1, 6)
    data = train.SyntheticTokens(cfg, train.ShapeConfig("t", 16, 2, "train"), seed=0)

    def run(state, step, lo, hi):
        return [step(state, {"tokens": _t(data.batch_at(i)["tokens"])})[1]["loss"]
                for i in range(lo, hi)]

    model, state = train.build_state(cfg, "cpu", seed=0)
    whole = run(state, train.make_step(model, cfg, lr_fn, 0.1), 0, 6)
    model_a, state_a = train.build_state(cfg, "cpu", seed=0)
    first = run(state_a, train.make_step(model_a, cfg, lr_fn, 0.1), 0, 3)
    ckpt = train.CheckpointManager(str(tmp_path), keep=1)
    ckpt.save(3, state_a)
    model_b, state_b = train.build_state(cfg, "cpu", seed=1)  # other weights, overwritten
    _, manifest = ckpt.restore(state_b)
    assert manifest["step"] == 3 and int(state_b["opt"]["step"]) == 3
    rest = run(state_b, train.make_step(model_b, cfg, lr_fn, 0.1), 3, 6)
    assert first + rest == whole
    for (n, p), q in zip(model.named_parameters(), model_b.parameters()):
        assert torch.equal(p, q), n


def test_train_cli_grad_compression_works(tmp_path):
    losses = train.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "15",
                         "--batch", "8", "--seq", "32", "--lr", "1e-2",
                         "--grad-compress", "0.1", "--device", "cpu"])
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_train_cli_injected_failure_retries(tmp_path, capsys):
    losses = train.main(["--arch", "llama3.2-3b", "--reduced", "--steps", "4", "--batch", "2",
                         "--seq", "8", "--inject-failure-at", "2", "--device", "cpu"])
    assert len(losses) == 4
    assert "retries=1 restores=0" in capsys.readouterr().out


def test_train_cli_refuses_tp_and_a_missing_card(monkeypatch):
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", "qwen1.5-0.5b", "--reduced", "--tp", "2", "--device", "cpu"])
    assert e.value.code == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        train.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "1"])
