"""The port's LM families (moe, vlm, ssm, hybrid, encdec) against the JAX
package, on the CPU, in fp32.

Each family's ``reduced()`` model is built from the JAX ``init_params``
weights carried across with ``repro_torch.convert.lm_params_from_numpy``;
its ``forward_cached`` prefill (with whisper's frames, the vlm's patches)
and decode steps are held against JAX ``lm.forward_cached`` — logits and
every cache leaf within 1e-5 of the tensor's scale (|got − want| <= 1e-5 ·
max(1, max |want|) + 1e-5 · |want|), the greedy tokens equal. The scale
matters for the SSM families: their chunked scans multiply by exp(±Σ log w)
over a chunk, and an fp64 run of the same reduced models (prompt 37) puts
JAX's own fp32 logits 1.70e-5 (rwkv6) and 1.27e-5 (zamba2) from it, with
logits up to 4.15, so no fp32 implementation that rounds in another order
can meet an absolute 1e-5. The prompt (37 tokens) ends inside RWKV-6's second
32-token chunk and Mamba-2's first 64-token chunk, so the last chunk is
ragged; whisper's encoder runs over 18 frames, a Tk no tile divides. The
MoE FFN is held with drops and a router bias, the balance state against
``repro.core.moe_balance``; bf16 models keep their fp32 leaves through
``convert``, both ways. The SSM mixers alone are in
``tests/test_torch_ssm.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import moe_balance as jmb
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import moe_balance as mb
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.names import jax_leaf

torch.set_num_threads(1)

FAMILIES = ["granite-moe-1b-a400m", "grok-1-314b", "internvl2-26b", "rwkv6-7b", "zamba2-7b",
            "whisper-tiny"]
TOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _both_models(arch, seed=0, **changes):
    jcfg = jax_get_config(arch).reduced()
    if changes:
        jcfg = type(jcfg)(**{**jcfg.__dict__, **changes})
    cfg = type(get_config(arch))(**jcfg.__dict__)
    params = _np_tree(jlm.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, params, cfg, convert.lm_params_from_numpy(params, cfg, device="cpu")


def _extras(cfg, b, t, seed):
    """Whisper's frames and the vlm's patches, as the launcher draws them."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, max(t // 2, 1), cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.normal(size=(b, cfg.vlm_patches, cfg.d_model)).astype(np.float32)
    return out


def _assert_close(got, want, what):
    """Within TOL of the tensor's scale (see the module docstring)."""
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale, err_msg=what)


def _assert_tree_close(got, want, what):
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _assert_close(g, w, what)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_cached_matches_jax(arch):
    """Prefill + 3 decode steps: logits and the whole cache within 1e-5 of
    their scale, the greedy token of every step equal (JAX's token feeds
    both)."""
    jcfg, params, cfg, model = _both_models(arch)
    b, t, n_dec = 2, 37, 3
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (b, t)).astype(np.int32)
    extras = _extras(cfg, b, t, 4)
    jcache = jlm.init_cache(jcfg, b, t + n_dec + 1)
    cache = convert.cache_from_numpy(_np_tree(jcache), device="cpu")
    offset = cfg.vlm_patches if cfg.family == "vlm" else 0
    ops.reset_launch_counts()

    jlog, jcache = jlm.forward_cached(params, jcfg, jcache, jnp.asarray(prompts), jnp.int32(0),
                                      **{k: jnp.asarray(v) for k, v in extras.items()})
    logits, cache = lm.forward_cached(model, cfg, cache, _t(prompts), 0,
                                      **{k: _t(v) for k, v in extras.items()})
    steps = [(np.asarray(jlog), logits.numpy())]
    for i in range(n_dec):
        tok = np.asarray(jnp.argmax(jlog[:, -1:], axis=-1)).astype(np.int32)
        pos = offset + t + i
        jlog, jcache = jlm.forward_cached(params, jcfg, jcache, jnp.asarray(tok), jnp.int32(pos))
        logits, cache = lm.forward_cached(model, cfg, cache, _t(tok), pos)
        steps.append((np.asarray(jlog), logits.numpy()))

    assert steps[0][1].shape == (b, t, cfg.vocab)
    for i, (want, got) in enumerate(steps):
        _assert_close(got, want, f"step {i}")
        np.testing.assert_array_equal(got[:, -1].argmax(-1), want[:, -1].argmax(-1))
    _assert_tree_close(convert.cache_to_numpy(cache), _np_tree(jcache), arch)
    # CPU tensors take the plain version: no kernel launched.
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_tokens_equal_jax(arch):
    """A jitted JAX greedy loop and the port's, each on its own tokens."""
    jcfg, params, cfg, model = _both_models(arch, seed=1)
    b, t, n = 2, 9, 6
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (b, t)).astype(np.int32)
    extras = _extras(cfg, b, t, 6)
    offset = cfg.vlm_patches if cfg.family == "vlm" else 0
    jcache = jlm.init_cache(jcfg, b, t + n)
    cache = lm.init_cache(cfg, b, t + n, device="cpu")
    decode = jax.jit(lambda p, c, tok, pos: jlm.forward_cached(p, jcfg, c, tok, pos))

    jlog, jcache = jlm.forward_cached(params, jcfg, jcache, jnp.asarray(prompts), jnp.int32(0),
                                      **{k: jnp.asarray(v) for k, v in extras.items()})
    logits, cache = lm.forward_cached(model, cfg, cache, _t(prompts), 0,
                                      **{k: _t(v) for k, v in extras.items()})
    jtok = jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    jouts, outs = [np.asarray(jtok)], [tok.numpy()]
    for i in range(n - 1):
        jlog, jcache = decode(params, jcache, jtok, jnp.int32(offset + t + i))
        logits, cache = lm.forward_cached(model, cfg, cache, tok, offset + t + i)
        jtok = jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        jouts.append(np.asarray(jtok))
        outs.append(tok.numpy())
    np.testing.assert_array_equal(np.concatenate(outs, 1), np.concatenate(jouts, 1))


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_cache_matches_jax_layout(arch):
    cfg = get_config(arch).reduced()
    want = jax.eval_shape(lambda: jlm.init_cache(jax_get_config(arch).reduced(), 3, 10))
    got = lm.init_cache(cfg, 3, 10, device="cpu")
    assert jax.tree.structure(convert.cache_to_numpy(got)) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape and not g.any()
        assert str(g.dtype).split(".")[1] == str(w.dtype)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layout_dtypes_and_distributions(arch, dtype):
    """The port's own init: the JAX tree's leaves, each with the JAX shape
    and dtype (a bf16 model's fp32 leaves included), and the JAX
    distributions of a few leaves."""
    jcfg = jax_get_config(arch).reduced()
    jcfg = type(jcfg)(**{**jcfg.__dict__, "dtype": dtype})
    cfg = type(get_config(arch))(**jcfg.__dict__)
    model = lm.init_params(cfg, torch.Generator().manual_seed(0))
    want = convert._leaves(jax.eval_shape(lambda: jlm.init_params(jcfg, jax.random.PRNGKey(0))))
    seen = set()
    for name, p in model.named_parameters():
        key, layer = jax_leaf(name)
        seen.add(key)
        shape = want[key].shape[1:] if layer is not None else want[key].shape
        assert tuple(p.shape) == shape, name
        assert str(p.dtype).split(".")[1] == str(want[key].dtype), name
    assert seen == set(want)
    blk = model.blocks[0]
    if cfg.family == "ssm":
        assert float(blk.att["u"].std()) == pytest.approx(0.5, rel=0.3)
        assert torch.all(blk.att["w0"] == -0.6) and torch.all(blk.att["mu"] == 0.5)
    elif cfg.family == "hybrid":
        assert torch.all(blk.mamba["dt_bias"] == -2) and not blk.mamba["a_log"].any()
        assert model.shared.attn["wq"].shape == (cfg.d_model, cfg.n_heads * cfg.d_head)
    elif cfg.moe:
        e = cfg.moe.n_experts
        assert float(blk.moe["w_gate"].float().std()) == pytest.approx(e**-0.5, rel=0.1)
        assert float(blk.moe["w_down"].float().std()) == pytest.approx(cfg.d_ff**-0.5, rel=0.1)


def _moe_params(rng, d, f, e):
    return dict(
        router=(rng.normal(size=(d, e)) * d**-0.5).astype(np.float32),
        w_gate=(rng.normal(size=(e, d, f)) * e**-0.5).astype(np.float32),
        w_up=(rng.normal(size=(e, d, f)) * e**-0.5).astype(np.float32),
        w_down=(rng.normal(size=(e, f, d)) * f**-0.5).astype(np.float32),
    )


@pytest.mark.parametrize("cf,bias,k", [(0.5, False, 2), (0.5, True, 2), (8.0, True, 2),
                                       (1.25, False, 1), (0.25, True, 3)])
def test_moe_ffn_matches_jax(cf, bias, k):
    """Output, aux loss and loads against ``repro.models.layers.moe_ffn``,
    with drops (capacity factor below 1: some (token, slot) pairs overflow
    to the dump row) and with an ADWISE router bias."""
    rng = np.random.default_rng(int(cf * 100) + k)
    d, f, e = 32, 48, 4
    p = _moe_params(rng, d, f, e)
    x = rng.normal(size=(2, 13, d)).astype(np.float32)
    rb = rng.normal(size=(e,)).astype(np.float32) if bias else None
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf)
    want = JL.moe_ffn({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
                      router_bias=None if rb is None else jnp.asarray(rb), **kw)
    got = L.moe_ffn({n: _t(a) for n, a in p.items()}, _t(x),
                    router_bias=None if rb is None else _t(rb), **kw)
    for g, w, what in zip(got, want, ("out", "aux", "loads")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL, err_msg=what)
    cap = max(8, -(-int(cf * 26 * k / e) // 8) * 8)
    dropped = np.maximum(got[2].numpy() - cap, 0).sum()
    assert (dropped > 0) == (cf < 1), (dropped, cap)


def test_moe_top_k_ties_take_the_lower_expert():
    """A zero router makes every expert tie: ``lax.top_k`` takes the lowest
    indices, and so must the port (``torch.topk`` does not promise it)."""
    rng = np.random.default_rng(9)
    d, f, e = 16, 8, 8
    p = _moe_params(rng, d, f, e)
    p["router"][:] = 0
    x = rng.normal(size=(1, 20, d)).astype(np.float32)
    kw = dict(n_experts=e, top_k=3, capacity_factor=1.0)
    want = JL.moe_ffn({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), **kw)
    got = L.moe_ffn({n: _t(a) for n, a in p.items()}, _t(x), **kw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[2].numpy(), [20, 20, 20, 0, 0, 0, 0, 0])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=TOL, atol=TOL)


def test_moe_model_with_drops_matches_jax():
    """The reduced granite model at capacity factor 0.25 (``reduced()`` sets
    8.0, drop-free): prefill + 2 decode steps, logits and cache."""
    jcfg, params, cfg, model = _both_models("granite-moe-1b-a400m", seed=2)
    jcfg = type(jcfg)(**{**jcfg.__dict__, "moe": type(jcfg.moe)(4, 2, capacity_factor=0.25)})
    cfg = type(cfg)(**{**cfg.__dict__, "moe": type(cfg.moe)(4, 2, capacity_factor=0.25)})
    b, t = 2, 21
    prompts = np.random.default_rng(7).integers(0, cfg.vocab, (b, t)).astype(np.int32)
    jcache = jlm.init_cache(jcfg, b, t + 2)
    cache = lm.init_cache(cfg, b, t + 2, device="cpu")
    jlog, jcache = jlm.forward_cached(params, jcfg, jcache, jnp.asarray(prompts), jnp.int32(0))
    logits, cache = lm.forward_cached(model, cfg, cache, _t(prompts), 0)
    _assert_close(logits.numpy(), np.asarray(jlog), "prefill")
    for i in range(2):
        tok = np.asarray(jnp.argmax(jlog[:, -1:], axis=-1)).astype(np.int32)
        jlog, jcache = jlm.forward_cached(params, jcfg, jcache, jnp.asarray(tok), jnp.int32(t + i))
        logits, cache = lm.forward_cached(model, cfg, cache, _t(tok), t + i)
        _assert_close(logits.numpy(), np.asarray(jlog), f"decode {i}")
    _assert_tree_close(convert.cache_to_numpy(cache), _np_tree(jcache), "cache")
    # Every prefill layer drops: 2·21·2 = 84 (token, slot) pairs and 4
    # experts of max(8, ⌈int(0.25·84/4) / 8⌉·8) = 8 slots, 32 in all.


def test_moe_balance_matches_jax():
    """Five steps of router bias → update_loads, from zero loads, against
    ``repro.core.moe_balance``."""
    rng = np.random.default_rng(11)
    e = 6
    jst = jmb.init_moe_balance(e, lam_init=1.0)
    st = mb.init_moe_balance(e, lam_init=1.0, device="cpu")
    for step in range(5):
        counts = rng.integers(0, 50, e).astype(np.float32)
        progress = step / 4
        jbias, jst = jmb.adwise_router_bias(jst, jnp.float32(progress))
        bias, st = mb.adwise_router_bias(st, progress)
        np.testing.assert_allclose(bias.numpy(), np.asarray(jbias), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(st.lam.item(), float(jst.lam), rtol=1e-6)
        jst = jmb.update_loads(jst, jnp.asarray(counts))
        st = mb.update_loads(st, _t(counts))
        np.testing.assert_allclose(st.loads.numpy(), np.asarray(jst.loads), rtol=1e-6)
    assert st.loads.dtype == torch.float32 and st.lam.shape == ()


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-7b", "zamba2-7b"])
def test_bf16_models_keep_fp32_leaves_through_convert(arch):
    """JAX keeps some leaves fp32 in a bf16 model; the port keeps them fp32
    and unrounded from numpy (each set to values bf16 cannot hold), and
    gives them back bit for bit."""
    jcfg, params, cfg, _ = _both_models(arch, dtype="bfloat16")
    fp32 = {"granite-moe-1b-a400m": ["blocks.moe.router"],
            "rwkv6-7b": ["blocks.att.w0", "blocks.att.w_a", "blocks.att.w_b", "blocks.att.u",
                         "blocks.att.ln_x"],
            "zamba2-7b": ["blocks.mamba.a_log", "blocks.mamba.dt_bias", "blocks.mamba.d_skip",
                          "blocks.mamba.norm"]}[arch]
    rng = np.random.default_rng(0)
    flat = convert._leaves(params)
    for key in fp32:
        assert flat[key].dtype == np.float32
        flat[key] = (1 + rng.random(flat[key].shape) * 2**-10).astype(np.float32)
        assert not np.array_equal(flat[key].astype(jnp.bfloat16).astype(np.float32), flat[key])
    model = convert.lm_params_from_numpy(convert._nest(flat), cfg, device="cpu")
    named = dict(model.named_parameters())
    back = convert._leaves(convert.lm_params_to_numpy(model))
    for key in fp32:
        assert named[key.replace("blocks.", "blocks.0.", 1)].dtype == torch.float32
    assert named["embed"].dtype == torch.bfloat16
    assert set(back) == set(flat)
    for key, a in flat.items():
        np.testing.assert_array_equal(back[key], a.astype(np.float32), err_msg=key)
    # And the fp32 SSM states of a bf16 model's cache.
    jcache = _np_tree(jlm.init_cache(jcfg, 1, 4))
    for a, w in zip(jax.tree.leaves(convert.cache_from_numpy(jcache, device="cpu")),
                    jax.tree.leaves(jcache)):
        assert str(a.dtype).split(".")[1] == str(w.dtype)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-26b", "rwkv6-7b",
                                  "zamba2-7b", "whisper-tiny"])
def test_serve_cli_generates_on_the_cpu(arch, capsys):
    from repro_torch.launch.serve import main

    info = {}
    gen = main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "11",
                "--gen", "5", "--device", "cpu"], info=info)
    vocab = get_config(arch).reduced().vocab
    assert gen.shape == (2, 5) and gen.dtype == np.int32 and (gen >= 0).all() and (gen < vocab).all()
    out = capsys.readouterr().out
    assert out.startswith("generated: ") and "prefill 2x11 in" in out and "decode 8 tok" in out
    assert info["logits_finite"] and info["peak_bytes"] is None
    assert info["prefill_launches"]["flash_attention"] == 0
    assert sum(info["prefill_flash_bodies"].values()) == 0


@pytest.mark.parametrize("arch", ["internvl2-26b", "whisper-tiny"])
def test_serve_cli_draws_inputs_like_jax(arch, monkeypatch):
    """The launcher's prompts, then frames / patches, from one numpy
    generator in the JAX launcher's order, and the vlm's decode positions
    offset by its patches: the port's tokens equal a JAX greedy loop run
    on the same inputs and the port's weights."""
    from repro_torch.launch import serve

    cfg = get_config(arch).reduced()
    jcfg = jax_get_config(arch).reduced()
    b, t, n, seed = 2, 10, 4, 3
    models = []
    real = lm.init_params
    monkeypatch.setattr(lm, "init_params",
                        lambda *a, **k: models.append(real(*a, **k)) or models[-1])
    gen = serve.main(["--arch", arch, "--reduced", "--batch", str(b), "--prompt-len", str(t),
                      "--gen", str(n), "--seed", str(seed), "--device", "cpu"])
    params = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(models[0]))
    rng = np.random.default_rng(seed)
    prompts = jnp.asarray(rng.integers(0, cfg.vocab, (b, t)), jnp.int32)
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = jnp.asarray(rng.normal(size=(b, t // 2, cfg.d_model)), jnp.float32)
    if cfg.family == "vlm":
        kw["patches"] = jnp.asarray(rng.normal(size=(b, cfg.vlm_patches, cfg.d_model)),
                                    jnp.float32)
    offset = cfg.vlm_patches if cfg.family == "vlm" else 0
    cache = jlm.init_cache(jcfg, b, t + n)
    logits, cache = jlm.forward_cached(params, jcfg, cache, prompts, jnp.int32(0), **kw)
    toks = [jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)]
    for i in range(n - 1):
        logits, cache = jlm.forward_cached(params, jcfg, cache, toks[-1],
                                           jnp.int32(offset + t + i))
        toks.append(jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32))
    np.testing.assert_array_equal(gen, np.concatenate([np.asarray(x) for x in toks], 1))
