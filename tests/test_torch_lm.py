"""The port's dense LM against the JAX package, on the CPU.

The layers (``rms_norm``, ``rope``, ``mlp``, ``attention`` in prefill,
decode and cache-less form) are held against ``repro.models.layers`` on the
same numpy inputs at 1e-5 (fp32). The whole model is built from the JAX
``init_params`` weights carried across with
``repro_torch.convert.lm_params_from_numpy`` at ``reduced()`` of three dense
configs (llama3.2-3b: GQA, tied embeddings; qwen1.5-0.5b: QKV bias;
phi3-mini-3.8b: untied head), and its ``forward_cached`` prefill + two
decode steps are held against JAX ``lm.forward_cached`` — logits and the
cache contents at 2e-3 — and a greedy loop must give equal tokens. The
port's attention prefill runs the plain version of ``flash_attention``
here; the JAX package's runs its XLA blocked softmax.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import lm

torch.set_num_threads(1)

DENSE = ["llama3.2-3b", "qwen1.5-0.5b", "phi3-mini-3.8b"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _attn_params(rng, d, h, kv, dh, bias):
    p = dict(
        wq=rng.normal(size=(d, h * dh)) * d**-0.5,
        wk=rng.normal(size=(d, kv * dh)) * d**-0.5,
        wv=rng.normal(size=(d, kv * dh)) * d**-0.5,
        wo=rng.normal(size=(h * dh, d)) * (h * dh) ** -0.5,
    )
    if bias:
        p.update(bq=rng.normal(size=(h * dh,)) * 0.1, bk=rng.normal(size=(kv * dh,)) * 0.1,
                 bv=rng.normal(size=(kv * dh,)) * 0.1)
    return {k: v.astype(np.float32) for k, v in p.items()}


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 128)).astype(np.float32) * 3
    g = rng.normal(size=(128,)).astype(np.float32)
    want = np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(g)))
    got = L.rms_norm(_t(x), _t(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("theta,start", [(1e4, 0), (5e5, 37)])
def test_rope_matches_jax(theta, start):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) + start
    want = np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = L.rope(_t(x), _t(pos), theta).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mlp_matches_jax():
    rng = np.random.default_rng(2)
    p = {k: (rng.normal(size=s) * s[0] ** -0.5).astype(np.float32)
         for k, s in (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    x = rng.normal(size=(3, 4, 64)).astype(np.float32)
    want = np.asarray(JL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = L.mlp({k: _t(v) for k, v in p.items()}, _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,kv,bias", [(4, 2, False), (6, 2, True), (4, 4, False)])
def test_attention_prefill_then_decode_matches_jax(h, kv, bias):
    """Prefill from 0 into a cache (T = 9), then one decode token at
    position 9: outputs and the written cache at 1e-5."""
    rng = np.random.default_rng(h * 10 + kv)
    d, dh, b, t, s = 64, 32, 2, 9, 16
    p = _attn_params(rng, d, h, kv, dh, bias)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    x1 = rng.normal(size=(b, 1, d)).astype(np.float32)
    kw = dict(h=h, kv=kv, dh=dh, rope_theta=1e4)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    zeros = np.zeros((b, kv, s, dh), np.float32)

    jout, jcache = JL.attention(jp, jnp.asarray(x), cache=(jnp.asarray(zeros),) * 2,
                                cache_pos=jnp.int32(0), **kw)
    cache = (_t(zeros.copy()), _t(zeros.copy()))
    out, cache2 = L.attention(tp, _t(x), cache=cache, cache_pos=0, **kw)
    assert cache2[0] is cache[0]  # written in place
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for a, w in zip(cache, jcache):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)

    jout, jcache = JL.attention(jp, jnp.asarray(x1), cache=jcache, cache_pos=jnp.int32(t), **kw)
    out, _ = L.attention(tp, _t(x1), cache=cache, cache_pos=t, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for a, w in zip(cache, jcache):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["causal", "non-causal", "cross"])
def test_attention_without_cache_matches_jax(mode):
    """The cache-less branch (training, encoder, cross-attention calls)."""
    rng = np.random.default_rng(5)
    d, h, kv, dh, t = 64, 4, 2, 32, 128
    p = _attn_params(rng, d, h, kv, dh, False)
    x = rng.normal(size=(2, t, d)).astype(np.float32)
    kw = dict(h=h, kv=kv, dh=dh, rope_theta=1e4, causal=mode == "causal")
    jkw, tkw = dict(kw), dict(kw)
    if mode == "cross":
        ek, ev = (rng.normal(size=(2, kv, 256, dh)).astype(np.float32) for _ in range(2))
        jkw.update(rope_theta=None, xattn_kv=(jnp.asarray(ek), jnp.asarray(ev)))
        tkw.update(rope_theta=None, xattn_kv=(_t(ek), _t(ev)))
    jout, _ = JL.attention({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), **jkw)
    out, cache = L.attention({k: _t(v) for k, v in p.items()}, _t(x), **tkw)
    assert cache is None
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)


def _both_models(arch, seed=0):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    assert cfg == type(cfg)(**{f: getattr(jcfg, f) for f in cfg.__dataclass_fields__})
    params = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    model = convert.lm_params_from_numpy(_np_tree(params), cfg, device="cpu")
    return jcfg, params, cfg, model


def _prompts(cfg, b, t, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_cached_matches_jax(arch):
    jcfg, params, cfg, model = _both_models(arch)
    b, t, s = 2, 11, 16
    prompts = _prompts(cfg, b, t, 3)
    jcache = jlm.init_cache(jcfg, b, s)
    cache = convert.cache_from_numpy(_np_tree(jcache), device="cpu")
    ops.reset_launch_counts()

    jlog, jcache = jlm.forward_cached(params, jcfg, jcache, jnp.asarray(prompts), jnp.int32(0))
    logits, cache = lm.forward_cached(model, cfg, cache, _t(prompts), 0)
    steps = [(np.asarray(jlog), logits)]
    tok = np.asarray(jnp.argmax(jlog[:, -1:], axis=-1)).astype(np.int32)
    for i in range(2):
        jlog, jcache = jlm.forward_cached(params, jcfg, jcache, jnp.asarray(tok), jnp.int32(t + i))
        logits, cache = lm.forward_cached(model, cfg, cache, _t(tok), t + i)
        steps.append((np.asarray(jlog), logits))
        tok = np.asarray(jnp.argmax(jlog[:, -1:], axis=-1)).astype(np.int32)

    for want, got in steps:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    want_cache = _np_tree(jcache)["kv"]
    for a, w in zip(convert.cache_to_numpy(cache)["kv"], want_cache):
        np.testing.assert_allclose(a, w, rtol=2e-3, atol=2e-3)
    # CPU tensors take the plain version: no kernel launched.
    assert ops.launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_tokens_equal_jax(arch):
    jcfg, params, cfg, model = _both_models(arch, seed=1)
    b, t, n = 2, 8, 6
    prompts = _prompts(cfg, b, t, 4)
    jcache = jlm.init_cache(jcfg, b, t + n)
    cache = lm.init_cache(cfg, b, t + n, device="cpu")
    decode = jax.jit(lambda p, c, tok, pos: jlm.forward_cached(p, jcfg, c, tok, pos))

    jlog, jcache = jlm.forward_cached(params, jcfg, jcache, jnp.asarray(prompts), jnp.int32(0))
    logits, cache = lm.forward_cached(model, cfg, cache, _t(prompts), 0)
    jtok = jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    jouts, outs = [np.asarray(jtok)], [tok.numpy()]
    for i in range(n - 1):
        jlog, jcache = decode(params, jcache, jtok, jnp.int32(t + i))
        logits, cache = lm.forward_cached(model, cfg, cache, tok, t + i)
        jtok = jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        jouts.append(np.asarray(jtok))
        outs.append(tok.numpy())
    np.testing.assert_array_equal(np.concatenate(outs, 1), np.concatenate(jouts, 1))


def test_init_params_layout_and_distributions():
    cfg = get_config("qwen1.5-0.5b").reduced()
    model = lm.init_params(cfg, torch.Generator().manual_seed(0))
    jparams = jax.eval_shape(lambda: jlm.init_params(
        jax_get_config("qwen1.5-0.5b").reduced(), jax.random.PRNGKey(0)))
    names = {n for n, _ in model.named_parameters()}
    assert "head" in names and not cfg.tie_embeddings
    blk = model.blocks[0]
    for k, v in jparams["blocks"]["attn"].items():
        assert tuple(blk.attn[k].shape) == v.shape[1:], k
    assert float(model.embed.std()) == pytest.approx(0.02, rel=0.05)
    assert float(blk.attn["wq"].std()) == pytest.approx(cfg.d_model**-0.5, rel=0.05)
    assert float(blk.mlp["w_down"].std()) == pytest.approx(cfg.d_ff**-0.5, rel=0.05)
    assert torch.equal(blk.ln1, torch.ones(cfg.d_model)) and not blk.attn["bq"].any()
    tied = lm.init_params(get_config("llama3.2-3b").reduced(), torch.Generator().manual_seed(0))
    assert not hasattr(tied, "head")


def test_padded_heads_have_zero_wo_rows():
    cfg = get_config("llama3.2-3b").reduced()  # 4 heads: tp=3 pads them to 6
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), tp=3)
    assert model.dims.policy == "pad" and model.dims.h == 6
    wo = model.blocks[0].attn["wo"]
    assert not wo[cfg.n_heads * cfg.d_head:].any() and wo[: cfg.n_heads * cfg.d_head].any()


def test_conversion_rejects_wrong_leaves():
    jcfg = jax_get_config("llama3.2-3b").reduced()
    cfg = get_config("llama3.2-3b").reduced()
    params = _np_tree(jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    params["head"] = np.zeros((cfg.d_model, cfg.vocab), np.float32)
    with pytest.raises(KeyError, match="unexpected.*head"):
        convert.lm_params_from_numpy(params, cfg, device="cpu")
    del params["head"]
    params["blocks"]["mlp"]["w_up"] = params["blocks"]["mlp"]["w_up"][:, :, :7]
    with pytest.raises(ValueError, match="w_up"):
        convert.lm_params_from_numpy(params, cfg, device="cpu")


def test_bf16_leaves_carry_exactly():
    jcfg = jax_get_config("llama3.2-3b")
    jcfg = type(jcfg)(**{**jcfg.reduced().__dict__, "dtype": "bfloat16"})
    cfg = type(get_config("llama3.2-3b"))(**jcfg.__dict__)
    params = _np_tree(jlm.init_params(jcfg, jax.random.PRNGKey(0)))
    model = convert.lm_params_from_numpy(params, cfg, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(model.embed.float().numpy(),
                                  params["embed"].astype(np.float32))
    cache = _np_tree(jlm.init_cache(jcfg, 1, 4))
    cache["kv"] = (params["blocks"]["attn"]["wq"][:, None, None, :2, :64],) * 2
    back = convert.cache_to_numpy(convert.cache_from_numpy(cache, device="cpu"))
    np.testing.assert_array_equal(back["kv"][0], cache["kv"][0].astype(np.float32))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "rwkv6-7b", "zamba2-7b",
                                  "whisper-tiny", "internvl2-26b"])
def test_other_families_raise_naming_their_roadmap_item(arch):
    """Every family is ported, serving and training (no ROADMAP.md item is
    left to name): ``LM`` and ``init_cache`` build, ``forward_train`` gives
    finite logits of the right shape and ``loss_fn`` two finite losses
    (tests/test_torch_train_families.py holds them to JAX)."""
    cfg = get_config(arch).reduced()
    model = lm.init_params(cfg, torch.Generator().manual_seed(0))
    assert lm.init_cache(cfg, 1, 4, device="cpu")
    rng = np.random.default_rng(0)

    def batch(t):
        out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (1, t)).astype(np.int32))}
        if cfg.family == "encdec":
            out["frames"] = torch.from_numpy(rng.normal(size=(1, 3, cfg.d_model)).astype(np.float32))
        if cfg.family == "vlm":
            out["patches"] = torch.from_numpy(
                rng.normal(size=(1, cfg.vlm_patches, cfg.d_model)).astype(np.float32))
        return out

    with torch.no_grad():
        logits, aux = lm.forward_train(model, cfg, batch(5))
        losses = [lm.loss_fn(model, cfg, batch(6))[0].item() for _ in range(2)]
    assert logits.shape == (1, 5, cfg.vocab) and torch.isfinite(logits).all()
    assert torch.isfinite(aux) and np.isfinite(losses).all()


def test_serve_cli_generates_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    info = {}
    gen = main(["--arch", "qwen1.5-0.5b", "--reduced", "--batch", "2",
                "--prompt-len", "8", "--gen", "6", "--device", "cpu"], info=info)
    assert gen.shape == (2, 6) and gen.dtype == np.int32
    assert (gen >= 0).all() and (gen < get_config("qwen1.5-0.5b").reduced().vocab).all()
    out = capsys.readouterr().out
    assert out.startswith("generated: ") and "prefill 2x8 in" in out and "decode 10 tok" in out
    assert info["logits_finite"] and info["decode_tokens"] == 10
    assert info["prefill_launches"]["flash_attention"] == 0 and info["peak_bytes"] is None


def test_serve_cli_refuses_tensor_parallel():
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit) as exc:
        main(["--arch", "llama3.2-3b", "--reduced", "--tp", "2", "--device", "cpu"])
    assert exc.value.code == 2
