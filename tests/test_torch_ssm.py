"""The port's SSM mixers (``repro_torch.models.ssm``) against
``repro.models.ssm`` on the CPU, in fp32, on the same numpy inputs.

RWKV-6's time mix and channel mix and Mamba-2's mixer, each from a
non-zero state and token-shift carry and from none, at lengths that end
inside a chunk, fill whole chunks, cross chunk boundaries and decode one
token (T = 1, padded to one chunk as in the JAX package): output, final
state and carry within 1e-5 of the tensor's scale (the chunked scans
multiply by exp(±Σ log w) over a chunk; see tests/test_torch_families.py).
Their gradients (training runs them under autograd) are held to ``jax.grad``
of the same functions across chunk boundaries, within 2e-5 of each
gradient's scale (``GRAD_TOL``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.models import ssm as S

torch.set_num_threads(1)

TOL = 1e-5
D, H, DH, FF = 64, 4, 16, 96


def _close(got, want, what=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale, err_msg=what)


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _rwkv_params(rng):
    p = dict(
        mu=rng.random((5, D)).astype(np.float32),
        w0=(-0.6 + _rand(rng, (D,), 0.3)),
        w_a=_rand(rng, (D, S.RWKV_LORA), 0.05),
        w_b=_rand(rng, (S.RWKV_LORA, D), 0.05),
        u=_rand(rng, (H, DH), 0.5),
        ln_x=1 + _rand(rng, (D,), 0.1),
    )
    for k in ("wr", "wk", "wv", "wg", "wo"):
        p[k] = _rand(rng, (D, D), D**-0.5)
    return p


@pytest.mark.parametrize("t", [1, 31, 32, 45, 100])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_mixer_matches_jax(t, with_state):
    rng = np.random.default_rng(t + 100 * with_state)
    p = _rwkv_params(rng)
    x = _rand(rng, (2, t, D))
    state = _rand(rng, (2, H, DH, DH), 0.5) if with_state else None
    last = _rand(rng, (2, D)) if with_state else None
    kw = dict(n_heads=H, dh=DH)
    want = JS.rwkv6_mixer({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x),
                          state=None if state is None else jnp.asarray(state),
                          last_x=None if last is None else jnp.asarray(last), **kw)
    got = S.rwkv6_mixer({k: torch.from_numpy(a) for k, a in p.items()}, torch.from_numpy(x),
                        state=None if state is None else torch.from_numpy(state),
                        last_x=None if last is None else torch.from_numpy(last), **kw)
    for g, w, what in zip(got, want, ("out", "state", "last_x")):
        _close(g, w, what)


@pytest.mark.parametrize("t", [1, 7, 40])
@pytest.mark.parametrize("with_last", [False, True])
def test_rwkv6_channel_mix_matches_jax(t, with_last):
    rng = np.random.default_rng(t + 7 * with_last)
    p = dict(mu=rng.random((2, D)).astype(np.float32), wk=_rand(rng, (D, FF), D**-0.5),
             wv=_rand(rng, (FF, D), FF**-0.5), wr=_rand(rng, (D, D), D**-0.5))
    x = _rand(rng, (3, t, D))
    last = _rand(rng, (3, D)) if with_last else None
    want = JS.rwkv6_channel_mix({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x),
                                last_x=None if last is None else jnp.asarray(last))
    got = S.rwkv6_channel_mix({k: torch.from_numpy(a) for k, a in p.items()},
                              torch.from_numpy(x),
                              last_x=None if last is None else torch.from_numpy(last))
    for g, w, what in zip(got, want, ("out", "last_x")):
        _close(g, w, what)


def _mamba_params(rng, n_state):
    d_in = 2 * D
    return dict(
        w_z=_rand(rng, (D, d_in), D**-0.5), w_x=_rand(rng, (D, d_in), D**-0.5),
        w_B=_rand(rng, (D, n_state), D**-0.5), w_C=_rand(rng, (D, n_state), D**-0.5),
        w_dt=_rand(rng, (D, H), D**-0.5), a_log=_rand(rng, (H,), 0.3),
        dt_bias=-2 + _rand(rng, (H,), 0.5), d_skip=1 + _rand(rng, (H,), 0.2),
        norm=1 + _rand(rng, (d_in,), 0.1), w_out=_rand(rng, (d_in, D), d_in**-0.5),
    )


@pytest.mark.parametrize("t", [1, 63, 64, 70, 150])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_mixer_matches_jax(t, with_state):
    rng = np.random.default_rng(t + 1000 * with_state)
    n_state = 16
    p = _mamba_params(rng, n_state)
    x = _rand(rng, (2, t, D))
    state = _rand(rng, (2, H, n_state, 2 * D // H), 0.5) if with_state else None
    kw = dict(n_heads=H, d_state=n_state)
    want = JS.mamba2_mixer({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x),
                           state=None if state is None else jnp.asarray(state), **kw)
    got = S.mamba2_mixer({k: torch.from_numpy(a) for k, a in p.items()}, torch.from_numpy(x),
                         state=None if state is None else torch.from_numpy(state), **kw)
    for g, w, what in zip(got, want, ("out", "state")):
        _close(g, w, what)


def test_decode_continues_a_prefill():
    """Prefill T tokens, then decode one: the state carried through equals
    one call over T + 1 tokens (both mixers, the port alone)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_rand(rng, (2, 41, D)))
    p = {k: torch.from_numpy(a) for k, a in _rwkv_params(rng).items()}
    kw = dict(n_heads=H, dh=DH)
    whole, s_all, _ = S.rwkv6_mixer(p, x, **kw)
    head, s0, last = S.rwkv6_mixer(p, x[:, :40], **kw)
    tail, s1, _ = S.rwkv6_mixer(p, x[:, 40:], state=s0, last_x=last, **kw)
    torch.testing.assert_close(torch.cat([head, tail], 1), whole, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s1, s_all, rtol=1e-5, atol=1e-5)
    m = {k: torch.from_numpy(a) for k, a in _mamba_params(rng, 8).items()}
    kw = dict(n_heads=H, d_state=8)
    whole, s_all = S.mamba2_mixer(m, x, **kw)
    head, s0 = S.mamba2_mixer(m, x[:, :40], **kw)
    tail, s1 = S.mamba2_mixer(m, x[:, 40:], state=s0, **kw)
    torch.testing.assert_close(torch.cat([head, tail], 1), whole, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s1, s_all, rtol=1e-5, atol=1e-5)


def test_init_leaves_follow_jax():
    """Shapes, dtypes (fp32 leaves in a bf16 mixer) and the constant leaves
    of both mixers' inits."""
    import jax

    gen = torch.Generator().manual_seed(0)
    for ours, theirs in (
        (S.init_rwkv6(gen, D, H, DH, torch.bfloat16),
         JS.init_rwkv6(jax.random.PRNGKey(0), D, H, DH, jnp.bfloat16)),
        (S.init_rwkv6_cm(gen, D, FF, torch.bfloat16),
         JS.init_rwkv6_cm(jax.random.PRNGKey(0), D, FF, jnp.bfloat16)),
        (S.init_mamba2(gen, D, H, 16, torch.bfloat16),
         JS.init_mamba2(jax.random.PRNGKey(0), D, H, 16, jnp.bfloat16)),
    ):
        assert set(ours) == set(theirs)
        for k, w in theirs.items():
            assert tuple(ours[k].shape) == w.shape, k
            assert str(ours[k].dtype).split(".")[1] == str(w.dtype), k
            if float(jnp.std(w.astype(jnp.float32))) == 0:  # a constant leaf
                np.testing.assert_array_equal(ours[k].float().numpy(),
                                              np.asarray(w, np.float32), err_msg=k)


# ----------------------------------------------------------------------------
# Gradients (training runs the mixers under autograd)
# ----------------------------------------------------------------------------

# Gradients of both mixers within 2e-5 of each gradient's largest element:
# measured at most 3.5e-6 (Mamba-2's a_log; the chunked scans' exp(±Σ log w)
# products, as in the forward, summed again by the backward), and the
# forward's own tolerance is 1e-5 of the scale.
GRAD_TOL = 2e-5


def _grads_match_jax(jax_fn, torch_fn, p, x, extra):
    """The gradients of the scalar ``fn(params, x, extra)`` with respect to
    every parameter, x and every entry of ``extra`` (an incoming state or
    carry), by ``jax.grad`` and by torch autograd, each within GRAD_TOL of
    its largest element."""
    want = jax.grad(jax_fn, argnums=(0, 1, 2))(
        {k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x),
        {k: jnp.asarray(a) for k, a in extra.items()})
    tp, te = ({k: torch.from_numpy(a).requires_grad_(True) for k, a in d.items()} for d in (p, extra))
    tx = torch.from_numpy(x).requires_grad_(True)
    torch_fn(tp, tx, te).backward()
    got = {**{k: v.grad for k, v in tp.items()}, "x": tx.grad,
           **{f"in_{k}": v.grad for k, v in te.items()}}
    want = {**want[0], "x": want[1], **{f"in_{k}": v for k, v in want[2].items()}}
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        assert g.shape == w.shape, k
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (k, err)


@pytest.mark.parametrize("t", [45, 100])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_mixer_grads_match_jax(t, with_state):
    """The gradient of Σ out·d_out + Σ state·d_state with respect to x, every
    parameter and the incoming state and carry, against ``jax.grad`` of
    ``repro.models.ssm.rwkv6_mixer``, across 32-token chunk boundaries (a
    ragged last chunk at T = 45 and 100)."""
    rng = np.random.default_rng(t + 10 * with_state)
    p = _rwkv_params(rng)
    x = _rand(rng, (2, t, D))
    extra = dict(state=_rand(rng, (2, H, DH, DH), 0.5), last_x=_rand(rng, (2, D))) if with_state else {}
    d_out, d_state = _rand(rng, (2, t, D)), _rand(rng, (2, H, DH, DH))
    kw = dict(n_heads=H, dh=DH)

    def jax_fn(p_, x_, extra_):
        out, s, _ = JS.rwkv6_mixer(p_, x_, **extra_, **kw)
        return jnp.sum(out * d_out) + jnp.sum(s * d_state)

    def torch_fn(p_, x_, extra_):
        out, s, _ = S.rwkv6_mixer(p_, x_, **extra_, **kw)
        return torch.sum(out * torch.from_numpy(d_out)) + torch.sum(s * torch.from_numpy(d_state))

    _grads_match_jax(jax_fn, torch_fn, p, x, extra)


@pytest.mark.parametrize("t", [70, 150])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_mixer_grads_match_jax(t, with_state):
    """As above for ``mamba2_mixer``, across 64-token chunk boundaries."""
    rng = np.random.default_rng(t + 10 * with_state + 1)
    n_state = 16
    p = _mamba_params(rng, n_state)
    x = _rand(rng, (2, t, D))
    sshape = (2, H, n_state, 2 * D // H)
    extra = dict(state=_rand(rng, sshape, 0.5)) if with_state else {}
    d_out, d_state = _rand(rng, (2, t, D)), _rand(rng, sshape)
    kw = dict(n_heads=H, d_state=n_state)

    def jax_fn(p_, x_, extra_):
        out, s = JS.mamba2_mixer(p_, x_, **extra_, **kw)
        return jnp.sum(out * d_out) + jnp.sum(s * d_state)

    def torch_fn(p_, x_, extra_):
        out, s = S.mamba2_mixer(p_, x_, **extra_, **kw)
        return torch.sum(out * torch.from_numpy(d_out)) + torch.sum(s * torch.from_numpy(d_state))

    _grads_match_jax(jax_fn, torch_fn, p, x, extra)


@pytest.mark.parametrize("with_last", [False, True])
def test_rwkv6_channel_mix_grads_match_jax(with_last):
    rng = np.random.default_rng(21 + with_last)
    p = dict(mu=rng.random((2, D)).astype(np.float32), wk=_rand(rng, (D, FF), D**-0.5),
             wv=_rand(rng, (FF, D), FF**-0.5), wr=_rand(rng, (D, D), D**-0.5))
    x = _rand(rng, (2, 40, D))
    extra = dict(last_x=_rand(rng, (2, D))) if with_last else {}
    d_out = _rand(rng, (2, 40, D))

    def jax_fn(p_, x_, extra_):
        return jnp.sum(JS.rwkv6_channel_mix(p_, x_, **extra_)[0] * d_out)

    def torch_fn(p_, x_, extra_):
        return torch.sum(S.rwkv6_channel_mix(p_, x_, **extra_)[0] * torch.from_numpy(d_out))

    _grads_match_jax(jax_fn, torch_fn, p, x, extra)
