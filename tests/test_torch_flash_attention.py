"""The port's ``flash_attention`` op on the CPU against the JAX package.

On a CPU tensor ``repro_torch.kernels.ops.flash_attention`` runs its plain
torch version. It is held here against the JAX package's Pallas kernel in
interpret mode (``tier="interpret"``, the TPU kernel's own blocks and online
softmax, run on this CPU) and against its XLA reference (``tier="xla"``), on
the same numpy inputs: the six shapes of ``tests/test_kernels.py``, plus
Dh 96, Dh 112 (zamba2's head dim), a GQA group of 3 and a Tq that is not a
multiple of 128. Tolerances are the JAX kernel tests': 2e-3 in fp32, 5e-3
in fp16 (another summation and exponent order). Non-causal calls at a Tk
that no 128-row tile divides — whisper's encoder and cross-attention,
which the Pallas kernel refuses — are held against the function the JAX
LM computes there, ``repro.models.layers._blocked_softmax_attn``, at 1e-5. The CUDA kernel is held against the plain version on
the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(1)

SHAPES = [
    # b, hq, hkv, tq, tk, dh, dtype — the shapes of tests/test_kernels.py
    (1, 1, 1, 8, 8, 32, np.float32),
    (2, 4, 2, 130, 130, 64, np.float32),
    (1, 8, 1, 256, 256, 128, np.float32),   # MQA
    (2, 4, 4, 64, 64, 64, np.float16),
    (1, 4, 2, 1, 513, 64, np.float32),      # decode append
    (1, 2, 2, 100, 356, 32, np.float32),    # chunked continuation
    # and what the port's models add
    (1, 6, 2, 200, 200, 96, np.float32),    # Dh 96 (phi-3), GQA group 3
    (2, 6, 2, 77, 300, 128, np.float16),    # group 3, Dh 128, Tq % 128 != 0
    (1, 4, 2, 130, 130, 112, np.float32),   # Dh 112 (zamba2)
    (2, 8, 8, 77, 200, 112, np.float16),    # Dh 112, Tq < Tk
]


def _inputs(b, hq, hkv, tq, tk, dh, dtype):
    rng = np.random.default_rng(b * 7 + tq)
    q = rng.normal(size=(b, hq, tq, dh)).astype(dtype)
    k = rng.normal(size=(b, hkv, tk, dh)).astype(dtype)
    v = rng.normal(size=(b, hkv, tk, dh)).astype(dtype)
    return q, k, v


def _tol(dtype):
    return 5e-3 if dtype == np.float16 else 2e-3


@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh,dtype", SHAPES)
@pytest.mark.parametrize("tier", ["interpret", "xla"])
def test_plain_matches_jax(b, hq, hkv, tq, tk, dh, dtype, tier):
    q, k, v = _inputs(b, hq, hkv, tq, tk, dh, dtype)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), tier=tier)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert got.dtype == torch.from_numpy(q).dtype and got.shape == q.shape
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("tier", ["interpret", "xla"])
def test_non_causal_and_explicit_scale_match_jax(tier):
    q, k, v = _inputs(2, 4, 2, 64, 256, 32, np.float32)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=False, scale=0.3, tier=tier)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=False, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)


def test_bf16_matches_jax_xla_reference():
    """bf16 in and out: both compute in fp32 and round once at the end, so
    they agree within one bf16 ulp of |out| <= 4 (2^-6)."""
    q, k, v = _inputs(1, 6, 2, 96, 96, 128, np.float32)
    want = jops.flash_attention(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                                jnp.asarray(v, jnp.bfloat16), tier="xla")
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = ops.flash_attention(*t)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=2.0**-6)


@pytest.mark.parametrize("q_shape,k_shape,causal,match", [
    ((1, 4, 8, 32), (1, 3, 8, 32), True, "multiple of Hkv"),
    ((1, 4, 9, 32), (1, 2, 8, 32), True, "Tq <= Tk"),
    ((2, 4, 8, 32), (1, 2, 8, 32), True, "batch or Dh"),
    ((1, 4, 8, 32), (1, 2, 8, 64), True, "batch or Dh"),
    ((4, 8, 32), (1, 2, 8, 32), True, "4-D"),
])
def test_op_rejects_shapes_outside_its_contract(q_shape, k_shape, causal, match):
    q, k = torch.zeros(q_shape), torch.zeros(k_shape)
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, k.clone(), causal=causal)


# b, hq, hkv, tq, tk, dh: what the op refused before it took any Tk when
# non-causal (Tk = 200), whisper's encoder (18 frames of a reduced prompt),
# its cross-attention in prefill and in decode (Tq = 1), and Dh 112.
NON_CAUSAL_RAGGED = [
    (1, 4, 2, 8, 200, 32), (2, 6, 6, 18, 18, 64), (2, 6, 6, 37, 18, 64),
    (2, 6, 6, 1, 18, 64), (1, 4, 4, 130, 300, 112), (1, 3, 1, 1, 1, 32),
]


@pytest.mark.parametrize("b,hq,hkv,tq,tk,dh", NON_CAUSAL_RAGGED)
def test_non_causal_any_tk_matches_blocked_softmax(b, hq, hkv, tq, tk, dh):
    """Non-causal at any Tk and Tq against the JAX LM's attention (q given
    pre-scaled, as the model passes it): 1e-5 in fp32."""
    q, k, v = _inputs(b, hq, hkv, tq, tk, dh, np.float32)
    q = q * np.float32(dh**-0.5)
    want = JL._blocked_softmax_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False, 0)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=False, scale=1.0)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 2, 4, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention(q, q, q)
    assert fa.flash_attention_plain is not None and fa.REPLACES.endswith(":77")


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_body_for_names_the_body_of_each_dtype_and_head_dim(dtype, dh):
    want = ("fma" if dtype == torch.float32
            else "wgmma" if dh in (64, 128) else "mma_sync")
    assert fa.body_for(dtype, dh) == want
    assert want in fa.BODIES and set(fa.LAUNCHES_BY_BODY) == set(fa.BODIES)


def test_body_for_rejects_what_no_body_takes():
    with pytest.raises(ValueError, match="Dh must be one of"):
        fa.body_for(torch.bfloat16, 80)
    with pytest.raises(TypeError, match="float32, float16 or bfloat16"):
        fa.body_for(torch.float64, 64)


def test_rows_aligned_is_the_tma_stride_rule():
    """A tensor map needs its base and every (b, h, row) stride on 16
    bytes; an axis of extent 1 has no stride to check."""
    buf = torch.zeros(2 * 8 * 16 * 128 + 64, dtype=torch.bfloat16)
    base = buf[:2 * 8 * 16 * 128].view(2, 8, 16, 128)
    assert fa.rows_aligned(base)
    # (B, T, H, Dh) memory seen as (B, H, T, Dh), as the model passes it.
    assert fa.rows_aligned(base.view(2, 16, 8, 128).transpose(1, 2))
    # A base 2 bytes past 16-byte alignment.
    assert not fa.rows_aligned(buf[1:1 + 2 * 8 * 16 * 128].view(2, 8, 16, 128))
    # A row stride of 68 elements (136 bytes) is not a multiple of 16 bytes ...
    wide = torch.zeros(1, 2, 16, 68, dtype=torch.bfloat16)
    assert not fa.rows_aligned(wide[..., :64])
    # ... unless the axis has extent 1.
    assert fa.rows_aligned(wide[:, :, :1, :64])
    assert fa.rows_aligned(torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16))
    # A broadcast axis (stride 0) cannot be a tensor map's stride.
    assert not fa.rows_aligned(torch.zeros(1, 1, 16, 64, dtype=torch.float16).expand(1, 4, 16, 64))
    # fp32 rows of 32 elements are 128 bytes.
    assert fa.rows_aligned(torch.zeros(1, 2, 3, 32))
