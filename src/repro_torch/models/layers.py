"""Transformer building blocks of the port (counterpart of ``repro.models.layers``).

Plain functions over tensors and parameter mappings (a ``dict`` or an
``nn.ParameterDict`` with the JAX package's leaf names), in the JAX
package's layouts: activations (B, T, D), attention heads (B, H, T, Dh),
weights (in, out) applied as ``x @ w``. Initializers take an explicit
``torch.Generator``; the draws differ from ``jax.random``'s, so a test
carries weights across with :func:`repro_torch.convert.lm_params_from_numpy`.

Attention sends its prefill (a cache given, T > 1) and its cache-less calls
through :func:`repro_torch.kernels.ops.flash_attention` — the hand-written
kernel on a CUDA tensor, the plain version on a CPU one, differentiable on
both (the training forward's cache-less calls take gradients through it);
the JAX package computes them with its XLA blocked softmax, the same
function. Decode
(T == 1) stays a masked product over the whole cache in plain torch, with
the JAX package's roundings. ``moe_ffn`` is not ported yet (ROADMAP.md port
queue 1).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

__all__ = [
    "NEG_INF",
    "dense_init",
    "rms_norm",
    "rope",
    "init_attention",
    "attention",
    "init_mlp",
    "mlp",
]

NEG_INF = -1e30

Params = Mapping[str, torch.Tensor]


def dense_init(
    gen: torch.Generator, shape, dtype: torch.dtype, scale: float | None = None,
) -> torch.Tensor:
    """N(0, 1) · scale (default fan_in**-0.5, fan_in = shape[0] for 2-D and
    up), drawn in fp32 on the generator's device, then cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in**-0.5
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalise in fp32, cast back to ``x.dtype``, then scale by γ in the
    working dtype — the JAX package's rounding order."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., T, H, Dh); positions: (T,) or (B, T)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (..., T, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    cos, sin = cos[..., None, :], sin[..., None, :]  # broadcast over heads
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_attention(
    gen: torch.Generator, d_model: int, h: int, kv: int, dh: int,
    dtype: torch.dtype, qkv_bias: bool,
) -> dict[str, torch.Tensor]:
    p = dict(
        wq=dense_init(gen, (d_model, h * dh), dtype),
        wk=dense_init(gen, (d_model, kv * dh), dtype),
        wv=dense_init(gen, (d_model, kv * dh), dtype),
        wo=dense_init(gen, (h * dh, d_model), dtype),
    )
    if qkv_bias:
        dev = gen.device
        p.update(
            bq=torch.zeros((h * dh,), dtype=dtype, device=dev),
            bk=torch.zeros((kv * dh,), dtype=dtype, device=dev),
            bv=torch.zeros((kv * dh,), dtype=dtype, device=dev),
        )
    return p


def attention(
    params: Params,
    x: torch.Tensor,  # (B, T, D)
    *,
    h: int,
    kv: int,
    dh: int,
    rope_theta: float | None,
    causal: bool = True,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (k, v): (B, KV, S, Dh)
    cache_pos: int = 0,  # write offset into the cache
    xattn_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cross-attention K/V
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """GQA attention. Returns (out (B, T, D), the cache or None).

    With a cache, this call's keys and values are written into it **in
    place** at ``cache_pos`` and the same two tensors are returned. T > 1
    with a cache is prefill from position 0 (chunked prefill is not
    supported, as in the JAX package): it attends within the fresh segment.
    """
    b, t, _ = x.shape
    q = x @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    q = q.reshape(b, t, h, dh)

    new_cache = None
    kx = vx = None
    if xattn_kv is not None:
        kk, vv = xattn_kv
        pos = 0
    else:
        kx = x @ params["wk"]
        vx = x @ params["wv"]
        if "bk" in params:
            kx, vx = kx + params["bk"], vx + params["bv"]
        kx = kx.reshape(b, t, kv, dh)
        vx = vx.reshape(b, t, kv, dh).transpose(1, 2)  # (B, KV, T, Dh)
        pos = int(cache_pos)
        if rope_theta:
            kpos = pos + torch.arange(t, device=x.device)
            kx = rope(kx, kpos, rope_theta)
        kx = kx.transpose(1, 2)
        if cache is not None:
            ck, cv = cache
            ck[:, :, pos:pos + t] = kx
            cv[:, :, pos:pos + t] = vx
            kk, vv = ck, cv
            new_cache = (ck, cv)
        else:
            kk, vv = kx, vx

    if rope_theta and xattn_kv is None:
        qpos = pos + torch.arange(t, device=x.device)
        q = rope(q, qpos, rope_theta)
    q = (q * (dh**-0.5)).transpose(1, 2)  # (B, H, T, Dh), scaled in the working dtype

    if cache is not None and t > 1:
        # Prefill from zero: the fresh segment only (the cache is written).
        out = ops.flash_attention(q, kx, vx, causal=causal, scale=1.0)
    elif cache is not None:
        # Decode: the new token attends the whole cache up to pos + t. Both
        # products keep fp32 results and probs are cast to the cache dtype
        # before the second, as in the JAX package; unwritten positions are
        # zeros and masked.
        s = kk.shape[2]
        live = torch.arange(s, device=x.device) < pos + t
        logits_mask = torch.where(live, 0.0, NEG_INF)
        group = h // kv
        qg = q.reshape(b, kv, group, t, dh)
        logits = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), kk.float())
        logits = logits + logits_mask
        if causal and t > 1:
            qpos = pos + torch.arange(t, device=x.device)
            cmask = qpos[:, None] >= torch.arange(s, device=x.device)[None, :]
            logits = torch.where(cmask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgqs,bksd->bkgqd", probs.to(vv.dtype).float(), vv.float())
        out = out.reshape(b, h, t, dh).to(x.dtype)
    else:
        out = ops.flash_attention(q, kk, vv, causal=causal and xattn_kv is None, scale=1.0)

    out = out.transpose(1, 2).reshape(b, t, h * dh)
    return out @ params["wo"], new_cache


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype) -> dict:
    return dict(
        w_gate=dense_init(gen, (d_model, d_ff), dtype),
        w_up=dense_init(gen, (d_model, d_ff), dtype),
        w_down=dense_init(gen, (d_ff, d_model), dtype),
    )


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x @ w_gate) * (x @ w_up)) @ w_down."""
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]
