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
the JAX package's roundings. A cross-attention call (``xattn_kv``) is
non-causal at any Tk and any Tq, Tq = 1 in decode included; it reaches the
kernel too.

``moe_ffn`` is the JAX package's sort-based, capacity-constrained top-k MoE
in plain torch: the routing, the stable sorts, the capacity drops and the
fp32 combine are tensor code, and the expert products are batched matrix
products (``torch.bmm``), which the JAX package leaves to XLA's einsums
outside any Pallas kernel.

Tensor parallelism (``shard=``, a :class:`repro_torch.models.tp.Shard`;
the default :data:`~repro_torch.models.tp.NO_SHARD` changes nothing). Each
weight holds this rank's slice as ``launch.sharding.param_specs(mode=
"serve")`` gives it, and the layer reads the split from its shape against
the full size: a weight split on its output (column) dimension gives a
local output; one split on its input (row) dimension (``wo``, ``w_down``,
the experts) gives a partial sum, taken in fp32 and summed over the model
group in fp32, then cast once — the single device's one rounding of an
fp32-accumulated product, to within the order of the fp32 sums; a weight
the rules left whole (a dimension tp does not divide) is used whole, with
no collective. The KV cache holds this rank's slice of the sequence, all
KV heads (``launch.sharding.cache_specs``); see :func:`attention`. A norm
over columns split over the model group (RWKV-6's ``ln_x``, Mamba-2's
gated norm) is :func:`rms_norm_tp`.

Under autograd (training over ranks) the same calls differentiate: a
row-split sum's backward is the identity, and a tensor every rank holds
whole that enters a split product (a column-split projection's input, the
replicated K/V a 'shard_q' / 'pad' rank selects heads of, the MoE's token
rows and gate weights) passes ``Shard.enter``, whose backward sums its
gradient over the model group; so
every leaf's gradient is JAX's, whole or the rank's part, with no sum
afterwards. The layers see each leaf in its serve layout (the train
layout's FSDP pieces are gathered by ``models.lm`` first).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.tp import NO_SHARD, Shard

__all__ = [
    "NEG_INF",
    "dense_init",
    "rms_norm",
    "rms_norm_tp",
    "rope",
    "init_attention",
    "attention",
    "init_mlp",
    "mlp",
    "init_moe",
    "moe_ffn",
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


def rms_norm_tp(x: torch.Tensor, gamma: torch.Tensor, shard: Shard, width: int,
                eps: float = 1e-6) -> torch.Tensor:
    """:func:`rms_norm` over a last dimension of ``width`` of which ``x``
    holds this rank's columns (and ``gamma`` their scales): the rank's sum
    of squares, in fp32, summed over the model group before the scale is
    taken. A whole ``x`` (or tp 1) is :func:`rms_norm` itself.

    Under autograd the summed squares feed every rank's split columns, so
    their gradient is summed over the model group (``Shard.enter``) before
    it reaches a rank's own squares (the sum's backward, the identity)."""
    if shard.tp == 1 or x.shape[-1] == width:
        return rms_norm(x, gamma, eps)
    xf = x.float()
    sq = shard.enter(shard.all_reduce((xf * xf).sum(dim=-1, keepdim=True)))
    return (xf * torch.rsqrt(sq / width + eps)).to(x.dtype) * gamma


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
    shard: Shard = NO_SHARD,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """GQA attention. Returns (out (B, T, D), the cache or None).

    With a cache, this call's keys and values are written into it **in
    place** at ``cache_pos`` and the same two tensors are returned. T > 1
    with a cache is prefill from position 0 (chunked prefill is not
    supported, as in the JAX package): it attends within the fresh segment.
    ``h``, ``kv`` and ``dh`` are the model's (padded) head counts; under a
    ``shard`` with a model axis above 1, see :func:`_attention_tp`.
    """
    if shard.tp > 1:
        return _attention_tp(params, x, h=h, kv=kv, dh=dh, rope_theta=rope_theta, causal=causal,
                             cache=cache, cache_pos=cache_pos, xattn_kv=xattn_kv, shard=shard)
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


def _fp32_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` (``w`` 2-D, or both 3-D: a batched product) with an fp32
    result. A 16-bit product on the card keeps its operands and takes
    cuBLAS's fp32 accumulator as the result (``out_dtype``: the tensor-core
    rate, no fp32 copy of the weight); that op has no derivative, so under
    autograd it runs inside :class:`_Fp32Product`. A ``meta`` tensor (the
    dry run, ``launch.dryrun``) takes the card's branch, so that the
    operations and bytes counted are the card's. Elsewhere the operands
    are taken to fp32, which holds them exactly (the CPU has no such
    kernel)."""
    if (a.is_cuda or a.is_meta) and a.dtype in (torch.bfloat16, torch.float16):
        if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
            return _Fp32Product.apply(a, w)
        return _mm_fp32(a, w)
    return torch.matmul(a.float(), w.float())


def _mm_fp32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if w.dim() == 3:
        return torch.bmm(a, w, out_dtype=torch.float32)
    out = torch.mm(a.reshape(-1, a.shape[-1]), w, out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], w.shape[-1])


class _Fp32Product(torch.autograd.Function):
    """The card's 16-bit product into an fp32 result, differentiable: the
    backward casts the fp32 gradient to the operands' dtype and runs both
    products in it, as the backward of a 16-bit ``a @ w`` does."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return _mm_fp32(a, w)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        da = dw = None
        if w.dim() == 3:
            if ctx.needs_input_grad[0]:
                da = torch.bmm(g, w.transpose(1, 2))
            if ctx.needs_input_grad[1]:
                dw = torch.bmm(a.transpose(1, 2), g)
            return da, dw
        if ctx.needs_input_grad[0]:
            da = g @ w.T
        if ctx.needs_input_grad[1]:
            dw = a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return da, dw


def _row_split_product(a: torch.Tensor, w: torch.Tensor, shard: Shard) -> torch.Tensor:
    """``a @ w`` where ``w`` holds this rank's rows (and ``a`` the matching
    columns): the partial product in fp32, summed over the model group in
    fp32, cast once to ``a.dtype``. Under autograd the sum's backward is the
    identity: every rank's rows of ``w`` get the whole gradient."""
    return shard.all_reduce(_fp32_product(a, w)).to(a.dtype)


def _kv_heads_of(k: torch.Tensor, h0: int, hl: int, group: int) -> torch.Tensor:
    """The KV heads that q heads h0 .. h0 + hl - 1 read (head j reads
    j // group): a slice when the local heads read whole, equal groups of
    consecutive KV heads, else one KV head per q head (gathered)."""
    idx = [(h0 + j) // group for j in range(hl)]
    first, n = idx[0], idx[-1] - idx[0] + 1
    if hl % n == 0 and idx == [first + j // (hl // n) for j in range(hl)]:
        return k[:, first:first + n]
    return k[:, idx]


def _attention_tp(params, x, *, h, kv, dh, rope_theta, causal, cache, cache_pos, xattn_kv,
                  shard: Shard):
    """Attention on one rank of a model axis above 1 (serving: a call with
    a cache, a cache-less call such as whisper's encoder, or a
    cross-attention; training: a cache-less call under autograd, the
    column-split projections' input through ``Shard.enter``).

    ``wq`` holds the rank's q heads (all of them under the 'replicate'
    policy), ``wk`` / ``wv`` its KV heads under 'shard' (all of them under
    'shard_q', 'pad' and 'replicate'); the cache (B, KV, S / tp, Dh) holds
    its slice of the sequence, positions [r·S/tp, (r+1)·S/tp), all KV heads.

    Prefill (T > 1 from position 0) and a cache-less call:
    ``ops.flash_attention`` runs the rank's q heads against the KV heads
    they read — its own under 'shard', the replicated K/V sliced (or, where
    the heads straddle a KV boundary, expanded per head) under 'shard_q' /
    'pad', all heads under 'replicate'. With a cache, the fresh K/V,
    gathered over heads under 'shard', are then written where they fall in
    the rank's slice.

    Decode (T = 1): q is gathered to all heads (and the new K/V under
    'shard'); the rank whose slice holds ``pos`` writes the new K/V. Each
    rank then attends its slice for every head, as the single device
    attends the whole cache, with its roundings, and the slices are merged
    (:func:`_merge_slices`). The rank keeps its own heads' rows for its
    rows of ``wo``.

    Cross-attention (``xattn_kv``): over T > 1 (whisper's prefill) the K/V
    are the rank's KV heads at the encoder's full length, projected with
    its ``wk`` / ``wv`` columns, and flash runs as in prefill, non-causal.
    At T = 1 (decode) they are the rank's slice of the cached cross K/V,
    all heads, and the merge runs with every position live. The kernel
    returns no log-sum-exp, so its outputs cannot be merged across ranks:
    a decode step at tp > 1 launches no flash for its cross-attention,
    where tp 1 launches one a layer.

    The output projection is a row-split product (summed over the model
    group) when ``wo`` holds the rank's rows, whole otherwise."""
    b, t, _ = x.shape
    hl, kvl = params["wq"].shape[1] // dh, params["wk"].shape[1] // dh
    q_split, kv_split = hl < h, kvl < kv
    h0 = shard.model_rank * hl if q_split else 0
    xq = shard.enter(x) if q_split else x
    q = xq @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    q = q.reshape(b, t, hl, dh)
    pos = 0 if xattn_kv is not None else int(cache_pos)
    if xattn_kv is None:
        xk = xq if kv_split else x
        kx = xk @ params["wk"]
        vx = xk @ params["wv"]
        if "bk" in params:
            kx, vx = kx + params["bk"], vx + params["bv"]
        kx = kx.reshape(b, t, kvl, dh)
        vx = vx.reshape(b, t, kvl, dh).transpose(1, 2)  # (B, KVl, T, Dh)
        if rope_theta:
            kx = rope(kx, pos + torch.arange(t, device=x.device), rope_theta)
            q = rope(q, pos + torch.arange(t, device=x.device), rope_theta)
        kx = kx.transpose(1, 2)
    q = (q * (dh**-0.5)).transpose(1, 2)  # (B, Hl, T, Dh)

    if xattn_kv is not None and t == 1:  # cross decode: the rank's slice, all heads
        kk, vv = xattn_kv
        live = torch.ones(kk.shape[2], dtype=torch.bool, device=x.device)
        out = _merge_slices(q, kk, vv, live, h=h, kv=kv, h0=h0, shard=shard)
    elif cache is None or t > 1:
        kk, vv = xattn_kv if xattn_kv is not None else (kx, vx)
        if not (kv_split or hl == h):  # 'shard_q' / 'pad': the KV heads the local q heads read
            kk, vv = (_kv_heads_of(shard.enter(z), h0, hl, h // kv) for z in (kk, vv))
        out = ops.flash_attention(q, kk, vv, causal=causal and xattn_kv is None, scale=1.0)
    if cache is not None and xattn_kv is None:
        if kv_split:
            kx, vx = shard.all_gather(kx, 1), shard.all_gather(vx, 1)
        ck, cv = cache
        s_l = ck.shape[2]
        s0 = shard.model_rank * s_l
        lo, hi = max(pos, s0), min(pos + t, s0 + s_l)
        if lo < hi:
            ck[:, :, lo - s0:hi - s0] = kx[:, :, lo - pos:hi - pos]
            cv[:, :, lo - s0:hi - s0] = vx[:, :, lo - pos:hi - pos]
        if t == 1:
            live = (s0 + torch.arange(s_l, device=x.device)) < pos + t
            out = _merge_slices(q, ck, cv, live, h=h, kv=kv, h0=h0, shard=shard)
    out = out.transpose(1, 2).reshape(b, t, hl * dh)
    if params["wo"].shape[0] < h * dh:
        return _row_split_product(out, params["wo"], shard), cache
    return out @ params["wo"], cache


def _merge_slices(q, kk, vv, live, *, h, kv, h0, shard: Shard) -> torch.Tensor:
    """Attention of the query rows ``q`` (B, Hl, T, Dh: the rank's heads
    from ``h0``, gathered to all H when Hl < H) over a sequence split over
    the model group: this rank holds ``kk`` / ``vv`` (B, KV, S_l, Dh),
    positions ``live`` (S_l,) of them attended; a rank that holds no
    position (S_l = 0: a cross K/V sequence that ends before its slice)
    attends one dead one. Returns the rank's heads' rows (B, Hl, T, Dh).

    Each rank attends its slice for every head with the single device's
    decode roundings: fp32 logits, dead positions masked with the finite
    -1e30, a softmax over the slice (running max m, sum l), probs cast to
    the K/V dtype before the second product, an fp32 output o. The merge:
    M = all_reduce_max(m); then one all_reduce_sum of the packed (w, o·w)
    with w = l·exp(m − M); out = Σ(o·w) / Σw. A slice with no live position
    has m = -1e30 and weight 0 (no NaN, as an -inf mask would give)."""
    hl = q.shape[1]
    if kk.shape[2] == 0:
        kk, vv = (z.new_zeros(z.shape[:2] + (1,) + z.shape[3:]) for z in (kk, vv))
        live = torch.zeros(1, dtype=torch.bool, device=kk.device)
    qa = shard.all_gather(q, 1) if hl < h else q  # (B, H, T, Dh)
    b, _, t, dh = qa.shape
    logits = torch.einsum("bkgqd,bksd->bkgqs", qa.reshape(b, kv, h // kv, t, dh).float(),
                          kk.float())
    logits = logits + torch.where(live, 0.0, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    l_sum = e.sum(dim=-1, keepdim=True)
    probs = e / l_sum
    o = torch.einsum("bkgqs,bksd->bkgqd", probs.to(vv.dtype).float(), vv.float())
    big_m = shard.all_reduce(m.clone(), "max")
    w = l_sum * torch.exp(m - big_m)
    packed = shard.all_reduce(torch.cat([w, o * w], dim=-1))
    out = (packed[..., 1:] / packed[..., :1]).reshape(b, h, t, dh).to(q.dtype)
    return out[:, h0:h0 + hl] if hl < h else out


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype) -> dict:
    return dict(
        w_gate=dense_init(gen, (d_model, d_ff), dtype),
        w_up=dense_init(gen, (d_model, d_ff), dtype),
        w_down=dense_init(gen, (d_ff, d_model), dtype),
    )


def mlp(params: Params, x: torch.Tensor, shard: Shard = NO_SHARD,
        d_ff: Optional[int] = None) -> torch.Tensor:
    """SwiGLU: (silu(x @ w_gate) * (x @ w_up)) @ w_down. Under a shard,
    ``d_ff`` (the full width) tells a ``w_down`` that holds this rank's rows
    (a row-split product) from a whole one."""
    split = shard.tp > 1 and params["w_down"].shape[0] < _full(d_ff, "mlp")
    if split:
        x = shard.enter(x)
    hidden = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    if split:
        return _row_split_product(hidden, params["w_down"], shard)
    return hidden @ params["w_down"]


def _full(d_ff: Optional[int], what: str) -> int:
    if d_ff is None:
        raise ValueError(f"repro_torch.models.layers.{what}: a sharded call needs d_ff, the full width")
    return d_ff


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype: torch.dtype) -> dict:
    """The router is fp32 whatever ``dtype`` is, as in the JAX package; the
    3-D expert weights draw with ``dense_init``'s fan-in ``shape[0]`` (the
    expert count E, the JAX package's rule), ``w_down`` with an explicit
    ``d_ff**-0.5``."""
    return dict(
        router=dense_init(gen, (d_model, n_experts), torch.float32),
        w_gate=dense_init(gen, (n_experts, d_model, d_ff), dtype),
        w_up=dense_init(gen, (n_experts, d_model, d_ff), dtype),
        w_down=dense_init(gen, (n_experts, d_ff, d_model), dtype, scale=d_ff**-0.5),
    )


def moe_ffn(
    params: Params,
    x: torch.Tensor,  # (B, T, D)
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    router_bias: Optional[torch.Tensor] = None,  # (E,): the ADWISE-balance hook
    shard: Shard = NO_SHARD,
    d_ff: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based capacity-constrained top-k MoE (token drop on overflow).

    Returns (out (B, T, D), aux_loss (), expert_load (E,) fp32): the Switch
    load-balancing loss E · Σ_e f_e · p_e and the tokens routed to each
    expert before drops. ``router_bias`` (``repro_torch.core.moe_balance``)
    is added to the fp32 router logits.

    The JAX package's choices, each kept: the top k by a stable descending
    sort (``lax.top_k`` takes the lower expert on ties; ``torch.topk``
    promises no order), the (token, slot) pairs grouped by expert with a
    stable sort, capacity ``max(8, ⌈int(cf·T·k/E) / 8⌉·8)`` slots an expert,
    pairs past it sent to a dump row, and the combine summed in fp32 per
    token (``index_add_``, whose order on the card differs from XLA's
    scatter-add: equal within fp32 rounding, not bit for bit).

    The plan is the whole batch's. When ``x`` holds this rank's share of
    rows of a batch split over the data axes (``shard.rows_split``), the
    router logits (fp32, (rows, E): what routing needs of a token) are
    gathered over the data group in data coordinate order, and the
    capacity, the sorts, ``dest`` and ``aux`` are computed over every
    token, as one device computes them; the rank then dispatches and
    combines its own tokens only, at the slots the plan gave them. Under
    autograd the gather's backward sums the logits' gradient over the data
    group (``aux`` reads every rank's rows) and keeps the rank's rows.

    Under a model axis above 1 every rank computes the whole plan (the
    router is replicated, so ``aux`` and the load are equal on every
    rank). With the experts split (EP: ``w_gate`` holds this rank's E / tp
    experts) a rank runs ``bmm`` over its experts' capacity rows only; with
    ``d_ff`` split (each expert's columns) it runs every expert on its
    slice, the last product in fp32. Either way it combines its partial
    rows into the fp32 ``out``, which is summed over the model group
    before the cast; under autograd the token rows and the gate weights
    entering that split compute sum their gradients over the model group
    (``Shard.enter``).
    """
    b, t, d = x.shape
    n_mine = b * t
    e, k = n_experts, top_k
    xf = x.reshape(n_mine, d)

    logits = shard.gather_rows(xf.float() @ params["router"])
    n_tok, lo = logits.shape[0], shard.row_offset(n_mine)
    cap = int(capacity_factor * n_tok * k / e)
    cap = max(8, -(-cap // 8) * 8)
    if router_bias is not None:
        logits = logits + router_bias[None, :]
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = top.values[:, :k], top.indices[:, :k]  # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    me = probs.mean(dim=0)
    fe = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(fe * me)

    flat_e = gate_idx.reshape(-1)  # (T·k,)
    flat_t = torch.arange(n_tok, device=x.device).repeat_interleave(k)
    order = torch.sort(flat_e, stable=True).indices
    se, st_, sw = flat_e[order], flat_t[order], gate_vals.reshape(-1)[order]
    # the pairs per expert with no host sync (bincount sizes its output on the host)
    counts = torch.zeros(e, dtype=se.dtype, device=x.device).index_add_(0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n_tok * k, device=x.device) - starts[se]
    keep = rank < cap
    dest = torch.where(keep, se * cap + rank, e * cap)  # overflow -> the dump row
    if n_tok != n_mine:
        # This rank's pairs, its tokens counted from its first row, in a fixed
        # size: another rank's pair goes to the dump row from the rank's row
        # 0 with weight 0, so it dispatches nothing and adds 0 to that row.
        own = (st_ >= lo) & (st_ < lo + n_mine)
        keep, dest = keep & own, torch.where(own, dest, e * cap)
        st_, sw = torch.where(own, st_ - lo, 0), torch.where(own, sw, 0.0)

    el = params["w_gate"].shape[0]
    ep = shard.tp > 1 and el < e
    ff_split = shard.tp > 1 and params["w_down"].shape[1] < _full(d_ff, "moe_ffn")
    if ep or ff_split:
        xf, sw = shard.enter(xf), shard.enter(sw)
    xs = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    xs[dest] = xf[st_]
    xs = xs[:-1].reshape(e, cap, d)
    if ep:
        xs = xs[shard.model_rank * el:(shard.model_rank + 1) * el]
    hidden = F.silu(torch.bmm(xs, params["w_gate"])) * torch.bmm(xs, params["w_up"])
    if ff_split:
        ys = _fp32_product(hidden, params["w_down"])  # (E, C, D), a partial sum
    else:
        ys = torch.bmm(hidden, params["w_down"])  # (E, C, D)

    if ep:  # the pairs routed to this rank's experts, rows counted from its first
        y_rows, lo_e = ys.reshape(el * cap, d), shard.model_rank * el * cap
        mine = keep & (dest >= lo_e) & (dest < lo_e + el * cap)
        gathered = torch.where(mine[:, None], y_rows[(dest - lo_e).clamp(0, el * cap - 1)], 0.0)
    else:
        y_rows = ys.reshape(e * cap, d)
        gathered = torch.where(keep[:, None], y_rows[dest.clamp_max(e * cap - 1)], 0.0)
    out = torch.zeros((n_mine, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, st_, gathered.float() * sw[:, None])
    if ep or ff_split:
        out = shard.all_reduce(out)
    return out.reshape(b, t, d).to(x.dtype), aux, counts.float()
