"""Linear-recurrence sequence mixers of the port: RWKV-6 (Finch) and Mamba-2
(SSD) — the counterpart of ``repro.models.ssm``.

The JAX package's chunked-parallel form, kept operation for operation:
the intra-chunk work is batched products over all chunks, and only the
short state recurrence S ← exp(p_last)·S + contrib runs chunk after chunk
(``lax.scan`` there, a Python loop over chunks here). Decode is a T = 1
call padded to one chunk, as in the JAX package (a recurrent one-token
step is ROADMAP.md port queue 2 work). State and decay numerics are fp32
whatever the model's dtype; the chunk sizes are the JAX package's (32 for
RWKV-6, 64 for Mamba-2). Plain torch on both devices: the JAX package has
no Pallas kernel here.

RWKV-6: per-channel data-dependent decay w_t ∈ (0,1)^{Dh} per head,
  S_t = diag(w_t)·S_{t-1} + k_t v_tᵀ,   o_t = S_{t-1}ᵀ r_t + (r_t·(u⊙k_t)) v_t

Mamba-2 (SSD): scalar per-head decay a_t,
  h_t = a_t·h_{t-1} + B_t (Δ_t x_t)ᵀ,   y_t = C_tᵀ h_t + D ⊙ x_t

Parameters are mappings with the JAX leaf names; the leaves the JAX
package keeps in fp32 in a bf16 model (RWKV-6 ``w0``, ``w_a``, ``w_b``,
``u``, ``ln_x``; Mamba-2 ``a_log``, ``dt_bias``, ``d_skip``, ``norm``) are
fp32 here too.

Tensor parallelism (``shard=``; ``launch.sharding``'s rules) splits both
mixers by heads: each weight holds this rank's slice and the mixer reads
the split from its shape. The scans run on the rank's heads and update the
rank's heads of the state; the norms over all of D (RWKV-6's ``ln_x``) or
d_in (Mamba-2's gated norm) sum their squares over the model group
(``layers.rms_norm_tp``); the output projections and RWKV-6's channel-mix
``wv`` hold the rank's rows (``layers._row_split_product``). The token-shift
carries are the block input's last row, whole on every rank. A mixer whose
heads tp does not divide holds every leaf whole and runs whole on every
rank, with no collective.

Under autograd (training over ranks) every tensor that every rank holds
whole and that meets the rank's split compute passes ``Shard.enter``
(identity forward, the gradient summed over the model group backward): the
block's input and the whole leaves a split mixer reads (RWKV-6's ``mu``,
``w_a``, and the rank's columns of ``w_b``, ``w0`` and ``ln_x``; Mamba-2's
``w_B`` / ``w_C``), and in the channel mix the mixed inputs of a split
``wk`` / ``wr`` and the summed ``kk @ wv`` before the rank takes its
columns. Each leaf's gradient then comes out whole, or the rank's part,
with no sum afterwards.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.layers import dense_init, rms_norm_tp
from repro_torch.models.tp import NO_SHARD, Shard

__all__ = [
    "RWKV_LORA",
    "init_rwkv6",
    "rwkv6_mixer",
    "init_rwkv6_cm",
    "rwkv6_channel_mix",
    "init_mamba2",
    "mamba2_mixer",
]

Params = Mapping[str, torch.Tensor]

RWKV_LORA = 64  # rank of RWKV-6's data-dependent decay (w_a, w_b)


def _pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zeros appended on axis 1 (time) of a (B, T, ...) tensor."""
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + tuple(x.shape[2:]))], dim=1)


def _chunk_states(decay: torch.Tensor, contrib: torch.Tensor, s0: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over chunks: s ← decay_c · s + contrib_c, from s0.
    ``decay`` (B, NC, ...) broadcasts against the state. Returns (the state
    at each chunk's start, stacked on axis 1; the final state)."""
    s, starts = s0, []
    for c in range(contrib.shape[1]):
        starts.append(s)
        s = decay[:, c] * s + contrib[:, c]
    return torch.stack(starts, dim=1), s


# ----------------------------------------------------------------------------
# RWKV-6
# ----------------------------------------------------------------------------

def init_rwkv6(gen: torch.Generator, d_model: int, n_heads: int, dh: int,
               dtype: torch.dtype) -> dict:
    dev, f32 = gen.device, torch.float32
    return dict(
        mu=torch.full((5, d_model), 0.5, dtype=dtype, device=dev),  # token-shift mixes (r,k,v,g,w)
        w0=torch.full((d_model,), -0.6, dtype=f32, device=dev),  # decay base (log-log space)
        w_a=dense_init(gen, (d_model, RWKV_LORA), f32, scale=1e-2),
        w_b=dense_init(gen, (RWKV_LORA, d_model), f32, scale=1e-2),
        u=dense_init(gen, (n_heads, dh), f32, scale=0.5),
        wr=dense_init(gen, (d_model, d_model), dtype),
        wk=dense_init(gen, (d_model, d_model), dtype),
        wv=dense_init(gen, (d_model, d_model), dtype),
        wg=dense_init(gen, (d_model, d_model), dtype),
        wo=dense_init(gen, (d_model, d_model), dtype),
        ln_x=torch.ones((d_model,), dtype=f32, device=dev),
    )


def _rwkv6_chunk_scan(r, k, v, logw, u, s0, chunk: int):
    """Chunked GLA with per-channel decay.

    r, k, v, logw: (B, T, H, N) fp32 (logw <= 0); u: (H, N); s0: (B, H, N, N).
    Returns (o (B, T, H, N), the final state). Everything but the state
    recurrence is batched over the chunks.
    """
    b, t, h, n = r.shape
    nc = -(-t // chunk)
    pad = nc * chunk - t
    r, k, v, logw = (_pad_time(x, pad) for x in (r, k, v, logw))  # logw = 0: no decay
    csh = (b, nc, chunk, h, n)
    rc, kc, vc, wc = (x.reshape(csh) for x in (r, k, v, logw))
    pcum = torch.cumsum(wc, dim=2)  # inclusive Σ log w
    pprev = pcum - wc  # exclusive
    plast = pcum[:, :, -1]  # (B, NC, H, N)

    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device),
                     diagonal=-1)  # strict lower: j < t
    r_in = rc * torch.exp(pprev)
    k_in = kc * torch.exp(-pcum)

    # Intra-chunk attention and the diagonal bonus.
    a = torch.einsum("bcthn,bcshn->bchts", r_in, k_in)
    a = torch.where(tri, a, 0.0)
    o = torch.einsum("bchts,bcshn->bcthn", a, vc)
    bonus = torch.einsum("bcthn,hn,bcthn->bcth", rc, u, kc)
    o = o + bonus[..., None] * vc

    # Per-chunk state contributions (decay to the chunk's end <= 1: stable).
    k_end = kc * torch.exp(plast[:, :, None] - pcum)
    contrib = torch.einsum("bcthn,bcthm->bchnm", k_end, vc)  # (B, NC, H, N, N)
    s_starts, s_fin = _chunk_states(torch.exp(plast)[..., None], contrib, s0)

    # Inter-chunk contribution.
    o = o + torch.einsum("bcthn,bchnm->bcthm", r_in, s_starts)
    return o.reshape(b, nc * chunk, h, n)[:, :t], s_fin


def _token_shift(x: torch.Tensor, last_x: Optional[torch.Tensor]) -> torch.Tensor:
    """x shifted one step later in time, the carry (or zeros) first."""
    b, _, d = x.shape
    prev = x.new_zeros((b, 1, d)) if last_x is None else last_x[:, None]
    return torch.cat([prev, x[:, :-1]], dim=1)


def rwkv6_mixer(
    params: Params,
    x: torch.Tensor,  # (B, T, D)
    *,
    n_heads: int,
    dh: int,
    state: Optional[torch.Tensor] = None,  # (B, H, N, N) fp32
    last_x: Optional[torch.Tensor] = None,  # (B, D): the token-shift carry
    chunk: int = 32,
    shard: Shard = NO_SHARD,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out (B, T, D), the new state, the new token-shift carry).

    Under a shard ``wr`` / ``wk`` / ``wv`` / ``wg`` hold the rank's columns
    (its Hl heads), ``u`` its heads and ``wo`` its rows; ``mu``, ``w0``,
    ``w_a``, ``w_b`` and ``ln_x`` are whole, and the rank takes its columns
    of ``w0``, ``w_b`` and ``ln_x`` (each decay column is computed alone).
    ``state`` is the rank's heads (B, Hl, N, N)."""
    b, t, d = x.shape
    hl = params["wr"].shape[1] // dh  # the rank's heads
    split = hl < n_heads
    mu, w_a, w_b, w0, ln_x = (params[k] for k in ("mu", "w_a", "w_b", "w0", "ln_x"))
    if split:  # whole tensors entering the rank's split compute
        x, mu, w_a, w_b, w0, ln_x = (shard.enter(z) for z in (x, mu, w_a, w_b, w0, ln_x))
        cols = slice(shard.model_rank * hl * dh, (shard.model_rank + 1) * hl * dh)
        w_b, w0, ln_x = w_b[:, cols], w0[cols], ln_x[cols]  # the rank's columns
    xx = _token_shift(x, last_x)

    def mixed(i):
        return x + (xx - x) * mu[i]

    def heads(y):
        return y.reshape(b, t, hl, dh)

    r = heads(mixed(0) @ params["wr"]).float()
    k = heads(mixed(1) @ params["wk"]).float()
    v = heads(mixed(2) @ params["wv"]).float()
    g = mixed(3) @ params["wg"]
    w_raw = w0 + torch.tanh(mixed(4).float() @ w_a) @ w_b
    logw = -torch.exp(w_raw).reshape(b, t, hl, dh)  # log w <= 0

    if state is None:
        state = torch.zeros((b, hl, dh, dh), dtype=torch.float32, device=x.device)
    o, s_fin = _rwkv6_chunk_scan(r, k, v, logw, params["u"], state, chunk)
    o = rms_norm_tp(o.reshape(b, t, hl * dh).to(x.dtype), ln_x.to(x.dtype), shard, d)
    o = o * F.silu(g)
    if params["wo"].shape[0] < d:
        return L._row_split_product(o, params["wo"], shard), s_fin, x[:, -1]
    return o @ params["wo"], s_fin, x[:, -1]


def init_rwkv6_cm(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype) -> dict:
    return dict(
        mu=torch.full((2, d_model), 0.5, dtype=dtype, device=gen.device),  # (k, r) mixes
        wk=dense_init(gen, (d_model, d_ff), dtype),
        wv=dense_init(gen, (d_ff, d_model), dtype),
        wr=dense_init(gen, (d_model, d_model), dtype),
    )


def rwkv6_channel_mix(params: Params, x: torch.Tensor, last_x: Optional[torch.Tensor] = None,
                      shard: Shard = NO_SHARD, d_ff: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV channel-mix: a squared-ReLU MLP with token shift and an r gate.
    Returns (out (B, T, D), the new token-shift carry).

    Under a shard ``wk`` holds the rank's d_ff columns and ``wv`` its rows
    (a row-split product; ``d_ff``, the full width, tells them from whole
    ones), and ``wr`` the rank's D columns: the rank gates its columns of
    the summed ``kk @ wv`` and the gated columns are gathered along D, equal
    elementwise to the unsplit product."""
    xx = _token_shift(x, last_x)
    xk = x + (xx - x) * params["mu"][0]
    xr = x + (xx - x) * params["mu"][1]
    kv_split = shard.tp > 1 and params["wv"].shape[0] < L._full(d_ff, "rwkv6_channel_mix")
    dl = params["wr"].shape[1]
    r_split = dl < x.shape[-1]
    if kv_split:
        xk = shard.enter(xk)
    if r_split:
        xr = shard.enter(xr)
    kk = torch.square(F.relu(xk @ params["wk"]))
    if kv_split:
        kv = L._row_split_product(kk, params["wv"], shard)
    else:
        kv = kk @ params["wv"]
    r = torch.sigmoid(xr @ params["wr"])
    if r_split:  # the rank's columns of the gate
        kv = shard.enter(kv)[..., shard.model_rank * dl:(shard.model_rank + 1) * dl]
        return shard.all_gather(r * kv, -1), x[:, -1]
    return r * kv, x[:, -1]


# ----------------------------------------------------------------------------
# Mamba-2 (SSD)
# ----------------------------------------------------------------------------

def init_mamba2(gen: torch.Generator, d_model: int, n_heads: int, d_state: int,
                dtype: torch.dtype, expand: int = 2) -> dict:
    """Separate projections (not one fused in-projection), as in the JAX
    package."""
    d_in = expand * d_model
    dev, f32 = gen.device, torch.float32
    return dict(
        w_z=dense_init(gen, (d_model, d_in), dtype),
        w_x=dense_init(gen, (d_model, d_in), dtype),
        w_B=dense_init(gen, (d_model, d_state), dtype),
        w_C=dense_init(gen, (d_model, d_state), dtype),
        w_dt=dense_init(gen, (d_model, n_heads), dtype),
        a_log=torch.zeros((n_heads,), dtype=f32, device=dev),  # A = -exp(a_log) = -1
        dt_bias=torch.full((n_heads,), -2.0, dtype=f32, device=dev),  # softplus(-2) ≈ 0.13
        d_skip=torch.ones((n_heads,), dtype=f32, device=dev),
        norm=torch.ones((d_in,), dtype=f32, device=dev),
        w_out=dense_init(gen, (d_in, d_model), dtype),
    )


def _ssd_chunk_scan(xh, bc, cc, loga, s0, chunk: int):
    """Chunked SSD. xh: (B, T, H, P) Δ-scaled inputs; bc, cc: (B, T, N);
    loga: (B, T, H); s0: (B, H, N, P). Returns (y (B, T, H, P), the final
    state). The diagonal is included (j <= t)."""
    b, t, h, p = xh.shape
    n = bc.shape[-1]
    nc = -(-t // chunk)
    pad = nc * chunk - t
    xh, bc, cc, loga = (_pad_time(x, pad) for x in (xh, bc, cc, loga))
    xc = xh.reshape(b, nc, chunk, h, p)
    bcc = bc.reshape(b, nc, chunk, n)
    ccc = cc.reshape(b, nc, chunk, n)
    lac = loga.reshape(b, nc, chunk, h)
    pcum = torch.cumsum(lac, dim=2)  # (B, NC, C, H) inclusive
    plast = pcum[:, :, -1]  # (B, NC, H)

    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))  # j <= t

    # Intra-chunk, batched over chunks.
    ldiff = pcum[:, :, :, None, :] - pcum[:, :, None, :, :]  # (B, NC, C, C, H)
    lmat = torch.where(tri[:, :, None], torch.exp(ldiff), 0.0)
    scores = torch.einsum("bctn,bcsn->bcts", ccc, bcc)  # shared across heads
    y = torch.einsum("bcts,bctsh,bcshp->bcthp", scores, lmat, xc)

    # Per-chunk state contributions.
    wgt = torch.exp(plast[:, :, None] - pcum)  # (B, NC, C, H)
    contrib = torch.einsum("bctn,bcth,bcthp->bchnp", bcc, wgt, xc)
    s_starts, s_fin = _chunk_states(torch.exp(plast)[..., None, None], contrib, s0)

    y = y + torch.einsum("bctn,bcth,bchnp->bcthp", ccc, torch.exp(pcum), s_starts)
    return y.reshape(b, nc * chunk, h, p)[:, :t], s_fin


def mamba2_mixer(
    params: Params,
    x: torch.Tensor,  # (B, T, D)
    *,
    n_heads: int,
    d_state: int,
    state: Optional[torch.Tensor] = None,  # (B, H, N, P) fp32
    chunk: int = 64,
    expand: int = 2,
    shard: Shard = NO_SHARD,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, T, D), the new state).

    Under a shard ``w_z`` / ``w_x`` (head-major d_in columns), ``w_dt``,
    ``a_log``, ``dt_bias``, ``d_skip`` and ``norm`` hold the rank's Hl
    heads and ``w_out`` its rows; ``w_B`` / ``w_C`` are whole, so every rank
    computes C·Bᵀ itself. ``state`` is the rank's heads (B, Hl, N, P)."""
    b, t, d = x.shape
    d_in = expand * d
    p = d_in // n_heads
    hl = params["w_dt"].shape[1]  # the rank's heads
    w_b, w_c = params["w_B"], params["w_C"]
    if hl < n_heads:  # whole tensors entering the rank's split compute
        x, w_b, w_c = (shard.enter(y) for y in (x, w_b, w_c))
    n_heads = hl
    z = x @ params["w_z"]
    xs = x @ params["w_x"]
    bc = x @ w_b
    cc = x @ w_c
    dt = F.softplus((x @ params["w_dt"]).float() + params["dt_bias"])  # (B, T, H)
    loga = -torch.exp(params["a_log"])[None, None] * dt  # <= 0
    xf = xs.reshape(b, t, n_heads, p).float()
    if state is None:
        state = torch.zeros((b, n_heads, d_state, p), dtype=torch.float32, device=x.device)
    y, s_fin = _ssd_chunk_scan(xf * dt[..., None], bc.float(), cc.float(), loga, state, chunk)
    y = y + params["d_skip"][None, None, :, None] * xf
    y = y.reshape(b, t, n_heads * p).to(x.dtype)
    y = rms_norm_tp(y * F.silu(z), params["norm"].to(x.dtype), shard, d_in)
    if params["w_out"].shape[0] < d_in:
        return L._row_split_product(y, params["w_out"], shard), s_fin
    return y @ params["w_out"], s_fin
