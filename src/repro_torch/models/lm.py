"""The port's language model (counterpart of ``repro.models.lm``), family
``dense``: GQA decoder blocks with a SwiGLU FFN, RMSNorm, RoPE, optional QKV
bias and tied embeddings.

  init_params(cfg, generator, tp)                  — an :class:`LM` with random
                                                     weights drawn on the
                                                     generator's device
  forward_train(model, cfg, batch, tp)             — logits for the next-token
                                                     loss (or the hidden states)
  loss_fn(model, cfg, batch, tp)                   — chunked cross-entropy
  init_cache(cfg, batch, max_seq, tp, device) +
  forward_cached(model, cfg, cache, tokens, pos)   — prefill / decode

The parameters follow the JAX ``init_params`` layout and distributions, one
module per layer in place of the stacked ``blocks`` leaves (the JAX scan
over layers becomes a Python loop). They are created with
``requires_grad=False``; a trainer turns gradients on
(``model.requires_grad_(True)``). Training remats each block and each
cross-entropy chunk with ``torch.utils.checkpoint`` where the JAX package
uses ``jax.checkpoint``; the cache-less attention of the training forward
goes through ``ops.flash_attention``, which is differentiable. Every other
family (moe, ssm, hybrid, encdec, vlm) is not ported yet: it raises
``NotImplementedError`` naming its ROADMAP.md item, never runs something
else.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import compat
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

__all__ = ["ModelDims", "model_dims", "LM", "init_params", "forward_train", "loss_fn",
           "init_cache", "forward_cached"]

Cache = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"repro_torch.models.lm: family {cfg.family!r} ({cfg.name}) is not ported "
            f"yet; see ROADMAP.md port queue 1, item 14 (LM families: {cfg.family})"
        )


@dataclasses.dataclass(frozen=True)
class ModelDims:
    h: int
    kv: int
    dh: int
    policy: str  # 'shard' | 'shard_q' | 'pad' | 'replicate'


def model_dims(cfg: ArchConfig, tp: int = 1) -> ModelDims:
    h, kv, policy = cfg.padded_heads(tp)
    return ModelDims(h, kv, cfg.d_head, policy)


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class Block(nn.Module):
    """One decoder block: ``ln1``, ``attn`` (wq wk wv wo [bq bk bv]),
    ``ln2``, ``mlp`` (w_gate w_up w_down) — the JAX block's leaves."""

    def __init__(self, cfg: ArchConfig, dims: ModelDims, device: torch.device):
        super().__init__()
        dt, d = _dtype(cfg), cfg.d_model
        self.ln1 = _param((d,), dt, device)
        shapes = dict(wq=(d, dims.h * dims.dh), wk=(d, dims.kv * dims.dh),
                      wv=(d, dims.kv * dims.dh), wo=(dims.h * dims.dh, d))
        if cfg.qkv_bias:
            shapes.update(bq=(dims.h * dims.dh,), bk=(dims.kv * dims.dh,),
                          bv=(dims.kv * dims.dh,))
        self.attn = nn.ParameterDict({k: _param(s, dt, device) for k, s in shapes.items()})
        self.ln2 = _param((d,), dt, device)
        self.mlp = nn.ParameterDict({
            "w_gate": _param((d, cfg.d_ff), dt, device),
            "w_up": _param((d, cfg.d_ff), dt, device),
            "w_down": _param((cfg.d_ff, d), dt, device),
        })


class LM(nn.Module):
    """The dense LM's parameters (uninitialised; see :func:`init_params` and
    :func:`repro_torch.convert.lm_params_from_numpy`): ``embed`` (V, D),
    ``ln_f``, ``head`` (D, V) unless the embeddings are tied (then the head
    is ``embed.T``), and ``blocks``, one :class:`Block` per layer."""

    def __init__(self, cfg: ArchConfig, tp: int = 1, device=None):
        super().__init__()
        _require_dense(cfg)
        dev = compat.resolve_device(device)
        self.dims = model_dims(cfg, tp)
        dt = _dtype(cfg)
        self.embed = _param((cfg.vocab, cfg.d_model), dt, dev)
        self.ln_f = _param((cfg.d_model,), dt, dev)
        if not cfg.tie_embeddings:
            self.head = _param((cfg.d_model, cfg.vocab), dt, dev)
        self.blocks = nn.ModuleList(Block(cfg, self.dims, dev) for _ in range(cfg.n_layers))


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator, tp: int = 1) -> LM:
    """An :class:`LM` on the generator's device with the JAX ``init_params``
    distributions: embed N(0, 0.02²), dense weights N(0, 1/fan_in), norms
    ones, QKV biases zeros; under the ``pad`` head policy the padded heads'
    ``wo`` rows are zero, so they do not change the function."""
    model = LM(cfg, tp, device=generator.device)
    dt, dims = _dtype(cfg), model.dims
    model.embed.copy_(L.dense_init(generator, (cfg.vocab, cfg.d_model), dt, scale=0.02))
    model.ln_f.fill_(1)
    if not cfg.tie_embeddings:
        model.head.copy_(L.dense_init(generator, (cfg.d_model, cfg.vocab), dt))
    for blk in model.blocks:
        blk.ln1.fill_(1)
        blk.ln2.fill_(1)
        attn = L.init_attention(generator, cfg.d_model, dims.h, dims.kv, dims.dh, dt,
                                cfg.qkv_bias)
        if dims.policy == "pad" and cfg.n_heads < dims.h:
            attn["wo"][cfg.n_heads * dims.dh:] = 0
        for name, t in attn.items():
            blk.attn[name].copy_(t)
        for name, t in L.init_mlp(generator, cfg.d_model, cfg.d_ff, dt).items():
            blk.mlp[name].copy_(t)
    return model


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, tp: int = 1, device=None) -> Cache:
    """Zero KV cache ``dict(kv=(k, v))``, each (n_layers, B, KV, S, Dh) in
    the model's dtype — the JAX layout."""
    _require_dense(cfg)
    dims = model_dims(cfg, tp)
    dev = compat.resolve_device(device)
    shape = (cfg.n_layers, batch, dims.kv, max_seq, dims.dh)
    return dict(kv=(torch.zeros(shape, dtype=_dtype(cfg), device=dev),
                    torch.zeros(shape, dtype=_dtype(cfg), device=dev)))


def _attn_block(blk: Block, x, cfg: ArchConfig, dims: ModelDims, cache=None, pos: int = 0):
    """Residual attention + FFN block; writes the layer's cache in place
    (cache-less, causal over the whole sequence, when ``cache`` is None)."""
    out, _ = L.attention(
        blk.attn, L.rms_norm(x, blk.ln1), h=dims.h, kv=dims.kv, dh=dims.dh,
        rope_theta=cfg.rope_theta, causal=True, cache=cache, cache_pos=pos,
    )
    x = x + out
    return x + L.mlp(blk.mlp, L.rms_norm(x, blk.ln2))


def _head(model: LM, cfg: ArchConfig) -> torch.Tensor:
    return model.embed.T if cfg.tie_embeddings else model.head


def forward_train(
    model: LM,
    cfg: ArchConfig,
    batch: Dict[str, torch.Tensor],
    tp: int = 1,
    remat: bool = True,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), moe_aux_loss ()); the final-normed hidden
    states (B, S, D) in place of the logits if asked.

    ``batch["tokens"]``: (B, S) int. With ``remat`` each block runs under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward, so on the card each layer's
    ``flash_attention`` kernel launches twice per training step. The dense
    family has no auxiliary loss (a zero).
    """
    _require_dense(cfg)
    dims = model_dims(cfg, tp)
    x = model.embed[batch["tokens"]]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in model.blocks:
        if remat:
            x = checkpoint(_attn_block, blk, x, cfg, dims, use_reentrant=False)
        else:
            x = _attn_block(blk, x, cfg, dims)
    x = L.rms_norm(x, model.ln_f)
    if return_hidden:
        return x, aux
    return x @ _head(model, cfg), aux


def loss_fn(
    model: LM,
    cfg: ArchConfig,
    batch: Dict[str, torch.Tensor],
    tp: int = 1,
    remat: bool = True,
    aux_weight: float = 0.01,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (+ MoE aux): (loss, dict(ce, moe_aux)), the
    JAX keys. ``batch["tokens"]``: (B, S+1)."""
    tokens = batch["tokens"]
    hidden, aux = forward_train(model, cfg, dict(batch, tokens=tokens[:, :-1]), tp=tp,
                                remat=remat, return_hidden=True)
    ce = _chunked_ce(hidden, _head(model, cfg), tokens[:, 1:], remat=remat)
    return ce + aux_weight * aux, dict(ce=ce, moe_aux=aux)


def _chunk_loss(x_c: torch.Tensor, head: torch.Tensor, y_c: torch.Tensor) -> torch.Tensor:
    logits = (x_c @ head).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, y_c[..., None].long())[..., 0]
    return (logz - gold).sum()


def _chunked_ce(
    hidden: torch.Tensor,  # (B, S, D)
    head: torch.Tensor,  # (D, V)
    labels: torch.Tensor,  # (B, S)
    n_chunks: int = 8,
    remat: bool = True,
) -> torch.Tensor:
    """Sequence-chunked cross-entropy, mean over the B·S tokens.

    The head product and the CE run per chunk of ⌈S / n⌉ positions with
    fp32 logits; with ``remat`` each chunk is checkpointed, so only one
    (B, S/n, V) slice of logits is live, in the forward and in the backward.
    The gold logit is a ``gather``, equal to the JAX package's one-hot sum.
    """
    b, s, _ = hidden.shape
    n_chunks = min(n_chunks, s)
    cs = -(-s // n_chunks)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, cs):
        hi = min(s, lo + cs)
        args = (hidden[:, lo:hi], head, labels[:, lo:hi])
        if remat:
            total = total + checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            total = total + _chunk_loss(*args)
    return total / (b * s)


@torch.no_grad()
def forward_cached(
    model: LM,
    cfg: ArchConfig,
    cache: Cache,
    tokens: torch.Tensor,  # (B, T) — T = 1 decode, T > 1 prefill from position 0
    pos: int,  # absolute position of tokens[:, 0]
    tp: int = 1,
) -> Tuple[torch.Tensor, Cache]:
    """Returns (logits (B, T, V), cache).

    The cache is updated **in place** (each layer's K and V written at
    ``pos``) and returned as the same object, where the JAX function returns
    a new one. Each layer's prefill launches ``flash_attention`` once on a
    CUDA model; decode launches it not at all.
    """
    _require_dense(cfg)
    dims = model_dims(cfg, tp)
    pos = int(pos)
    ck, cv = cache["kv"]
    x = model.embed[tokens]
    for i, blk in enumerate(model.blocks):
        x = _attn_block(blk, x, cfg, dims, (ck[i], cv[i]), pos)
    x = L.rms_norm(x, model.ln_f)
    return x @ _head(model, cfg), cache
