"""The port's language model (counterpart of ``repro.models.lm``), for
every family of the JAX package:

  dense / moe / vlm : GQA decoder blocks (SwiGLU or top-k MoE FFN); vlm
                      prepends projected image patches (``vit_proj``)
  ssm (rwkv6)       : RWKV-6 blocks (time mix + channel mix)
  hybrid (zamba2)   : Mamba-2 layers + ONE shared-weight attention block
                      applied after every ``shared_every`` layers
  encdec (whisper)  : a bidirectional encoder over stub frame embeddings +
                      a causal decoder with cross-attention

  init_params(cfg, generator, tp)                  — an :class:`LM` with random
                                                     weights drawn on the
                                                     generator's device
  forward_train(model, cfg, batch, tp, shard=)     — logits for the next-token
                                                     loss (or the hidden states)
  loss_fn(model, cfg, batch, tp, shard=)           — chunked cross-entropy
  reduce_grads(model, shard)                       — the data-group sum of the
                                                     gradients FSDP leaves whole
  attention_calls(cfg, remat)                      — flash_attention launches
                                                     and backward calls of
                                                     one training step
  init_cache(cfg, batch, max_seq, tp, device) +
  forward_cached(model, cfg, cache, tokens, pos,
                 frames=, patches=)                — prefill / decode

The parameters follow the JAX ``init_params`` layout, leaf names, dtypes and
distributions, one module per layer in place of the stacked ``blocks`` /
``enc_blocks`` leaves (the JAX scans over layers become Python loops): a
:class:`Block` (attention + MLP or MoE, with cross-attention in whisper's
decoder), an :class:`RwkvBlock` or a :class:`MambaBlock`. The leaves the JAX
package keeps in fp32 in a bf16 model (the MoE router, RWKV-6's decay and
bonus leaves and ``ln_x``, Mamba-2's ``a_log``, ``dt_bias``, ``d_skip`` and
``norm``) are fp32 here too. They are created with ``requires_grad=False``;
a trainer turns gradients on (``model.requires_grad_(True)``). Training
remats each block and each cross-entropy chunk with
``torch.utils.checkpoint`` where the JAX package uses ``jax.checkpoint``
(the hybrid's shared block excepted, as there); the cache-less attention of
the training forward goes through ``ops.flash_attention``, which is
differentiable.

Tensor-parallel serving (``shard=``, a :class:`repro_torch.models.tp.Shard`
of a mesh with more than one rank; every family, built by the launcher
with ``launch.sharding.shard_for``, which resolves the layout from the
sharding rules): :class:`LM` allocates this rank's slice of each
parameter (``shard.param_index``; ``LM.tp_layout``: name -> (full shape,
index)), :func:`init_params` draws every leaf whole, as one device draws
it, and keeps the slice, :func:`init_cache` allocates the rank's slice of
the cache (``shard.cache_index``: the KV and cross K/V sequences over
``model``, the SSM states by heads, the batch over ``data`` when it
divides), and
:func:`forward_cached` takes the rank's rows of the batch and returns the
whole logits. The default :data:`~repro_torch.models.tp.NO_SHARD` changes
nothing.

Training over ranks (``shard=`` from ``shard_for(mode="train")``; every
family): :class:`LM` holds the rank's FSDP + TP piece of each leaf,
:func:`forward_train` gathers each block's pieces over the data axes
inside the block's checkpointed call (ZeRO-3: the recompute gathers them
again; the hybrid's shared block, which is not rematerialised, once for all
its applications), :func:`loss_fn` returns the whole batch's loss (the data
ranks' mean) and :func:`reduce_grads` finishes the gradients of the leaves
not split over data.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import compat
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.names import tree_map_with_path
from repro_torch.models.tp import NO_SHARD, Shard

__all__ = ["ModelDims", "model_dims", "Block", "RwkvBlock", "MambaBlock", "LM", "init_params",
           "forward_train", "loss_fn", "reduce_grads", "attention_calls", "init_cache",
           "forward_cached"]

Cache = Dict[str, Any]


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


def _sharded(cfg: ArchConfig, tp: int, shard: Shard) -> bool:
    """Whether ``shard`` splits anything (a mesh of more than one rank);
    raises for a ``tp`` that is not the mesh's model size. (An SSM mixer
    whose heads tp does not divide is left whole by the rules, and runs
    whole on every rank.)"""
    if shard.mesh.size == 1:
        return False
    if shard.tp != tp:
        raise ValueError(f"repro_torch.models.lm: tp={tp} but the mesh's model axis is {shard.tp}")
    if not shard.param_index or shard.cache_index is None:
        raise ValueError("repro_torch.models.lm: the shard has no layout; build it with "
                         "repro_torch.launch.sharding.shard_for")
    return True


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def _params(shapes: Dict[str, tuple], dtype: torch.dtype, device, fp32=()) -> nn.ParameterDict:
    """A ParameterDict of uninitialised leaves in ``dtype``, those named in
    ``fp32`` in float32."""
    return nn.ParameterDict({k: _param(s, torch.float32 if k in fp32 else dtype, device)
                             for k, s in shapes.items()})


def _attn_shapes(cfg: ArchConfig, dims: ModelDims) -> Dict[str, tuple]:
    d, hd, kvd = cfg.d_model, dims.h * dims.dh, dims.kv * dims.dh
    shapes = dict(wq=(d, hd), wk=(d, kvd), wv=(d, kvd), wo=(hd, d))
    if cfg.qkv_bias:
        shapes.update(bq=(hd,), bk=(kvd,), bv=(kvd,))
    return shapes


def _fill(dst: nn.ParameterDict, src: Dict[str, torch.Tensor], local, prefix: str) -> None:
    """Copies each initialised leaf (its part ``local(prefix.name, leaf)``)
    into its parameter (same names, shapes and dtypes)."""
    if set(dst) != set(src):
        raise KeyError(f"leaves {sorted(src)} do not match {sorted(dst)}")
    for name, t in src.items():
        t = local(f"{prefix}.{name}", t)
        if t.shape != dst[name].shape or t.dtype != dst[name].dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} into "
                             f"{tuple(dst[name].shape)} {dst[name].dtype}")
        dst[name].copy_(t)


class Block(nn.Module):
    """One attention block: ``ln1``, ``attn`` (wq wk wv wo [bq bk bv]),
    ``ln2``, and ``mlp`` (w_gate w_up w_down) or, in an MoE model, ``moe``
    (router (fp32), w_gate w_up (E, D, F), w_down (E, F, D)); with
    ``cross``, also ``ln_x`` and ``xattn`` (whisper's decoder) — the JAX
    block's leaves."""

    def __init__(self, cfg: ArchConfig, dims: ModelDims, device: torch.device,
                 cross: bool = False):
        super().__init__()
        dt, d, f = _dtype(cfg), cfg.d_model, cfg.d_ff
        self.ln1 = _param((d,), dt, device)
        self.attn = _params(_attn_shapes(cfg, dims), dt, device)
        self.ln2 = _param((d,), dt, device)
        if cfg.moe:
            e = cfg.moe.n_experts
            self.moe = _params(dict(router=(d, e), w_gate=(e, d, f), w_up=(e, d, f),
                                    w_down=(e, f, d)), dt, device, fp32=("router",))
        else:
            self.mlp = _params(dict(w_gate=(d, f), w_up=(d, f), w_down=(f, d)), dt, device)
        if cross:
            self.ln_x = _param((d,), dt, device)
            self.xattn = _params(_attn_shapes(cfg, dims), dt, device)


class RwkvBlock(nn.Module):
    """One RWKV-6 block: ``ln1``, ``att`` (the time mix; ``w0``, ``w_a``,
    ``w_b``, ``u`` and ``ln_x`` fp32), ``ln2``, ``cm`` (the channel mix)."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        dt, d, f = _dtype(cfg), cfg.d_model, cfg.d_ff
        self.ln1 = _param((d,), dt, device)
        self.att = _params(dict(
            mu=(5, d), w0=(d,), w_a=(d, S.RWKV_LORA), w_b=(S.RWKV_LORA, d),
            u=(cfg.n_heads, cfg.d_head), wr=(d, d), wk=(d, d), wv=(d, d), wg=(d, d),
            wo=(d, d), ln_x=(d,)), dt, device, fp32=("w0", "w_a", "w_b", "u", "ln_x"))
        self.ln2 = _param((d,), dt, device)
        self.cm = _params(dict(mu=(2, d), wk=(d, f), wv=(f, d), wr=(d, d)), dt, device)


class MambaBlock(nn.Module):
    """One Mamba-2 layer: ``ln`` and ``mamba`` (``a_log``, ``dt_bias``,
    ``d_skip`` and ``norm`` fp32)."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        dt, d, h, n = _dtype(cfg), cfg.d_model, cfg.n_heads, cfg.ssm_state
        d_in = 2 * d
        self.ln = _param((d,), dt, device)
        self.mamba = _params(dict(
            w_z=(d, d_in), w_x=(d, d_in), w_B=(d, n), w_C=(d, n), w_dt=(d, h), a_log=(h,),
            dt_bias=(h,), d_skip=(h,), norm=(d_in,), w_out=(d_in, d)), dt, device,
            fp32=("a_log", "dt_bias", "d_skip", "norm"))


class LM(nn.Module):
    """The LM's parameters (uninitialised; see :func:`init_params` and
    :func:`repro_torch.convert.lm_params_from_numpy`): ``embed`` (V, D),
    ``ln_f``, ``head`` (D, V) unless the embeddings are tied (then the head
    is ``embed.T``), and ``blocks``, one block per layer — a :class:`Block`
    (dense, moe, vlm; with cross-attention in encdec), an
    :class:`RwkvBlock` (ssm) or a :class:`MambaBlock` (hybrid). The vlm
    family adds ``vit_proj`` (D, D); hybrid its one ``shared``
    :class:`Block`; encdec ``enc_blocks`` (``n_enc_layers`` Blocks) and
    ``enc_ln_f``."""

    def __init__(self, cfg: ArchConfig, tp: int = 1, device=None, shard: Shard = NO_SHARD):
        super().__init__()
        final = torch.device("meta") if str(device) == "meta" else compat.resolve_device(device)
        sharded = _sharded(cfg, tp, shard)
        dev = torch.device("meta") if sharded else final  # whole shapes first, then the slices
        self.dims = dims = model_dims(cfg, tp)
        dt, d = _dtype(cfg), cfg.d_model
        self.embed = _param((cfg.vocab, d), dt, dev)
        self.ln_f = _param((d,), dt, dev)
        if not cfg.tie_embeddings:
            self.head = _param((d, cfg.vocab), dt, dev)
        fam, n = cfg.family, cfg.n_layers
        if fam in ("dense", "moe", "vlm"):
            self.blocks = nn.ModuleList(Block(cfg, dims, dev) for _ in range(n))
            if fam == "vlm":
                self.vit_proj = _param((d, d), dt, dev)
        elif fam == "ssm":
            self.blocks = nn.ModuleList(RwkvBlock(cfg, dev) for _ in range(n))
        elif fam == "hybrid":
            self.blocks = nn.ModuleList(MambaBlock(cfg, dev) for _ in range(n))
            self.shared = Block(cfg, dims, dev)
        elif fam == "encdec":
            self.enc_blocks = nn.ModuleList(Block(cfg, dims, dev)
                                            for _ in range(cfg.n_enc_layers))
            self.enc_ln_f = _param((d,), dt, dev)
            self.blocks = nn.ModuleList(Block(cfg, dims, dev, cross=True) for _ in range(n))
        else:
            raise ValueError(f"repro_torch.models.lm: unknown family {fam!r}")
        self.tp_layout: Dict[str, Tuple[tuple, tuple]] = {}
        if sharded:
            self._localize(shard, final)

    def _localize(self, shard: Shard, device: torch.device) -> None:
        """Replaces every (meta, whole) parameter by an empty one of this
        rank's slice (``shard.param_index``) on ``device``."""
        for name, p in list(self.named_parameters()):
            idx = shard.param_index[name]
            local = _param(tuple(s.stop - s.start for s in idx), p.dtype, device)
            owner, _, leaf = name.rpartition(".")
            mod = self.get_submodule(owner) if owner else self
            if isinstance(mod, nn.ParameterDict):
                mod[leaf] = local
            else:
                setattr(mod, leaf, local)
            self.tp_layout[name] = (tuple(p.shape), idx)

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """The part of ``full`` (the whole leaf of parameter ``name``) that
        this model holds: ``full`` itself when the model is not sharded."""
        layout = self.tp_layout.get(name)
        return full if layout is None else full[layout[1]]


def _init_block(blk: Block, cfg: ArchConfig, dims: ModelDims, gen: torch.Generator,
                local, prefix: str) -> None:
    """The JAX ``_init_block`` distributions: norms ones, attention and MLP
    N(0, 1/fan_in), the MoE as ``layers.init_moe``; under the ``pad`` head
    policy the padded heads' ``wo`` rows are zero, so they do not change
    the function. Each leaf is drawn whole; ``local`` gives the part the
    parameter keeps (by its name: ``prefix`` is the block's)."""
    dt = _dtype(cfg)

    def attention():
        attn = L.init_attention(gen, cfg.d_model, dims.h, dims.kv, dims.dh, dt, cfg.qkv_bias)
        if dims.policy == "pad" and cfg.n_heads < dims.h:
            attn["wo"][cfg.n_heads * dims.dh:] = 0
        return attn

    blk.ln1.fill_(1)
    _fill(blk.attn, attention(), local, f"{prefix}.attn")
    blk.ln2.fill_(1)
    if cfg.moe:
        _fill(blk.moe, L.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.moe.n_experts, dt), local,
              f"{prefix}.moe")
    else:
        _fill(blk.mlp, L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt), local, f"{prefix}.mlp")
    if hasattr(blk, "xattn"):
        blk.ln_x.fill_(1)
        _fill(blk.xattn, attention(), local, f"{prefix}.xattn")


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator, tp: int = 1,
                shard: Shard = NO_SHARD) -> LM:
    """An :class:`LM` on the generator's device with the JAX ``init_params``
    distributions: embed N(0, 0.02²), dense weights N(0, 1/fan_in), norms
    ones, QKV biases zeros, and the RWKV-6 / Mamba-2 / MoE leaves as
    ``models.ssm`` and ``layers.init_moe`` draw them. Under a ``shard``
    every leaf is drawn whole, in the same order, from the same generator,
    and the rank keeps its slice: the weights of the one-device model,
    split."""
    model = LM(cfg, tp, device=generator.device, shard=shard)
    dt, dims, d = _dtype(cfg), model.dims, cfg.d_model
    model.embed.copy_(model.local("embed", L.dense_init(generator, (cfg.vocab, d), dt, scale=0.02)))
    model.ln_f.fill_(1)
    if not cfg.tie_embeddings:
        model.head.copy_(model.local("head", L.dense_init(generator, (d, cfg.vocab), dt)))
    for i, blk in enumerate(model.blocks):
        name = f"blocks.{i}"
        if isinstance(blk, RwkvBlock):
            blk.ln1.fill_(1)
            blk.ln2.fill_(1)
            _fill(blk.att, S.init_rwkv6(generator, d, cfg.n_heads, cfg.d_head, dt), model.local,
                  f"{name}.att")
            _fill(blk.cm, S.init_rwkv6_cm(generator, d, cfg.d_ff, dt), model.local, f"{name}.cm")
        elif isinstance(blk, MambaBlock):
            blk.ln.fill_(1)
            _fill(blk.mamba, S.init_mamba2(generator, d, cfg.n_heads, cfg.ssm_state, dt),
                  model.local, f"{name}.mamba")
        else:
            _init_block(blk, cfg, dims, generator, model.local, name)
    for i, blk in enumerate(getattr(model, "enc_blocks", ())):
        _init_block(blk, cfg, dims, generator, model.local, f"enc_blocks.{i}")
    if cfg.family == "encdec":
        model.enc_ln_f.fill_(1)
    if cfg.family == "hybrid":
        _init_block(model.shared, cfg, dims, generator, model.local, "shared")
    if cfg.family == "vlm":
        model.vit_proj.copy_(model.local("vit_proj", L.dense_init(generator, (d, d), dt)))
    return model


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, tp: int = 1, device=None,
               shard: Shard = NO_SHARD) -> Cache:
    """The zero cache of ``cfg``'s family on ``device``, in the JAX layout
    and dtypes:

    - dense, moe: ``kv=(k, v)``, each (n_layers, B, KV, max_seq, Dh);
    - vlm: the same over ``max_seq + vlm_patches`` positions;
    - ssm: ``s`` (n_layers, B, H, Dh, Dh) fp32, ``lx_att`` and ``lx_cm``
      (n_layers, B, D), the token-shift carries;
    - hybrid: ``s`` (n_layers, B, H, N, 2D/H) fp32 and ``kv``, a list of one
      (k, v) pair (B, KV, max_seq, Dh) per application of the shared block;
    - encdec: ``kv`` as dense and ``xkv`` (n_layers, B, KV, max(max_seq // 2,
      1), Dh), the cross-attention K/V, which prefill replaces.

    Under a ``shard`` (``batch`` is the global batch) each leaf is this
    rank's slice as ``shard.cache_index`` places it: for model coordinate
    r, positions [r·S_l, (r+1)·S_l) of each KV sequence (the hybrid's
    per-application pairs too; S_l = ⌈S / tp⌉, S = ``max_seq``, plus
    ``vlm_patches`` in the vlm), padded past S (never written: a decode
    step masks every position past ``pos``); the same positions of a cross
    K/V sequence that lie below its length (a rank past its end holds
    none); the rank's heads of an SSM state (all of them when tp does not
    divide the heads), the token-shift carries whole, and rows of the batch
    by data coordinate when the data axis divides it (every row otherwise).
    """
    if _sharded(cfg, tp, shard):
        dev = torch.device("meta") if str(device) == "meta" else compat.resolve_device(device)

        def local(path, t):
            idx = shard.cache_index(path, t.shape)
            return torch.zeros([i.stop - i.start for i in idx], dtype=t.dtype, device=dev)

        return tree_map_with_path(local, init_cache(cfg, batch, max_seq, tp, "meta"))
    dims = model_dims(cfg, tp)
    dev = torch.device("meta") if str(device) == "meta" else compat.resolve_device(device)
    dt, lg, d = _dtype(cfg), cfg.n_layers, cfg.d_model

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def kv(*lead, s):
        return (zeros(*lead, batch, dims.kv, s, dims.dh), zeros(*lead, batch, dims.kv, s, dims.dh))

    fam = cfg.family
    if fam in ("dense", "moe"):
        return dict(kv=kv(lg, s=max_seq))
    if fam == "vlm":
        return dict(kv=kv(lg, s=max_seq + cfg.vlm_patches))
    if fam == "ssm":
        return dict(s=zeros(lg, batch, cfg.n_heads, cfg.d_head, cfg.d_head, dtype=torch.float32),
                    lx_att=zeros(lg, batch, d), lx_cm=zeros(lg, batch, d))
    if fam == "hybrid":
        n_apps = cfg.n_layers // cfg.shared_every
        s = zeros(lg, batch, cfg.n_heads, cfg.ssm_state, 2 * d // cfg.n_heads,
                  dtype=torch.float32)
        return dict(s=s, kv=[kv(s=max_seq) for _ in range(n_apps)])
    if fam == "encdec":
        return dict(kv=kv(lg, s=max_seq), xkv=kv(lg, s=max(max_seq // 2, 1)))
    raise ValueError(f"repro_torch.models.lm: unknown family {fam!r}")


def _attn_block(blk: Block, x, cfg: ArchConfig, dims: ModelDims, cache=None, pos: int = 0,
                causal: bool = True, xattn_kv=None, enc_out=None, shard: Shard = NO_SHARD):
    """Residual attention (+ cross-attention) + FFN block; writes the
    layer's cache in place (cache-less over the whole sequence when
    ``cache`` is None). Returns (x, the MoE's auxiliary loss (), or None
    without an MoE).

    The cross-attention reads ``xattn_kv`` (the cached encoder K/V) or, in
    training, ``enc_out``, which it projects to K/V itself, as the JAX
    block does: under remat the projection is then recomputed with the
    block, and the gradient reaches the encoder through it."""
    out, _ = L.attention(
        blk.attn, L.rms_norm(x, blk.ln1), h=dims.h, kv=dims.kv, dh=dims.dh,
        rope_theta=cfg.rope_theta, causal=causal, cache=cache, cache_pos=pos, shard=shard,
    )
    x = x + out
    # staticcheck: disable=SC002 torch.utils.checkpoint runs eagerly: enc_out is None or a tensor, never traced
    if xattn_kv is None and enc_out is not None:
        b, te = enc_out.shape[:2]
        # staticcheck: disable=SC002 torch.utils.checkpoint runs eagerly: shapes are ints, never traced
        if blk.xattn["wk"].shape[1] < dims.kv * dims.dh:  # the rank's KV heads' columns
            enc_out = shard.enter(enc_out)
        xattn_kv = tuple((enc_out @ blk.xattn[w]).reshape(b, te, -1, dims.dh).transpose(1, 2)
                         for w in ("wk", "wv"))
    # staticcheck: disable=SC002 torch.utils.checkpoint runs eagerly: xattn_kv is None or a pair of tensors, never traced
    if xattn_kv is not None:
        out, _ = L.attention(blk.xattn, L.rms_norm(x, blk.ln_x), h=dims.h, kv=dims.kv,
                             dh=dims.dh, rope_theta=None, causal=False, xattn_kv=xattn_kv,
                             shard=shard)
        x = x + out
    h2 = L.rms_norm(x, blk.ln2)
    # staticcheck: disable=SC002 torch.utils.checkpoint runs eagerly: cfg is a frozen config, never traced
    if cfg.moe:
        f, aux, _ = L.moe_ffn(blk.moe, h2, n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                              capacity_factor=cfg.moe.capacity_factor, shard=shard, d_ff=cfg.d_ff)
    else:
        f, aux = L.mlp(blk.mlp, h2, shard=shard, d_ff=cfg.d_ff), None
    return x + f, aux


def _rwkv_block(blk: RwkvBlock, x, cfg: ArchConfig, state=None, lx_att=None, lx_cm=None,
                shard: Shard = NO_SHARD):
    """Returns (x, the new state, the two new token-shift carries); training
    starts from no state and no carries (zeros)."""
    out, s_new, lxa = S.rwkv6_mixer(blk.att, L.rms_norm(x, blk.ln1), n_heads=cfg.n_heads,
                                    dh=cfg.d_head, state=state, last_x=lx_att, shard=shard)
    x = x + out
    out, lxc = S.rwkv6_channel_mix(blk.cm, L.rms_norm(x, blk.ln2), last_x=lx_cm, shard=shard,
                                   d_ff=cfg.d_ff)
    return x + out, s_new, lxa, lxc


def _mamba_block(blk: MambaBlock, x, cfg: ArchConfig, state=None, shard: Shard = NO_SHARD):
    """Returns (x, the new state); training starts from no state (zeros)."""
    out, s_new = S.mamba2_mixer(blk.mamba, L.rms_norm(x, blk.ln), n_heads=cfg.n_heads,
                                d_state=cfg.ssm_state, state=state, shard=shard)
    return x + out, s_new


def _patch_prefix(model: LM, patches: torch.Tensor, dtype: torch.dtype,
                  vit_proj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The vlm's ``patches @ vit_proj`` in the promoted dtype (fp32 patches
    against a bf16 projection multiply in fp32, as JAX promotes them), cast
    to the model's dtype. ``vit_proj`` (gathered over the data axes under a
    train shard) replaces the model's."""
    vit_proj = model.vit_proj if vit_proj is None else vit_proj
    ct = torch.promote_types(patches.dtype, vit_proj.dtype)
    return (patches.to(ct) @ vit_proj.to(ct)).to(dtype)


def _head(model: LM, cfg: ArchConfig, shard: Shard = NO_SHARD) -> torch.Tensor:
    if cfg.tie_embeddings:
        return model.embed.T
    return _leaf(model, "head", shard)


def _leaf(model: LM, name: str, shard: Shard) -> torch.Tensor:
    """Parameter ``name`` as the layers read it: gathered over the data axes
    into its serve-layout piece under a train shard (``Shard.fsdp_gather``),
    else itself."""
    p = model.get_parameter(name)
    return shard.fsdp_gather([p], [shard.fsdp_dim(name)])[0]


def _gathered(module: nn.Module, prefix: str, shard: Shard) -> types.SimpleNamespace:
    """A block's leaves as the layers read them: each gathered over the data
    axes into its serve-layout piece under a train shard, in one
    ``Shard.fsdp_gather`` (one collective per dtype), as a namespace with the
    block's attributes (``ln1``, ``attn``: a dict of its leaves, ...)."""
    named = list(module.named_parameters(prefix=prefix))
    whole = shard.fsdp_gather([p for _, p in named], [shard.fsdp_dim(n) for n, _ in named])
    ns: Dict[str, Any] = {}
    for (name, _), t in zip(named, whole):
        head, _, leaf = name[len(prefix) + 1:].partition(".")
        if leaf:
            ns.setdefault(head, {})[leaf] = t
        else:
            ns[head] = t
    return types.SimpleNamespace(**ns)


def _block_over_ranks(fn, blk: nn.Module, prefix: str, x, cfg: ArchConfig, shard: Shard,
                      *args, **kw):
    """``fn(blk, x, cfg, *args, shard=shard, **kw)`` (:func:`_attn_block`,
    :func:`_rwkv_block`, :func:`_mamba_block`) on a train shard: the
    block's leaves gathered over the data axes first, inside the call (so
    under remat the recompute gathers them again, and no gathered weight
    outlives its block)."""
    return fn(_gathered(blk, prefix, shard), x, cfg, *args, shard=shard, **kw)


def forward_train(
    model: LM,
    cfg: ArchConfig,
    batch: Dict[str, torch.Tensor],
    tp: int = 1,
    remat: bool = True,
    return_hidden: bool = False,
    shard: Shard = NO_SHARD,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), moe_aux_loss ()); the final-normed hidden
    states (B, S, D) in place of the logits if asked.

    ``batch["tokens"]``: (B, S) int; the vlm's ``batch["patches"]`` (B, P,
    D) and whisper's ``batch["frames"]`` (B, S_enc, D), of any float dtype.
    With ``remat`` each block runs under ``torch.utils.checkpoint``
    (non-reentrant): its activations are recomputed in the backward, so on
    the card each of its attentions launches ``flash_attention`` twice per
    training step. As in the JAX package, the hybrid's shared block (after
    every ``shared_every`` Mamba layers, none after the remainder) is not
    rematerialised, whisper's encoder blocks are, and each decoder block
    projects the normed encoder output to its cross K/V inside the block.
    The vlm's patch prefix is dropped after the final norm (text positions
    only). The auxiliary loss is the MoE's, summed over the layers of a
    dense / moe / vlm model (a zero without an MoE).

    Over ranks (``shard`` from ``launch.sharding.shard_for(mode="train")``;
    every family) the model holds the rank's FSDP + TP pieces and the
    batch the rank's rows (``shard.rows_split`` when they are its share;
    whisper's frames follow them). Each block's leaves are gathered over the
    data axes into their serve-layout pieces inside the block's call
    (``_gathered``), the ``head`` and ``vit_proj`` before their use, the
    hybrid's shared block once before its first application (it is not
    rematerialised, so the gathered leaves serve every application and
    their gradient, summed over the applications, is reduce-scattered
    once); the blocks then run the sharded layers and mixers under autograd
    (``models.tp``'s collectives; whisper's encoder output enters each
    decoder block's column-split cross K/V), the vocab-split embedding
    summed over the model group. The logits (not the hidden states) are
    gathered over the vocab.
    """
    dims = model_dims(cfg, tp)
    sharded = _sharded(cfg, tp, shard)
    tokens = batch["tokens"]
    x = _embed_tp(model, cfg, tokens, shard) if sharded else model.embed[tokens]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    fam = cfg.family

    def run(fn, blk, prefix, x, *args, **kw):
        """``fn(blk, x, cfg, *args, **kw)``, over ranks through
        :func:`_block_over_ranks`, under remat if asked."""
        if sharded:
            fn, args = _block_over_ranks, (fn, blk, prefix, x, cfg, shard) + args
        else:
            args = (blk, x, cfg) + args
        if remat:
            return checkpoint(fn, *args, use_reentrant=False, **kw)
        return fn(*args, **kw)

    if fam == "vlm":
        vit = _leaf(model, "vit_proj", shard) if sharded else model.vit_proj
        x = torch.cat([_patch_prefix(model, batch["patches"], x.dtype, vit), x], dim=1)
    if fam in ("dense", "moe", "vlm"):
        for i, blk in enumerate(model.blocks):
            x, a = run(_attn_block, blk, f"blocks.{i}", x, dims)
            if cfg.moe:
                aux = aux + a
    elif fam == "ssm":
        for i, blk in enumerate(model.blocks):
            x = run(_rwkv_block, blk, f"blocks.{i}", x)[0]
    elif fam == "hybrid":
        shared, sh = model.shared, NO_SHARD
        if sharded and cfg.n_layers >= cfg.shared_every:
            shared, sh = _gathered(model.shared, "shared", shard), shard
        for i, blk in enumerate(model.blocks):
            x = run(_mamba_block, blk, f"blocks.{i}", x)[0]
            if (i + 1) % cfg.shared_every == 0:
                x, _ = _attn_block(shared, x, cfg, dims, shard=sh)
    elif fam == "encdec":
        enc = batch["frames"].to(x.dtype)
        for i, blk in enumerate(model.enc_blocks):
            enc, _ = run(_attn_block, blk, f"enc_blocks.{i}", enc, dims, causal=False)
        enc = L.rms_norm(enc, model.enc_ln_f)
        for i, blk in enumerate(model.blocks):
            x, _ = run(_attn_block, blk, f"blocks.{i}", x, dims, enc_out=enc)
    else:
        raise ValueError(f"repro_torch.models.lm: unknown family {fam!r}")

    x = L.rms_norm(x, model.ln_f)
    if fam == "vlm":
        x = x[:, batch["patches"].shape[1]:]  # text positions only
    if return_hidden:
        return x, aux
    head = _head(model, cfg, shard)
    split = sharded and head.shape[1] < cfg.vocab
    if split:
        return shard.all_gather(shard.enter(x) @ head, -1), aux
    return x @ head, aux


def loss_fn(
    model: LM,
    cfg: ArchConfig,
    batch: Dict[str, torch.Tensor],
    tp: int = 1,
    remat: bool = True,
    aux_weight: float = 0.01,
    shard: Shard = NO_SHARD,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (+ MoE aux): (loss, dict(ce, moe_aux)), the
    JAX keys. ``batch["tokens"]``: (B, S+1); ``patches`` / ``frames`` as
    :func:`forward_train` takes them.

    Over ranks each rank computes the loss of its rows (the MoE's aux over
    the whole batch's plan), and the three values returned are their means
    over the data group (``Shard.data_mean``, one all-reduce): the whole
    batch's loss, equal on every rank, whose backward gives each rank 1/dp
    of its rows' gradient. A vocab-split head's chunks gather their logits
    over the vocab (``_chunk_loss``)."""
    sharded = _sharded(cfg, tp, shard)
    tokens = batch["tokens"]
    hidden, aux = forward_train(model, cfg, dict(batch, tokens=tokens[:, :-1]), tp=tp,
                                remat=remat, return_hidden=True, shard=shard)
    head = _head(model, cfg, shard)
    split = sharded and head.shape[1] < cfg.vocab
    ce = _chunked_ce(hidden, head, tokens[:, 1:], remat=remat, shard=shard if split else NO_SHARD)
    loss = ce + aux_weight * aux
    if sharded and shard.dp > 1:
        loss, ce, aux = shard.data_mean(torch.stack([loss, ce, aux])).unbind()
    return loss, dict(ce=ce, moe_aux=aux)


@torch.no_grad()
def reduce_grads(model: LM, shard: Shard) -> None:
    """After ``loss_fn(..., shard=).backward()``: the gradients of the
    leaves not split over the data axes (``embed``'s ``("model", None)``, the
    norms, a dim the rules left whole) summed over the data group, in place,
    packed into one all-reduce per dtype; the FSDP-split leaves' were
    reduce-scattered by their gathers' backward. With a data axis of 1,
    nothing."""
    if shard.dp == 1:
        return
    for name, p in model.named_parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    shard.data_sum([p.grad for name, p in model.named_parameters()
                    if shard.fsdp_dim(name) is None])


def attention_calls(cfg: ArchConfig, remat: bool = True) -> Tuple[int, int]:
    """(flash_attention launches, attention backward calls) of one training
    step of ``cfg`` (:func:`loss_fn` + ``backward()``): one backward call
    per attention; one launch per attention, and one more for each that
    ``remat`` recomputes — every attention but the hybrid's shared block.
    Whisper's decoder layers each hold a self- and a cross-attention."""
    if cfg.family == "hybrid":
        n = cfg.n_layers // cfg.shared_every
        return n, n
    n = {"encdec": cfg.n_enc_layers + 2 * cfg.n_layers, "ssm": 0}.get(cfg.family, cfg.n_layers)
    return (2 if remat else 1) * n, n


def _chunk_loss(x_c: torch.Tensor, head: torch.Tensor, y_c: torch.Tensor,
                shard: Shard = NO_SHARD) -> torch.Tensor:
    """A chunk's summed CE. Under a ``shard`` the ``head`` holds this rank's
    columns of the vocab: the chunk's hidden states enter the split product
    (``Shard.enter``) and its logits are gathered over the vocab (the
    backward keeps the rank's columns), so every rank takes the CE over the
    whole vocab row, as one device does."""
    # staticcheck: disable=SC002 torch.utils.checkpoint runs eagerly: shard is a frozen context, never traced
    if shard.tp > 1:
        logits = shard.all_gather(shard.enter(x_c) @ head, -1).float()
    else:
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
    shard: Shard = NO_SHARD,
) -> torch.Tensor:
    """Sequence-chunked cross-entropy, mean over the B·S tokens.

    The head product and the CE run per chunk of ⌈S / n⌉ positions with
    fp32 logits; with ``remat`` each chunk is checkpointed, so only one
    (B, S/n, V) slice of logits is live, in the forward and in the backward.
    The gold logit is a ``gather``, equal to the JAX package's one-hot sum.
    A ``shard`` means a vocab-split ``head`` (:func:`_chunk_loss`).
    """
    b, s, _ = hidden.shape
    n_chunks = min(n_chunks, s)
    cs = -(-s // n_chunks)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, cs):
        hi = min(s, lo + cs)
        args = (hidden[:, lo:hi], head, labels[:, lo:hi], shard)
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
    frames: Optional[torch.Tensor] = None,  # (B, S_enc, D): whisper's prefill
    patches: Optional[torch.Tensor] = None,  # (B, P, D): the vlm's prefill
    shard: Shard = NO_SHARD,
) -> Tuple[torch.Tensor, Cache]:
    """Returns (logits (B, T, V), cache).

    The cache is updated **in place** and returned as the same object,
    where the JAX function returns a new one: each layer's K and V are
    written at ``pos``, the SSM states and token-shift carries overwritten.
    One entry is *replaced* rather than written: whisper's prefill
    (``frames`` given) runs the encoder and sets ``cache["xkv"]`` to a new
    pair of (n_layers, B, KV, S_enc, Dh) tensors, the encoder output's
    cross-attention K and V at the frames' length — the zero buffer
    ``init_cache`` sized at ``max_seq // 2`` would make decode attend zeros,
    unmasked. A vlm prefill (``patches`` given) prepends ``patches @
    vit_proj`` to the tokens (the cache holds ``vlm_patches + max_seq``
    positions; decode positions count the patches) and returns the text
    positions' logits only.

    On a CUDA model every attention over a fresh segment launches
    ``flash_attention``: one launch per layer in a dense / moe / vlm
    prefill, one per application of the shared block in a hybrid prefill,
    and in encdec one per encoder layer and two per decoder layer (self and
    cross) in prefill, one per decoder layer (cross) in decode. A decode
    step's self-attention over the cache is plain torch.

    Under a ``shard`` (``model`` and ``cache`` this rank's, from
    :class:`LM` / :func:`init_cache` with the same shard; ``tokens``,
    ``patches`` and ``frames`` the rank's rows of the batch) a vocab-split
    ``embed`` looks up the rank's rows (ids outside them give zeros) and
    sums over the model group; the blocks run as ``layers`` and ``ssm``
    describe, at the rank's heads; a vocab-split head's logits are gathered
    along the vocab in model coordinate order (a head the rules left whole,
    as whisper's vocab of 51,865 is, is not gathered). Every rank returns
    the whole logits of its rows. Whisper's prefill projects each decoder
    layer's cross K/V with the rank's ``xattn`` columns; its cross calls
    run flash on them at the encoder's full length, and ``cache["xkv"]``
    keeps the rank's positions of the frames, all heads (gathered): those
    of [r·⌈S_enc/tp⌉, (r+1)·⌈S_enc/tp⌉) below S_enc, none on a rank past
    the end. A decode step's cross-attention then merges the slices over
    the ranks in plain torch: at tp > 1 a whisper decode step launches no
    flash.

    Under a train shard (FSDP + TP pieces: JAX's default layout for a
    serving cell of its dry run, whose GSPMD gathers the weights in the
    step) each block's leaves are gathered over the data axes into their
    serve-layout pieces before the block runs (the hybrid's shared block
    once), and the ``head``, ``vit_proj`` and whisper's cross K/V
    projections before their use.
    """
    dims = model_dims(cfg, tp)
    pos = int(pos)
    fam = cfg.family
    sharded = _sharded(cfg, tp, shard)
    if sharded and fam == "encdec":
        if frames is None and tokens.shape[1] > 1:
            raise ValueError("repro_torch.models.lm.forward_cached: a sharded encdec call over "
                             "more than one token is a prefill and needs frames")
    fsdp = sharded and shard.mode == "train" and shard.dp > 1

    def whole(blk, prefix):
        return _gathered(blk, prefix, shard) if fsdp else blk

    x = _embed_tp(model, cfg, tokens, shard) if sharded else model.embed[tokens]
    if fam == "vlm" and patches is not None:
        x = torch.cat([_patch_prefix(model, patches, x.dtype, _leaf(model, "vit_proj", shard)), x],
                      dim=1)

    if fam in ("dense", "moe", "vlm"):
        ck, cv = cache["kv"]
        for i, blk in enumerate(model.blocks):
            x, _ = _attn_block(whole(blk, f"blocks.{i}"), x, cfg, dims, (ck[i], cv[i]), pos,
                               shard=shard)
    elif fam == "ssm":
        s, lxa, lxc = cache["s"], cache["lx_att"], cache["lx_cm"]
        for i, blk in enumerate(model.blocks):
            x, s[i], lxa[i], lxc[i] = _rwkv_block(whole(blk, f"blocks.{i}"), x, cfg, s[i], lxa[i],
                                                  lxc[i], shard=shard)
    elif fam == "hybrid":
        s, se = cache["s"], cfg.shared_every
        shared = whole(model.shared, "shared") if cfg.n_layers >= se else None
        for i, blk in enumerate(model.blocks):
            x, s[i] = _mamba_block(whole(blk, f"blocks.{i}"), x, cfg, s[i], shard=shard)
            if (i + 1) % se == 0:  # the last n_layers % se layers have no shared block after them
                x, _ = _attn_block(shared, x, cfg, dims, cache["kv"][i // se], pos, shard=shard)
    elif fam == "encdec":
        fresh = None
        if frames is not None:
            enc = frames.to(x.dtype)
            for i, blk in enumerate(model.enc_blocks):
                enc, _ = _attn_block(whole(blk, f"enc_blocks.{i}"), enc, cfg, dims, causal=False,
                                     shard=shard)
            enc = L.rms_norm(enc, model.enc_ln_f)
            b, te = enc.shape[:2]

            def proj(w):
                return (enc @ w).reshape(b, te, w.shape[1] // dims.dh, dims.dh).transpose(1, 2)

            fresh = [tuple(proj(_leaf(model, f"blocks.{i}.xattn.{name}", shard))
                           for name in ("wk", "wv")) for i in range(len(model.blocks))]
            cache["xkv"] = tuple(torch.stack([kv[j] for kv in fresh]) for j in (0, 1))
            if sharded:
                cache["xkv"] = _cross_cache(cache["xkv"], dims, shard)
        (ck, cv), (xk, xv) = cache["kv"], cache["xkv"]
        for i, blk in enumerate(model.blocks):
            xkv = fresh[i] if sharded and tokens.shape[1] > 1 else (xk[i], xv[i])
            x, _ = _attn_block(whole(blk, f"blocks.{i}"), x, cfg, dims, (ck[i], cv[i]), pos,
                               xattn_kv=xkv, shard=shard)
    else:
        raise ValueError(f"repro_torch.models.lm: unknown family {fam!r}")

    if fam == "vlm" and patches is not None:
        x = x[:, patches.shape[1]:]  # text positions only
    x = L.rms_norm(x, model.ln_f)
    logits = x @ _head(model, cfg, shard)
    if sharded and logits.shape[-1] < cfg.vocab:
        logits = shard.all_gather(logits, -1)
    return logits, cache


def _cross_cache(xkv, dims: ModelDims, shard: Shard):
    """The rank's part of the cross K/V cache from its projections (each
    (L, B, KVl, S_enc, Dh): its KV heads under 'shard', all of them
    otherwise): the heads gathered over the model group, then its positions
    of the sequence, [r·S_l, (r+1)·S_l) with S_l = ⌈S_enc / tp⌉, cut at
    S_enc (``launch.sharding``'s cache layout: every position held is a
    frame, and a rank past the end holds none)."""
    out = []
    for z in xkv:
        if z.shape[2] < dims.kv:
            z = shard.all_gather(z, 2)
        n = z.shape[3]
        s_l = -(-n // shard.tp)
        lo = min(shard.model_rank * s_l, n)
        out.append(z[:, :, :, lo:min(lo + s_l, n)].clone())
    return tuple(out)


def _embed_tp(model: LM, cfg: ArchConfig, tokens: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The embedding of ``tokens`` from a vocab-split ``embed``: the rank's
    rows, zeros for ids outside them, summed over the model group (one rank
    adds a row, the others zeros: exact). A whole ``embed`` is looked up."""
    rows = model.embed.shape[0]
    if rows == cfg.vocab:
        return model.embed[tokens]
    local = tokens.long() - shard.model_rank * rows
    inside = (local >= 0) & (local < rows)
    x = model.embed[local.clamp(0, rows - 1)].masked_fill(~inside[..., None], 0)
    return shard.all_reduce(x)
