"""Architecture configuration system (the port's copy).

A copy of the JAX package's ``configs/base.py`` — pure data, so the port
keeps its own instead of importing ``repro``. One `ArchConfig` per
assigned architecture (exact public-literature sizes in
`repro_torch/configs/<id>.py`), consumed by `repro_torch.models.lm` (model
build) and `repro_torch.launch.serve`. `reduced()` yields the CPU-smoke
variant of the same family, the same function as the JAX package's, so
both packages build the same reduced models.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Sequence

__all__ = ["ArchConfig", "MoEConfig", "get_config", "ARCH_IDS", "SHAPES", "ShapeConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Transformer-family architecture description.

    family: 'dense' | 'moe' | 'ssm' (rwkv6) | 'hybrid' (mamba2+shared attn)
            | 'encdec' (whisper) | 'vlm' (internvl)
    layer kinds are derived from the family; `shared_every` controls the
    zamba2 shared-attention cadence.
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 128
    qkv_bias: bool = False
    rope_theta: float = 1e4
    moe: Optional[MoEConfig] = None
    ssm_state: int = 64  # mamba2 state width / rwkv6 head dim
    shared_every: int = 6  # zamba2: shared attn block cadence
    n_enc_layers: int = 0  # whisper encoder depth
    vlm_patches: int = 256  # internvl: image patch tokens (stub frontend)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # Which shape cells apply (long_500k only for sub-quadratic mixers).
    supports_long: bool = False
    has_decoder: bool = True
    notes: str = ""

    @property
    def attn_dims(self) -> tuple[int, int, int]:
        return self.n_heads, self.n_kv, self.d_head

    def padded_heads(self, tp: int) -> tuple[int, int, str]:
        """Resolve the attention TP policy for tensor-parallel degree `tp`.

        Returns (H_pad, KV_pad, policy):
          'shard'     — H and KV divisible: full head sharding.
          'shard_q'   — H divisible, KV replicated across TP.
          'pad'       — H padded to the next multiple of tp (zero extra heads).
          'replicate' — attention replicated over the model axis (tiny archs).
        """
        h, kv = self.n_heads, self.n_kv
        if h % tp == 0 and kv % tp == 0:
            return h, kv, "shard"
        if h % tp == 0:
            return h, kv, "shard_q"
        h_pad = -(-h // tp) * tp
        if h_pad <= h * 1.5:  # ≤50% extra attention FLOPs: pad
            return h_pad, kv, "pad"
        return h, kv, "replicate"

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        h, kv, dh = self.n_heads, self.n_kv, self.d_head
        attn = d * h * dh + 2 * d * kv * dh + h * dh * d
        if self.qkv_bias:
            attn += (h + 2 * kv) * dh
        if self.moe:
            mlp = 3 * d * ff * self.moe.n_experts + d * self.moe.n_experts
        else:
            mlp = 3 * d * ff
        norms = 2 * d
        if self.family == "ssm":  # rwkv6: r,k,v,g,o + decay params per layer
            mix = 5 * d * d + 2 * d + 4 * d * 64  # lora-ish decay/mix params
            per_layer = mix + mlp + norms
        elif self.family == "hybrid":
            d_in = 2 * d  # mamba2 expand=2
            mamba = d * (2 * d_in + 2 * self.ssm_state) + d_in * d + d_in
            n_shared = self.n_layers // self.shared_every
            n_mamba = self.n_layers - n_shared
            return (
                n_mamba * (mamba + norms)
                + (attn + mlp + 2 * norms)  # one shared block
                + v * d * (1 if self.tie_embeddings else 2)
                + d
            )
        else:
            per_layer = attn + mlp + norms
        if self.family in ("ssm",):
            total = self.n_layers * per_layer
        else:
            total = self.n_layers * per_layer
        if self.family == "encdec":
            total += self.n_enc_layers * (attn + mlp + norms) + self.n_layers * (
                attn + norms
            )  # cross-attention blocks
        total += v * d * (1 if self.tie_embeddings else 2) + d
        return int(total)

    def active_param_count(self) -> int:
        """N_active for MoE (experts scaled by top_k/n_experts)."""
        if not self.moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        full_mlp = 3 * d * ff * self.moe.n_experts
        active_mlp = 3 * d * ff * self.moe.top_k
        return int(self.param_count() - self.n_layers * (full_mlp - active_mlp))

    def reduced(self) -> "ArchConfig":
        """CPU-smoke variant: same family/topology, tiny sizes."""
        kw = dataclasses.asdict(self)
        if self.moe:
            # Ample capacity: reduced configs must be drop-free so prefill /
            # decode / train paths are bit-consistent regardless of routing.
            kw["moe"] = MoEConfig(
                min(self.moe.n_experts, 4), min(self.moe.top_k, 2),
                capacity_factor=8.0,
            )
        kw.update(
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else 5),
            d_model=128,
            n_heads=4,
            n_kv=max(1, min(self.n_kv, 2)),
            d_head=32,
            d_ff=256,
            vocab=512,
            ssm_state=16,
            shared_every=2,
            n_enc_layers=min(self.n_enc_layers, 2),
            vlm_patches=8,
            dtype="float32",
            name=self.name + "-smoke",
        )
        return ArchConfig(**kw)


ARCH_IDS = [
    "rwkv6_7b",
    "llama3_2_3b",
    "phi3_mini_3_8b",
    "qwen1_5_110b",
    "qwen1_5_0_5b",
    "zamba2_7b",
    "whisper_tiny",
    "granite_moe_1b",
    "grok_1_314b",
    "internvl2_26b",
]

_ALIASES = {
    "rwkv6-7b": "rwkv6_7b",
    "llama3.2-3b": "llama3_2_3b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen1.5-110b": "qwen1_5_110b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "zamba2-7b": "zamba2_7b",
    "whisper-tiny": "whisper_tiny",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "grok-1-314b": "grok_1_314b",
    "internvl2-26b": "internvl2_26b",
}


def get_config(arch: str) -> ArchConfig:
    mod_name = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
