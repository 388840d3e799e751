"""Grok-1 314B — 8-expert top-2 MoE [hf:xai-org/grok-1]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_head=128,
    d_ff=32768,
    vocab=131072,
    moe=MoEConfig(n_experts=8, top_k=2),
    notes="8 experts: expert-ff TP sharding (8 % 16 != 0 -> no pure EP)",
)
