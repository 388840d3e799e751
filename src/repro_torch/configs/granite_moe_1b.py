"""Granite-3.0-1B-A400M — 32-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv=8,
    d_head=64,
    d_ff=512,
    vocab=49155,
    moe=MoEConfig(n_experts=32, top_k=8),
    notes="fine-grained experts; EP-shardable (32 % 16 == 0)",
)
