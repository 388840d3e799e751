"""Zamba2-7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv=32,
    d_head=112,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    shared_every=6,       # one shared attn+MLP block applied every 6 layers
    supports_long=True,   # mamba2 recurrence carries long_500k decode
    notes="mamba2 SSD layers; single shared-weight attention block",
)
