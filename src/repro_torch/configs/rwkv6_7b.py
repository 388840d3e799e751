"""RWKV-6 'Finch' 7B — attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,           # rwkv6 heads = d_model / 64
    n_kv=64,
    d_head=64,
    d_ff=14336,
    vocab=65536,
    supports_long=True,   # linear recurrence: sub-quadratic, runs long_500k
    notes="attn-free linear recurrence; per-channel data-dependent decay",
)
