"""InternVL2-26B — InternViT frontend (stub) + InternLM2 backbone
[arXiv:2404.16821]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_head=128,
    d_ff=16384,
    vocab=92553,
    vlm_patches=256,      # precomputed patch embeddings (stub frontend)
)
