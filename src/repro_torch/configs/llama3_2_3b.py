"""Llama-3.2 3B — dense GQA decoder [hf:meta-llama/Llama-3.2-3B]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv=8,
    d_head=128,
    d_ff=8192,
    vocab=128256,
    rope_theta=5e5,
    tie_embeddings=True,
    notes="RoPE SwiGLU GQA; 24 heads pad to 32 under 16-way TP (see DESIGN.md)",
)
