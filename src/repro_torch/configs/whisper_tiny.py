"""Whisper-tiny — enc-dec; conv frontend is a stub (precomputed frame
embeddings via input_specs) [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,           # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv=6,
    d_head=64,
    d_ff=1536,
    vocab=51865,
    notes="audio backbone only; 6 heads -> attention replicated over TP axis",
)
