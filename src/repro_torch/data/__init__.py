"""Deterministic synthetic data pipeline (shard-aware, resumable) — the
port's copy of ``repro.data``."""
from repro_torch.data.pipeline import SyntheticTokens, make_batch_spec

__all__ = ["SyntheticTokens", "make_batch_spec"]
