"""Checkpointing of the port: async, atomic, keep-k, bit-exact resume
(counterpart of ``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
