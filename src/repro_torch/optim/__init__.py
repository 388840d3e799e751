"""Optimizer substrate of the port: AdamW + schedule + gradient compression
(counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import adamw_init, adamw_update, cosine_schedule, global_norm
from repro_torch.optim.compress import topk_compress_allreduce

__all__ = [
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
    "topk_compress_allreduce",
]
