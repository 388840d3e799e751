"""Deterministic synthetic token pipeline — a copy of ``repro.data.pipeline``
(numpy only), so its batches are bit-equal to the JAX package's.

Production frameworks must feed every data-parallel shard a disjoint,
deterministic, resumable stream. This pipeline derives each example from
(seed, step, global_example_index) with a counter-based generator so that:
  * restarts resume bit-exactly from the checkpointed step,
  * elastic re-meshes re-slice the same global batch order (a host only
    needs its new index range),
  * no host ever materializes another host's shard.

Token sequences are Zipf-distributed (vocab skew like natural text) with a
deterministic per-example offset so the loss is learnable (next-token
structure exists: tokens follow arithmetic progressions modulo vocab).
The batches are numpy arrays; the trainer moves them to its device.
``make_batch_spec`` gives a batch's stand-ins as ``meta``-device tensors
(shapes and dtypes, no storage), where the JAX package gives
``ShapeDtypeStruct``s.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig

__all__ = ["SyntheticTokens", "make_batch_spec"]

_K1 = np.uint64(0x9E3779B97F4A7C15)
_K2 = np.uint64(0xBF58476D1CE4E5B9)
_K3 = np.uint64(0x94D049BB133111EB)


def _splitmix(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — counter-based randomness, vectorized."""
    x = (x + _K1).astype(np.uint64)
    x ^= x >> np.uint64(30)
    x *= _K2
    x ^= x >> np.uint64(27)
    x *= _K3
    x ^= x >> np.uint64(31)
    return x


def _uniform(seed: int, step: int, idx: np.ndarray, pos: np.ndarray,
             salt: int) -> np.ndarray:
    """u ∈ (0,1) keyed by (seed, step, example, position, salt) — the value of
    any (example, position) cell never depends on which shard computes it."""
    with np.errstate(over="ignore"):  # uint64 wraparound is intentional
        h = _splitmix(
            np.uint64(seed) * _K2
            ^ np.uint64(step) * _K3
            ^ np.uint64(salt) * _K1
            ^ (idx.astype(np.uint64) << np.uint64(20))
            ^ pos.astype(np.uint64)
        )
    return ((h >> np.uint64(11)).astype(np.float64) + 0.5) * 2.0**-53


def _zipf_like(u: np.ndarray, a: float = 1.3) -> np.ndarray:
    """Inverse-transform Zipf-ish skew (heavier head than uniform)."""
    return np.floor(np.minimum(u ** (-1.0 / (a - 1.0)), 2**31)).astype(np.int64)


def _normal(seed, step, idx, pos, salt):
    u1 = _uniform(seed, step, idx, pos, salt)
    u2 = _uniform(seed, step, idx, pos, salt + 101)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2 * np.pi * u2)


class SyntheticTokens:
    """Iterator of training batches for an (arch, shape) cell.

    Args:
      cfg / shape: architecture and input-shape cell.
      seed: global data seed.
      shard: (index, count) — this host's slice of the global batch.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        shape: ShapeConfig,
        seed: int = 0,
        shard: tuple[int, int] = (0, 1),
    ):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.shard_idx, self.shard_count = shard
        assert shape.global_batch % self.shard_count == 0
        self.local_batch = shape.global_batch // self.shard_count

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg, shp = self.cfg, self.shape
        b, s = self.local_batch, shp.seq_len
        lo = self.shard_idx * b
        idx = np.arange(lo, lo + b, dtype=np.int64)[:, None]
        pos = np.arange(s + 1, dtype=np.int64)[None, :]
        # Zipf-skewed base tokens + per-example deterministic progression
        # (so a next-token structure exists and the loss is learnable).
        base = _zipf_like(_uniform(self.seed, step, idx, pos, 1))
        prog = idx * 7 + pos * 3
        tokens = ((base + prog) % cfg.vocab).astype(np.int32)
        out: Dict[str, np.ndarray] = {"tokens": tokens}
        if cfg.family == "encdec":
            fpos = np.arange(max(s // 2, 1) * cfg.d_model, dtype=np.int64)[None, :]
            out["frames"] = _normal(self.seed, step, idx, fpos, 2).reshape(
                b, max(s // 2, 1), cfg.d_model
            ).astype(np.float32)
        if cfg.family == "vlm":
            ppos = np.arange(cfg.vlm_patches * cfg.d_model, dtype=np.int64)[None, :]
            out["patches"] = _normal(self.seed, step, idx, ppos, 3).reshape(
                b, cfg.vlm_patches, cfg.d_model
            ).astype(np.float32)
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_batch_spec(
    cfg: ArchConfig, shape: ShapeConfig, extra_token: bool = True
) -> Dict[str, torch.Tensor]:
    """A global batch's stand-ins on the ``meta`` device (no allocation):
    ``tokens`` (B, S [+ 1]) int32, whisper's ``frames`` (B, max(S // 2, 1),
    D) and the vlm's ``patches`` (B, vlm_patches, D) float32."""
    b, s = shape.global_batch, shape.seq_len

    def meta(*dims, dtype=torch.float32):
        return torch.empty(dims, dtype=dtype, device="meta")

    spec = {"tokens": meta(b, s + (1 if extra_token else 0), dtype=torch.int32)}
    if cfg.family == "encdec":
        spec["frames"] = meta(b, max(s // 2, 1), cfg.d_model)
    if cfg.family == "vlm":
        spec["patches"] = meta(b, cfg.vlm_patches, cfg.d_model)
    return spec
