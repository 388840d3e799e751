"""State carried across between the two packages, as numpy arrays.

The system has no weights: its state is the ADWISE scan carry and the
partitioned graph. These functions turn their fields, taken out of either
package as numpy arrays, into the port's types and back, so a test can
start both packages from the same mid-stream state.

The port's carry keeps a scatter-dump row W on the three lazy-traversal
caches (``cached_rcs``, ``cached_ver_u``, ``cached_ver_v``), where the JAX
step pads and slices per step; :func:`carry_from_numpy` adds it and
:func:`carry_to_numpy` strips it, so the numpy side always has the JAX
package's shapes.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core.adwise import Carry
from repro_torch.engine import partitioned

__all__ = ["carry_from_numpy", "carry_to_numpy", "partitioned_graph_from_numpy"]

_PADDED = {"cached_rcs": 0.0, "cached_ver_u": -1, "cached_ver_v": -1}
_DTYPES = {
    "replicas": torch.bool, "win_valid": torch.bool, "last_grew": torch.bool,
    "lam": torch.float32, "cached_rcs": torch.float32, "theta": torch.float32,
    "sum_g": torch.float32, "avg_g_prev": torch.float32,
    "budget_left": torch.float32, "lat_ema": torch.float32,
    "cost_per_score": torch.float32, "base_cost": torch.float32,
}


def carry_from_numpy(fields: Dict[str, np.ndarray], device=None) -> Carry:
    """A port :class:`~repro_torch.core.adwise.Carry` on ``device`` from the
    JAX ``Carry``'s fields (one instance, no batch axis) as numpy arrays."""
    dev = compat.resolve_device(device)
    missing = set(Carry._fields) - set(fields)
    if missing:
        raise KeyError(f"carry_from_numpy: missing fields {sorted(missing)}")
    out = {}
    for name in Carry._fields:
        a = np.asarray(fields[name])
        if name in _PADDED:
            pad = np.full((1,) + a.shape[1:], _PADDED[name], a.dtype)
            a = np.concatenate([a, pad])
        dtype = _DTYPES.get(name, torch.int32)
        out[name] = torch.tensor(a, device=dev).to(dtype)
    return Carry(**out)


def carry_to_numpy(carry: Carry) -> Dict[str, np.ndarray]:
    """The carry's fields as numpy arrays, in the JAX ``Carry``'s shapes."""
    out = {}
    for name, t in zip(Carry._fields, carry):
        a = t.detach().cpu().numpy()
        out[name] = a[:-1] if name in _PADDED else a
    return out


def partitioned_graph_from_numpy(
    edges: np.ndarray,  # (k, e_max, 2) int
    evalid: np.ndarray,  # (k, e_max) bool
    replicas: np.ndarray,  # (V, k) bool
    masters: np.ndarray,  # (V,) int
    degrees: np.ndarray,  # (V,) int
    num_vertices: int,
    k: int,
    device=None,
) -> partitioned.PartitionedGraph:
    """A port PartitionedGraph from the JAX ``PartitionedGraph``'s fields
    (builds the destination-sorted message layout the engine gathers with)."""
    return partitioned.from_arrays(
        np.asarray(edges, np.int32), np.asarray(evalid, bool),
        np.asarray(replicas, bool), np.asarray(masters, np.int32),
        np.asarray(degrees, np.int32), num_vertices, k,
        compat.resolve_device(device),
    )
