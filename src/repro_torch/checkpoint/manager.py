"""Checkpoint manager: atomic, async, keep-k, resumable — the layout of
``repro.checkpoint.manager`` for trees of torch tensors.

Layout (one directory per step):
  <root>/step_000123.tmp-<pid>/   — written here first
      arrays.npz                  — flattened tree (keypath -> array)
      manifest.json               — step, keypaths, shapes, dtypes, meta
  <root>/step_000123/             — atomic rename on completion

Atomic rename means a crashed writer never corrupts the latest checkpoint;
`latest_step()` only considers fully-renamed directories. Writes can run on a
background thread (async) so the train loop overlaps serialization with
compute; `wait()` joins before the next save or at exit.

A tree is a nested dict with string keys whose leaves are tensors; a leaf's
keypath joins its keys with "/". Differences from the JAX manager, both
because the port's train step updates its state in place:

* `save` copies every tensor to the host before it returns or starts its
  thread, so later in-place updates cannot tear the checkpoint;
* `restore` copies the saved values into the template's own tensors (the
  live parameters, moments, step and residual) and returns the template.

Each array is stored bit-exactly: a bfloat16 tensor (which numpy cannot
hold) as its int16 bit pattern, with the dtype recorded in the manifest.

Over ranks (``pieces``: a state whose leaves are the ranks' pieces, as
training over a mesh holds it) the checkpoint is still the single-host
layout, whole leaves: every rank calls `save`, each piece is gathered to
rank 0 (``torch.distributed.gather`` over the default group), which
assembles the whole leaves on the host and writes them; a leaf not in
``pieces`` (the step) is rank 0's. `restore` waits for rank 0's write,
then every rank reads the whole leaves and copies its pieces back.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import dist as ranks

__all__ = ["CheckpointManager"]

# Tensors numpy cannot hold, stored as an integer view of their bits.
_BITS = {torch.bfloat16: torch.int16}


def _leaves(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if not isinstance(tree, dict):
        raise TypeError(f"checkpoint: leaf {prefix!r} is {type(tree).__name__}, not a tensor")
    out: Dict[str, torch.Tensor] = {}
    for k in sorted(tree):
        out.update(_leaves(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy, taken now."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    return t.numpy()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[1]


class CheckpointManager:
    """``pieces`` (over ranks): keypath ("params/embed", "opt/m/embed", ...)
    -> (the whole leaf's shape, the index of each rank's piece in rank
    order) for every leaf held in pieces."""

    def __init__(self, root: str, keep: int = 3, async_write: bool = True,
                 pieces: Optional[Dict[str, Any]] = None):
        self.root = root
        self.keep = keep
        self.async_write = async_write
        self.pieces = pieces
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    # -- writing ------------------------------------------------------------

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None) -> None:
        self.wait()
        leaves = _leaves(tree)
        if self.pieces is not None:
            flat = self._gathered(leaves)  # whole leaves on rank 0, None elsewhere
            if flat is None:
                return
        else:
            flat = {k: _host_array(t) for k, t in leaves.items()}  # device→host before thread
        dtypes = {k: _dtype_name(t.dtype) for k, t in leaves.items()}
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, dtypes, meta or {}), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, flat, dtypes, meta or {})

    def _gathered(self, leaves: Dict[str, torch.Tensor]) -> Optional[Dict[str, np.ndarray]]:
        """Each leaf whole on rank 0 (None on the other ranks): the ranks'
        pieces gathered to it, placed at their indices."""
        me, world = ranks.rank(), ranks.world_size()
        flat: Dict[str, np.ndarray] = {}
        for key, t in leaves.items():
            if key not in self.pieces:
                if me == 0:
                    flat[key] = _host_array(t)
                continue
            shape, indices = self.pieces[key]
            t = t.detach().contiguous()
            parts = [torch.empty_like(t) for _ in range(world)] if me == 0 else None
            dist.gather(t, parts, dst=0)
            if me == 0:
                first = _host_array(parts[0])
                whole = np.empty(tuple(shape), dtype=first.dtype)
                for idx, part in zip(indices, parts):
                    whole[tuple(idx)] = _host_array(part)
                flat[key] = whole
        return flat if me == 0 else None

    def _write(self, step: int, flat: Dict[str, np.ndarray], dtypes: Dict[str, str],
               meta: Dict) -> None:
        final = os.path.join(self.root, f"step_{step:09d}")
        tmp = f"{final}.tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = dict(
            step=step,
            time=time.time(),
            keys=sorted(flat),
            shapes={k: list(v.shape) for k, v in flat.items()},
            dtypes=dtypes,
            meta=meta,
        )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.pieces is not None:
            ranks.barrier()  # rank 0's write is on disk before any rank reads

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"), ignore_errors=True)

    # -- reading ------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and ".tmp" not in name:
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, template: Any, step: Optional[int] = None) -> tuple[Any, Dict]:
        """Copy the checkpoint into the tensors of ``template`` (shapes
        checked; values converted to each tensor's dtype and device) and
        return (template, manifest)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        d = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        me = ranks.rank()
        with np.load(os.path.join(d, "arrays.npz")) as z:
            for key, leaf in _leaves(template).items():
                saved = torch.from_numpy(z[key])
                dtype = getattr(torch, manifest["dtypes"][key])
                if dtype in _BITS:
                    saved = saved.view(dtype)
                if self.pieces is not None and key in self.pieces:
                    saved = saved[tuple(self.pieces[key][1][me])]
                if tuple(saved.shape) != tuple(leaf.shape):
                    raise ValueError(f"{key}: {tuple(saved.shape)} != {tuple(leaf.shape)}")
                leaf.copy_(saved)
        return template, manifest
