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
    def __init__(self, root: str, keep: int = 3, async_write: bool = True):
        self.root = root
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    # -- writing ------------------------------------------------------------

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None) -> None:
        self.wait()
        leaves = _leaves(tree)
        flat = {k: _host_array(t) for k, t in leaves.items()}  # device→host before thread
        dtypes = {k: _dtype_name(t.dtype) for k, t in leaves.items()}
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, dtypes, meta or {}), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, flat, dtypes, meta or {})

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
        with np.load(os.path.join(d, "arrays.npz")) as z:
            for key, leaf in _leaves(template).items():
                saved = torch.from_numpy(z[key])
                dtype = getattr(torch, manifest["dtypes"][key])
                if dtype in _BITS:
                    saved = saved.view(dtype)
                if tuple(saved.shape) != tuple(leaf.shape):
                    raise ValueError(f"{key}: {tuple(saved.shape)} != {tuple(leaf.shape)}")
                leaf.copy_(saved)
        return template, manifest
