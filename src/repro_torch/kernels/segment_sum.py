"""``segment_sum``: the engine's edge→vertex accumulation kernel on Hopper.

Replaces the TPU kernel ``segment_sum_pallas`` + ``_kernel`` of the JAX
package (``src/repro/kernels/segment_sum.py``), which pads destination-sorted
rows into 512-edge chunks per 128-row output block for an MXU one-hot matmul.
On Hopper the natural form is a sorted-run reduction. The host turns the
sorted segment ids into a :class:`SegmentLayout` once per graph
(:func:`segment_layout`, with the input checks of the JAX package's
``csr_block_layout``): each segment's run cut into chunks of at most
``CHUNK_ROWS`` rows. ``csrc/segment_sum.cu`` sums every chunk with one warp,
then adds the chunks of each split segment in a fixed order — fp32, no
atomics, deterministic, and a hub vertex spread over many warps. Its header
states the bound (memory: E·D input values read, S·D floats written).

The plain version is :func:`~repro_torch.kernels.ref.segment_sum_ref`, bound
here as ``segment_sum_plain``; ``kernels.ops`` sends CPU tensors to it.
``LAUNCHES`` counts calls of the kernel's launcher (one per call, which
runs both passes; see ``kernels/window_score.py`` for how CUDA-graph replays
are credited).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import segment_sum_ref as segment_sum_plain

__all__ = [
    "CHUNK_ROWS",
    "SegmentLayout",
    "segment_layout",
    "segment_offsets",
    "segment_sum",
    "segment_sum_plain",
    "LAUNCHES",
    "REPLACES",
]

REPLACES = "src/repro/kernels/segment_sum.py:143"  # segment_sum_pallas
LAUNCHES = 0
CAPTURED = 0
# Rows per chunk: a warp's share of one segment. Long runs (hub vertices)
# split into many chunks, short ones stay one chunk and skip the second pass.
CHUNK_ROWS = 32

_DTYPES = {torch.float32: 0, torch.float16: 1}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("segment_sum")
        fn = lib.segment_sum_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, p, p, i, p, p, i, p, p, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def segment_offsets(seg_ids: np.ndarray, num_segments: int) -> np.ndarray:
    """Host layout: int32 (S+1,) row offsets of each segment's run.

    ``seg_ids`` must be 1-D, sorted ascending and in ``[0, num_segments)``;
    anything else raises the same ``ValueError`` as the JAX package's
    ``csr_block_layout``, naming the offending position. Empty input is
    legal (all runs empty).
    """
    seg_ids = np.asarray(seg_ids)
    if seg_ids.ndim != 1:
        raise ValueError(
            f"segment_offsets: seg_ids must be 1-D, got shape {seg_ids.shape}"
        )
    if num_segments < 1:
        raise ValueError(
            f"segment_offsets: num_segments must be >= 1, got {num_segments}"
        )
    if seg_ids.size:
        drop = np.diff(seg_ids) < 0
        if drop.any():
            i = int(np.argmax(drop))
            raise ValueError(
                "segment_offsets: segment ids must be sorted ascending; "
                f"seg_ids[{i}]={int(seg_ids[i])} > "
                f"seg_ids[{i + 1}]={int(seg_ids[i + 1])}"
            )
        bad = (seg_ids < 0) | (seg_ids >= num_segments)
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                "segment_offsets: segment ids must lie in "
                f"[0, {num_segments}); seg_ids[{i}]={int(seg_ids[i])}"
            )
    if seg_ids.size >= 2**31:
        raise ValueError("segment_offsets: more than 2^31 - 1 rows")
    offs = np.searchsorted(seg_ids, np.arange(num_segments + 1), side="left")
    return offs.astype(np.int32)


class SegmentLayout(NamedTuple):
    """Where each row of a segment-sorted (E, D) array goes, on one device.

    seg_ids: (E,) int32 — the sorted segment id of every row (the plain
      version's input, and the engine's message destinations).
    chunk_row: (C+1,) int32 — chunk c covers rows chunk_row[c] ..
      chunk_row[c+1]; chunks never straddle a segment and every segment has
      at least one (an empty segment one empty chunk).
    chunk_out: (C,) int32 — the output row of a segment's only chunk, or
      ``-(p + 1)`` for partial row p of a segment cut into several chunks.
    multi_seg: (M,) int32 — the segments cut into several chunks.
    multi_ptr: (M+1,) int32 — segment multi_seg[m]'s partial rows, in chunk
      order: multi_ptr[m] .. multi_ptr[m+1].
    num_segments, num_partials: S and multi_ptr[-1], on the host.
    """

    seg_ids: torch.Tensor
    chunk_row: torch.Tensor
    chunk_out: torch.Tensor
    multi_seg: torch.Tensor
    multi_ptr: torch.Tensor
    num_segments: int
    num_partials: int

    @property
    def device(self) -> torch.device:
        return self.seg_ids.device


def segment_layout(
    seg_ids: np.ndarray, num_segments: int, device, chunk_rows: int = CHUNK_ROWS,
) -> SegmentLayout:
    """Host layout of sorted ``seg_ids`` for :func:`segment_sum`, on
    ``device``. Raises as :func:`segment_offsets` does on ids that are not
    1-D, sorted and in ``[0, num_segments)``."""
    if chunk_rows < 1:
        raise ValueError(f"segment_layout: chunk_rows must be >= 1, got {chunk_rows}")
    seg_ids = np.asarray(seg_ids)
    offs = segment_offsets(seg_ids, num_segments).astype(np.int64)
    runs = np.diff(offs)
    n_chunks = np.maximum(1, -(-runs // chunk_rows))
    chunk_seg = np.repeat(np.arange(num_segments), n_chunks)
    first = np.cumsum(n_chunks) - n_chunks
    in_seg = np.arange(len(chunk_seg)) - np.repeat(first, n_chunks)
    chunk_row = np.append(offs[chunk_seg] + in_seg * chunk_rows, offs[-1])
    split = (n_chunks > 1)[chunk_seg]
    slot = np.cumsum(split) - 1
    chunk_out = np.where(split, -(slot + 1), chunk_seg)
    multi_seg = np.flatnonzero(n_chunks > 1)
    multi_ptr = np.concatenate([[0], np.cumsum(n_chunks[multi_seg])])

    def put(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return SegmentLayout(
        seg_ids=put(seg_ids), chunk_row=put(chunk_row), chunk_out=put(chunk_out),
        multi_seg=put(multi_seg), multi_ptr=put(multi_ptr),
        num_segments=int(num_segments), num_partials=int(multi_ptr[-1]),
    )


def segment_sum(data: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """(S, D) fp32 sums of the rows of each segment of ``layout``.

    ``data``: (E, D) float32 or float16, contiguous, rows sorted by segment;
    ``layout``: from :func:`segment_layout` for these E rows, on the same card.
    """
    global LAUNCHES, CAPTURED
    if not isinstance(data, torch.Tensor) or not isinstance(layout, SegmentLayout):
        raise TypeError("segment_sum: data must be a tensor and layout a SegmentLayout")
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"segment_sum: the kernel takes CUDA tensors, got {dev}")
    if layout.device != dev:
        raise ValueError(f"segment_sum: layout on {layout.device}, data on {dev}")
    if data.dim() != 2:
        raise ValueError(f"segment_sum: data must be (E, D), got shape {tuple(data.shape)}")
    if data.dtype not in _DTYPES:
        raise TypeError(f"segment_sum: data must be float32 or float16, got {data.dtype}")
    if data.shape[0] != layout.seg_ids.shape[0]:
        raise ValueError(
            f"segment_sum: data has {data.shape[0]} rows, the layout "
            f"{layout.seg_ids.shape[0]}"
        )
    if not data.is_contiguous():
        raise ValueError("segment_sum: data must be contiguous")
    d = data.shape[1]
    s = layout.num_segments
    out = torch.empty((s, d), dtype=torch.float32, device=dev)
    if d == 0:
        return out
    partial = torch.empty((layout.num_partials, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            data.data_ptr(), _DTYPES[data.dtype], d,
            layout.chunk_row.data_ptr(), layout.chunk_out.data_ptr(),
            layout.chunk_out.shape[0],
            layout.multi_seg.data_ptr(), layout.multi_ptr.data_ptr(),
            layout.multi_seg.shape[0],
            partial.data_ptr(), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"segment_sum: kernel launch failed (cudaError {err})")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED += 1
    else:
        LAUNCHES += 1
    return out
