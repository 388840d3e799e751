"""``segment_sum``: the engine's edge→vertex accumulation kernel on Hopper.

Replaces the TPU kernel ``segment_sum_pallas`` + ``_kernel`` of the JAX
package (``src/repro/kernels/segment_sum.py``), which pads destination-sorted
rows into 512-edge chunks per 128-row output block for an MXU one-hot matmul.
On Hopper the natural form is a sorted-run reduction. The host turns the
sorted segment ids into a :class:`SegmentLayout` once per graph
(:func:`segment_layout`, with the input checks of the JAX package's
``csr_block_layout``): the merged list of the E rows and the S segment ends
cut into tiles of ``TILE_ITEMS`` items (merge path), each tile's first row
and first segment, and the segments whose rows cross tiles.
``csrc/segment_sum.cu`` sums every tile with one block in one launch;
a crossing segment's partials go to slots of the layout, and the last tile
to arrive adds them in tile order — fp32, no float atomics, deterministic,
and a hub vertex spread over many blocks. Its header states the bound
(memory: E·D input values read, S·D floats written).

The plain version is :func:`~repro_torch.kernels.ref.segment_sum_ref`, bound
here as ``segment_sum_plain``; ``kernels.ops`` sends CPU tensors to it.
``LAUNCHES`` counts the kernel's launches (one per call; see
``kernels/window_score.py`` for how CUDA-graph replays are credited).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import segment_sum_ref as segment_sum_plain

__all__ = [
    "TILE_ITEMS",
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
# Items (rows + segment ends) per tile: one block's share (256 threads, 8
# items a thread), fixed in the kernel as kTileItems.
TILE_ITEMS = 2048

_DTYPES = {torch.float32: 0, torch.float16: 1}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("segment_sum")
        fn = lib.segment_sum_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, p, p, i, p, p, p, p, p]
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

    The merged list of the E rows and the S segment ends (segment s's end
    follows its last row) is cut into T tiles of ``tile_items`` items; the
    kernel sums each tile with one block. A segment whose rows lie in more
    than one tile is *crossing*: each of its tiles leaves a partial in a
    slot, and the last to arrive adds them in tile order.

    seg_ids: (E,) int32 — the sorted segment id of every row (the plain
      version's input, and the engine's message destinations).
    offsets: (S+1,) int32 — segment s's rows are offsets[s] .. offsets[s+1].
    tiles: (T+1, 4) int32 — per tile: its first row, its first segment (the
      first whose end is in or after the tile), the crossing segment that
      ends in it and the crossing segment open at its end (indices into
      ``cross``, or -1); row T is (E, S, -1, -1).
    cross: (M, 4) int32 — per crossing segment, in segment order: its id,
      its first and last tile, and its number of slots (last - first + 1).
    counters: (M,) int32 — arrivals per crossing segment, 0 between calls.
    slots: width D -> (2, T, D) fp32 — the tiles' tail and head partials;
      the buffer of a width is made at the first call at that width.
    stream: the stream of the first eager launch on the layout, once there
      is one (a list of at most one ``torch.cuda.Stream``).
    num_segments, tile_items: S and the tile size, on the host.

    The counters and slots make the layout the kernel's scratch: calls on
    one layout must run one after another on one stream, as the engine's
    do. An eager call on another stream than the first raises. A call
    captured into a CUDA graph runs on whichever stream replays the graph,
    so the check does not apply to capture; replays of graphs over one
    layout, and a launch cut short (which leaves a counter non-zero), stay
    the caller's to keep apart.
    """

    seg_ids: torch.Tensor
    offsets: torch.Tensor
    tiles: torch.Tensor
    cross: torch.Tensor
    counters: torch.Tensor
    slots: Dict[int, torch.Tensor]
    stream: List[torch.cuda.Stream]
    num_segments: int
    tile_items: int

    @property
    def device(self) -> torch.device:
        return self.seg_ids.device

    @property
    def num_tiles(self) -> int:
        return self.tiles.shape[0] - 1


def _tile_plan(offsets: np.ndarray, tile_items: int):
    """Merge-path tiles of the segment run bounds ``offsets`` (S+1,):
    ``(tiles, cross)`` as :class:`SegmentLayout` holds them, in numpy."""
    offs = np.asarray(offsets, np.int64)
    s = len(offs) - 1
    e = int(offs[-1])
    n_tiles = -(-(e + s) // tile_items)
    # Merged positions: row j sits at j + (segment ends before it), segment
    # s's end at offs[s + 1] + s.
    end_pos = offs[1:] + np.arange(s)
    diag = np.minimum(np.arange(n_tiles + 1) * tile_items, e + s)
    seg0 = np.searchsorted(end_pos, diag, side="left")
    row0 = diag - seg0
    t_last = end_pos // tile_items
    t_first = (offs[:-1] + np.arange(s)) // tile_items
    crossing = np.flatnonzero((np.diff(offs) > 0) & (t_first < t_last))
    tb, te = t_first[crossing], t_last[crossing]
    cross = np.stack([crossing, tb, te, te - tb + 1], 1)
    m_in = np.full(n_tiles + 1, -1)
    m_in[te] = np.arange(len(crossing))
    # A crossing segment is open at the end of its tiles tb .. te - 1.
    spans = te - tb
    m_out = np.full(n_tiles + 1, -1)
    m_out[np.repeat(tb - np.cumsum(spans) + spans, spans) + np.arange(spans.sum())] = (
        np.repeat(np.arange(len(crossing)), spans))
    tiles = np.stack([row0, seg0, m_in, m_out], 1)
    return tiles.astype(np.int32), cross.reshape(-1, 4).astype(np.int32)


def segment_layout(
    seg_ids: np.ndarray, num_segments: int, device, tile_items: int = TILE_ITEMS,
) -> SegmentLayout:
    """Host layout of sorted ``seg_ids`` for :func:`segment_sum`, on
    ``device``. Raises as :func:`segment_offsets` does on ids that are not
    1-D, sorted and in ``[0, num_segments)``. The kernel takes only
    ``TILE_ITEMS``; the plan itself (and the plain version) takes any size
    >= 1, with which the CPU tests reach its edge cases at small sizes."""
    if tile_items < 1:
        raise ValueError(f"segment_layout: tile_items must be >= 1, got {tile_items}")
    seg_ids = np.asarray(seg_ids)
    offs = segment_offsets(seg_ids, num_segments)
    if len(seg_ids) + num_segments >= 2**31:
        raise ValueError("segment_layout: more than 2^31 - 1 rows and segments")
    tiles, cross = _tile_plan(offs, tile_items)

    def put(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return SegmentLayout(
        seg_ids=put(seg_ids), offsets=put(offs), tiles=put(tiles), cross=put(cross),
        counters=torch.zeros(len(cross), dtype=torch.int32, device=device), slots={},
        stream=[], num_segments=int(num_segments), tile_items=int(tile_items),
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
    if layout.tile_items != TILE_ITEMS:
        raise ValueError(
            f"segment_sum: the kernel takes tiles of {TILE_ITEMS} items, "
            f"the layout has {layout.tile_items}"
        )
    e, d = data.shape
    out = torch.empty((layout.num_segments, d), dtype=torch.float32, device=dev)
    if d == 0:
        return out
    slots = layout.slots.get(d)
    if slots is None:
        slots = layout.slots[d] = torch.empty(
            (2, layout.num_tiles, d), dtype=torch.float32, device=dev)
    capturing = torch.cuda.is_current_stream_capturing()
    current = torch.cuda.current_stream(dev)
    if not capturing:
        if not layout.stream:
            layout.stream.append(current)
        elif layout.stream[0] != current:
            raise RuntimeError(
                "segment_sum: the layout is the kernel's scratch and was first "
                f"used on {layout.stream[0]}; this call is on {current}. Build "
                "one layout per stream."
            )
    with torch.cuda.device(dev):
        stream = current.cuda_stream
        err = _launcher()(
            data.data_ptr(), _DTYPES[data.dtype], e, d, layout.offsets.data_ptr(),
            layout.tiles.data_ptr(), layout.num_tiles, layout.cross.data_ptr(),
            layout.counters.data_ptr(), slots.data_ptr(), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"segment_sum: kernel launch failed (cudaError {err})")
    if capturing:
        CAPTURED += 1
    else:
        LAUNCHES += 1
    return out
