"""``flash_attention``: causal / non-causal GQA attention (forward) on Hopper.

Replaces the TPU kernel ``flash_attention_pallas`` + ``_kernel`` of the JAX
package (``src/repro/kernels/flash_attention.py``): online softmax over KV
tiles with fp32 running max, sum and accumulator, KV head = q_head // group,
causality aligned to the end of KV, tiles above the diagonal skipped. The
CUDA source is ``csrc/flash_attention.cu``; its header states the bound
(tensor-core operations at the serving shape) and the design (one block per
q tile, the KV walk a loop inside the block, the ragged edges masked in the
kernel). It holds three bodies, and :func:`body_for` names the one a call
takes: ``"wgmma"`` for fp16 / bf16 at Dh 64 and 128 (TMA loads by a
producer warpgroup, ``wgmma`` products on two consumer warpgroups),
``"mma_sync"`` for fp16 / bf16 at Dh 32, 96 and 112, ``"fma"`` for fp32.
Causal calls need Tq <= Tk; non-causal calls take any Tk and Tq (the kernel
masks the columns at or past Tk on every body), where the TPU kernel needs
Tk % 128 == 0.

:func:`flash_attention` takes CUDA tensors only; ``kernels.ops`` checks the
shapes and sends CPU tensors to the plain version,
:func:`~repro_torch.kernels.ref.flash_attention_ref`, bound here as
``flash_attention_plain``, and ``meta`` tensors (the dry run,
``launch.dryrun``) to :func:`flash_attention_meta`, which computes nothing:
it returns an output of the kernel's shape and layout and credits the work
the kernel would do (:func:`kernel_flops`, over the tiles it runs) to
``META_FLOPS`` and its bytes to ``META_BYTES``. ``LAUNCHES`` counts kernel launches (a launch
recorded into a CUDA graph counts in ``CAPTURED`` instead; see
``kernels/window_score.py``), and ``LAUNCHES_BY_BODY`` splits them by body.

**Gradients.** :class:`FlashAttentionFn` is the op under autograd, and
``kernels.ops.flash_attention`` goes through it on both devices. Its
forward is the kernel on a CUDA tensor and the plain version on a CPU one
(the kernel's output has no autograd history of its own). Its backward,
:func:`attention_backward_plain`, recomputes the plain softmax attention in
fp32 over blocks of 512 query rows, as the JAX package's
``_blocked_softmax_attn`` computes the function it differentiates, and
differentiates each block with ``torch.autograd.grad``; dK and dV are
summed over each GQA group. ``BACKWARD_CALLS`` counts backward calls. This
is not a port of a TPU kernel: ``flash_attention_pallas`` is forward-only
and the JAX package's training gradient is XLA's autodiff of its blocked
softmax, so no backward kernel is owed. A hand-written Hopper backward
(ROADMAP.md port queue 2) is open work.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import NEG_INF
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

__all__ = [
    "BODIES",
    "HEAD_DIMS",
    "WGMMA_HEAD_DIMS",
    "body_for",
    "check_shapes",
    "rows_aligned",
    "flash_attention",
    "flash_attention_plain",
    "attention_backward_plain",
    "FlashAttentionFn",
    "BACKWARD_CALLS",
    "BACKWARD_Q_BLOCK",
    "LAUNCHES",
    "LAUNCHES_BY_BODY",
    "REPLACES",
    "TILES",
    "kernel_flops",
    "flash_attention_meta",
    "META_CALLS",
    "META_FLOPS",
    "META_BYTES",
]

REPLACES = "src/repro/kernels/flash_attention.py:77"  # flash_attention_pallas
LAUNCHES = 0
CAPTURED = 0
HEAD_DIMS = (32, 64, 96, 112, 128)
WGMMA_HEAD_DIMS = (64, 128)
BODIES = ("fma", "mma_sync", "wgmma")  # the kernel's codes 0, 1, 2
LAUNCHES_BY_BODY = dict.fromkeys(BODIES, 0)
BACKWARD_CALLS = 0
# Query rows per block of the backward's recompute: the q_block of JAX's
# _blocked_softmax_attn, which bounds the live fp32 logits to (B, H, 512, Tk).
BACKWARD_Q_BLOCK = 512
# (query rows a block, KV rows a tile) of each body: kBQ / kBK of the fma
# and mma_sync bodies, kWgRows of the wgmma body (csrc/flash_attention.cu).
TILES = {"fma": (64, 64), "mma_sync": (64, 64), "wgmma": (128, 128)}
# The dry run's calls on meta tensors: calls, and the work credited to them.
META_CALLS = 0
META_FLOPS = 0
META_BYTES = 0

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# The launcher's codes above every cudaError_t (csrc/flash_attention.cu).
_ERR_ENCODE = 100000
_ERR_NO_ENCODER = 200000
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("flash_attention")
        fn = lib.flash_attention_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p, p, p, p, i, i, i, i, i, i, i] + [ll] * 12
                       + [ctypes.c_float, i, p, ctypes.POINTER(i)])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def body_for(dtype: torch.dtype, dh: int) -> str:
    """The kernel body a CUDA call with this dtype and head dim takes:
    ``"wgmma"`` for fp16 / bf16 at Dh 64 and 128, ``"mma_sync"`` for
    fp16 / bf16 at Dh 32, 96 and 112, ``"fma"`` for fp32 (exact products)."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: Dh must be one of {HEAD_DIMS}, got {dh}")
    if dtype == torch.float32:
        return "fma"
    if dtype in (torch.float16, torch.bfloat16):
        return "wgmma" if dh in WGMMA_HEAD_DIMS else "mma_sync"
    raise TypeError(f"flash_attention: dtype must be float32, float16 or bfloat16, got {dtype}")


def rows_aligned(t: torch.Tensor) -> bool:
    """Every (b, h, row) of ``t`` starts on 16 bytes, at a positive stride:
    the rule of the 16-bit bodies' 16-byte loads, and TMA's rule for a
    tensor map's base and strides (an axis of extent 1 has no stride to
    check)."""
    return t.data_ptr() % 16 == 0 and all(
        st > 0 and st * t.element_size() % 16 == 0
        for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1
    )


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    """The op's shape contract, on either device: q (B, Hq, Tq, Dh), k and v
    (B, Hkv, Tk, Dh) with Hq % Hkv == 0; causal calls need Tq <= Tk (query
    row r sits at position Tk - Tq + r), non-causal ones take any Tk."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be a 4-D tensor (B, H, T, Dh)")
    b, hq, tq, dh = q.shape
    if tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch or Dh"
        )
    hkv, tk = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv != 0:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of Hkv={hkv}")
    if causal and tq > tk:
        raise ValueError(f"flash_attention: causal needs Tq <= Tk, got Tq={tq}, Tk={tk}")


def kernel_flops(q_shape, tk: int, dtype: torch.dtype, causal: bool) -> int:
    """The floating-point operations a CUDA call with q of ``q_shape``
    (B, Hq, Tq, Dh) and ``tk`` keys runs on the body :func:`body_for`
    names: two products (q·kᵀ, p·v) of 2·rows·cols·Dh a tile pair, the
    ragged edges at the tiles' full size, over the pairs the kernel's loop
    bound gives — every q tile walks the KV tiles up to the one that holds
    its last row's position (Tk - Tq + row) when ``causal``, else all
    ⌈Tk / tile⌉ of them."""
    b, hq, tq, dh = (int(n) for n in q_shape)
    bq, bk = TILES[body_for(dtype, dh)]
    n_kv, pairs = -(-tk // bk), 0
    for q0 in range(0, tq, bq):
        last_row = tk - tq + min(q0 + bq, tq) - 1
        pairs += min(n_kv, last_row // bk + 1) if causal else n_kv
    return b * hq * pairs * 4 * bq * bk * dh


def flash_attention_meta(
    q: torch.Tensor,  # (B, Hq, Tq, Dh), on the meta device
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """The kernel's call on ``meta`` tensors, for the dry run: the shape
    checks the CUDA call makes, then an output of its shape and layout
    ((B, Tq, Hq, Dh) in memory, returned as its (B, Hq, Tq, Dh) view), with
    :func:`kernel_flops` added to ``META_FLOPS`` and the inputs' and the
    output's bytes to ``META_BYTES``. Nothing is computed or launched."""
    global META_CALLS, META_FLOPS, META_BYTES
    check_shapes(q, k, v, causal)
    b, hq, tq, dh = q.shape
    out = torch.empty((b, tq, hq, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    META_CALLS += 1
    META_FLOPS += kernel_flops(q.shape, k.shape[2], q.dtype, causal)
    META_BYTES += sum(t.numel() * t.element_size() for t in (q, k, v, out))
    return out


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Tq, Dh)
    k: torch.Tensor,  # (B, Hkv, Tk, Dh)
    v: torch.Tensor,  # (B, Hkv, Tk, Dh)
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """(B, Hq, Tq, Dh) attention in ``q.dtype`` from the CUDA kernel.

    q, k and v: CUDA tensors of one dtype (float32, float16 or bfloat16) on
    one device, Dh in :data:`HEAD_DIMS`, each with a contiguous last axis
    (any strides on the other three; a 16-bit input whose rows do not start
    on 16 bytes, which the kernel's vector and TMA loads need, is copied into
    a contiguous tensor first). The output is laid out as (B, Tq, Hq, Dh) in
    memory and returned as its (B, Hq, Tq, Dh) view, so a caller that merges
    the heads next gets a free reshape. The kernel takes the body
    :func:`body_for` names; ``LAUNCHES_BY_BODY`` counts the one it reports.
    """
    global LAUNCHES, CAPTURED
    check_shapes(q, k, v, causal)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: the kernel takes CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype must be float32, float16 or bfloat16, got {q.dtype}")
    b, hq, tq, dh = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    body_for(q.dtype, dh)  # raises on a Dh no body takes
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} must have a contiguous last axis")
    if q.element_size() == 2:
        q, k, v = (t if rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    if b > 65535 or hq > 65535:
        raise ValueError(f"flash_attention: B={b} and Hq={hq} must be at most 65535")
    out = torch.empty((b, tq, hq, dh), dtype=q.dtype, device=dev).transpose(1, 2)
    if b == 0 or tq == 0:
        return out
    if tk == 0:
        raise ValueError("flash_attention: Tk must be at least 1")
    scale = float(scale) if scale is not None else 1.0 / (dh**0.5)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    ran = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            b, hq, hkv, tq, tk, dh, *strides, scale, int(bool(causal)), stream,
            ctypes.byref(ran),
        )
    body = BODIES[ran.value] if 0 <= ran.value < len(BODIES) else "none"
    if err >= _ERR_NO_ENCODER:
        raise RuntimeError("flash_attention: no cuTensorMapEncodeTiled entry point on this system")
    if err >= _ERR_ENCODE:
        raise RuntimeError(
            f"flash_attention: TMA tensor map refused (CUresult {err - _ERR_ENCODE})")
    if err != 0:
        raise RuntimeError(
            f"flash_attention: kernel launch failed (cudaError {err}; body {body})")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED += 1
    else:
        LAUNCHES += 1
        LAUNCHES_BY_BODY[body] += 1
    return out


def attention_backward_plain(
    q: torch.Tensor,  # (B, Hq, Tq, Dh)
    k: torch.Tensor,  # (B, Hkv, Tk, Dh)
    v: torch.Tensor,  # (B, Hkv, Tk, Dh)
    dout: torch.Tensor,  # (B, Hq, Tq, Dh)
    *,
    causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the plain version's output against ``dout``, each in
    its input's dtype, on either device.

    The attention of each block of ``BACKWARD_Q_BLOCK`` query rows (read at
    the call) is recomputed in fp32 (the plain version's arithmetic) and
    differentiated with ``torch.autograd.grad``; dq is written per block, dk and dv are summed
    over the blocks in fp32, each already summed over its GQA group by the
    grouped product. A causal block reads only the keys its last row sees
    (row r sits at Tk - Tq + r): the keys beyond are masked to NEG_INF,
    whose probabilities are exactly 0, so they add nothing to any gradient.
    """
    b, hq, tq, dh = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / (dh**0.5)
    kf = k.detach().float()
    vf = v.detach().float()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    with torch.enable_grad():
        for lo in range(0, tq, BACKWARD_Q_BLOCK):
            hi = min(tq, lo + BACKWARD_Q_BLOCK)
            kn = tk - tq + hi if causal else tk
            qb = q[:, :, lo:hi].detach().float().requires_grad_(True)
            kb = kf[:, :, :kn].requires_grad_(True)
            vb = vf[:, :, :kn].requires_grad_(True)
            qg = (qb * scale).reshape(b, hkv, group, hi - lo, dh)
            logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb)
            if causal:
                qpos = torch.arange(lo, hi, device=q.device) + (tk - tq)
                mask = qpos[:, None] >= torch.arange(kn, device=q.device)[None, :]
                logits = torch.where(mask, logits, NEG_INF)
            probs = torch.softmax(logits, dim=-1)
            out = torch.einsum("bhgqk,bhkd->bhgqd", probs, vb).reshape(b, hq, hi - lo, dh)
            gq, gk, gv = torch.autograd.grad(out, (qb, kb, vb), dout[:, :, lo:hi].float())
            dq[:, :, lo:hi] = gq
            dk[:, :, :kn] += gk
            dv[:, :, :kn] += gv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` under autograd: the kernel (CUDA), the plain
    version (CPU) or :func:`flash_attention_meta` (meta) forward,
    :func:`attention_backward_plain` backward. Saves q, k and v;
    ``BACKWARD_CALLS`` counts the backward calls."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal, scale=scale)
        if q.device.type == "meta":
            return flash_attention_meta(q, k, v, causal=causal)
        return flash_attention(q, k, v, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, dout):
        global BACKWARD_CALLS
        q, k, v = ctx.saved_tensors
        BACKWARD_CALLS += 1
        with torch.profiler.record_function("flash_attention_backward"):
            dq, dk, dv = attention_backward_plain(q, k, v, dout, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None
