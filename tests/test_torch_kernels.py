"""The port's kernel ops against the JAX package's oracles.

On the CPU each op runs its plain torch version, held here against
``repro.kernels.ops`` at the shapes and seeds of ``tests/test_kernels.py``:
``window_score`` bit-equal (rtol/atol 1e-5 at least, masked entries
bit-equal), ``segment_sum`` at rtol 1e-5 in f32 and 2e-3 in f16 (another
fp32 summation order). The CUDA kernels themselves are compared with their
plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.segment_sum import csr_block_layout
from repro_torch.kernels import ops
from repro_torch.kernels import segment_sum as ss
from repro_torch.kernels import window_score as ws

torch.set_num_threads(1)

WS_SHAPES = [
    (1, 2, True), (7, 3, True), (128, 32, True), (200, 20, True),
    (130, 64, False), (64, 5, False),
]
SS_SHAPES = [
    (10, 8, 5, np.float32), (1000, 64, 300, np.float32),
    (3000, 32, 700, np.float32), (513, 128, 129, np.float32),
    (2048, 16, 256, np.float16),
]


def _ws_inputs(w, k):
    """The inputs of tests/test_kernels.py::test_window_score_shapes."""
    rng = np.random.default_rng(w * 31 + k)
    v = 200
    uv = rng.integers(0, v, (w, 2)).astype(np.int32)
    valid = rng.random(w) < 0.85
    repu = rng.random((w, k)) < 0.2
    repv = rng.random((w, k)) < 0.2
    degu = rng.integers(1, 40, w).astype(np.int32)
    degv = rng.integers(1, 40, w).astype(np.int32)
    bal = rng.random(k).astype(np.float32)
    allowed = rng.random(k) < 0.9
    return uv, valid, repu, repv, degu, degv, bal, allowed


def _torch_args(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.parametrize("w,k,use_cs", WS_SHAPES)
def test_window_score_plain_matches_jax(w, k, use_cs):
    arrays = _ws_inputs(w, k)
    want = np.asarray(jops.window_score(
        *arrays, jnp.float32(1.3), jnp.int32(40), use_cs=use_cs, tier="xla"))
    got = ops.window_score(*_torch_args(arrays), 1.3, 40, use_cs=use_cs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    valid, allowed = arrays[1], arrays[7]
    mask = (~valid)[:, None] | (~allowed)[None, :]
    np.testing.assert_array_equal(got[mask], want[mask])
    # Same operation order, no FMA: bit-equal, not just close.
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _ws_table_inputs(w, k, v=200):
    """A window over a (v + 1)-row vertex table, as the ADWISE step holds
    it: slot ids in [0, v] (v is the table's dump row), a (v + 1, K) bool
    replica table and (v + 1,) int32 degrees."""
    rng = np.random.default_rng(w * 29 + k)
    uv = rng.integers(0, v + 1, (w, 2)).astype(np.int32)
    valid = rng.random(w) < 0.85
    replicas = rng.random((v + 1, k)) < 0.2
    deg = rng.integers(1, 40, v + 1).astype(np.int32)
    return uv, valid, replicas, deg


def _gathered(uv, replicas, deg):
    u, v = uv[:, 0], uv[:, 1]
    return replicas[u], replicas[v], deg[u], deg[v]


@pytest.mark.parametrize("w,k,use_cs", WS_SHAPES)
def test_window_score_rows_equal_full_op_rows(w, k, use_cs):
    uv, valid, replicas, deg = _ws_table_inputs(w, k)
    rng = np.random.default_rng(w + 7 * k)
    rows = rng.integers(0, w, max(1, w // 3)).astype(np.int32)
    got = ops.window_score_rows(*_torch_args((uv, valid, replicas, deg)), 40,
                                torch.as_tensor(rows), use_cs=use_cs)
    # λ = 0 and every partition allowed: the full op's unmasked rows are R + CS,
    # here on the table rows gathered at the window's ids.
    bal = rng.random(k).astype(np.float32)
    full = ops.window_score(*_torch_args((uv, valid, *_gathered(uv, replicas, deg))),
                            torch.as_tensor(bal), torch.ones(k, dtype=torch.bool),
                            0.0, 40, use_cs=use_cs)
    live = valid[rows]
    np.testing.assert_array_equal(got.numpy()[live], full.numpy()[rows[live]])
    # int64 slots (the step's sort order) give the same rows.
    again = ops.window_score_rows(*_torch_args((uv, valid, replicas, deg)), 40,
                                  torch.as_tensor(rows.astype(np.int64)), use_cs=use_cs)
    assert torch.equal(again, got)


@pytest.mark.parametrize("w,k,use_cs", WS_SHAPES)
def test_window_score_rows_from_tables_match_jax(w, k, use_cs):
    """The table-gathered row op gives, bit for bit, the rows of the JAX
    ``window_score`` on replicas[u], replicas[v], deg[u], deg[v]."""
    uv, valid, replicas, deg = _ws_table_inputs(w, k)
    rows = np.arange(w, dtype=np.int32)[::-1].copy()
    got = ops.window_score_rows(*_torch_args((uv, valid, replicas, deg)), 40,
                                torch.as_tensor(rows), use_cs=use_cs).numpy()
    want = np.asarray(jops.window_score(
        uv, valid, *_gathered(uv, replicas, deg), np.zeros(k, np.float32),
        np.ones(k, bool), jnp.float32(0.0), jnp.int32(40), use_cs=use_cs, tier="xla"))
    live = valid[rows]
    np.testing.assert_array_equal(got[live].view(np.int32), want[rows[live]].view(np.int32))


def test_window_score_kernel_wrapper_rejects_cpu_tensors():
    t = _torch_args(_ws_inputs(7, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ws.window_score(*t, torch.tensor(1.3), torch.tensor(40, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ws.window_score_rows(*_torch_args(_ws_table_inputs(7, 3)),
                             torch.tensor(40, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss.segment_sum(torch.zeros(4, 2), ss.segment_layout([0, 0, 1, 2], 3, "cpu"))


@pytest.mark.parametrize("e,d,s,dtype", SS_SHAPES)
def test_segment_sum_plain_matches_jax(e, d, s, dtype):
    rng = np.random.default_rng(e + d)
    seg = np.sort(rng.integers(0, s, e)).astype(np.int32)
    data = rng.normal(size=(e, d)).astype(dtype)
    want = np.asarray(jops.segment_sum_sorted(
        jnp.asarray(data, jnp.float32), seg, s, tier="xla"))
    got = ops.segment_sum_sorted(torch.as_tensor(data), ss.segment_layout(seg, s, "cpu"))
    assert got.dtype == torch.float32 and got.shape == (s, d)
    tol = 2e-3 if dtype == np.float16 else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("seg,s", [
    (np.array([1, 5, 3], np.int32), 10),
    (np.array([0, 4, 10], np.int32), 10),
    (np.array([-1, 0, 3], np.int32), 10),
    (np.array([], np.int32), 0),
    (np.zeros((2, 2), np.int32), 4),
])
def test_segment_offsets_rejects_what_csr_block_layout_rejects(seg, s):
    with pytest.raises(ValueError) as jax_err:
        csr_block_layout(seg, s, 4)
    strip = lambda e: str(e.value).split(": ", 1)[1]  # noqa: E731
    for build in (ss.segment_offsets, lambda a, b: ss.segment_layout(a, b, "cpu")):
        with pytest.raises(ValueError) as port_err:
            build(seg, s)
        assert strip(port_err) == strip(jax_err)


@pytest.mark.parametrize("e,s", [(0, 7), (1, 1), (5000, 1000), (700, 1)])
def test_segment_offsets_are_run_bounds(e, s):
    rng = np.random.default_rng(e + s)
    seg = np.sort(rng.integers(0, s, e)).astype(np.int32)
    offs = ss.segment_offsets(seg, s)
    assert offs.dtype == np.int32 and offs.shape == (s + 1,)
    assert offs[0] == 0 and offs[-1] == e
    np.testing.assert_array_equal(np.diff(offs), np.bincount(seg, minlength=s))


def _two_pass_sum(data, lay):
    """The kernel's two passes in numpy: one sum per chunk (to its output
    row, or to a partial row), then each split segment's partials in order."""
    rows, out_of = lay.chunk_row.numpy(), lay.chunk_out.numpy()
    out = np.full((lay.num_segments, data.shape[1]), np.nan, np.float32)
    partial = np.full((lay.num_partials, data.shape[1]), np.nan, np.float32)
    for c, o in enumerate(out_of):
        part = data[rows[c]:rows[c + 1]].sum(0, dtype=np.float32)
        if o >= 0:
            out[o] = part
        else:
            partial[-o - 1] = part
    ptr = lay.multi_ptr.numpy()
    for m, seg in enumerate(lay.multi_seg.numpy()):
        out[seg] = partial[ptr[m]:ptr[m + 1]].sum(0, dtype=np.float32)
    return out


# (rows, segments, chunk rows, hub rows): empty input, one segment, runs
# shorter and longer than a chunk, exact multiples of it, and one hub run.
LAYOUT_CASES = [(0, 7, 32, 0), (1, 1, 32, 0), (5000, 1000, 4, 0), (700, 1, 32, 0),
                (640, 20, 32, 0), (3000, 300, 32, 2500)]


@pytest.mark.parametrize("e,s,chunk,hub", LAYOUT_CASES)
def test_segment_layout_chunks_cover_every_run(e, s, chunk, hub):
    rng = np.random.default_rng(e + s + hub)
    seg = np.sort(np.concatenate([rng.integers(0, s, e - hub), np.full(hub, s // 2)])).astype(np.int32)
    lay = ss.segment_layout(seg, s, "cpu", chunk_rows=chunk)
    rows, out_of = lay.chunk_row.numpy(), lay.chunk_out.numpy()
    sizes = np.diff(rows)
    assert rows[0] == 0 and rows[-1] == e and (sizes >= 0).all() and (sizes <= chunk).all()
    # Every segment owns at least one chunk, and its chunks' rows are its run.
    chunk_seg = seg[np.minimum(rows[:-1], max(e - 1, 0))] if e else np.arange(s)
    direct = out_of >= 0
    np.testing.assert_array_equal(chunk_seg[direct & (sizes > 0)], out_of[direct & (sizes > 0)])
    multi = lay.multi_seg.numpy()
    per_seg = np.bincount(out_of[direct], minlength=s) + np.isin(np.arange(s), multi)
    np.testing.assert_array_equal(per_seg, np.ones(s))
    runs = np.diff(ss.segment_offsets(seg, s))
    np.testing.assert_array_equal(np.flatnonzero(runs > chunk), multi)
    np.testing.assert_array_equal(np.diff(lay.multi_ptr.numpy()), -(-runs[multi] // chunk))
    assert lay.num_partials == int(lay.multi_ptr[-1]) == int((~direct).sum())
    np.testing.assert_array_equal(np.sort(-out_of[~direct] - 1), np.arange(lay.num_partials))


@pytest.mark.parametrize("e,s,chunk,hub", LAYOUT_CASES)
@pytest.mark.parametrize("d", [1, 3])
def test_segment_layout_two_pass_sum_is_the_segment_sum(e, s, chunk, hub, d):
    # Small integers: every partial sum is exact in fp32, so the two passes
    # must give the plain version's result bit for bit.
    rng = np.random.default_rng(e + s + hub + d)
    seg = np.sort(np.concatenate([rng.integers(0, s, e - hub), np.full(hub, s // 2)])).astype(np.int32)
    data = rng.integers(-4, 5, (e, d)).astype(np.float32)
    lay = ss.segment_layout(seg, s, "cpu", chunk_rows=chunk)
    want = ops.segment_sum_sorted(torch.as_tensor(data), lay).numpy()
    np.testing.assert_array_equal(_two_pass_sum(data, lay), want)


def test_segment_sum_sorted_rejects_a_layout_of_other_rows():
    lay = ss.segment_layout(np.array([0, 1, 1], np.int32), 2, "cpu")
    with pytest.raises(ValueError, match="4 rows, the layout 3"):
        ops.segment_sum_sorted(torch.zeros(4, 2), lay)
