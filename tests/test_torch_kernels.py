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
from repro.kernels.segment_sum import csr_block_layout, segment_sum_pallas
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


@pytest.mark.parametrize("z", [1, 3, 4])
@pytest.mark.parametrize("w,k,use_cs", WS_SHAPES)
def test_window_score_rows_batched_equal_single_instance_and_jax(w, k, use_cs, z):
    """The batched plain row op over z instances: instance i's rows equal the
    z = 1 call on instance i's tables and, bit for bit, the rows of the JAX
    ``window_score`` on that instance's gathered rows."""
    rng = np.random.default_rng(z * 101 + w + k)
    v = 200
    uv = rng.integers(0, v + 1, (z, w, 2)).astype(np.int32)
    valid = rng.random((z, w)) < 0.85
    replicas = rng.random((z, v + 1, k)) < 0.2
    deg = rng.integers(1, 40, (z, v + 1)).astype(np.int32)
    max_deg = rng.integers(1, 60, z).astype(np.int32)
    rows = rng.integers(0, w, (z, max(1, w // 3)))
    for dtype in (np.int32, np.int64):
        got = ops.window_score_rows_batched(
            *_torch_args((uv, valid, replicas, deg, max_deg, rows.astype(dtype))), use_cs=use_cs)
        assert got.shape == (z, rows.shape[1], k) and got.dtype == torch.float32
        for i in range(z):
            one = ops.window_score_rows(
                *_torch_args((uv[i], valid[i], replicas[i], deg[i])), int(max_deg[i]),
                torch.as_tensor(rows[i].astype(dtype)), use_cs=use_cs)
            np.testing.assert_array_equal(got[i].numpy().view(np.int32), one.numpy().view(np.int32))
            want = np.asarray(jops.window_score(
                uv[i], valid[i], *_gathered(uv[i], replicas[i], deg[i]), np.zeros(k, np.float32),
                np.ones(k, bool), jnp.float32(0.0), jnp.int32(max_deg[i]), use_cs=use_cs,
                tier="xla"))
            live = valid[i][rows[i]]
            np.testing.assert_array_equal(got[i].numpy()[live].view(np.int32),
                                          want[rows[i][live]].view(np.int32))


def test_window_score_kernel_wrapper_rejects_cpu_tensors():
    t = _torch_args(_ws_inputs(7, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ws.window_score(*t, torch.tensor(1.3), torch.tensor(40, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ws.window_score_rows(*_torch_args(_ws_table_inputs(7, 3)),
                             torch.tensor(40, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    uv, valid, replicas, deg = _ws_table_inputs(7, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ws.window_score_rows_batched(
            *_torch_args((uv[None], valid[None], replicas[None], deg[None])),
            torch.tensor([40], dtype=torch.int32), torch.zeros((1, 2), dtype=torch.int32))
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


def _tile_model_sum(data, lay):
    """The kernel's order in numpy: each tile sums the rows of every segment
    that ends in it (writing it to ``out``, or to a head slot when its rows
    began in an earlier tile) and of the segment open at its end (a tail
    slot); then each crossing segment adds its slots in tile order. Returns
    the (S, D) sums and how many times each segment was written."""
    offs, tiles, cross = lay.offsets.numpy(), lay.tiles.numpy(), lay.cross.numpy()
    d = data.shape[1]
    out = np.full((lay.num_segments, d), np.nan, np.float32)
    writes = np.zeros(lay.num_segments, np.int64)
    slots = np.full((2, lay.num_tiles, d), np.nan, np.float32)
    for t in range(lay.num_tiles):
        r0, s0, m_in, m_out = tiles[t]
        r1, s1 = tiles[t + 1][:2]
        for s in range(s0, s1):
            part = data[max(offs[s], r0):offs[s + 1]].sum(0, dtype=np.float32)
            if s == s0 and m_in >= 0:
                assert cross[m_in][0] == s and cross[m_in][2] == t
                slots[1, t] = part
            else:
                assert offs[s] >= r0  # wholly inside the tile
                out[s] = part
                writes[s] += 1
        if m_out >= 0:
            assert cross[m_out][0] == s1
            slots[0, t] = data[max(offs[s1], r0):r1].sum(0, dtype=np.float32)
    for seg, first, last, n in cross:
        assert n == last - first + 1
        acc = np.zeros(d, np.float32)
        for t in range(first, last):
            acc = acc + slots[0, t]
        out[seg] = acc + slots[1, last]
        writes[seg] += 1
    return out, writes


def _runs_seg(runs):
    runs = np.asarray(runs, np.int64)
    return np.repeat(np.arange(len(runs)), runs).astype(np.int32), len(runs)


def _random_seg(e, s, hub):
    rng = np.random.default_rng(e + s + hub)
    seg = np.sort(np.concatenate([rng.integers(0, s, e - hub), np.full(hub, s // 2)]))
    return seg.astype(np.int32), s


# (segment ids, tile items): empty input, one segment, runs shorter and
# longer than a tile, exact multiples of it, and one hub run (random ids);
# then, from run lengths, a segment whose last row ends a tile (its end
# opens the next one), tiles wholly inside a hub, a run of empty segments
# longer than a tile, no rows over several tiles, and one segment of none.
LAYOUT_CASES = {
    "empty input": (lambda: _random_seg(0, 7, 0), 32),
    "one row": (lambda: _random_seg(1, 1, 0), 32),
    "short runs": (lambda: _random_seg(5000, 1000, 0), 4),
    "one segment": (lambda: _random_seg(700, 1, 0), 32),
    "multiples": (lambda: _random_seg(640, 20, 0), 32),
    "hub": (lambda: _random_seg(3000, 300, 2500), 32),
    "tile edge": (lambda: _runs_seg([3, 4, 6, 0, 1, 2, 8, 5, 0, 7]), 8),
    "inside a hub": (lambda: _runs_seg([5, 100, 3, 1]), 16),
    "empty run": (lambda: _runs_seg([4] + [0] * 50 + [6, 2]), 16),
    "no rows": (lambda: _runs_seg([0] * 40), 8),
    "one empty segment": (lambda: _runs_seg([0]), 8),
}


def _merged_positions(seg, s):
    offs = ss.segment_offsets(seg, s).astype(np.int64)
    return np.arange(len(seg)) + seg, offs[1:] + np.arange(s), offs


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_segment_layout_tiles_cover_every_row_and_segment_once(case):
    make, k = LAYOUT_CASES[case]
    seg, s = make()
    e = len(seg)
    lay = ss.segment_layout(seg, s, "cpu", tile_items=k)
    tiles, cross = lay.tiles.numpy(), lay.cross.numpy()
    row0, seg0, m_in, m_out = tiles.T
    t_count = lay.num_tiles
    assert t_count == -(-(e + s) // k)
    assert tuple(tiles[0, :2]) == (0, 0) and tuple(tiles[-1]) == (e, s, -1, -1)
    # Consecutive tiles own consecutive rows and segment ends, k items each
    # (the last at most k), so every row and every segment end lies in
    # exactly one tile ...
    items = np.diff(row0) + np.diff(seg0)
    assert (np.diff(row0) >= 0).all() and (np.diff(seg0) >= 0).all()
    assert (items[:-1] == k).all() and 0 < items[-1] <= k
    # ... the one its merged position (merge path) falls in.
    row_pos, end_pos, offs = _merged_positions(seg, s)
    np.testing.assert_array_equal(row_pos // k, np.searchsorted(row0, np.arange(e), "right") - 1)
    np.testing.assert_array_equal(end_pos // k, np.searchsorted(seg0, np.arange(s), "right") - 1)
    # Crossing segments: those with rows before their end's tile, each with
    # its first row's tile and its end's tile; every other tile boundary
    # splits none.
    runs = np.diff(offs)
    t_first, t_last = (offs[:-1] + np.arange(s)) // k, end_pos // k
    want = np.flatnonzero((runs > 0) & (offs[:-1] < row0[t_last]))
    np.testing.assert_array_equal(cross[:, 0], want)
    np.testing.assert_array_equal(cross[:, 1], t_first[want])
    np.testing.assert_array_equal(cross[:, 2], t_last[want])
    np.testing.assert_array_equal(cross[:, 3], t_last[want] - t_first[want] + 1)
    assert (cross[:, 1] < cross[:, 2]).all()
    # Each crossing segment ends in one tile and is open at the end of the
    # tiles before it, back to its first.
    np.testing.assert_array_equal(np.flatnonzero(m_in >= 0), cross[:, 2])
    np.testing.assert_array_equal(m_in[cross[:, 2]], np.arange(len(cross)))
    want_out = np.full(t_count + 1, -1)
    for m, (_, first, last, _) in enumerate(cross):
        want_out[first:last] = m
    np.testing.assert_array_equal(m_out, want_out)
    assert lay.counters.shape == (len(cross),) and int(lay.counters.abs().sum()) == 0


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
@pytest.mark.parametrize("d", [1, 3])
def test_segment_layout_tile_model_sum_is_the_segment_sum(case, d):
    # Small integers: every partial sum is exact in fp32, so the tiles and
    # the fixup must give the plain version's result bit for bit, each
    # segment written exactly once.
    make, k = LAYOUT_CASES[case]
    seg, s = make()
    rng = np.random.default_rng(len(seg) + s + d)
    data = rng.integers(-4, 5, (len(seg), d)).astype(np.float32)
    lay = ss.segment_layout(seg, s, "cpu", tile_items=k)
    want = ops.segment_sum_sorted(torch.as_tensor(data), lay).numpy()
    got, writes = _tile_model_sum(data, lay)
    np.testing.assert_array_equal(writes, np.ones(s))
    np.testing.assert_array_equal(got, want)


def _pallas_segment_sum(data, seg, s):
    """The JAX package's TPU kernel, ``segment_sum_pallas``, in interpret
    mode over its ``csr_block_layout``; (S, D) float32."""
    perm, loc, chunk_ptr, nchunks, _ = csr_block_layout(seg, s, data.shape[1])
    padded = np.where((perm >= 0)[:, None], data[np.maximum(perm, 0)], 0).astype(np.float32)
    out = segment_sum_pallas(
        jnp.asarray(padded), jnp.asarray(loc), jnp.asarray(chunk_ptr), jnp.asarray(nchunks), s,
        max_chunks=int(nchunks.max()), interpret=True)
    return np.asarray(out)[:s]


# (segment ids, tile items, D): a 1,000-row hub among short runs, a run of
# empty segments longer than a tile, and random runs at D = 1.
PALLAS_CASES = {
    "hub": (lambda: _random_seg(3000, 300, 1000), 64, 3),
    "empty segments": (lambda: _runs_seg([3, 0, 9] + [0] * 300 + [40, 1, 0, 2] * 20), 64, 2),
    "random D=1": (lambda: _random_seg(2000, 150, 0), 32, 1),
}


@pytest.mark.parametrize("case", list(PALLAS_CASES))
@pytest.mark.parametrize("values", ["small integers", "normal"])
def test_segment_sum_matches_the_pallas_kernel(case, values):
    """The plain version and the model of the kernel's order against the
    JAX package's Pallas kernel (interpret mode): bit-equal on small
    integers, within 1e-5 on normal f32 data (another summation order)."""
    make, k, d = PALLAS_CASES[case]
    seg, s = make()
    rng = np.random.default_rng(len(seg) + d)
    if values == "normal":
        data = rng.normal(size=(len(seg), d)).astype(np.float32)
    else:
        data = rng.integers(-4, 5, (len(seg), d)).astype(np.float32)
    want = _pallas_segment_sum(data, seg, s)
    lay = ss.segment_layout(seg, s, "cpu", tile_items=k)
    plain = ops.segment_sum_sorted(torch.as_tensor(data), lay).numpy()
    model, _ = _tile_model_sum(data, lay)
    for got in (plain, model):
        if values == "normal":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)


def test_segment_sum_sorted_rejects_a_layout_of_other_rows():
    lay = ss.segment_layout(np.array([0, 1, 1], np.int32), 2, "cpu")
    with pytest.raises(ValueError, match="4 rows, the layout 3"):
        ops.segment_sum_sorted(torch.zeros(4, 2), lay)
