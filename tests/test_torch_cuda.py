"""The port on the card: each CUDA kernel against its plain torch version,
and the CUDA-graph scan driver against the plain CPU loop.

Every test here needs a CUDA device; without one it skips. This file
imports neither ``jax`` nor ``repro``, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import AdwiseConfig, driver, partition_stream
from repro_torch.engine import build_partitioned_graph, pagerank
from repro_torch.graph import make_graph
from repro_torch.kernels import ops
from repro_torch.kernels.segment_sum import segment_layout

pytestmark = pytest.mark.cuda

WS_SHAPES = [
    (1, 2, True), (7, 3, True), (128, 32, True), (200, 20, True),
    (130, 64, False), (64, 5, False), (256, 32, True),
]
SS_SHAPES = [
    (10, 8, 5, np.float32), (1000, 64, 300, np.float32),
    (3000, 32, 700, np.float32), (513, 128, 129, np.float32),
    (2048, 16, 256, np.float16), (20000, 1, 3000, np.float32),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ws_inputs(w, k):
    rng = np.random.default_rng(w * 31 + k)
    return (
        rng.integers(0, 200, (w, 2)).astype(np.int32),
        rng.random(w) < 0.85,
        rng.random((w, k)) < 0.2,
        rng.random((w, k)) < 0.2,
        rng.integers(1, 40, w).astype(np.int32),
        rng.integers(1, 40, w).astype(np.int32),
        rng.random(k).astype(np.float32),
        rng.random(k) < 0.9,
    )


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.int32)


@pytest.mark.parametrize("w,k,use_cs", WS_SHAPES)
def test_window_score_kernel_bit_equal_to_plain(cuda, w, k, use_cs):
    arrays = _ws_inputs(w, k)
    cpu = ops.window_score(*(torch.as_tensor(a) for a in arrays), 1.3, 40, use_cs=use_cs)
    gpu = ops.window_score(*(torch.as_tensor(a, device=cuda) for a in arrays), 1.3, 40,
                           use_cs=use_cs)
    np.testing.assert_array_equal(_bits(gpu), _bits(cpu))
    rows = torch.arange(w, dtype=torch.int32).flip(0)
    a = ops.window_score_rows(*(torch.as_tensor(x) for x in arrays[:6]), 40, rows,
                              use_cs=use_cs)
    b = ops.window_score_rows(*(torch.as_tensor(x, device=cuda) for x in arrays[:6]), 40,
                              rows.to(cuda), use_cs=use_cs)
    np.testing.assert_array_equal(_bits(b), _bits(a))


def test_window_score_kernel_rejects_bad_input(cuda):
    t = [torch.as_tensor(a, device=cuda) for a in _ws_inputs(7, 3)]
    lam = torch.tensor(1.3, device=cuda)
    md = torch.tensor(40, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="rep_u must be torch.bool"):
        ops.window_score(t[0], t[1], t[2].float(), *t[3:], lam, md)
    with pytest.raises(ValueError, match="share one device"):
        ops.window_score(t[0].cpu(), *t[1:], lam, md)


@pytest.mark.parametrize("e,d,s,dtype", SS_SHAPES)
def test_segment_sum_kernel_matches_plain(cuda, e, d, s, dtype):
    rng = np.random.default_rng(e + d)
    seg = np.sort(rng.integers(0, s, e)).astype(np.int32)
    data = torch.as_tensor(rng.normal(size=(e, d)).astype(dtype))
    cpu = ops.segment_sum_sorted(data, segment_layout(seg, s, "cpu"))
    lay = segment_layout(seg, s, cuda)
    gpu = ops.segment_sum_sorted(data.to(cuda), lay)
    again = ops.segment_sum_sorted(data.to(cuda), lay)
    tol = 2e-3 if dtype == np.float16 else 1e-5
    np.testing.assert_allclose(gpu.cpu().numpy(), cpu.numpy(), rtol=tol, atol=tol)
    assert torch.equal(gpu, again)  # deterministic: no atomics


@pytest.mark.parametrize("d", [1, 5, 256, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_segment_sum_kernel_exact_on_a_hub(cuda, d, dtype):
    # One 20,000-row hub among short runs and empty segments; small-integer
    # data keeps every partial sum exact, so any order gives the same bits.
    rng = np.random.default_rng(d)
    seg = np.sort(np.concatenate([rng.integers(0, 500, 3000), np.full(20000, 250)])).astype(np.int32)
    data = torch.as_tensor(rng.integers(-4, 5, (len(seg), d))).to(dtype)
    want = ops.segment_sum_sorted(data, segment_layout(seg, 600, "cpu"))
    got = ops.segment_sum_sorted(data.to(cuda), segment_layout(seg, 600, cuda))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("steps_per_graph", [1, 7, 32])
def test_graph_replayed_scan_equals_cpu_loop(cuda, steps_per_graph, monkeypatch):
    monkeypatch.setattr(driver, "STEPS_PER_GRAPH", steps_per_graph)
    edges, n = make_graph("tiny_clustered", seed=1, scale=0.2)
    cfg = AdwiseConfig(k=4, window_max=32, lazy=False)
    before = ops.launch_counts()["window_score"]
    gpu = partition_stream(edges, n, cfg, device=cuda)
    launches = ops.launch_counts()["window_score"] - before
    cpu = partition_stream(edges, n, cfg, device="cpu")
    np.testing.assert_array_equal(gpu.assign, cpu.assign)
    np.testing.assert_array_equal(gpu.stats["w_trace"], cpu.stats["w_trace"])
    assert gpu.stats["score_rows"] == cpu.stats["score_rows"]
    assert launches == gpu.stats["steps_run"] + gpu.stats["warmup_steps"]


def test_pagerank_on_the_card_matches_cpu(cuda):
    edges, n = make_graph("tiny_clustered", seed=1, scale=0.5)
    assign = (np.arange(len(edges)) % 4).astype(np.int32)
    a, _ = pagerank(build_partitioned_graph(edges, assign, n, 4, device="cpu"), iters=20)
    before = ops.launch_counts()["segment_sum"]
    b, _ = pagerank(build_partitioned_graph(edges, assign, n, 4, device=cuda), iters=20)
    assert ops.launch_counts()["segment_sum"] - before == 20
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-8)
