"""Whole ADWISE runs of the port against ``repro.core.partition_stream``.

Same edges, same configuration, the JAX package's jitted scan against the
port's plain CPU loop: assignments, ``score_rows``, ``w_trace``,
``final_w``, ``lam_final`` and the driver's chunking are equal. The sweep
covers lazy traversal on and off, the clustering score on and off, batched
assignment, a small window, an ``allowed`` mask, no capacity cap and a
latency budget with a pinned per-score cost (without the pin the window
controller would recalibrate from wall time, which differs between runs).
"""
import numpy as np
import pytest
import torch

from repro.core import AdwiseConfig as JaxConfig
from repro.core import partition_stream as jax_partition_stream
from repro_torch.core import AdwiseConfig, partition_stream
from repro_torch.graph import make_graph

torch.set_num_threads(1)

GRAPH = make_graph("tiny_clustered", seed=1, scale=0.1)

SWEEP = [
    (dict(k=4, window_max=64), None),
    (dict(k=4, window_max=64, lazy=False), None),
    (dict(k=4, window_max=64, use_clustering=False), None),
    (dict(k=4, window_max=64, assign_batch=2), None),
    (dict(k=4, window_max=8), None),
    (dict(k=6, window_max=32), np.array([True, False, True, True, False, True])),
    (dict(k=4, window_max=32, cap_slack=None), None),
    (dict(k=4, window_max=32, cap_slack=1.15, lazy=False, use_clustering=False), None),
    (dict(k=4, window_max=64, latency_budget=2e-3), None),
]


def _id(case):
    kw, allowed = case
    s = ",".join(f"{k}={v}" for k, v in kw.items())
    return s + (",allowed" if allowed is not None else "")


@pytest.mark.parametrize("case", SWEEP, ids=_id)
def test_partition_stream_equals_jax(case):
    kw, allowed = case
    edges, n = GRAPH
    want = jax_partition_stream(edges, n, JaxConfig(**kw), allowed=allowed,
                                cost_per_score=3e-7)
    got = partition_stream(edges, n, AdwiseConfig(**kw), allowed=allowed,
                           cost_per_score=3e-7, device="cpu")
    np.testing.assert_array_equal(got.assign, want.assign)
    np.testing.assert_array_equal(got.stats["w_trace"], want.stats["w_trace"])
    for key in ("score_rows", "score_count", "final_w", "lam_final", "assigned",
                "scan_calls", "scan_steps_per_call", "r_sel", "unassigned", "k"):
        assert got.stats[key] == want.stats[key], key
    if allowed is not None:
        assert set(np.unique(got.assign)) <= set(np.flatnonzero(allowed))


def test_partition_stream_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    edges, n = GRAPH
    with pytest.raises(RuntimeError, match="device='cpu'"):
        partition_stream(edges, n, AdwiseConfig(k=4))
