"""Each port scoring function is bit-equal to ``repro.core.scoring``.

``repro.core.scoring.window_scores`` is jitted, and XLA's CPU backend fuses
its ``lam * bal + R`` into an FMA (ROADMAP.md, queue 3); the port computes
the multiply and the add separately, as the code is written, so that one is
compared with the JAX function run op by op (``jax.disable_jit``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scoring as jsc
from repro_torch.core import scoring as tsc

torch.set_num_threads(1)

CASES = [(0, 1, 1), (1, 16, 4), (2, 64, 32), (3, 200, 20), (4, 256, 64)]


def _inputs(seed, w, k):
    rng = np.random.default_rng(seed)
    # Degrees never exceed max_deg (it is their running maximum), so
    # 2 - ψ > 0; with 2 - ψ < 0 XLA's select-for-bool·x gives +0.0 where a
    # multiply gives -0.0 (ROADMAP.md, queue 3).
    max_deg = np.int32(rng.integers(0, 600))
    return dict(
        uv=rng.integers(0, max(2, w // 2), (w, 2)).astype(np.int32),
        valid=rng.random(w) < 0.8,
        rep_u=rng.random((w, k)) < 0.3,
        rep_v=rng.random((w, k)) < 0.3,
        deg_u=rng.integers(0, max_deg + 1, w).astype(np.int32),
        deg_v=rng.integers(0, max_deg + 1, w).astype(np.int32),
        max_deg=max_deg,
        sizes=rng.integers(0, 10_000, k).astype(np.int32),
        allowed=np.r_[True, rng.random(k - 1) < 0.7],
        lam=np.float32(rng.uniform(0.4, 5.0)),
        assigned=np.int32(rng.integers(0, 50_000)),
        m=np.int32(rng.integers(1, 60_000)),
    )


def _bits_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(
        got.reshape(-1).view(np.uint8), want.reshape(-1).view(np.uint8)
    )


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("seed,w,k", CASES)
def test_balance_score_bit_equal(seed, w, k):
    x = _inputs(seed, w, k)
    for eps in (0.01, 1.0):
        _bits_equal(
            tsc.balance_score(_t(x["sizes"]), _t(x["allowed"]), eps),
            jsc.balance_score(jnp.asarray(x["sizes"]), jnp.asarray(x["allowed"]), eps),
        )


@pytest.mark.parametrize("seed,w,k", CASES)
def test_replication_score_bit_equal(seed, w, k):
    x = _inputs(seed, w, k)
    names = ("rep_u", "rep_v", "deg_u", "deg_v", "max_deg")
    _bits_equal(
        tsc.replication_score(*(_t(x[n]) for n in names)),
        jsc.replication_score(*(jnp.asarray(x[n]) for n in names)),
    )


@pytest.mark.parametrize("seed,w,k", CASES)
def test_clustering_terms_bit_equal(seed, w, k):
    x = _inputs(seed, w, k)
    names = ("uv", "valid", "rep_u", "rep_v")
    got = tsc.clustering_terms(*(_t(x[n]) for n in names))
    want = jsc.clustering_terms(*(jnp.asarray(x[n]) for n in names))
    for a, b in zip(got, want):
        _bits_equal(a, b)


@pytest.mark.parametrize("seed,w,k", CASES)
@pytest.mark.parametrize("use_cs", [True, False])
def test_window_scores_bit_equal(seed, w, k, use_cs):
    x = _inputs(seed, w, k)
    names = ("uv", "valid", "rep_u", "rep_v", "deg_u", "deg_v", "max_deg",
             "sizes", "allowed", "lam")
    with jax.disable_jit():
        want = jsc.window_scores(*(jnp.asarray(x[n]) for n in names), use_cs=use_cs)
    _bits_equal(tsc.window_scores(*(_t(x[n]) for n in names), use_cs=use_cs), want)


@pytest.mark.parametrize("seed,w,k", CASES)
def test_lambda_update_bit_equal(seed, w, k):
    x = _inputs(seed, w, k)
    names = ("lam", "sizes", "allowed", "assigned", "m")
    _bits_equal(
        tsc.lambda_update(*(_t(x[n]) for n in names), 0.4, 5.0),
        jsc.lambda_update(*(jnp.asarray(x[n]) for n in names), 0.4, 5.0),
    )
