"""One ADWISE step of the port against one step of the JAX package.

Both packages start from the same mid-stream carry: the JAX scan runs some
steps, its ``Carry`` is taken out as numpy and handed to the port through
``repro_torch.convert``. Then each takes one step. The JAX step runs op by
op (``jax.disable_jit``): that is the step's arithmetic as written, a
multiply then a separate add. (Under ``jit`` XLA's CPU backend may contract
some multiply-adds of the fused step into FMAs, depending on its fusion
decisions; the whole-run tests in ``test_torch_adwise_runs.py`` hold the
port against the jitted ``partition_stream``.)

Every carry field and the step's outputs must be bit-equal, except Θ: it
is the mean of up to W non-negative fp32 values, which XLA sums in fp32 and
the port in fp64 (exact, then rounded once), so Θ is held to the error
bound of a W-term fp32 sum in any order, W·2⁻²⁴ relative.

The port's step advances a batch of instances; here the batch holds the
one instance (z = 1), its carry stacked from the JAX package's and taken
apart again after the step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.adwise import _init_carry as jax_init_carry
from repro.core.adwise import _make_step as jax_make_step
from repro.core.types import AdwiseConfig as JaxConfig
from repro_torch.convert import carry_from_numpy, carry_to_numpy
from repro_torch.core.adwise import StepOut, _make_step, stack_instances, take_instance
from repro_torch.core.types import AdwiseConfig
from repro_torch.graph import make_graph

torch.set_num_threads(1)

GRAPH = make_graph("tiny_clustered", seed=1, scale=0.1)
CPU = torch.device("cpu")
STEPS = 6

CONFIGS = [
    dict(k=4, window_max=64),
    dict(k=4, window_max=64, lazy=False),
    dict(k=4, window_max=64, use_clustering=False),
    dict(k=4, window_max=8, assign_batch=2),
    dict(k=6, window_max=16, cap_slack=None),
    dict(k=4, window_max=16, latency_budget=1e-3),
]


def _bits(a) -> np.ndarray:
    return np.asarray(a).reshape(-1).view(np.uint8)


def _pair(kw, allowed=None):
    """(jax step, port step, the JAX package's initial carry)."""
    edges, n = GRAPH
    m = len(edges)
    jcfg, tcfg = JaxConfig(**kw), AdwiseConfig(**kw)
    k = jcfg.k
    allowed = np.ones(k, bool) if allowed is None else allowed
    r_sel = jcfg.resolve_r_sel()
    cap = jcfg.cap_value(m, int(allowed.sum()))
    has_budget = jcfg.latency_budget is not None
    jstep = jax_make_step(
        jcfg, n, r_sel, jnp.asarray(edges), jnp.int32(m), jnp.asarray(allowed),
        jnp.int32(cap), has_budget, jnp.full((m,), -1, jnp.int32), True,
    )
    tstep = _make_step(
        tcfg, n, r_sel, torch.as_tensor(edges)[None], torch.tensor([m], dtype=torch.int32),
        torch.as_tensor(allowed)[None], torch.tensor([cap], dtype=torch.int32),
        has_budget, torch.full((1, m), -1, dtype=torch.int32), True,
    )
    carry = jax_init_carry(jcfg, n, jcfg.latency_budget or 0.0)
    carry = carry._replace(cost_per_score=jnp.float32(3e-7))
    return jstep, tstep, carry


def _fields(carry) -> dict:
    return {f: np.asarray(getattr(carry, f)) for f in carry._fields}


def _batch(fields) -> tuple:
    """The port's z = 1 batch of a JAX carry's fields."""
    return stack_instances([carry_from_numpy(fields, CPU)])


def _unbatch(port) -> dict:
    return carry_to_numpy(take_instance(port, 0))


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_one_step_bit_equal_from_mid_stream_carry(kw):
    jstep, tstep, carry = _pair(kw)
    run = jax.jit(lambda c: jax.lax.scan(jstep, c, None, length=120)[0])
    carry = run(carry)
    b = kw.get("assign_batch", 1)
    theta_checked = 0
    for _ in range(STEPS):
        start = _fields(carry)
        with jax.disable_jit():
            carry, jout = jstep(carry, None)
        port = _batch(start)
        out = StepOut.empty(1, 1, b, CPU)
        tstep(port, out)
        got, want = _unbatch(port), _fields(carry)
        for name in want:
            if name == "theta":
                bound = kw["window_max"] * 2.0**-24 * abs(float(want[name]))
                assert abs(float(got[name]) - float(want[name])) <= bound
                theta_checked += 1
                continue
            assert got[name].shape == want[name].shape, name
            np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]), err_msg=name)
        np.testing.assert_array_equal(out.sidx[0, 0].numpy(), np.asarray(jout.sidx))
        np.testing.assert_array_equal(out.p[0, 0].numpy(), np.asarray(jout.p))
        assert int(out.w_cap[0, 0]) == int(jout.w_cap)
        np.testing.assert_array_equal(_bits(out.g_chosen[0, 0].numpy()), _bits(jout.g_chosen))
        assert int(out.t[0]) == 1
    assert theta_checked == STEPS


def test_one_step_with_allowed_mask_bit_equal():
    allowed = np.array([True, False, True, True, False, True])
    kw = dict(k=6, window_max=32)
    jstep, tstep, carry = _pair(kw, allowed)
    carry = jax.jit(lambda c: jax.lax.scan(jstep, c, None, length=100)[0])(carry)
    start = _fields(carry)
    with jax.disable_jit():
        carry, _ = jstep(carry, None)
    port = _batch(start)
    tstep(port, StepOut.empty(1, 1, 1, CPU))
    got, want = _unbatch(port), _fields(carry)
    for name in want:
        if name != "theta":
            np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]), err_msg=name)
    assert not got["sizes"][~allowed].any()


def test_carry_round_trip_through_convert():
    _, _, carry = _pair(CONFIGS[0])
    fields = _fields(carry)
    port = carry_from_numpy(fields, CPU)
    assert port.cached_rcs.shape[0] == fields["cached_rcs"].shape[0] + 1  # dump row
    back = carry_to_numpy(port)
    assert set(back) == set(fields)
    for name in fields:
        assert back[name].dtype == fields[name].dtype, name
        np.testing.assert_array_equal(back[name], fields[name], err_msg=name)


def test_step_writes_outputs_at_the_device_counter():
    _, tstep, carry = _pair(CONFIGS[0])
    port = _batch(_fields(carry))
    out = StepOut.empty(5, 1, 1, CPU)
    for _ in range(5):
        tstep(port, out)
    assert int(out.t[0]) == 5
    sidx = out.sidx[:, 0, 0].numpy()
    assert len(set(sidx)) == 5 and (sidx >= 0).all()  # one new edge a step
    assert int(port.assigned) == 5
