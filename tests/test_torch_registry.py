"""The port's strategy registry against the JAX package's."""
import numpy as np
import pytest
import torch

from repro.core import registry as jreg
from repro.core.reference import ref_adwise_partition as jax_ref_adwise
from repro.core.types import AdwiseConfig as JaxConfig
from repro_torch.core import registry
from repro_torch.graph import make_graph

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["hash", "dbh", "grid"])
@pytest.mark.parametrize("preset,k,seed", [
    ("tiny_clustered", 4, 0), ("tiny_clustered", 32, 3), ("tiny_social", 9, 1),
])
def test_stateless_baselines_bit_equal(name, preset, k, seed):
    edges, n = make_graph(preset, seed=seed, scale=0.5)
    want = jreg.run_partitioner(name, edges, n, k, seed=seed)
    got = registry.run_partitioner(name, edges, n, k, seed=seed, device="cpu")
    assert got.assign.dtype == want.assign.dtype
    np.testing.assert_array_equal(got.assign, want.assign)
    assert got.stats["name"] == want.stats["name"] and got.stats["k"] == k


@pytest.mark.parametrize("name", ["hash", "dbh"])
def test_masked_hashes_bit_equal(name):
    edges, n = make_graph("tiny_clustered", seed=2, scale=0.5)
    allowed = np.array([False, True, True, False, True, False, False, True])
    want = jreg.run_partitioner(name, edges, n, 8, seed=1, allowed=allowed)
    got = registry.run_partitioner(name, edges, n, 8, seed=1, allowed=allowed,
                                   device="cpu")
    np.testing.assert_array_equal(got.assign, want.assign)


def test_grid_rejects_a_spread_mask_like_jax():
    edges, n = make_graph("tiny_clustered", seed=2, scale=0.2)
    with pytest.raises(ValueError, match="spotlight spread mask"):
        registry.run_partitioner("grid", edges, n, 4, allowed=np.ones(4, bool),
                                 device="cpu")


@pytest.mark.parametrize("kw", [
    dict(window_max=8), dict(window_max=4, lazy=False, use_clustering=False),
])
def test_adwise_oracle_equals_jax_reference(kw):
    edges, n = make_graph("tiny_clustered", seed=1, scale=0.06)
    got = registry.run_partitioner("adwise", edges, n, 4, oracle=True,
                                   device="cpu", **kw)
    want = jax_ref_adwise(edges, n, JaxConfig(k=4, **kw))
    np.testing.assert_array_equal(got.assign, want.assign)
    np.testing.assert_array_equal(got.stats["w_trace"], want.stats["w_trace"])
    np.testing.assert_array_equal(got.stats["lam_trace"], want.stats["lam_trace"])
    assert got.stats["score_count"] == want.stats["score_count"]


def test_adwise_through_the_registry_equals_jax():
    edges, n = make_graph("tiny_clustered", seed=1, scale=0.1)
    want = jreg.run_partitioner("adwise", edges, n, 4, window_max=32)
    got = registry.run_partitioner("adwise", edges, n, 4, window_max=32,
                                   device="cpu")
    np.testing.assert_array_equal(got.assign, want.assign)
    assert got.stats["score_rows"] == want.stats["score_rows"]


def test_unknown_config_key_raises_type_error():
    edges, n = make_graph("tiny_clustered", seed=1, scale=0.1)
    with pytest.raises(TypeError, match=r"adwise: unknown config keys \['windw_max'\]"):
        registry.run_partitioner("adwise", edges, n, 4, windw_max=8, device="cpu")
    with pytest.raises(TypeError):
        registry.run_partitioner("hash", edges, n, 4, lam=1.0, device="cpu")


def test_unknown_strategy_raises_key_error_listing_names():
    with pytest.raises(KeyError, match="available: 2ps, 2ps-l, adwise, adwise-restream, "
                                      "dbh, greedy, grid, hash, hdrf"):
        registry.get_partitioner("nope")
    assert registry.available_strategies() == jreg.available_strategies()


def test_register_rejects_a_duplicate_name():
    with pytest.raises(ValueError, match="already registered"):
        registry.register("hash")(lambda *a, **k: None)
