"""The port's sharding rules against the JAX package's, with no process
group: ``repro_torch.launch.sharding``'s ``param_specs`` (modes 'train'
and 'serve', and ``ep_override=False``), ``cache_specs`` and
``batch_specs`` equal ``repro.launch.sharding``'s leaf by leaf for all ten
architectures on both production meshes (the port's shape-only
``MeshShape``, which the JAX rules take as ``tests/test_sharding.py``'s
``FakeMesh``); port models and caches on the ``meta`` device, JAX's from
``jax.eval_shape``. ``local_slice`` tiles every leaf exactly, the head
policy table holds, and ``make_batch_spec`` has JAX's shapes and dtypes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.data import make_batch_spec as jax_make_batch_spec
from repro.launch import sharding as jshg
from repro.models import lm as jlm
from repro_torch.configs import SHAPES, get_config
from repro_torch.data import make_batch_spec
from repro_torch.launch import sharding
from repro_torch.launch.mesh import MODEL_PARALLEL, MeshShape, make_production_mesh
from repro_torch.models import lm
from repro_torch.models.names import jax_leaf

ALL_ARCHS = [
    "rwkv6-7b", "llama3.2-3b", "phi3-mini-3.8b", "qwen1.5-110b",
    "qwen1.5-0.5b", "zamba2-7b", "whisper-tiny", "granite-moe-1b-a400m",
    "grok-1-314b", "internvl2-26b",
]
MOE_ARCHS = ["granite-moe-1b-a400m", "grok-1-314b"]
MESHES = {"1pod": make_production_mesh(), "2pod": make_production_mesh(multi_pod=True)}
TP = MODEL_PARALLEL


def _path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _flat_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {_path(p): tuple(s) for p, s in flat}


@functools.lru_cache(maxsize=None)
def _jax_params_shape(arch):
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    return jax.eval_shape(lambda k: jlm.init_params(jax_get_config(arch), k, tp=TP), key)


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    return lm.LM(get_config(arch), TP, device="meta")


def _check_params(arch, mesh, mode, ep_override=None):
    want = _flat_specs(jshg.param_specs(jax_get_config(arch), mesh, TP, _jax_params_shape(arch),
                                        mode=mode, ep_override=ep_override))
    model = _port_model(arch)
    got = sharding.param_specs(get_config(arch), mesh, TP, model, mode=mode,
                               ep_override=ep_override)
    assert set(got) == {n for n, _ in model.named_parameters()}
    seen = set()
    for name, spec in got.items():
        key, layer = jax_leaf(name)
        jspec = want[key.replace(".", "/")]
        assert spec == (jspec if layer is None else jspec[1:]), (name, spec, jspec)
        if layer is not None:
            assert jspec[0] is None
        seen.add(key.replace(".", "/"))
    assert seen == set(want)


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_equal_jax(arch, mesh, mode):
    _check_params(arch, MESHES[mesh], mode)


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_specs_with_d_ff_split_experts_equal_jax(arch, mesh, mode):
    """``ep_override=False``: each expert's d_ff over 'model', not the
    experts."""
    _check_params(arch, MESHES[mesh], mode, ep_override=False)


# SSM mixers whose heads tp does not divide (4 heads at tp 3, D 192; the
# hybrid's d_in 384): the JAX rules split their columns over 'model' off
# head boundaries (192 / 3 = 64 columns, 1.33 heads). JAX's specs only
# place data, since its serve path runs one program (``repro.launch.serve``
# builds a mesh and never uses it); the port's ranks run the mixers, so its
# rules replicate every ``att`` / ``cm`` / ``mamba`` leaf over 'model'
# (each rank runs the mixer whole). Every other leaf's spec is JAX's.
MIXER_CASES = [("rwkv6-7b", {"d_model": 192, "d_head": 48, "d_ff": 384}),
               ("zamba2-7b", {"d_model": 192})]


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch,changes", MIXER_CASES, ids=[c[0] for c in MIXER_CASES])
def test_param_specs_replicate_mixers_that_tp_does_not_split(arch, changes, mode):
    """On a (2, 3) mesh: each port spec equals JAX's, except the mixers'
    leaves, which are JAX's with 'model' dropped (and JAX splits some)."""
    import dataclasses

    from repro_torch.configs.base import ArchConfig

    mesh = MeshShape(("data", "model"), (2, 3))
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **changes)
    cfg = ArchConfig(**dict(jcfg.__dict__))
    assert cfg.n_heads % 3
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    jshape = jax.eval_shape(lambda k: jlm.init_params(jcfg, k, tp=3), key)
    want = _flat_specs(jshg.param_specs(jcfg, mesh, 3, jshape, mode=mode))
    got = sharding.param_specs(cfg, mesh, 3, lm.LM(cfg, 3, device="meta"), mode=mode)
    differs = 0
    for name, spec in got.items():
        key, layer = jax_leaf(name)
        jspec = want[key.replace(".", "/")]
        jspec = jspec if layer is None else jspec[1:]
        if {"att", "cm", "mamba"} & set(key.split(".")):
            dropped = tuple(None if e == "model" else e for e in jspec)
            assert spec == dropped and "model" not in spec, (name, spec, jspec)
            differs += spec != jspec
        else:
            assert spec == jspec, (name, spec, jspec)
    assert differs > 0


@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_equal_jax(arch, mesh):
    """Batch 128 (divisible by the data axes) and 1 (replicated), 1,024
    positions over 'model'."""
    mesh_ = MESHES[mesh]
    for batch in (128, 1):
        jshape = jax.eval_shape(lambda: jlm.init_cache(jax_get_config(arch), batch, 1024, tp=TP))
        want = _flat_specs(jshg.cache_specs(jax_get_config(arch), mesh_, TP, jshape))
        cache = lm.init_cache(get_config(arch), batch, 1024, tp=TP, device="meta")
        specs = sharding.cache_specs(get_config(arch), mesh_, TP, cache)
        paths = [_path(p) for p, _ in jax.tree_util.tree_flatten_with_path(cache)[0]]
        assert {p: _at(specs, p) for p in paths} == want


def _at(tree, path):
    """The node of a tree of dicts, tuples and lists at a "/"-joined path
    (the spec trees have tuple leaves, so they are walked by the cache's
    paths)."""
    for k in path.split("/"):
        tree = tree[k] if isinstance(tree, dict) else tree[int(k)]
    return tree


@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batch_specs_equal_jax(arch, mesh):
    """Every shape cell's batch (global batches 256, 32, 128, 1), with and
    without the extra label token."""
    mesh_ = MESHES[mesh]
    for cell in SHAPES:
        for extra in (True, False):
            jspec = jax_make_batch_spec(jax_get_config(arch), JAX_SHAPES[cell], extra)
            want = _flat_specs(jshg.batch_specs(jax_get_config(arch), mesh_, jspec))
            spec = make_batch_spec(get_config(arch), SHAPES[cell], extra)
            got = sharding.batch_specs(get_config(arch), mesh_, spec)
            assert {k: tuple(v) for k, v in got.items()} == want


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_make_batch_spec_matches_jax(arch):
    """Shapes and dtypes of every cell's batch stand-ins, on the meta device."""
    for cell in SHAPES:
        for extra in (True, False):
            want = jax_make_batch_spec(jax_get_config(arch), JAX_SHAPES[cell], extra)
            got = make_batch_spec(get_config(arch), SHAPES[cell], extra)
            assert got.keys() == want.keys()
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), (cell, k)
                assert str(t.dtype).split(".")[1] == str(np.dtype(want[k].dtype)), (cell, k)


def _coords(mesh):
    for flat in range(mesh.size):
        coords, rest = {}, flat
        for ax, n in reversed(list(mesh.shape.items())):
            coords[ax], rest = rest % n, rest // n
        yield coords


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_local_slice_tiles_every_leaf(arch, mesh, mode):
    """Over every rank of the mesh, each dimension's slices are equal
    consecutive chunks that cover it, and each element is held by as many
    ranks as the axes the spec does not name have — for one layer of every
    parameter leaf and every cache leaf."""
    mesh_ = MESHES[mesh]
    model = _port_model(arch)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters() if jax_leaf(n)[1] in (None, 0)}
    specs = sharding.param_specs(get_config(arch), mesh_, TP, shapes, mode=mode)
    cache = lm.init_cache(get_config(arch), 128, 1024, tp=TP, device="meta")
    flat = jax.tree_util.tree_flatten_with_path(cache)[0]
    for p, t in flat:
        shapes[_path(p)] = tuple(t.shape)
        specs[_path(p)] = sharding.cache_spec(get_config(arch), mesh_, TP, _path(p), t.shape)
    all_coords = list(_coords(mesh_))
    for name, shape in shapes.items():
        spec = specs[name]
        named = [ax for e in spec if e is not None for ax in (e if isinstance(e, tuple) else (e,))]
        assert len(named) == len(set(named)), (name, spec)
        copies = mesh_.size // int(np.prod([mesh_.shape[a] for a in named]))
        held = {}
        for c in all_coords:
            key = tuple((s.start, s.stop) for s in sharding.local_slice(shape, spec, mesh_, c))
            held[key] = held.get(key, 0) + 1
        assert set(held.values()) == {copies}, name
        for d, dim in enumerate(shape):
            bounds = sorted({k[d] for k in held})
            assert bounds[0][0] == 0 and bounds[-1][1] == dim, (name, d)
            assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:])), (name, d)
            assert len({hi - lo for lo, hi in bounds}) == 1, (name, d)
        assert sharding.local_shape(shape, spec, mesh_) == tuple(
            hi - lo for lo, hi in next(iter(held)))


def test_head_policy_table():
    """The attention TP policy of each architecture at tp 16 (as
    ``tests/test_sharding.py`` documents it) and at the small degrees the
    tensor-parallel tests run, equal to JAX's."""
    expect = {
        "llama3.2-3b": "pad",         # 24 Q heads -> 32
        "phi3-mini-3.8b": "shard",    # 32/32
        "qwen1.5-110b": "shard_q",    # 64 Q, 8 KV replicated
        "whisper-tiny": "replicate",  # 6 heads, padding too wasteful
        "grok-1-314b": "shard_q",
        "qwen1.5-0.5b": "shard",
    }
    for arch, policy in expect.items():
        assert get_config(arch).padded_heads(16)[2] == policy, arch
    assert get_config("llama3.2-3b").padded_heads(16) == (32, 8, "pad")
    for arch in ALL_ARCHS:
        for tp in (1, 2, 3, 4, 8, 16):
            assert get_config(arch).padded_heads(tp) == jax_get_config(arch).padded_heads(tp)
            assert (get_config(arch).reduced().padded_heads(tp)
                    == jax_get_config(arch).reduced().padded_heads(tp))


def test_mesh_shape_is_what_the_jax_rules_read():
    """``MeshShape``: ordered axes and sizes; the production meshes."""
    m1, m2 = MESHES["1pod"], MESHES["2pod"]
    assert m1.shape == {"data": 16, "model": 16} and m1.axis_names == ("data", "model")
    assert list(m2.shape) == ["pod", "data", "model"] and m2.size == 512
    assert sharding.fsdp_axes(m2) == ("pod", "data") and jshg.fsdp_axes(m2) == ("pod", "data")
    assert sharding.opt_specs(None, m1, TP, None, {"w": ("model",)}) == dict(
        m={"w": ("model",)}, v={"w": ("model",)}, step=())
    with pytest.raises(ValueError):
        MeshShape(("data",), (1, 2))
