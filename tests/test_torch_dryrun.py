"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, on the CPU.

1. Bytes against JAX's rules: for every architecture, both production
   meshes and both modes, a rank's parameter, AdamW and cache bytes (the
   record's ``argument`` and ``alias``, with the batch's rows) equal the
   local shapes of ``repro.launch.sharding``'s ``param_specs`` /
   ``opt_specs`` / ``cache_specs`` / ``batch_specs`` over ``jax.eval_shape``
   leaves (specs only: no meta pass).
2. Against ``repro.launch.dryrun.run_cell`` itself, in one subprocess
   (importing it sets ``XLA_FLAGS`` to 512 devices, so this process never
   imports it), patched to reduced configs, a (2, 2) mesh, tp 2 and a
   64-token shape at a batch of 3, which the data axis does not divide
   (where it does, JAX 0.9 refuses ``with_sharding_constraint`` on its
   explicit mesh: ROADMAP.md §3): the port's ``run_cell`` on the same
   patched inputs has the same ``status``, ``n_chips``, ``model_flops``,
   ``bytes_per_device["argument"]`` and record keys (its one more,
   ``collectives``); ``cell_supported`` is equal for every (arch, shape).
3. A FLOP invariant: the ranks' FLOPs sum to the one-device count.
4. ``ops.flash_attention``'s meta branch: the kernel's tile arithmetic,
   read from its CUDA source, and its output's shape and layout.
5. The CLI: a production cell, a skipped cell, resume, an error record.

The collectives of the dry run are held to real gloo ranks in the rank
tests (``tests/_dry.py``).
"""
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import textwrap
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.data import make_batch_spec as jax_make_batch_spec
from repro.launch import sharding as jshg
from repro.models import lm as jlm
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MODEL_PARALLEL, MeshShape, make_production_mesh
from repro_torch.launch.sharding import local_shape

ROOT = pathlib.Path(__file__).resolve().parents[1]
ALL_ARCHS = [
    "rwkv6-7b", "llama3.2-3b", "phi3-mini-3.8b", "qwen1.5-110b",
    "qwen1.5-0.5b", "zamba2-7b", "whisper-tiny", "granite-moe-1b-a400m",
    "grok-1-314b", "internvl2-26b",
]
MESHES = {"1pod": make_production_mesh(), "2pod": make_production_mesh(multi_pod=True)}
TP = MODEL_PARALLEL
# JAX's run_cell in a subprocess: five cells at ~10 s of XLA compile each,
# and the import of 512 placeholder devices.
JAX_TIMEOUT = 600
SMALL_MESH = MeshShape(("data", "model"), (2, 2))
SMALL_SHAPES = {kind: ShapeConfig(kind, 64, 3, kind) for kind in ("train", "prefill", "decode")}
JAX_CELLS = [("llama3.2-3b", "train"), ("llama3.2-3b", "decode"),
             ("granite-moe-1b-a400m", "train"), ("rwkv6-7b", "prefill"),
             ("whisper-tiny", "train")]


# -- 1. bytes against JAX's rules ---------------------------------------------

def _local_bytes(tree, specs, mesh):
    """Σ over leaves of the local shape's elements × the dtype's bytes."""
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return sum(int(np.prod(local_shape(leaf.shape, tuple(spec), mesh))) * leaf.dtype.itemsize
               for leaf, spec in zip(leaves, spec_leaves))


def _jax_param_bytes(jcfg, mesh, params_shape, mode):
    return _local_bytes(params_shape, jshg.param_specs(jcfg, mesh, TP, params_shape, mode=mode),
                        mesh)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_bytes_follow_jax_specs(arch):
    """Every cell of ``arch`` on both production meshes, in mode 'train'
    (FSDP + TP; a serving cell's default, as in JAX's ``run_cell``) and,
    for a serving cell, 'serve' (TP only): ``argument`` = JAX's local
    params (+ AdamW m, v and step, and the batch's rows, in train; + the
    cache, the inputs' rows and decode's int32 position otherwise), and
    ``alias`` = the params and the moments, or the cache."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    params_shape = jax.eval_shape(partial(jlm.init_params, jcfg, tp=TP), key)
    opt_shape = {"m": jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32),
                                   params_shape)}
    n_cells = 0
    for mesh in MESHES.values():
        for name, shape in SHAPES.items():
            if not dryrun.cell_supported(cfg, shape)[0]:
                continue
            jshape = JAX_SHAPES[name]
            modes = ("train",) if shape.kind == "train" else ("train", "serve")
            for mode in modes:
                rec = dryrun.dry_run_rank(cfg, shape, mesh, mode=mode, cost=False)
                bpd = rec["bytes_per_device"]
                params = _jax_param_bytes(jcfg, mesh, params_shape, mode)
                if shape.kind == "train":
                    pspecs = jshg.param_specs(jcfg, mesh, TP, params_shape, mode="train")
                    moments = 2 * _local_bytes(opt_shape["m"], pspecs, mesh) + 4  # m, v, step
                    batch = jax_make_batch_spec(jcfg, jshape)
                    batch_bytes = _local_bytes(batch, jshg.batch_specs(jcfg, mesh, batch), mesh)
                    assert bpd["alias"] == params + moments, (name, mode)
                    assert bpd["argument"] == params + moments + batch_bytes, (name, mode)
                else:
                    cache = jax.eval_shape(partial(jlm.init_cache, jcfg, jshape.global_batch,
                                                   jshape.seq_len, tp=TP))
                    cache_bytes = _local_bytes(cache, jshg.cache_specs(jcfg, mesh, TP, cache), mesh)
                    if shape.kind == "decode":
                        tok = {"tokens": jax.ShapeDtypeStruct((jshape.global_batch, 1), jnp.int32)}
                        extra = 4  # the position
                    else:
                        tok = jax_make_batch_spec(jcfg, jshape, extra_token=False)
                        extra = 0
                    inputs = _local_bytes(tok, jshg.batch_specs(jcfg, mesh, tok), mesh)
                    assert bpd["alias"] == cache_bytes, (name, mode)
                    assert bpd["argument"] == params + cache_bytes + inputs + extra, (name, mode)
                assert rec["n_chips"] == mesh.size and rec["cost_exact"] is False
                n_cells += 1
    assert n_cells >= 2 * (1 + 2 * 2)  # train, 2 serving shapes in both modes; both meshes


def test_parameter_bytes_clear_the_sanity_floor():
    """A rank's parameters and AdamW state at ``train_4k`` on the 1-pod mesh
    hold at least ``param_count()`` × 10 B / 256 (bf16 weights, fp32 m and
    v, each split over 256 ranks; replicated leaves only add)."""
    for arch in ("llama3.2-3b", "qwen1.5-110b", "grok-1-314b"):
        cfg = get_config(arch)
        rec = dryrun.dry_run_rank(cfg, SHAPES["train_4k"], MESHES["1pod"], cost=False)
        assert rec["bytes_per_device"]["alias"] >= cfg.param_count() * 10 / 256, arch


# -- 2. JAX's run_cell ----------------------------------------------------------

_JAX_SCRIPT = textwrap.dedent(
    """
    import json
    import repro.launch.dryrun as D  # sets XLA_FLAGS: 512 placeholder devices
    import jax
    from repro import compat
    from repro.configs import ARCH_IDS, SHAPES, get_config
    from repro.configs.base import ShapeConfig

    out = {"supported": {f"{a}|{s}": list(D.cell_supported(get_config(a), SHAPES[s]))
                         for a in ARCH_IDS for s in SHAPES}}
    mesh = compat.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    D.get_config = lambda arch: get_config(arch).reduced()
    D.make_production_mesh = lambda multi_pod=False: mesh
    D.MODEL_PARALLEL = 2
    D.SHAPES = {k: ShapeConfig(k, 64, 3, k) for k in ("train", "prefill", "decode")}
    out["cells"] = {f"{a}|{s}": D.run_cell(a, s, False, verbose=False) for a, s in CELLS}
    print("RESULT " + json.dumps(out, default=float))
    """
)


@pytest.fixture(scope="module")
def jax_records():
    code = f"CELLS = {JAX_CELLS!r}\n" + _JAX_SCRIPT
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=JAX_TIMEOUT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu"), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def port_records():
    """The port's ``run_cell`` patched as the subprocess patches JAX's."""
    mp = pytest.MonkeyPatch()
    mp.setattr(dryrun, "get_config", lambda arch: get_config(arch).reduced())
    mp.setattr(dryrun, "make_production_mesh", lambda multi_pod=False: SMALL_MESH)
    mp.setattr(dryrun, "MODEL_PARALLEL", 2)
    mp.setattr(dryrun, "SHAPES", SMALL_SHAPES)
    try:
        return {f"{a}|{s}": dryrun.run_cell(a, s, False, verbose=False) for a, s in JAX_CELLS}
    finally:
        mp.undo()


@pytest.mark.parametrize("cell", JAX_CELLS, ids=["|".join(c) for c in JAX_CELLS])
def test_run_cell_matches_jax(cell, jax_records, port_records):
    """The same status, chip count, model FLOPs, argument bytes a device
    (XLA's ``memory_analysis`` against the port's local shapes: equal to
    the byte) and record keys (the port's adds ``collectives``), with the
    same ``bytes_per_device`` keys; both count collectives."""
    key = "|".join(cell)
    want, got = jax_records["cells"][key], port_records[key]
    assert set(got) - {"collectives"} == set(want)
    assert set(got["bytes_per_device"]) == set(want["bytes_per_device"])
    assert set(got["collective_bytes"]) <= set(want["collective_bytes"]) | {"reduce-scatter"}
    for k in ("status", "n_chips", "model_flops"):
        assert got[k] == want[k], k
    assert got["bytes_per_device"]["argument"] == want["bytes_per_device"]["argument"]
    assert got["collective_bytes"]["total"] > 0 and want["collective_bytes"]["total"] > 0


def test_cell_supported_matches_jax(jax_records):
    """``cell_supported`` of every (arch, shape), reason included."""
    for arch in ARCH_IDS:
        for name, shape in SHAPES.items():
            want = jax_records["supported"][f"{arch}|{name}"]
            assert list(dryrun.cell_supported(get_config(arch), shape)) == want, (arch, name)
    assert jax_records["supported"]["llama3_2_3b|long_500k"][0] is False


# -- 3. FLOPs -------------------------------------------------------------------

def _ranks(mesh):
    return [tuple(c) for c in np.ndindex(*mesh.sizes)]


def _flops_over_ranks(cfg, sizes):
    shape = ShapeConfig("t", 32, 4, "train")
    one = dryrun.dry_run_rank(cfg, shape, MeshShape(("data", "model"), (1, 1)))
    mesh = MeshShape(("data", "model"), sizes)
    recs = [dryrun.dry_run_rank(cfg, shape, mesh, coords) for coords in _ranks(mesh)]
    assert one["collectives"] == {} and all(r["collectives"] for r in recs)
    for r in recs + [one]:
        assert 0 < r["useful_flops_ratio"] <= 1
        assert r["model_flops"] == one["model_flops"]
    return one["hlo_flops"], sum(r["hlo_flops"] for r in recs)


# (mesh, reduced llama's KV heads): its 4 heads and 2 KV heads split at tp 2;
# at tp 4 with 4 KV heads; over data, its rows split.
FLOP_CASES = [((1, 2), 2), ((1, 4), 4), ((2, 1), 2)]


@pytest.mark.parametrize("sizes,n_kv", FLOP_CASES, ids=lambda c: str(c))
def test_rank_flops_sum_to_one_device(sizes, n_kv):
    """Reduced llama's training step (4 x 32 tokens): the FLOPs of the
    mesh's ranks (heads, columns, vocab or rows split) sum to the one-device
    count, and every rank's ``useful_flops_ratio`` lies in (0, 1]."""
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), n_kv=n_kv)
    assert sizes[1] == 1 or cfg.padded_heads(sizes[1])[2] == "shard"
    one, ranks = _flops_over_ranks(cfg, sizes)
    assert ranks == one


def test_replicated_kv_projections_add_their_flops_on_every_rank():
    """Under 'shard_q' (reduced llama's 2 KV heads at tp 4) each rank
    projects the whole K and V: the ranks' FLOPs exceed the one-device count
    by (tp - 1) times those products — 2·N·D·KVD each, for K and V, in the
    forward, the remat recompute and the backward's two (input and weight)
    — in each layer."""
    cfg = get_config("llama3.2-3b").reduced()
    assert cfg.padded_heads(4)[2] == "shard_q"
    one, ranks = _flops_over_ranks(cfg, (1, 4))
    n_tok, kvd = 4 * 32, cfg.n_kv * cfg.d_head
    kv = 2 * (1 + 1 + 2) * 2 * n_tok * cfg.d_model * kvd * cfg.n_layers
    assert ranks - one == 3 * kv


# -- 4. the flash_attention meta branch ------------------------------------------

def _source_tiles():
    """(q rows a block, KV rows a tile) of each body, read from the CUDA
    source."""
    src = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    small = (const("kBQ"), const("kBK"))
    return {"fma": small, "mma_sync": small, "wgmma": (const("kWgRows"),) * 2}


def _tile_pairs(tq, tk, causal, bq, bk):
    """Every (q tile, KV tile) pair the kernel runs, one by one: a KV tile
    runs when it starts at or below the position of its q tile's last row
    (causal), always otherwise."""
    n = 0
    for q0 in range(0, tq, bq):
        last = tk - tq + min(q0 + bq, tq) - 1
        n += sum(1 for k0 in range(0, tk, bk) if not causal or k0 <= last)
    return n


META_CASES = [  # (B, Hq, Hkv, Tq, Tk, Dh, dtype, causal)
    (2, 4, 2, 300, 300, 64, torch.bfloat16, True),
    (1, 6, 6, 200, 517, 128, torch.float16, True),
    (2, 4, 1, 77, 333, 64, torch.bfloat16, False),
    (1, 2, 2, 1, 45, 32, torch.bfloat16, False),
    (3, 3, 3, 130, 130, 96, torch.float32, True),
    (1, 8, 2, 5, 129, 112, torch.float16, False),
]


@pytest.mark.parametrize("case", META_CASES, ids=lambda c: f"{c[3]}x{c[4]}-{c[5]}-{c[7]}")
def test_flash_attention_meta_credits_the_kernels_tiles(case):
    """On meta tensors the op returns an output of the kernel's shape and
    layout ((B, Tq, Hq, Dh) in memory), credits 4·rows·cols·Dh a tile pair
    over the pairs the kernel runs (a causal call skips those above the
    diagonal; the ragged edges at the tiles' size), and launches nothing."""
    b, hq, hkv, tq, tk, dh, dtype, causal = case
    assert {k: fa.TILES[k] for k in fa.TILES} == _source_tiles()
    q = torch.empty((b, hq, tq, dh), dtype=dtype, device="meta")
    k = torch.empty((b, hkv, tk, dh), dtype=dtype, device="meta")
    launches, calls, flops = ops.launch_counts(), fa.META_CALLS, fa.META_FLOPS
    out = ops.flash_attention(q, k, k, causal=causal)
    assert out.device.type == "meta" and out.shape == (b, hq, tq, dh) and out.dtype == dtype
    assert out.transpose(1, 2).is_contiguous()
    bq, bk = fa.TILES[fa.body_for(dtype, dh)]
    want = b * hq * _tile_pairs(tq, tk, causal, bq, bk) * 4 * bq * bk * dh
    assert fa.META_FLOPS - flops == want == fa.kernel_flops(q.shape, tk, dtype, causal)
    assert fa.META_CALLS == calls + 1 and ops.launch_counts() == launches
    if causal and tq == tk and tq > bq:
        assert want < b * hq * 4 * bq * bk * dh * -(-tq // bq) * -(-tk // bk)  # tiles skipped


def test_flash_attention_meta_refuses_what_the_kernel_refuses():
    q = torch.empty((1, 2, 8, 80), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="Dh must be one of"):
        ops.flash_attention(q, q, q)
    q = torch.empty((1, 2, 9, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 2, 8, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="causal needs Tq <= Tk"):
        ops.flash_attention(q, k, k, causal=True)


# -- 5. the CLI -------------------------------------------------------------------

def test_cli_runs_resumes_skips_and_records_errors(tmp_path, capsys):
    """``main`` on a production decode cell (1-pod): one ok record with
    JAX's keys; ``long_500k`` of a full-attention arch skipped with JAX's
    reason; a second ``main`` on the same ``--out`` redoes nothing; a cell
    that raises gives an error record and exit code 1."""
    out = str(tmp_path / "dry.json")
    assert dryrun.main(["--arch", "llama3.2-3b", "--shape", "decode_32k", "--out", out]) == 0
    assert dryrun.main(["--arch", "llama3.2-3b", "--shape", "long_500k", "--out", out]) == 0
    recs = json.loads(pathlib.Path(out).read_text())
    assert [r["status"] for r in recs] == ["ok", "skipped"]
    ok, skipped = recs
    assert ok["n_chips"] == 256 and ok["cost_exact"] and ok["dominant"] in (
        "compute", "memory", "collective")
    assert ok["bytes_per_device"]["temp"] > 0 and ok["collective_bytes"]["total"] > 0
    assert ok["model_flops"] == 2 * get_config("llama3.2-3b").active_param_count() * 128
    assert skipped["reason"] == "full-attention arch: 500k decode needs sub-quadratic mixer"
    before = pathlib.Path(out).read_text()
    capsys.readouterr()
    assert dryrun.main(["--arch", "llama3.2-3b", "--shape", "decode_32k", "--out", out]) == 0
    assert pathlib.Path(out).read_text() == before
    assert "[llama3.2-3b" not in capsys.readouterr().out  # no cell ran again
    assert dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k", "--out", out]) == 1
    recs = json.loads(pathlib.Path(out).read_text())
    assert recs[-1]["status"] == "error" and recs[-1]["arch"] == "no-such-arch"
    assert "dry-run: 1 ok, 1 skipped (documented), 1 errors" in capsys.readouterr().out


def test_multi_pod_cells_run_no_meta_pass():
    """A 2-pod cell: the specs' bytes, no cost fields, ``cost_exact``
    False, 512 chips."""
    rec = dryrun.run_cell("granite-moe-1b-a400m", "train_4k", True, verbose=False)
    assert rec["status"] == "ok" and rec["n_chips"] == 512 and rec["cost_exact"] is False
    assert rec["hlo_flops"] is None and rec["bytes_per_device"]["temp"] is None
    assert rec["bytes_per_device"]["argument"] > rec["bytes_per_device"]["alias"] > 0
