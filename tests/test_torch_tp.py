"""Tensor-parallel serving of the port against the JAX package, on the CPU.

Ranks are separate processes (``repro_torch.launch.mesh.spawn``), joined in
a gloo group through a file store under ``tmp_path`` (no ports), each on a
(data, model) mesh from ``launch.mesh.make_local_mesh``. A reduced fp32
model is carried from JAX's ``init_params(..., tp=T)`` (its heads padded
for T) to each rank's slice by ``convert.lm_params_from_numpy(shard=)``;
every rank prefills its rows of the batch and decodes 3 steps fed JAX's
greedy tokens. The logits each rank returns (gathered over the vocab) and
the whole cache (reassembled from the ranks' pieces where each rank's
``Shard.cache_index`` places them) are held to JAX's ``forward_cached(...,
tp=T)`` on one device — the function ``repro.launch.serve --tp T``
computes — within 1e-5 of the tensor's scale, and the greedy tokens must
be equal. Every spawn is joined with a timeout, so a hung rendezvous fails
the test instead of holding the suite.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.launch import mesh as meshes
from repro_torch.launch import sharding
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import lm

import _dry
import _tp_ranks

TOL = 1e-5
SPAWN_TIMEOUT = 120.0

# (id, arch, changes to its reduced config, (data, model) mesh, ep_override);
# 2 of the reduced configs' 4 layers, so the file stays near a minute.
CASES = [
    ("dense-shard", "qwen1.5-0.5b", {}, (1, 2), None),
    ("dense-shard_q", "qwen1.5-0.5b", {}, (1, 4), None),
    ("dense-pad", "llama3.2-3b", {"n_heads": 4}, (1, 3), None),
    ("dense-replicate", "qwen1.5-0.5b", {"n_heads": 2, "n_kv": 1}, (1, 4), None),
    ("moe-ep", "granite-moe-1b-a400m", {}, (1, 2), None),
    ("moe-dff", "granite-moe-1b-a400m", {}, (1, 2), False),
    ("vlm", "internvl2-26b", {}, (1, 2), None),
    ("mesh-2x2", "qwen1.5-0.5b", {}, (2, 2), None),
]
N_LAYERS = 2
POLICY = {"dense-shard": "shard", "dense-shard_q": "shard_q", "dense-pad": "pad",
          "dense-replicate": "replicate", "vlm": "shard", "mesh-2x2": "shard"}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, changes):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), n_layers=N_LAYERS, **changes)
    kw = dict(jcfg.__dict__)
    if jcfg.moe is not None:
        kw["moe"] = MoEConfig(**jcfg.moe.__dict__)
    return jcfg, ArchConfig(**kw)


def _assert_close(got, want, what):
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale, err_msg=what)


def _max_seq(cfg, tp, need):
    """The least cache length >= ``need`` whose positions (with the vlm's
    patches) split over tp."""
    extra = cfg.vlm_patches if cfg.family == "vlm" else 0
    return need + (-(need + extra)) % tp


def _jax_run(jcfg, tp, b, t, n_dec, max_seq, seed=0, frames=None):
    """JAX's prefill of random prompts (+ the vlm's patches, or ``frames``
    frames for whisper) and ``n_dec`` greedy decode steps at ``tp``."""
    params = _np_tree(jlm.init_params(jcfg, jax.random.PRNGKey(seed), tp=tp))
    rng = np.random.default_rng(seed + 1)
    prompts = rng.integers(0, jcfg.vocab, (b, t)).astype(np.int32)
    extras = {}
    if frames is not None:
        extras["frames"] = rng.normal(size=(b, frames, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "vlm":
        extras["patches"] = rng.normal(size=(b, jcfg.vlm_patches, jcfg.d_model)).astype(np.float32)
    cache = jlm.init_cache(jcfg, b, max_seq, tp=tp)
    jlog, cache = jlm.forward_cached(params, jcfg, cache, jnp.asarray(prompts), jnp.int32(0), tp=tp,
                                     **{k: jnp.asarray(v) for k, v in extras.items()})
    logits, tokens = [np.asarray(jlog)], []
    offset = jcfg.vlm_patches if jcfg.family == "vlm" else 0
    for i in range(n_dec):
        tok = np.asarray(jnp.argmax(jlog[:, -1:], axis=-1)).astype(np.int32)
        tokens.append(tok)
        jlog, cache = jlm.forward_cached(params, jcfg, cache, jnp.asarray(tok),
                                         jnp.int32(offset + t + i), tp=tp)
        logits.append(np.asarray(jlog))
    return params, prompts, extras, tokens, logits, _np_tree(cache)


def _reassemble(cfg, tp, mesh, want_cache, results):
    """The whole cache from the ranks' pieces, each placed where its rank's
    ``Shard.cache_index`` puts it (``local_slice`` of the spec; a sequence
    tp does not divide laid out over ⌈S / tp⌉ · tp positions, the KV
    pieces' padding zeros, never written, the cross K/V pieces cut at the
    frames); every element is held by as many ranks as the axes its spec
    does not name have."""
    full = jax.tree.map(np.zeros_like, want_cache)
    flat = jax.tree_util.tree_flatten_with_path(full)[0]
    paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p) for p, _ in flat]
    shards = [sharding.shard_for(cfg, mesh, coords=tuple(res["coords"][a] for a in mesh.axis_names))
              for res in results]
    for path, (_, whole) in zip(paths, flat):
        spec = sharding.cache_spec(cfg, mesh, tp, path, whole.shape)
        named = [a for a in spec if a is not None]
        copies = mesh.size // int(np.prod([mesh.shape[a] for a in named]))
        padded = tuple(-(-n // tp) * tp if a == "model" else n for n, a in zip(whole.shape, spec))
        buf, cover = np.zeros(padded, whole.dtype), np.zeros(padded, np.int32)
        for res, shard in zip(results, shards):
            piece = jax.tree.leaves(res["cache"])[paths.index(path)]
            idx = shard.cache_index(path, whole.shape)
            assert piece.shape == tuple(i.stop - i.start for i in idx), path
            buf[idx] = piece
            cover[idx] += 1
        inside = tuple(slice(0, n) for n in whole.shape)
        assert (cover[inside] == copies).all(), f"{path}: the ranks' pieces tile the leaf"
        rest = np.ones(padded, bool)
        rest[inside] = False
        assert not buf[rest].any(), f"{path}: the padding past the sequence is never written"
        whole[...] = buf[inside]
    return full


def _assert_dry_run_counts(cfg, mesh, res, prompts, extras, tokens, max_seq, ep=None):
    """The dry run of the rank (``launch.dryrun`` on meta tensors, its
    shard in counting mode) counts the collectives the rank issued over
    gloo, by op, count and bytes: the prefill's, and each decode step's."""
    kw = dict(mode="serve", cache_len=max_seq, ep=ep)
    coords = res["coords"]
    prefill = _dry.collectives(cfg, mesh, coords, "prefill", dict(extras, tokens=prompts), **kw)
    assert _dry.counted(res["step_stats"][0]) == prefill, (coords, "prefill")
    decode = _dry.collectives(cfg, mesh, coords, "decode", {"tokens": tokens[0]}, **kw)
    for i, got in enumerate(res["step_stats"][1:]):
        assert _dry.counted(got) == decode, (coords, "decode", i)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_forward_cached_matches_jax(case, tmp_path):
    """Prefill + 3 decode steps on every rank against JAX's forward_cached(...,
    tp=T): logits of each rank's rows and the reassembled cache within 1e-5
    of their scale, greedy tokens equal; the decode merge ran (one max
    all-reduce per layer and step); the dry run of each rank counts its
    collectives."""
    name, arch, changes, (dp, tp), ep = case
    jcfg, cfg = _configs(arch, changes)
    if name in POLICY:
        assert cfg.padded_heads(tp)[2] == POLICY[name]
    b, t, n_dec = 2 * dp, 13, 3
    max_seq = _max_seq(cfg, tp, t + n_dec + 1)
    params, prompts, extras, tokens, want, want_cache = _jax_run(jcfg, tp, b, t, n_dec, max_seq)
    results = meshes.spawn(
        _tp_ranks.forward_rank, dp * tp,
        (cfg, tp, params, b, max_seq, prompts, extras, tokens, str(tmp_path / "store"), "cpu", ep),
        timeout=SPAWN_TIMEOUT)
    mesh = MeshShape(("data", "model"), (dp, tp))
    for res in results:
        lo, hi = res["rows"]
        assert (hi - lo) == b // dp  # the data axis divides the batch: each rank its rows
        for i, (got, w) in enumerate(zip(res["logits"], want)):
            _assert_close(got, w[lo:hi], f"{name} rank {res['coords']} step {i}")
            np.testing.assert_array_equal(got[:, -1].argmax(-1), w[lo:hi, -1].argmax(-1))
        assert res["stats"]["all_reduce_max"][0] == cfg.n_layers * n_dec
        _assert_dry_run_counts(cfg, (dp, tp), res, prompts, extras, tokens, max_seq, ep)
    _full = _reassemble(cfg, tp, mesh, want_cache, results)
    jax.tree.map(lambda g, w: _assert_close(g, w, f"{name} cache"), _full, want_cache)
    if ep is False:  # d_ff split: every rank holds every expert
        assert results[0]["shapes"]["blocks.0.moe.w_gate"][0] == cfg.moe.n_experts
    elif cfg.moe is not None:
        assert results[0]["shapes"]["blocks.0.moe.w_gate"][0] == cfg.moe.n_experts // tp


def test_serve_tp2_gives_the_tokens_of_tp1(tmp_path):
    """``launch.serve --tp 2`` over two ranks: the tokens of ``--tp 1`` (the
    same weights, drawn whole and split), every step's logits within 1e-5
    of their scale, rank 0's info with the run's tp, world, backend and
    collectives."""
    from repro_torch.launch import serve

    argv = ["--arch", "qwen1.5-0.5b", "--reduced", "--batch", "4", "--prompt-len", "16",
            "--gen", "8", "--device", "cpu"]
    info1 = {}
    want = serve.main(argv, info=info1, keep_logits=True)
    store = tmp_path / "store"
    results = meshes.spawn(_tp_ranks.serve_rank, 2,
                           (argv + ["--tp", "2", "--dist-init", f"file://{store}"],),
                           timeout=SPAWN_TIMEOUT)
    for gen, info, logits in results:
        np.testing.assert_array_equal(gen, want)
        for got, w in zip(logits, info1["logits"]):
            _assert_close(got, w, "serve --tp 2 logits")
        assert (info["tp"], info["world"], info["backend"], info["policy"]) == (2, 2, "gloo", "shard")
        assert info["prefill_collectives"]["all_gather"][0] > 0
        assert info["decode_collectives"]["all_reduce_max"][0] == 4 * 7  # layers x steps
    cfg = get_config("qwen1.5-0.5b").reduced()
    for r, (_, info, _) in enumerate(results):  # the dry run of each rank counts its collectives
        kw = dict(mode="serve", cache_len=24)
        assert _dry.counted(info["prefill_collectives"]) == _dry.collectives(
            cfg, (1, 2), r, "prefill", {"tokens": ((4, 16), np.int32)}, **kw)
        assert _dry.counted(info["decode_collectives"]) == _dry.times(_dry.collectives(
            cfg, (1, 2), r, "decode", {"tokens": ((4, 1), np.int32)}, **kw), 7)
    assert (info1["tp"], info1["world"], info1["backend"]) == (1, 1, None)
    assert info1["prefill_collectives"] == {} and info1["decode_collectives"] == {}


# Cache lengths that tp does not divide (repaired; ROADMAP.md §3): (id,
# arch, changes to its reduced config, mesh, prompt length, decode steps);
# max_seq = prompt + steps = 11 (19 positions with the vlm's 8 patches).
ODD_CASES = [
    ("dense-max_seq-11", "llama3.2-3b", {}, (1, 2), 7, 4),
    ("vlm-max_seq-11", "internvl2-26b", {}, (1, 2), 7, 4),
]


@pytest.mark.parametrize("case", ODD_CASES, ids=[c[0] for c in ODD_CASES])
def test_odd_lengths_match_jax(case, tmp_path):
    """A KV cache whose length tp does not divide: each rank holds ⌈S / tp⌉
    positions (the last rank's slice padded past S), the prefill and every
    decode step up to the cache's last position give JAX's
    forward_cached(..., tp=T) logits within 1e-5 of their scale and its
    greedy tokens, and the reassembled cache equals JAX's, its padding
    never written; the dry run of each rank counts its collectives."""
    name, arch, changes, (dp, tp), t, n_dec = case
    jcfg, cfg = _configs(arch, changes)
    b, max_seq = 2 * dp, t + n_dec
    params, prompts, extras, tokens, want, want_cache = _jax_run(jcfg, tp, b, t, n_dec, max_seq)
    results = meshes.spawn(
        _tp_ranks.forward_rank, dp * tp,
        (cfg, tp, params, b, max_seq, prompts, extras, tokens, str(tmp_path / "store"), "cpu"),
        timeout=SPAWN_TIMEOUT)
    n_pos = max_seq + (cfg.vlm_patches if cfg.family == "vlm" else 0)
    assert n_pos % tp
    for res in results:
        lo, hi = res["rows"]
        for i, (got, w) in enumerate(zip(res["logits"], want)):
            _assert_close(got, w[lo:hi], f"{name} rank {res['coords']} step {i}")
            np.testing.assert_array_equal(got[:, -1].argmax(-1), w[lo:hi, -1].argmax(-1))
        assert res["cache"]["kv"][0].shape[3] == -(-n_pos // tp)
        _assert_dry_run_counts(cfg, (dp, tp), res, prompts, extras, tokens, max_seq)
    mesh = MeshShape(("data", "model"), (dp, tp))
    full = _reassemble(cfg, tp, mesh, want_cache, results)
    jax.tree.map(lambda g, w: _assert_close(g, w, f"{name} cache"), full, want_cache)


def test_serve_tp2_at_an_odd_cache_length(tmp_path):
    """``launch.serve --tp 2`` of reduced llama at ``--prompt-len 7 --gen
    4`` (a cache of 11 positions over 2 ranks): the tokens of ``--tp 1``,
    every step's logits within 1e-5 of their scale."""
    from repro_torch.launch import serve

    argv = ["--arch", "llama3.2-3b", "--reduced", "--batch", "2", "--prompt-len", "7", "--gen", "4",
            "--device", "cpu"]
    info1 = {}
    want = serve.main(argv, info=info1, keep_logits=True)
    results = meshes.spawn(_tp_ranks.serve_rank, 2,
                           (argv + ["--tp", "2", "--dist-init", f"file://{tmp_path / 'store'}"],),
                           timeout=SPAWN_TIMEOUT)
    for gen, info, logits in results:
        np.testing.assert_array_equal(gen, want)
        assert len(logits) == len(info1["logits"]) == 4
        for got, w in zip(logits, info1["logits"]):
            _assert_close(got, w, "serve --tp 2 --prompt-len 7 logits")


def test_cache_parts_tile_the_whole_cache(tmp_path):
    """``convert.cache_from_numpy(shard=)`` on a (2, 2) mesh: each rank's part
    is its ``local_slice`` (sequence by model coordinate, batch by data),
    and the four parts tile the whole cache exactly once."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    whole = lm.init_cache(cfg, 4, 8, device="cpu")
    rng = np.random.default_rng(0)
    cache = {"kv": tuple(rng.normal(size=t.shape).astype(np.float32) for t in whole["kv"])}
    results = meshes.spawn(_tp_ranks.cache_rank, 4, (cfg, 2, cache, str(tmp_path / "store")),
                           timeout=SPAWN_TIMEOUT)
    cover = [np.zeros(a.shape, np.int32) for a in cache["kv"]]
    mesh = MeshShape(("data", "model"), (2, 2))
    for coords, part in results:
        for i, (a, p) in enumerate(zip(cache["kv"], part["kv"])):
            idx = sharding.local_slice(a.shape, (None, "data", None, "model", None), mesh, coords)
            np.testing.assert_array_equal(p, a[idx])
            cover[i][idx] += 1
    assert all((c == 1).all() for c in cover)


def test_spawn_fails_on_a_raising_or_hung_rank():
    """A rank that raises fails the run naming it; a rank that does not
    answer fails it at the timeout, and no rank is left running."""
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        meshes.spawn(_tp_ranks.failing_rank, 2, (1,), timeout=60)
    with pytest.raises(RuntimeError, match=r"ranks \[0(, 1)?\] of 2 gave no result"):
        meshes.spawn(_tp_ranks.hanging_rank, 2, (0, 300), timeout=6)


def _fake_shard(cfg, dp, tp, coords=(0, 0)):
    return sharding.shard_for(cfg, MeshShape(("data", "model"), (dp, tp)), coords=coords)


def _exits(capsys, fn, said):
    with pytest.raises(SystemExit) as exc:
        fn()
    assert exc.value.code == 2 and said in capsys.readouterr().err


def test_sharded_paths_refuse_what_they_cannot_run(monkeypatch, capsys):
    """No fallback: --tp above 1 with no process group, a world size tp does
    not divide, a sharded whisper prefill without frames, NCCL with two
    ranks on one device and a tp other than the mesh's all raise or exit
    naming the cause. (An SSM family whose heads tp does not divide, whisper
    frames and a cache length tp does not divide run: test_odd_lengths_match_jax
    here and in tests/test_torch_tp_families.py, and the layouts below.)"""
    from repro_torch.launch import serve

    base = ["--reduced", "--batch", "2", "--prompt-len", "8", "--gen", "2", "--device", "cpu"]
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    _exits(capsys, lambda: serve.main(["--arch", "qwen1.5-0.5b", "--tp", "2"] + base),
           "--tp > 1 needs a process group")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    _exits(capsys, lambda: serve.main(["--arch", "qwen1.5-0.5b", "--tp", "3"] + base),
           "world size 2 is not a multiple of --tp 3")
    wcfg = get_config("whisper-tiny").reduced()
    wshard = _fake_shard(wcfg, 1, 2)
    wmodel = lm.LM(wcfg, 2, device="cpu", shard=wshard)
    wcache = lm.init_cache(wcfg, 2, 12, tp=2, device="cpu", shard=wshard)
    tokens = torch.zeros((2, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="more than one token is a prefill and needs frames"):
        lm.forward_cached(wmodel, wcfg, wcache, tokens, 0, tp=2, shard=wshard)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="two ranks on one device"):
        meshes.init_ranks("nccl", torch.device("cuda"))
    cfg = get_config("qwen1.5-0.5b").reduced()
    with pytest.raises(ValueError, match="tp=1 but the mesh's model axis is 2"):
        lm.LM(cfg, 1, device="cpu", shard=_fake_shard(cfg, 1, 2))


def test_a_shard_without_its_layout_is_refused():
    """The model layer takes its slices from the launcher's layout
    (``launch.sharding.shard_for``); a ``Shard`` built without one raises
    instead of allocating whole leaves."""
    from repro_torch.models.tp import Shard

    cfg = get_config("qwen1.5-0.5b").reduced()
    bare = Shard(mesh=MeshShape(("data", "model"), (1, 2)), coords=(0, 0))
    with pytest.raises(ValueError, match="no layout; build it with .*shard_for"):
        lm.LM(cfg, 2, device="meta", shard=bare)
    with pytest.raises(ValueError, match="no layout"):
        lm.init_cache(cfg, 2, 8, tp=2, device="cpu", shard=bare)


def test_sharded_model_allocates_only_its_slices():
    """A rank's model holds the slices ``param_specs(mode='serve')`` gives
    it (llama at full width on the meta device, tp 2: the vocab, q and KV
    heads and d_ff split, the norms whole), and ``init_params`` on a shard
    keeps the one-device model's weights, split."""
    cfg = get_config("llama3.2-3b")
    model = lm.LM(cfg, 2, device="meta", shard=_fake_shard(cfg, 1, 2))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes["embed"] == (cfg.vocab // 2, cfg.d_model)
    assert shapes["blocks.0.attn.wq"] == (cfg.d_model, cfg.n_heads // 2 * cfg.d_head)
    assert shapes["blocks.0.attn.wk"] == (cfg.d_model, cfg.n_kv // 2 * cfg.d_head)
    assert shapes["blocks.0.attn.wo"] == (cfg.n_heads // 2 * cfg.d_head, cfg.d_model)
    assert shapes["blocks.0.mlp.w_down"] == (cfg.d_ff // 2, cfg.d_model)
    assert shapes["blocks.0.ln1"] == (cfg.d_model,)
    small = get_config("qwen1.5-0.5b").reduced()
    whole = lm.init_params(small, torch.Generator().manual_seed(3))
    for coords in ((0, 0), (0, 1)):
        shard = _fake_shard(small, 1, 2, coords)
        part = lm.init_params(small, torch.Generator().manual_seed(3), tp=2, shard=shard)
        for n, p in part.named_parameters():
            full, idx = part.tp_layout[n]
            assert tuple(whole.get_parameter(n).shape) == full
            assert torch.equal(p, whole.get_parameter(n)[idx]), n
