"""Tensor-parallel serving of the RWKV-6 (ssm), Zamba2 (hybrid) and
Whisper (encdec) families against the JAX package, on the CPU.

As ``tests/test_torch_tp.py`` does for the dense families: ranks are
processes spawned by ``repro_torch.launch.mesh.spawn`` into a gloo group
through a file store under ``tmp_path``, on a (data, model) mesh; a reduced
fp32 model is carried from JAX's ``init_params(..., tp=T)`` (attention
heads padded for T) to each rank's slice; every rank prefills its rows of
the batch (whisper with its rows of the frames) and decodes 3 steps fed
JAX's greedy tokens. Each rank's logits and the whole cache reassembled
from the ranks' pieces (``s``, ``lx_*``, the hybrid's per-application
``kv/i``, ``kv``, ``xkv``; each leaf tiled exactly) are held to JAX's
``forward_cached(..., tp=T)`` on one device within 1e-5 of their scale,
greedy tokens equal, and every step's collectives by op equal to the
counts the design gives per layer (:func:`_design_counts`), so that a path
that gathers more than it should is caught.
"""
import dataclasses
from collections import Counter

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import mesh as meshes
from repro_torch.launch.mesh import MeshShape

import _dry
import _tp_ranks
from test_torch_tp import (SPAWN_TIMEOUT, _assert_close, _assert_dry_run_counts, _jax_run,
                           _reassemble)

# (id, arch, changes to its reduced config, (data, model) mesh, head policy
# of the attention at that tp or None); 2 layers (the hybrid keeps its 5,
# shared_every 2: two applications of the shared block and a remainder).
CASES = [
    ("ssm-1x2", "rwkv6-7b", {}, (1, 2), None),
    ("ssm-1x4", "rwkv6-7b", {}, (1, 4), None),
    ("ssm-2x2", "rwkv6-7b", {}, (2, 2), None),
    ("hybrid-shard", "zamba2-7b", {}, (1, 2), "shard"),
    ("hybrid-shard_q", "zamba2-7b", {}, (1, 4), "shard_q"),
    ("encdec-shard", "whisper-tiny", {}, (1, 2), "shard"),
    ("encdec-shard_q", "whisper-tiny", {}, (1, 4), "shard_q"),
    ("encdec-pad", "whisper-tiny", {"n_heads": 3, "n_kv": 1}, (1, 2), "pad"),
]
N_LAYERS = {"ssm": 2, "hybrid": 5, "encdec": 2}
N_FRAMES = 8


def _configs(arch, changes):
    jcfg = jax_get_config(arch).reduced()
    jcfg = dataclasses.replace(jcfg, n_layers=N_LAYERS[jcfg.family], **changes)
    return jcfg, ArchConfig(**dict(jcfg.__dict__))


def _max_seq(cfg, tp, need):
    """The least cache length >= ``need`` that splits over tp, and whose
    half (the encdec cross cache ``init_cache`` sizes) does too."""
    s = need
    while s % tp or (cfg.family == "encdec" and (s // 2) % tp):
        s += 1
    return s


def _design_counts(cfg, tp, policy, phase):
    """The collectives (op -> count) a rank issues in one ``forward_cached``
    call of ``phase`` ('prefill' or 'decode'), as the design gives them:

    - a vocab-split embed: one sum; a vocab-split head: one gather;
    - RWKV-6 a layer: the ``ln_x`` sum of squares, ``wo``'s and the channel
      mix's ``wv`` row-split products (three sums), the gated columns (one
      gather); Mamba-2 a layer: the gated norm and ``w_out`` (two sums); a
      mixer whose heads tp does not divide runs whole: none;
    - an attention: ``wo`` (a sum, its rows split unless 'replicate'); with
      a cache under 'shard', the fresh K and V gathered over heads; in
      decode, q gathered over heads (unless 'replicate') and the merge's max
      and sum; a cross-attention in decode as that, with nothing fresh;
    - an MLP: ``w_down`` (a sum);
    - whisper's prefill: the cross K and V stacks gathered over heads under
      'shard'."""
    c = Counter()
    q_split, kv_split = policy != "replicate", policy == "shard"

    def attn(kind):  # 'self' (a cache), 'enc' (cache-less), 'cross'
        if phase == "decode" and kind != "enc":
            c["all_gather"] += q_split + 2 * (kv_split and kind == "self")
            c["all_reduce_max"] += 1
            c["all_reduce_sum"] += 1
        elif kind == "self":
            c["all_gather"] += 2 * kv_split
        c["all_reduce_sum"] += q_split

    def mlp():
        c["all_reduce_sum"] += cfg.d_ff % tp == 0

    if cfg.vocab % tp == 0:
        c["all_reduce_sum"] += 1
        c["all_gather"] += 1
    n = cfg.n_layers
    split = cfg.n_heads % tp == 0  # the mixers
    if cfg.family == "ssm":
        c["all_reduce_sum"] += 3 * n * split
        c["all_gather"] += n * split
    elif cfg.family == "hybrid":
        c["all_reduce_sum"] += 2 * n * split
        for _ in range(n // cfg.shared_every):
            attn("self")
            mlp()
    else:
        if phase == "prefill":
            for _ in range(cfg.n_enc_layers):
                attn("enc")
                mlp()
            c["all_gather"] += 2 * kv_split
        for _ in range(n):
            attn("self")
            attn("cross")
            mlp()
    return {k: v for k, v in c.items() if v}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_family_matches_jax(case, tmp_path):
    """Prefill + 3 decode steps on every rank against JAX's
    forward_cached(..., tp=T): each rank's logits and the reassembled cache
    within 1e-5 of their scale, the cache's leaves tiled, greedy tokens
    equal, each step's collectives as the design counts them and as the
    dry run of the rank counts them (bytes too); a rank holds its heads of
    the state and its slice of each KV sequence."""
    name, arch, changes, (dp, tp), policy = case
    jcfg, cfg = _configs(arch, changes)
    if policy is not None:
        assert cfg.padded_heads(tp)[2] == policy
    b, t, n_dec = 2 * dp, 13, 3
    max_seq = _max_seq(cfg, tp, t + n_dec + 1)
    params, prompts, extras, tokens, want, want_cache = _jax_run(
        jcfg, tp, b, t, n_dec, max_seq, frames=N_FRAMES if cfg.family == "encdec" else None)
    results = meshes.spawn(
        _tp_ranks.forward_rank, dp * tp,
        (cfg, tp, params, b, max_seq, prompts, extras, tokens, str(tmp_path / "store"), "cpu"),
        timeout=SPAWN_TIMEOUT)
    mesh = MeshShape(("data", "model"), (dp, tp))
    for res in results:
        lo, hi = res["rows"]
        assert (hi - lo) == b // dp
        for i, (got, w) in enumerate(zip(res["logits"], want)):
            _assert_close(got, w[lo:hi], f"{name} rank {res['coords']} step {i}")
            np.testing.assert_array_equal(got[:, -1].argmax(-1), w[lo:hi, -1].argmax(-1))
        for i, got in enumerate(res["step_stats"]):
            phase = "prefill" if i == 0 else "decode"
            counts = {op: n for op, (n, _) in got.items() if n}
            assert counts == _design_counts(cfg, tp, policy, phase), f"{name} step {i}"
        _assert_dry_run_counts(cfg, (dp, tp), res, prompts, extras, tokens, max_seq)
        cache = res["cache"]
        if cfg.family in ("ssm", "hybrid"):
            assert cache["s"].shape[2] == cfg.n_heads // tp  # the rank's heads of the state
        if cfg.family == "hybrid":
            assert cache["kv"][0][0].shape[2] == max_seq // tp
        if cfg.family == "encdec":
            assert cache["xkv"][0].shape[3] == N_FRAMES // tp
    full = _reassemble(cfg, tp, mesh, want_cache, results)
    jax.tree.map(lambda g, w: _assert_close(g, w, f"{name} cache"), full, want_cache)


# Shapes tp does not divide (repaired; ROADMAP.md §3): (id, arch, changes
# to its reduced config, (data, model) mesh, head policy or None, frames,
# prompt length). max_seq = prompt + 4 = 17 splits over neither tp.
# whisper's 7 frames over tp 2: rank 0 holds cross positions 0-3, rank 1
# 4-6; its 4 frames over tp 3: 0-1, 2-3 and none on rank 2. RWKV-6 and Zamba2 with 4 heads at tp 3 (D 192, so that the JAX
# rules would split the mixers' columns off head boundaries): the mixers
# run whole on every rank; zamba2's shared block pads its heads to 6.
WIDE = {"d_model": 192, "d_head": 48}
ODD_CASES = [
    ("encdec-frames-7", "whisper-tiny", {}, (1, 2), "shard", 7, 13),
    ("encdec-frames-4-1x3", "whisper-tiny", {}, (1, 3), "pad", 4, 13),
    ("ssm-heads-1x3", "rwkv6-7b", WIDE, (1, 3), None, None, 13),
    ("hybrid-heads-1x3", "zamba2-7b", {"d_model": 192}, (1, 3), "pad", None, 13),
]


@pytest.mark.parametrize("case", ODD_CASES, ids=[c[0] for c in ODD_CASES])
def test_odd_lengths_and_heads_match_jax(case, tmp_path):
    """Prefill + 4 decode steps (the cache's last position) against JAX's
    forward_cached(..., tp=T) where tp divides neither the cache nor the
    frames nor the SSM heads: each rank's logits and the reassembled cache
    (its padding never written) within 1e-5 of their scale, greedy tokens
    equal, each step's collectives as the design counts them (a mixer that
    runs whole issues none) and as the dry run of the rank counts them; the
    cross cache holds each rank's frames, the SSM state every head."""
    from test_torch_tp import _reassemble

    name, arch, changes, (dp, tp), policy, frames, t = case
    jcfg, cfg = _configs(arch, changes)
    if policy is not None:
        assert cfg.padded_heads(tp)[2] == policy
    b, n_dec = 2 * dp, 4
    max_seq = t + n_dec
    assert max_seq % tp and (frames is None or frames % tp)
    params, prompts, extras, tokens, want, want_cache = _jax_run(
        jcfg, tp, b, t, n_dec, max_seq, frames=frames)
    results = meshes.spawn(
        _tp_ranks.forward_rank, dp * tp,
        (cfg, tp, params, b, max_seq, prompts, extras, tokens, str(tmp_path / "store"), "cpu"),
        timeout=SPAWN_TIMEOUT)
    mesh = MeshShape(("data", "model"), (dp, tp))
    for res in results:
        lo, hi = res["rows"]
        for i, (got, w) in enumerate(zip(res["logits"], want)):
            _assert_close(got, w[lo:hi], f"{name} rank {res['coords']} step {i}")
            np.testing.assert_array_equal(got[:, -1].argmax(-1), w[lo:hi, -1].argmax(-1))
        for i, got in enumerate(res["step_stats"]):
            phase = "prefill" if i == 0 else "decode"
            counts = {op: n for op, (n, _) in got.items() if n}
            assert counts == _design_counts(cfg, tp, policy, phase), f"{name} step {i}"
        _assert_dry_run_counts(cfg, (dp, tp), res, prompts, extras, tokens, max_seq)
        cache, r = res["cache"], res["coords"]["model"]
        if cfg.family in ("ssm", "hybrid"):
            assert cache["s"].shape[2] == cfg.n_heads  # every head: the mixers run whole
        if cfg.family == "encdec":
            s_l = -(-frames // tp)
            assert cache["xkv"][0].shape[3] == min(frames, (r + 1) * s_l) - r * s_l
    full = _reassemble(cfg, tp, mesh, want_cache, results)
    jax.tree.map(lambda g, w: _assert_close(g, w, f"{name} cache"), full, want_cache)


# Attentions a decode step of each reduced model: none in RWKV-6, the shared
# block's two applications in zamba2 (5 layers), whisper's 4 decoder
# layers' self- and cross-attention.
MERGES_PER_STEP = {"rwkv6-7b": 0, "zamba2-7b": 2, "whisper-tiny": 8}


@pytest.mark.parametrize("arch", sorted(MERGES_PER_STEP))
def test_serve_tp2_gives_the_tokens_of_tp1(arch, tmp_path):
    """``launch.serve --tp 2`` over two ranks serves each family with the
    tokens of ``--tp 1`` (the same weights drawn whole and split; whisper's
    frames drawn after the prompts), every step's logits within 1e-5 of
    their scale; each rank's info carries its collectives per phase, with
    one decode merge (a max all-reduce) per attention a step, as the dry
    run of the rank counts them."""
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--reduced", "--batch", "4", "--prompt-len", "16", "--gen", "8",
            "--device", "cpu"]
    info1 = {}
    want = serve.main(argv, info=info1, keep_logits=True)
    store = tmp_path / "store"
    results = meshes.spawn(_tp_ranks.serve_rank, 2,
                           (argv + ["--tp", "2", "--dist-init", f"file://{store}"],),
                           timeout=SPAWN_TIMEOUT)
    for gen, info, logits in results:
        np.testing.assert_array_equal(gen, want)
        for got, w in zip(logits, info1["logits"]):
            _assert_close(got, w, f"serve --tp 2 {arch} logits")
        assert (info["tp"], info["world"], info["backend"]) == (2, 2, "gloo")
        assert info["prefill_collectives"]["all_reduce_sum"][0] > 0
        assert info["decode_collectives"]["all_reduce_sum"][0] > 0
        merges = info["decode_collectives"].get("all_reduce_max", [0])[0]
        assert merges == MERGES_PER_STEP[arch] * 7
    cfg = get_config(arch).reduced()
    inputs = {"tokens": ((4, 16), np.int32)}
    if cfg.family == "encdec":
        inputs["frames"] = ((4, 8, cfg.d_model), np.float32)
    for r, (_, info, _) in enumerate(results):
        kw = dict(mode="serve", cache_len=24)
        assert _dry.counted(info["prefill_collectives"]) == _dry.collectives(
            cfg, (1, 2), r, "prefill", inputs, **kw)
        assert _dry.counted(info["decode_collectives"]) == _dry.times(_dry.collectives(
            cfg, (1, 2), r, "decode", {"tokens": ((4, 1), np.int32)}, **kw), 7)
