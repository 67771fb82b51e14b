"""The dense decode on a mesh (`api.decode_step(..., mesh=)` on a rank's
shard of a dense cache: `transformer.shard_cache` / `gather_cache`,
`sharding.cache_split`, `attention.attention_decode`'s split forms,
`decode_attention_partials` and `collectives.merge_partial_softmax`)
against the JAX package's unsharded decode on the CPU.

One gloo world of 8 CPU ranks (`repro_torch.launch.mesh.World`; the rank
functions in tests/mesh_decode_common.py, which imports no JAX) runs every
case on a (2, 4) ("data", "model") mesh while the test process holds the
JAX side. Each case prefills with the JAX package (its cache enters the
port through `bridge.dense_cache_from_numpy`), decodes two steps
unsharded (the reference's tests/test_distributed.py:92,197 do one) and
the ranks decode the same two tokens on their shards: the first token the
prefill's greedy one, the second seeded, so that the second step reads
what the first wrote, across a rank boundary where the sequence is split.
Gates, the reference's own: each step's logits within 2e-3 (rtol and atol)
of the JAX step's on every rank, and the gathered cache within 1e-5 of
the JAX cache after the two steps.

  * qwen2 smoke, B 8, prompts of 12, max_len 16: the batch on "data", the
    sequence on "model" (2 KV heads on 4 ranks); once more with rows at
    lengths 7..12 and decode_uniform off, whose writes land on different
    ranks;
  * h2o-danube3 smoke, sliding_window 24, B 1, a 32-token prompt, max_len
    64: `cache_pspecs(seq_shard=True)` puts the sequence on ("data",
    "model") (the reference's assertion), eight slices of 8 keys, the
    window crossing them;
  * gpt2_medium (KV heads on "model"), olmoe (heads on "model", the
    capacity dispatch over every row), mamba2 (the SSM state's heads and
    the conv window's channels on "model", gathered for the step), zamba2
    (the same and the shared arena's heads) and whisper (self and cross
    arenas' heads) smoke at B 8.
"""
from __future__ import annotations

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_decode_common as common
from repro.configs import get_config as jax_get_config
from repro.core.salpim import SalPimConfig as JSalPimConfig
from repro.core.salpim import SalPimEngine as JSalPimEngine
from repro.models import api as japi
from repro_torch.launch.mesh import World

SHAPE = (2, 4)
# XLA's LLVM backend unoptimised: the same HLO, a shorter compile.
_O0 = {"xla_backend_optimization_level": 0}
# name: (arch, config overrides, batch, prompt tokens, max_len, seq_shard,
#        the k arena's spec ("ssm" for the SSM family), row lengths or None)
CASES = {
    "qwen2": ("qwen2_1_5b", {"decode_uniform": True}, 8, 12, 16, False,
              ("k", (None, "data", None, "model", None)), None),
    "qwen2-ragged": ("qwen2_1_5b", {"decode_uniform": False}, 8, 12, 16, False,
                     ("k", (None, "data", None, "model", None)), [12, 11, 8, 7, 12, 9, 11, 10]),
    "danube-window": ("h2o_danube3_4b", {"decode_uniform": True, "sliding_window": 24}, 1,
                      32, 64, True, ("k", (None, None, None, ("data", "model"), None)), None),
    "gpt2": ("gpt2_medium", {"decode_uniform": True}, 8, 12, 16, False,
             ("k", (None, "data", "model", None, None)), None),
    "olmoe": ("olmoe_1b_7b", {"decode_uniform": True}, 8, 12, 16, False,
              ("k", (None, "data", "model", None, None)), None),
    "mamba2": ("mamba2_370m", {"decode_uniform": True}, 8, 12, 16, False,
               ("ssm", (None, "data", "model", None, None)), None),
    "zamba2": ("zamba2_1_2b", {"decode_uniform": True}, 8, 12, 16, False,
               ("shared_k", (None, "data", "model", None, None)), None),
    "whisper": ("whisper_large_v3", {"decode_uniform": True}, 8, 12, 16, False,
                ("cross_k", (None, "data", "model", None, None)), None),
}


def _jax_case(name):
    """The JAX side of a case: its inputs for the ranks and the two
    unsharded steps' logits and final cache."""
    arch, over, B, S, max_len, seq_shard, _, lens = CASES[name]
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **over)
    eng = JSalPimEngine.create(JSalPimConfig())
    params = japi.init_params(jax.random.PRNGKey(0), jcfg)
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, jcfg.vocab)}
    if jcfg.family == "encdec":
        batch["frames"] = jax.random.normal(jax.random.PRNGKey(2),
                                            (B, jcfg.enc_seq, jcfg.d_model), jnp.float32)
    logits, cache = jax.jit(lambda p, b: japi.prefill(p, b, jcfg, eng, max_len=max_len)
                            ).lower(params, batch).compile(_O0)(params, batch)
    if lens is not None:
        cache = dataclasses.replace(cache, lengths=jnp.asarray(lens, jnp.int32))
    rng = np.random.RandomState(5)
    tokens = [np.asarray(jnp.argmax(logits, -1), np.int32),
              common.np_tokens(rng, B, jcfg.vocab)]
    # Plain fields, not the JAX package's Cache: the ranks import no JAX.
    np_cache = types.SimpleNamespace(**{f.name: None if getattr(cache, f.name) is None
                                        else np.asarray(getattr(cache, f.name))
                                        for f in dataclasses.fields(cache)})
    case = {"name": arch, "overrides": over, "shape": SHAPE, "seq_shard": seq_shard,
            "params": jax.tree.map(np.asarray, params), "cache": np_cache, "tokens": tokens}
    step = jax.jit(lambda p, t, c: japi.decode_step(p, t, c, jcfg, eng)).lower(
        params, jnp.asarray(tokens[0]), cache).compile(_O0)
    outs = []
    for tok in tokens:
        out, cache = step(params, jnp.asarray(tok), cache)
        outs.append(np.asarray(out, np.float32))
    return case, {"logits": outs, "cache": jax.tree.map(np.asarray, cache)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks start first and wait for the cases, which the JAX side
    writes when it is done."""
    tmp = tmp_path_factory.mktemp("mesh_decode")
    source = tmp / "cases.pt"
    w = World(common.decode_rank, 8, (str(source),), workdir=tmp, timeout_s=300)
    cases, refs = {}, {}
    try:
        for name in CASES:
            cases[name], refs[name] = _jax_case(name)
    finally:
        # Written also when the JAX side failed, so that the ranks finish.
        torch.save(cases, tmp / "cases.tmp")
        os.replace(tmp / "cases.tmp", source)
        ranks = w.join()
    return ranks, refs


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_decode_matches_the_unsharded_jax_decode(world, name):
    ranks, refs = world
    ref = refs[name]
    leaf, spec = CASES[name][6]
    for r, out in enumerate(ranks):
        assert out[name]["specs"][leaf] == spec, (r, out[name]["specs"][leaf])
        for step, (got, want) in enumerate(zip(out[name]["logits"], ref["logits"])):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3,
                                       err_msg=f"rank {r} step {step}")
        np.testing.assert_array_equal(out[name]["lengths"], np.asarray(ref["cache"].lengths))
    whole = ranks[0][name]["cache"]
    for path, got in whole.items():
        want = np.asarray(getattr(ref["cache"], path), np.float32)
        assert got.shape == want.shape, path
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=path)


def test_sequence_shards_hold_their_slice_and_take_the_partials_path(world):
    """The danube case: each rank holds 8 of the 64 positions of every
    arena and ran the partials (plain on the CPU: no kernel launch); the
    qwen2 case 4 of 16 positions of its 4 rows."""
    ranks, _ = world
    for out in ranks:
        assert out["danube-window"]["shapes"]["k"] == (2, 1, 2, 8, 16)
        assert out["qwen2"]["shapes"]["k"] == (2, 4, 2, 4, 16)
        assert out["gpt2"]["shapes"]["k"] == (2, 4, 1, 16, 16)
        assert out["danube-window"]["launches"] == 0
