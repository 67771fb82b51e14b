"""The port's mesh layer (`distributed/api.py`, `distributed/sharding.py`,
`distributed/collectives.gather_heads`, the sharded pools of
`serving/kvcache.py`, the expert-parallel MoE) against the JAX package on
the CPU.

Two gloo worlds, of 2 and 4 ranks (`repro_torch.launch.mesh.World`; the
rank functions in tests/mesh_common.py), run on the CPU beside the test
process:

  * `resolve_spec`, `axis_size` and `paged_pool_pspecs` on 1-D and 2-D
    meshes of both worlds equal to the JAX functions on fake-device meshes
    of the same shape and names (also under custom rules), `use_mesh`
    scoping and restoring as the reference's does;
  * `gather_heads` along every axis, f32 and bf16, on 2 and 4 ranks: the
    whole tensor bit for bit, through the mesh and through the group;
  * the two mesh `ValueError`s word for word with the reference's;
  * the rank's pools: Hkv/tp heads allocated, half the bytes on 2 ranks,
    `shard_cache` bit for bit the whole cache's slice and idempotent,
    `write_prompt_pages`, `copy_page` and the swap round trip on the slice,
    and the ranks' swap blobs of the same pools as the JAX package's,
    concatenated along the head axis, bit for bit its blob;
  * olmoe's smoke `apply_moe` with `moe_impl="shardmap"` on 2 ranks within
    the reference's 2e-4 of the JAX `_apply_moe_shardmap` under a 2-device
    "model" mesh, at the smoke cap factor and at 1.25 (tokens dropped);
  * every rank returns the same results.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import mesh_common
from repro.configs import get_config as jax_get_config
from repro.core.salpim import SalPimConfig, SalPimEngine
from repro.distributed import api as jax_dist
from repro.distributed.sharding import paged_pool_pspecs as jax_pool_pspecs
from repro.models import moe as jmoe
from repro.serving import kvcache as jkv
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro_torch.launch.mesh import World

MOE_CAPS = [None, 1.25]
MOE_SHAPES = [(4,), (2, 8), (80,)]


def _moe_inputs(jcfg):
    rng = np.random.RandomState(11)
    return [rng.randn(*s, jcfg.d_model).astype(np.float32) for s in MOE_SHAPES]


def _moe_config(cap):
    jcfg = dataclasses.replace(jax_get_config("olmoe_1b_7b", smoke=True), moe_impl="shardmap")
    return jcfg if cap is None else dataclasses.replace(jcfg, router_cap_factor=cap)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{2: [rank results], 4: [...]}, both worlds run while the JAX side of
    the MoE case is computed here."""
    tmp = tmp_path_factory.mktemp("mesh")
    moe_jobs = {}
    for cap in MOE_CAPS:
        jcfg = _moe_config(cap)
        jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
        moe_jobs[f"moe-{cap}"] = ("moe", (jax.tree.map(np.asarray, jp), _moe_inputs(jcfg), cap))
    jblobs, pools = _jax_swap_outs()
    w2 = World(mesh_common.jobs_rank, 2,
               ({"registry": ("registry", ()), "cache": ("cache", (pools,)), **moe_jobs},),
               workdir=tmp)
    w4 = World(mesh_common.jobs_rank, 4,
               ({"registry": ("registry", ()), "validation": ("validation", ())},), workdir=tmp)
    try:
        jax_moe = {}
        mesh = Mesh(np.asarray(jax.devices()[:2]), ("model",))
        eng = SalPimEngine.create(SalPimConfig())
        for cap in MOE_CAPS:
            jcfg = _moe_config(cap)
            jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
            fn = jax.jit(lambda p, x, jcfg=jcfg: jmoe.apply_moe(p, x, jcfg, eng))
            with jax_dist.use_mesh(mesh), mesh:
                jax_moe[cap] = [np.asarray(fn(jp, jax.numpy.asarray(x)))
                                for x in _moe_inputs(jcfg)]
    finally:
        out = {2: w2.join(), 4: w4.join()}
    out["jax_moe"] = jax_moe
    out["jax_blobs"] = jblobs
    return out


def _jax_swap_outs():
    """Seeded whole pools of GPT-2's smoke config, fp and int8 with f32
    scale rows, and the JAX blob of slot 1's pages [3, 5] (7 tokens) of
    each: ({format: blob arrays}, {format: the pools as numpy})."""
    jcfg = jax_get_config("gpt2_medium", smoke=True)
    rng = np.random.RandomState(5)
    shape = (jcfg.n_layers, 8, jcfg.n_kv_heads, 4, jcfg.head_dim)
    pools = {"fp": (rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32),
                    None, None),
             "int8": tuple(rng.randint(-127, 128, size=shape).astype(np.int8) for _ in "kv")
             + tuple(rng.rand(*shape[:-1]).astype(np.float32) for _ in "kv")}
    blobs = {}
    for fmt, arrays in pools.items():
        jc = jkv.PagedCache(jax.numpy.zeros(2, jax.numpy.int32),
                            jax.numpy.zeros((2, 8), jax.numpy.int32),
                            *[None if a is None else jax.numpy.asarray(a) for a in arrays])
        _, blob = jkv.swap_out_slot(jc, 1, [3, 5], 7)
        blobs[fmt] = [None if x is None else np.asarray(x)
                      for x in (blob.k, blob.v, blob.k_scale, blob.v_scale)]
    return blobs, pools


def _same_on_every_rank(results):
    first = results[0]
    for other in results[1:]:
        np.testing.assert_equal(other, first)


def _jax_mesh(shape, axes):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)


@pytest.mark.parametrize("world", [2, 4])
def test_registry_matches_jax(worlds, world):
    reg = [r["registry"] for r in worlds[world]]
    for key in mesh_common.MESHES[world]:
        jmesh = _jax_mesh(*key)
        want = [tuple(jax_dist.resolve_spec(s, jmesh)) for s in mesh_common.LOGICAL]
        custom = [tuple(jax_dist.resolve_spec(s, jmesh, mesh_common.CUSTOM_RULES))
                  for s in mesh_common.LOGICAL]
        sizes = {n: jax_dist.axis_size(jmesh, n) for n in mesh_common.LOGICAL_NAMES}
        for r in reg:
            assert r["specs"][key] == want, key
            assert r["custom"][key] == custom, key
            assert r["axis_size"][key] == sizes, key
    for rank, r in enumerate(reg):
        assert sorted(r["model_shard"]) == sorted(k for k in mesh_common.MESHES[world]
                                                  if "model" in k[1])
        for (shape, _), got in r["model_shard"].items():
            assert got == (rank % shape[-1], shape[-1], shape[-1])


@pytest.mark.parametrize("world", [2, 4])
def test_paged_pool_pspecs_match_jax(worlds, world):
    def as_tuples(specs):
        return {k: None if v is None else tuple(v) for k, v in specs.items()}

    for key in mesh_common.MESHES[world]:
        jmesh = _jax_mesh(*key)
        want = (as_tuples(jax_pool_pspecs(jmesh)), as_tuples(jax_pool_pspecs(jmesh, quantized=True)))
        for r in worlds[world]:
            assert tuple(as_tuples(s) for s in r["registry"]["pspecs"][key]) == want, key
    assert want[1]["scales"] == (None, None, "model", None)


@pytest.mark.parametrize("world", [2, 4])
def test_use_mesh_scopes_and_restores(worlds, world):
    for r in worlds[world]:
        assert all(r["registry"]["scope"]), r["registry"]["scope"]
    assert jax_dist.current_mesh() is None


@pytest.mark.parametrize("world", [2, 4])
def test_gather_heads_is_exact(worlds, world):
    for r in worlds[world]:
        assert len(r["registry"]["gather"]) == 12 and all(r["registry"]["gather"])
        assert r["registry"]["psum"] == [world * (world + 1) / 2] * 3


@pytest.mark.parametrize("label", ["dense", "non-dividing"])
def test_mesh_value_errors_match_jax(worlds, label):
    """A mesh on the dense engine, and a "model" extent of 4 against
    qwen2's 2 KV heads: the reference's messages, word for word, from
    validate() and from the engine, on every rank."""
    arch, paged = {"dense": ("gpt2_medium", False), "non-dividing": ("qwen2_1_5b", True)}[label]
    jcfg = jax_get_config(arch, smoke=True)
    with pytest.raises(ValueError) as err:
        JaxEngineConfig(slots=1, max_len=16, paged=paged,
                        mesh=_jax_mesh((4,), ("model",))).validate(jcfg)
    for r in worlds[4]:
        assert r["validation"][label] == [str(err.value)] * 2


@pytest.mark.parametrize("fmt", ["model", "int8"])
def test_rank_pools_hold_their_heads(worlds, fmt):
    for rank, r in enumerate(worlds[2]):
        c = r["cache"][fmt]
        assert c["head_range"] == (2 * rank, 2 * rank + 2)
        assert all(s[2] == w[2] // 2 and s[:2] + s[3:] == w[:2] + w[3:]
                   for s, w in zip(c["shapes"], c["whole_shapes"]))
        assert len(c["shapes"]) == (4 if fmt == "int8" else 2)
        assert 2 * c["bytes"][0] == c["bytes"][1]


@pytest.mark.parametrize("check", ["shard", "idempotent", "tables_whole", "write_copy", "blob",
                                   "swap_in"])
def test_shard_cache_and_slice_ops(worlds, check):
    for r in worlds[2]:
        assert r["cache"]["checks"][check]


@pytest.mark.parametrize("cap", MOE_CAPS)
def test_apply_moe_shardmap_matches_jax(worlds, cap):
    outs = [r[f"moe-{cap}"] for r in worlds[2]]
    _same_on_every_rank(outs)
    for got, want in zip(outs[0], worlds["jax_moe"][cap]):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("fmt", ["fp", "int8"])
def test_rank_swap_blobs_concatenate_to_the_jax_blob(worlds, fmt):
    """The same whole pools on both sides: each rank's blob of its slice,
    concatenated along the head axis in rank order, bit for bit the JAX
    engine's blob."""
    want = worlds["jax_blobs"][fmt]
    for j, w in enumerate(want):
        parts = [r["cache"]["blobs"][fmt][j] for r in worlds[2]]
        if w is None:
            assert all(p is None for p in parts)
            continue
        got = np.concatenate(parts, axis=2)
        assert got.dtype == w.dtype and np.array_equal(got, w)
