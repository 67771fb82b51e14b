"""Tensor-parallel paged serving in the port (`EngineConfig(paged=True,
mesh=...)`) against the JAX engine, on the CPU: the matrix of
tests/test_mesh_serving.py on smoke configs.

Each drain runs on every rank of a gloo world (2 ranks, and 4 for GPT-2 at
width 4; `repro_torch.launch.mesh.World`, rank functions in
tests/mesh_common.py), on a ("data", "model") mesh whose "model" extent is
the drain's width, while the test process runs the JAX engine on the same
requests with the same parameters:

  * GPT-2 at widths 1, 2 and 4 and in LUT mode; chunked prefill with prefix
    sharing (prompt tokens saved); int8 pools with bf16 scale rows and int4
    pools; `ngram` speculation; qwen2's GQA at width 2; the `SloScheduler`
    with preempt-and-swap on qwen2 — each token for token the JAX engine's
    drain, GPT-2 at width 2 also the JAX mesh engine's on 2 fake devices;
  * the SLO drain's preemptions, swap-outs and swap-ins equal to the JAX
    engine's, and the ranks' swap blobs, concatenated along the head axis,
    bit for bit the one-device port engine's in the order they were put
    (and within 1e-5 of the JAX engine's: its K/V are XLA's f32 sums);
  * `stats()["roofline"]` (modeled bytes and FLOPs, intensity, class),
    `describe()` and `per_device()` of a step at tensor_parallel 2 within
    1e-12 of the JAX mesh engine's;
  * every rank returns the same tokens and the same stats() counters; the
    counters equal the JAX engine's (bar the swap tier's bytes, which a
    rank holds a slice of); a rank's pool holds its Hkv/tp heads;
  * olmoe's smoke config with `moe_impl="shardmap"` serves on 2 ranks (the
    expert-parallel MoE under the engine), the ranks in lockstep.
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
from repro.models import api as jax_api
from repro.serving import EngineConfig, GenConfig, ServingEngine, SloScheduler, SpecConfig
from repro_torch.launch.mesh import World

ARCHS = ["gpt2_medium", "qwen2_1_5b"]
# name: the drain (mesh_common.drain_rank's case); "jax_mesh": also against
# the JAX mesh engine on that many fake devices.
CASES = {
    "gpt2-w1": dict(arch="gpt2_medium", width=1, seed=8),
    "gpt2-w2": dict(arch="gpt2_medium", width=2, seed=0, jax_mesh=2, kw=dict(hardware="hbm2")),
    "gpt2-w4": dict(arch="gpt2_medium", width=4, seed=0),
    "gpt2-w2-lut": dict(arch="gpt2_medium", width=2, seed=1, mode="lut"),
    "gpt2-w2-chunk-share": dict(arch="gpt2_medium", width=2, seed=3, shared_prefix=8,
                                kw=dict(prefix_sharing=True, prefill_chunk_tokens=5)),
    "gpt2-w2-int8": dict(arch="gpt2_medium", width=2, seed=4,
                         kw=dict(kv_cache_dtype="int8", kv_scale_dtype="bfloat16")),
    "gpt2-w2-int4": dict(arch="gpt2_medium", width=2, seed=2,
                         kw=dict(kv_cache_dtype="int4", kv_scale_dtype="bfloat16")),
    "gpt2-w2-ngram": dict(arch="gpt2_medium", width=2, spec_k=3),
    "qwen2-w2": dict(arch="qwen2_1_5b", width=2, seed=6),
    "qwen2-w2-slo": dict(arch="qwen2_1_5b", width=2, scheduler="slo", one_device=True),
}
PORT_ONLY = {"olmoe-w2-shardmap": dict(arch="olmoe_1b_7b", width=2, seed=9,
                                       moe_impl="shardmap")}


def _jax_drain(params, jcfg, case, mesh=None):
    """(tokens in submit order, the engine, its swap blobs in put order)."""
    kw = mesh_common.engine_kwargs(case)
    if "scheduler" in kw:
        kw["scheduler"] = SloScheduler()
    if "speculative" in kw:
        kw["speculative"] = SpecConfig(mode="ngram", k=case["spec_k"])
    eng = ServingEngine(params, jcfg, SalPimEngine.create(SalPimConfig(
        nonlinear_mode=case.get("mode", "exact"))), EngineConfig(
            paged=True, gen=GenConfig(temperature=0.0, stop_on_eos=False), mesh=mesh, **kw))
    blobs = []
    put = eng.swap_tier.put

    def record(uid, blob):
        blobs.append((uid, blob.n_tokens, *[None if t is None else np.asarray(t).copy()
                                            for t in (blob.k, blob.v, blob.k_scale,
                                                      blob.v_scale)]))
        put(uid, blob)

    eng.swap_tier.put = record
    prompts, new = mesh_common.case_requests(case, jcfg.vocab)
    uids = [eng.submit(p.copy(), max_new_tokens=n) for p, n in zip(prompts, new)]
    done = eng.run(max_steps=800)
    by = {r.uid: list(r.generated) for r in done}
    return [by.get(u) for u in uids], eng, blobs


@pytest.fixture(scope="module")
def drains(tmp_path_factory):
    """{"port": {case: [rank results]}, "jax": {case: (tokens, engine,
    blobs)}, "jax_mesh": {...}}: the worlds drain while the JAX engines
    drain here."""
    tmp = tmp_path_factory.mktemp("mesh_drains")
    jparams = {a: jax_api.init_params(jax.random.PRNGKey(0), jax_get_config(a, smoke=True))
               for a in ARCHS}
    np_params = {a: jax.tree.map(np.asarray, p) for a, p in jparams.items()}
    by_world = {2: {k: v for k, v in {**CASES, **PORT_ONLY}.items() if v["width"] <= 2},
                4: {k: v for k, v in CASES.items() if v["width"] == 4}}
    worlds = {n: World(mesh_common.drain_rank, n, (cases, {
        a: p for a, p in np_params.items() if any(c["arch"] == a for c in cases.values())}),
        workdir=tmp) for n, cases in by_world.items()}
    try:
        jax_runs, jax_mesh = {}, {}
        for name, case in CASES.items():
            jcfg = jax_get_config(case["arch"], smoke=True)
            jax_runs[name] = _jax_drain(jparams[case["arch"]], jcfg, case)
            if case.get("jax_mesh"):
                mesh = Mesh(np.asarray(jax.devices()[:case["jax_mesh"]]), ("model",))
                jax_mesh[name] = _jax_drain(jparams[case["arch"]], jcfg, case, mesh)
    finally:
        port = {}
        for n, w in worlds.items():
            ranks = w.join()
            for name in by_world[n]:
                port[name] = [r[name] for r in ranks]
    return {"port": port, "jax": jax_runs, "jax_mesh": jax_mesh}


def _same_on_every_rank(ranks):
    for r in ranks[1:]:
        assert r["tokens"] == ranks[0]["tokens"]
        assert r["counters"] == ranks[0]["counters"]


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_drain_matches_jax(drains, name):
    case = CASES[name]
    ranks = drains["port"][name]
    _same_on_every_rank(ranks)
    want, jeng, _ = drains["jax"][name]
    assert all(t is not None for t in want)
    assert ranks[0]["tokens"] == want
    if name in drains["jax_mesh"]:
        assert ranks[0]["tokens"] == drains["jax_mesh"][name][0]
    jcount = mesh_common.counters(jeng.stats())
    common = (set(jcount) & set(ranks[0]["counters"])) - {"swap_bytes_peak"}
    assert {"tokens", "prefill_tokens", "peak_pages", "preemptions"} <= common
    assert {k: ranks[0]["counters"][k] for k in common} == {k: jcount[k] for k in common}
    assert ranks[0]["used_pages"] == 0
    cfg = jax_get_config(case["arch"], smoke=True)
    heads = cfg.n_kv_heads // case["width"]
    for rank, r in enumerate(ranks):
        assert r["pool_heads"] == heads
        model_rank = rank % case["width"]
        assert r["heads"] == (None if case["width"] == 1
                              else (model_rank * heads, (model_rank + 1) * heads))


def test_chunked_prefill_shares_prefix_on_the_mesh(drains):
    assert drains["port"]["gpt2-w2-chunk-share"][0]["counters"]["prefill_tokens_saved"] > 0


def test_slo_preempt_swap_blobs_match_jax(drains):
    """Equal preemptions, swap-outs and swap-ins; the ranks' blobs,
    concatenated along the head axis, bit for bit the one-device port
    engine's (each rank's run of it), and within 1e-5 of the JAX engine's,
    whose f32 K/V projections are XLA's arithmetic, not the port's (tests/
    test_torch_mesh.py holds a swap-out of the same pools bit for bit)."""
    ranks = drains["port"]["qwen2-w2-slo"]
    _, jeng, jblobs = drains["jax"]["qwen2-w2-slo"]
    c = ranks[0]["counters"]
    assert jeng.preemptions > 0 and jeng.swap_ins > 0
    assert (c["preemptions"], c["swap_outs"], c["swap_ins"]) == (
        jeng.preemptions, jeng.swap_outs, jeng.swap_ins)
    for r in ranks:
        assert r["one_device"]["tokens"] == r["tokens"]
    one = ranks[0]["one_device"]["blobs"]
    assert len(jblobs) == len(one) == c["swap_outs"]
    assert all(len(r["blobs"]) == len(jblobs) for r in ranks)
    for i, (uid, n_tokens, *pools) in enumerate(jblobs):
        assert all(r["blobs"][i][:2] == one[i][:2] == (uid, n_tokens) for r in ranks)
        for j, want in enumerate(pools):
            parts = [r["blobs"][i][2 + j] for r in ranks]
            if want is None:
                assert all(p is None for p in parts) and one[i][2 + j] is None
                continue
            got = np.concatenate(parts, axis=2)
            assert got.dtype == want.dtype and np.array_equal(got, one[i][2 + j])
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_roofline_at_tp2_matches_jax(drains):
    r = drains["port"]["gpt2-w2"][0]
    jeng = drains["jax_mesh"]["gpt2-w2"][1]
    assert r["describe"]["tensor_parallel"] == 2 and r["describe"]["gather_bytes_per_token"] > 0
    want = {phase: {k: v[k] for k in ("modeled_bytes", "modeled_flops",
                                      "arithmetic_intensity", "bound")}
            for phase, v in jeng.stats()["roofline"].items()}
    assert r["roofline"].keys() == want.keys() and "decode" in want
    for phase, got in r["roofline"].items():
        assert got["bound"] == want[phase]["bound"]
        for k in ("modeled_bytes", "modeled_flops", "arithmetic_intensity"):
            assert got[k] == pytest.approx(want[phase][k], rel=1e-12), (phase, k)
    jdesc = jeng.cost_model.describe()
    for k in ("tensor_parallel", "gather_bytes_per_token", "page_bytes",
              "weight_stream_bytes", "kv_bytes_per_token"):
        assert r["describe"][k] == pytest.approx(jdesc[k], rel=1e-12), k
    from repro.serving.costmodel import StepShape as JaxStepShape
    shape = dataclasses.asdict(mesh_common.ROOF_SHAPE)
    jdev = jeng.cost_model.per_device(jeng.cost_model.step_costs(JaxStepShape(**shape)))
    assert r["per_device"].keys() == jdev.keys()
    for phase, (b, f) in r["per_device"].items():
        assert b == pytest.approx(jdev[phase].bytes, rel=1e-12)
        assert f == pytest.approx(jdev[phase].flops, rel=1e-12)


def test_expert_parallel_moe_serves_in_lockstep(drains):
    ranks = drains["port"]["olmoe-w2-shardmap"]
    _same_on_every_rank(ranks)
    assert all(t is not None and len(t) > 0 for t in ranks[0]["tokens"])
    assert ranks[0]["used_pages"] == 0
