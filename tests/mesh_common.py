"""Rank functions of the mesh tests (tests/test_torch_mesh.py and
tests/test_torch_mesh_drains.py).

Each runs in every process of a gloo world that `repro_torch.launch.mesh.
World` spawned (one thread a rank, a `FileStore` under the test's
temporary directory), on the CPU, and returns plain data for the test
process, which holds it to the JAX package. Nothing here imports JAX: the
reference's side runs in the test process, where conftest's fake CPU
devices exist.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.salpim import SalPimConfig, SalPimEngine
from repro_torch.distributed import api as dist_api
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import paged_pool_pspecs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import api, moe
from repro_torch.serving import kvcache
from repro_torch.serving.config import EngineConfig, GenConfig
from repro_torch.serving.costmodel import StepShape
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import SloScheduler
from repro_torch.serving.speculative import SpecConfig

# Logical specs resolved on every mesh, and the meshes of a world of 2 or 4.
LOGICAL = [("batch", None, "model"), ("nonsense", "model"), ("model",),
           ("model", "seq_tp"), ("batch",), ("fsdp", "expert"), (None, None)]
LOGICAL_NAMES = ("model", "batch", "data", "expert", "seq_shard", "nonsense")
MESHES = {2: [((2,), ("model",)), ((2,), ("data",)), ((2, 1), ("data", "model")),
              ((1, 2), ("data", "model"))],
          4: [((4,), ("model",)), ((4,), ("data",)), ((2, 2), ("data", "model"))]}
CUSTOM_RULES = {"model": "data"}


def cpu_mesh(shape, axes):
    return make_test_mesh(shape, axes, device_type="cpu")


def registry_rank(rank: int) -> dict:
    """The registry on each mesh of this world, `use_mesh`'s scoping, and
    `gather_heads` along every axis of f32 and bf16 tensors."""
    world = dist.get_world_size()
    out = {"specs": {}, "custom": {}, "axis_size": {}, "pspecs": {}, "model_shard": {}}
    for shape, axes in MESHES[world]:
        mesh = cpu_mesh(shape, axes)
        key = (shape, axes)
        out["specs"][key] = [dist_api.resolve_spec(spec, mesh) for spec in LOGICAL]
        out["custom"][key] = [dist_api.resolve_spec(spec, mesh, CUSTOM_RULES)
                              for spec in LOGICAL]
        out["axis_size"][key] = {n: dist_api.axis_size(mesh, n) for n in LOGICAL_NAMES}
        out["pspecs"][key] = (paged_pool_pspecs(mesh), paged_pool_pspecs(mesh, quantized=True))
        if "model" in axes:
            r, n, group = dist_api.model_shard(mesh)
            out["model_shard"][key] = (r, n, dist.get_world_size(group))

    mesh = cpu_mesh((world,), ("model",))
    scope = [dist_api.current_mesh() is None]
    with dist_api.use_mesh(mesh, rules={"model": "model"}):
        scope += [dist_api.current_mesh() is mesh, dist_api.current_rules()["model"] == "model"]
        with dist_api.use_mesh(None):
            scope.append(dist_api.current_mesh() is None)
        scope.append(dist_api.current_mesh() is mesh)
    scope += [dist_api.current_mesh() is None,
              dist_api.current_rules() is dist_api.DEFAULT_RULES]
    out["scope"] = scope

    gathered = []
    full = torch.randn(3 * world, 4 * world, 5 * world, generator=torch.Generator().manual_seed(0))
    for dtype in (torch.float32, torch.bfloat16):
        for axis in range(3):
            x = full.to(dtype)
            n = x.shape[axis] // world
            mine = x.narrow(axis, rank * n, n)
            for handle in (mesh, mesh.get_group("model")):
                got = collectives.gather_heads(mine, handle, axis)
                gathered.append(got.dtype == dtype and torch.equal(got, x))
    out["gather"] = gathered
    out["psum"] = collectives.psum(torch.full((3,), float(rank + 1)), mesh).tolist()
    return out


def validation_rank(rank: int) -> dict:
    """The messages of the reference's two mesh ValueErrors, raised by
    `EngineConfig.validate` and by `ServingEngine`, on a "model" mesh of
    this world."""
    mesh = cpu_mesh((dist.get_world_size(),), ("model",))
    out = {}
    for label, arch, paged in (("dense", "gpt2_medium", False),
                               ("non-dividing", "qwen2_1_5b", True)):
        cfg = get_config(arch, smoke=True)
        ec = EngineConfig(slots=1, max_len=16, paged=paged, mesh=mesh)
        msgs = []
        for call in (lambda: ec.validate(cfg),
                     lambda: ServingEngine(api.init_params(cfg, device="cpu"), cfg,
                                           SalPimEngine.create(), ec, device="cpu")):
            try:
                call()
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        out[label] = msgs
    return out


def cache_rank(rank: int, pools: dict) -> dict:
    """The rank's pools: allocated sharded (fp and int8/bf16), a whole
    cache cut by `shard_cache` (twice), and `write_prompt_pages`,
    `copy_page`, `swap_out_slot` and `swap_in_slot` on the slice, each
    against the whole cache's same call cut to the rank's heads; and the
    blob of slot 1's pages [3, 5] (7 tokens) swapped out of each whole
    cache of `pools` ({format: (k, v, k_scale, v_scale) numpy pools}) cut
    to the rank's heads."""
    cfg = get_config("gpt2_medium", smoke=True)
    mesh = cpu_mesh((dist.get_world_size(),), ("model",))
    out = {}
    for fmt, sdt in (("model", "float32"), ("int8", "bfloat16")):
        whole = api.init_paged_cache(cfg, 2, 8, 4, 8, kv_dtype=fmt, kv_scale_dtype=sdt,
                                     device="cpu")
        mine = api.init_paged_cache(cfg, 2, 8, 4, 8, kv_dtype=fmt, kv_scale_dtype=sdt,
                                    device="cpu", mesh=mesh)
        out[fmt] = {"head_range": mine.head_range,
                    "shapes": [tuple(t.shape) for t in kvcache._pools(mine) if t is not None],
                    "whole_shapes": [tuple(t.shape) for t in kvcache._pools(whole)
                                     if t is not None],
                    "bytes": (sum(t.nbytes for t in kvcache._pools(mine) if t is not None),
                              sum(t.nbytes for t in kvcache._pools(whole) if t is not None))}
    gen = torch.Generator().manual_seed(1)
    whole = api.init_paged_cache(cfg, 2, 8, 4, 8, device="cpu")
    for t in kvcache._pools(whole)[:2]:
        t.copy_(torch.randn(t.shape, generator=gen))
    mine = kvcache.shard_cache(whole, mesh)
    a, b = mine.head_range
    cut = lambda c: [t[:, :, a:b] for t in kvcache._pools(c)[:2]]  # noqa: E731
    checks = {"shard": all(torch.equal(x, y) for x, y in zip(kvcache._pools(mine), cut(whole))),
              "idempotent": kvcache.shard_cache(mine, mesh) is mine,
              "tables_whole": mine.block_tables is whole.block_tables}
    k_dense = torch.randn(cfg.n_layers, cfg.n_kv_heads, 7, cfg.head_dim, generator=gen)
    v_dense = torch.randn(k_dense.shape, generator=gen)
    for c in (whole, mine):
        kvcache.write_prompt_pages(c, 1, [3, 5], k_dense, v_dense, 7)
        kvcache.copy_page(c, 3, 6)
    checks["write_copy"] = all(torch.equal(x, y) for x, y in zip(kvcache._pools(mine),
                                                                 cut(whole)))
    _, blob_w = kvcache.swap_out_slot(whole, 1, [3, 5], 7)
    _, blob_m = kvcache.swap_out_slot(mine, 1, [3, 5], 7)
    checks["blob"] = (torch.equal(blob_m.k, blob_w.k[:, :, a:b])
                      and torch.equal(blob_m.v, blob_w.v[:, :, a:b]))
    kvcache.swap_in_slot(whole, 0, [2, 7], blob_w)
    kvcache.swap_in_slot(mine, 0, [2, 7], blob_m)
    checks["swap_in"] = (all(torch.equal(x, y) for x, y in zip(kvcache._pools(mine), cut(whole)))
                         and torch.equal(mine.lengths, whole.lengths))
    out["checks"] = checks
    out["blobs"] = {}
    for fmt, arrays in pools.items():
        t = [None if a is None else torch.from_numpy(a) for a in arrays]
        n_slots, n_table = 2, 8
        whole = kvcache.PagedCache(torch.zeros(n_slots, dtype=torch.int32),
                                   torch.zeros((n_slots, n_table), dtype=torch.int32), *t)
        _, blob = kvcache.swap_out_slot(kvcache.shard_cache(whole, mesh), 1, [3, 5], 7)
        out["blobs"][fmt] = [None if x is None else x.numpy()
                             for x in (blob.k, blob.v, blob.k_scale, blob.v_scale)]
    return out


def moe_rank(rank: int, params_np: dict, xs: list, cap) -> list:
    """`apply_moe` of olmoe's smoke config with `moe_impl="shardmap"` on a
    "model" mesh of this world, one output a input."""
    over = {"moe_impl": "shardmap"}
    if cap is not None:
        over["router_cap_factor"] = cap
    cfg = dataclasses.replace(get_config("olmoe_1b_7b", smoke=True), **over)
    p = bridge.params_from_numpy(params_np, device="cpu")
    mesh = cpu_mesh((dist.get_world_size(),), ("model",))
    eng = SalPimEngine.create()
    with dist_api.use_mesh(mesh):
        return [moe.apply_moe(p, torch.from_numpy(x), cfg, eng).numpy() for x in xs]


# -- drains -------------------------------------------------------------------

def workload(vocab: int, seed: int = 0, n: int = 4, shared_prefix: int = 0):
    """The reference's mesh-test workload (tests/test_mesh_serving.py)."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(2, vocab, size=shared_prefix)
    prompts = [np.concatenate([prefix, rng.randint(2, vocab, size=rng.randint(4, 9))])
               for _ in range(n)]
    new = [int(rng.randint(4, 9)) for _ in range(n)]
    return prompts, new


def spec_workload(vocab: int):
    rng = np.random.RandomState(5)
    block = rng.randint(2, vocab, size=3)
    return [np.tile(block, 4) for _ in range(3)], [8, 8, 8]


def slo_workload(vocab: int):
    rng = np.random.RandomState(7)
    prompts = [rng.randint(2, vocab, size=rng.randint(6, 11)) for _ in range(4)]
    return prompts, [int(rng.randint(8, 13)) for _ in range(4)]


SLO_KW = dict(slots=3, max_len=32, page_size=4, num_pages=12)


def engine_kwargs(case: dict) -> dict:
    """The EngineConfig fields of a drain case, with the scheduler and the
    speculation built here (case["scheduler"], case["spec_k"])."""
    kw = dict(dict(slots=2, max_len=32, page_size=8), **case.get("kw", {}))
    if case.get("scheduler") == "slo":
        kw.update(SLO_KW, scheduler=SloScheduler())
    if case.get("spec_k"):
        kw["speculative"] = SpecConfig(mode="ngram", k=case["spec_k"])
    return kw


def case_requests(case: dict, vocab: int):
    if case.get("scheduler") == "slo":
        return slo_workload(vocab)
    if case.get("spec_k"):
        return spec_workload(vocab)
    return workload(vocab, case.get("seed", 0), shared_prefix=case.get("shared_prefix", 0))


def counters(stats: dict) -> dict:
    """stats()'s counts (every int field), not its times."""
    return {k: v for k, v in stats.items() if isinstance(v, int) and not isinstance(v, bool)}


ROOF_SHAPE = StepShape(decode_lens=[9, 17], decode_ran=True, chunk=(0, 8))


def roofline_of(eng) -> dict:
    """The deterministic part of the roofline: stats()["roofline"] without
    its times, describe(), and per_device() of a fixed step's costs."""
    roof = {phase: {k: v[k] for k in ("modeled_bytes", "modeled_flops",
                                      "arithmetic_intensity", "bound")}
            for phase, v in eng.stats()["roofline"].items()}
    dev = eng.cost_model.per_device(eng.cost_model.step_costs(ROOF_SHAPE))
    return {"roofline": roof, "describe": eng.cost_model.describe(),
            "per_device": {p: (c.bytes, c.flops) for p, c in dev.items()}}


def drain_rank(rank: int, cases: dict, params_np: dict) -> dict:
    """Each case's drain on a ("data", "model") mesh of this world whose
    "model" extent is case["width"]: its tokens (uid order), counters,
    pool slice, swap blobs in the order they were put (SLO cases) and the
    roofline (cases that name a hardware)."""
    world = dist.get_world_size()
    params = {arch: bridge.params_from_numpy(t, device="cpu") for arch, t in params_np.items()}
    meshes = {}
    out = {}
    for name, case in cases.items():
        arch, width = case["arch"], case["width"]
        if width not in meshes:
            meshes[width] = cpu_mesh((world // width, width), ("data", "model"))
        cfg = get_config(arch, smoke=True)
        if case.get("moe_impl"):
            cfg = dataclasses.replace(cfg, moe_impl=case["moe_impl"])
        p = params.get(arch)
        if p is None:
            p = params[arch] = api.init_params(cfg, device="cpu")
        res = _drain(p, cfg, case, meshes[width])
        if case.get("kw", {}).get("hardware"):
            res.update(roofline_of(res.pop("engine")))
        if case.get("one_device"):
            res["one_device"] = _drain(p, cfg, case, None)
        res.pop("engine", None)
        res.get("one_device", {}).pop("engine", None)
        out[name] = res
    return out


def _drain(params, cfg, case: dict, mesh) -> dict:
    sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=case.get("mode", "exact")))
    eng = ServingEngine(params, cfg, sal, EngineConfig(
        paged=True, gen=GenConfig(temperature=0.0, stop_on_eos=False), mesh=mesh,
        **engine_kwargs(case)), device="cpu")
    blobs = []
    put = eng.swap_tier.put

    def record(uid, blob):
        blobs.append((uid, blob.n_tokens, *[None if t is None else t.numpy().copy()
                                            for t in (blob.k, blob.v, blob.k_scale,
                                                      blob.v_scale)]))
        put(uid, blob)

    eng.swap_tier.put = record
    prompts, new = case_requests(case, cfg.vocab)
    uids = [eng.submit(pr.copy(), max_new_tokens=n) for pr, n in zip(prompts, new)]
    done = eng.run(max_steps=800)
    by = {r.uid: list(r.generated) for r in done}
    return {"tokens": [by.get(u) for u in uids], "counters": counters(eng.stats()),
            "heads": eng.cache.head_range, "pool_heads": eng.cache.k_pages.shape[2],
            "pool_bytes": eng.cache.k_pages.nbytes, "blobs": blobs,
            "used_pages": eng.allocator.used_pages, "engine": eng}


JOBS = {"registry": registry_rank, "validation": validation_rank, "cache": cache_rank,
        "moe": moe_rank, "drains": drain_rank}


def jobs_rank(rank: int, jobs: dict) -> dict:
    """Several of the functions above in one world: {name: (job, args)}."""
    return {name: JOBS[job](rank, *args) for name, (job, args) in jobs.items()}
