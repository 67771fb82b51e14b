"""Rank functions of tests/test_torch_mesh_train.py (training under a mesh).

`jobs_rank` runs in every process of one gloo world of 4 CPU ranks that
`repro_torch.launch.mesh.World` spawned, builds each job's mesh there
((2, 2) and (1, 4) ("data", "model"), (4,) "pod", (4,) "data") and returns
plain data for the test process, which holds it to the JAX package.
Nothing here imports JAX: the reference's side runs in the test process.
"""
from __future__ import annotations

import dataclasses
import os
import signal

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.salpim import SalPimConfig, SalPimEngine
from repro_torch.data import tokens as data_lib
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.pipeline import make_pipelined_fn
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import api
from repro_torch.runtime import checkpoint as ckpt_lib
from repro_torch.runtime import optimizer as opt
from repro_torch.runtime.train_loop import (TrainConfig, batch_to_device, make_train_step,
                                            run_training, shard_train_step)

TP_PARTS = ("attn", "ffn", "experts", "head")


def cpu_mesh(shape, axes):
    return make_test_mesh(tuple(shape), tuple(axes), device_type="cpu")


def np_tree(tree):
    return opt.tree_map(lambda x: x.detach().float().numpy(), tree)


def coords(mesh) -> dict:
    return {n: mesh.get_local_rank(n) for n in mesh.mesh_dim_names}


def config(case: dict):
    return dataclasses.replace(get_config(case["name"], smoke=True), **case.get("overrides", {}))


def local_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in opt.tree_leaves(tree))


def step_job(case: dict) -> dict:
    """One sharded step from the case's whole params and batch: the
    metrics, and on rank 0 the gathered parameters and first moment."""
    cfg = config(case)
    mesh = cpu_mesh(case["shape"], ("data", "model"))
    shapes = api.init_params(cfg, device="meta")
    specs = sh.param_pspecs(shapes, mesh, fsdp=case["fsdp"])
    whole = bridge.params_from_numpy(case["params"], device="cpu")
    params = sh.shard_tree(whole, specs, mesh)
    engine = SalPimEngine.create(SalPimConfig(nonlinear_mode=case["mode"]))
    step = shard_train_step(make_train_step(cfg, engine, opt.AdamWConfig(**case["ocfg"]),
                                            n_micro=case["n_micro"]),
                            mesh, cfg, shapes, case["batch"], fsdp=case["fsdp"])
    batch = batch_to_device(sh.shard_batch(case["batch"], mesh, case["n_micro"]), "cpu")
    state = opt.init_opt_state(params)
    new, state, metrics = step(params, state, batch)
    out = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
           "bytes": [local_bytes(t) for t in (params, state.mu, state.nu)],
           "spec_bytes": sh.spec_bytes(whole, specs, mesh),
           "spec_moment_bytes": sh.spec_bytes(opt.tree_map(lambda p: p.float(), whole),
                                              specs, mesh),
           "whole_moment_bytes": local_bytes(opt.tree_map(lambda p: p.float(), whole)),
           "tp": {p: step.plan.tensor_parallel(p) is not None for p in TP_PARTS}}
    gathered = sh.gather_tree(new, specs, mesh)
    mu = sh.gather_tree(state.mu, specs, mesh)
    if dist.get_rank() == 0:
        out["params"], out["mu"] = np_tree(gathered), np_tree(mu)
    return out


def collectives_job(args: dict) -> dict:
    """compressed_psum over two steps of error feedback, merge_partial_softmax
    over a sequence split four ways, hierarchical_psum on (2, 2)."""
    rank = dist.get_rank()
    flat = cpu_mesh((4,), ("data",))
    group = flat.get_group("data")
    g1, g2 = (torch.from_numpy(a[rank]) for a in args["grads"])
    mean1, ef1 = collectives.compressed_psum(g1, group)
    mean2, ef2 = collectives.compressed_psum(g2, group, ef1)
    scores, v = (torch.from_numpy(a) for a in args["softmax"])
    n = scores.shape[0] // 4
    sc, vv = scores[rank * n:(rank + 1) * n], v[rank * n:(rank + 1) * n]
    m = sc.max()[None, None]
    e = torch.exp(sc - m[0])
    merged = collectives.merge_partial_softmax(m, e.sum()[None, None], (e @ vv)[None],
                                               group)
    mesh = cpu_mesh((2, 2), ("data", "model"))
    x = torch.from_numpy(args["hier"][rank])
    hier = collectives.hierarchical_psum(x, mesh.get_group("model"), mesh.get_group("data"))
    q, scale = collectives.quantize_int8(g1)
    return {"ef": [t.numpy() for t in (mean1, ef1, mean2, ef2)], "merged": merged.numpy(),
            "hier": hier.numpy(), "quantized": (q.numpy(), float(scale))}


def pipeline_job(args: dict) -> dict:
    mesh = cpu_mesh((4,), ("pod",))
    fn = make_pipelined_fn(lambda w, x: torch.tanh(x @ w), mesh, "pod", n_micro=4)
    return {"out": fn(torch.from_numpy(args["stage_params"]),
                      torch.from_numpy(args["x"])).numpy()}


def _leaves(tree) -> dict:
    return {p: x.detach().numpy() if x.dtype != torch.bfloat16 else
            x.detach().view(torch.int16).numpy() for p, x in opt.named_leaves(tree)}


def checkpoint_job(args: dict) -> dict:
    """Restores of a one-device and a JAX checkpoint onto (2, 2) with fsdp
    (each rank's leaves and coordinates), and a (2, 2) save after a step."""
    cfg = get_config("gpt2_medium", smoke=True)
    mesh = cpu_mesh((2, 2), ("data", "model"))
    shapes = api.init_params(cfg, device="meta")
    specs = sh.param_pspecs(shapes, mesh, fsdp=True)
    pshard = sh.to_shardings(specs, mesh)
    shardings = {"params": pshard, "opt": opt.OptState(step=None, mu=pshard, nu=pshard)}
    local = sh.shard_tree(api.init_params(cfg, seed=1, device="cpu"), specs, mesh)
    like = {"params": local, "opt": opt.init_opt_state(local)}
    out = {"coords": coords(mesh), "specs": specs}
    for key in ("torch_ckpt", "jax_ckpt"):
        tree, manifest = ckpt_lib.restore(args[key], like, shardings=shardings)
        out[key] = {"leaves": _leaves(tree), "step": manifest["step"]}
    # One step, then a sharded save.
    engine = SalPimEngine.create(SalPimConfig())
    dcfg = data_lib.data_config_for_model(cfg, 16, 4)
    step = shard_train_step(make_train_step(cfg, engine, opt.AdamWConfig()), mesh, cfg,
                            shapes, data_lib.batch_at(dcfg, 0), fsdp=True)
    batch = batch_to_device(sh.shard_batch(data_lib.batch_at(dcfg, 0), mesh), "cpu")
    new, state, _ = step(local, opt.init_opt_state(local), batch)
    tree = {"params": new, "opt": state}
    ckpt_lib.save(args["mesh_ckpt"], 1, tree, extra={"next_step": 1}, shardings=shardings)
    whole = {"params": sh.gather_tree(new, specs, mesh),
             "opt": opt.OptState(state.step, sh.gather_tree(state.mu, specs, mesh),
                                 sh.gather_tree(state.nu, specs, mesh))}
    if dist.get_rank() == 0:
        out["saved_whole"] = _leaves(whole)
    return out


def loop_job(args: dict) -> dict:
    """run_training on (2, 2) with fsdp: straight, in two runs with a
    resume, and with a SIGTERM sent to rank 1 during its first step."""
    cfg = get_config("gpt2_medium", smoke=True)
    mesh = cpu_mesh((2, 2), ("data", "model"))
    dcfg = data_lib.data_config_for_model(cfg, 16, 4)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    engine = SalPimEngine.create(SalPimConfig(nonlinear_mode="lut"))
    root = args["dir"]
    os.makedirs(root, exist_ok=True)

    def run(sub, steps, hooks=None, metrics=None):
        tc = TrainConfig(steps=steps, ckpt_dir=os.path.join(root, sub), ckpt_every=50,
                         log_every=1, async_ckpt=False, metrics_path=metrics)
        return run_training(cfg, tc, ocfg, dcfg, engine=engine, mesh=mesh, fsdp=True,
                            hooks=hooks, device="cpu")

    metrics = os.path.join(root, f"metrics{dist.get_rank()}.jsonl")
    straight = run("straight", 3, metrics=metrics)
    metric_lines = None
    if os.path.exists(metrics):
        with open(metrics) as f:
            metric_lines = len(f.readlines())
    run("resumed", 2)
    resumed = run("resumed", 3)
    same = [bool(torch.equal(a, b)) for (_, a), (_, b) in
            zip(opt.named_leaves({"p": straight["params"], "o": straight["opt_state"]}),
                opt.named_leaves({"p": resumed["params"], "o": resumed["opt_state"]}))]

    def on_log(rec):
        if dist.get_rank() == 1 and rec["step"] == 0:
            os.kill(os.getpid(), signal.SIGTERM)
    term = run("sigterm", 5, hooks={"on_log": on_log})
    return {"same": same, "losses": [r["loss"] for r in straight["history"]],
            "metric_lines": metric_lines,
            "resumed_steps": [r["step"] for r in resumed["history"]],
            "sigterm_steps": [r["step"] for r in term["history"]],
            "sigterm_latest": ckpt_lib.latest_step(os.path.join(root, "sigterm"))}


JOBS = {"step": step_job, "collectives": collectives_job, "pipeline": pipeline_job,
        "checkpoint": checkpoint_job, "loop": loop_job}


def jobs_rank(rank: int, jobs: dict) -> dict:
    """{job name: its result} for {job name: (kind, args)}, in sorted order
    on every rank."""
    return {name: JOBS[kind](args) for name, (kind, args) in sorted(jobs.items())}
