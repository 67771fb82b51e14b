"""Fault-tolerant training loop (the port of `repro.runtime.train_loop`):
the train step, checkpoint/restart, a save on SIGTERM and on a crash, a
straggler watch, a metrics JSONL; on one device or on a mesh.

The step runs eagerly (the JAX package jits it; capturing it in a CUDA
graph is later work). Batches come from `data.tokens` as numpy and are
moved to the device here. After a SIGTERM the loop saves at the next
step and returns with that checkpoint as the latest (the reference also
writes its end-of-run save then, labelled `train_cfg.steps`, which a
resume would take for steps never run).

On a mesh (`mesh=`, a `DeviceMesh` over every rank of the process group,
each rank running this same call; `launch/mesh.World` spawns them) the
twin of the reference's `jit_train_step` is `shard_train_step`: each rank
holds its slice of every parameter and AdamW moment by `param_pspecs(...,
fsdp=fsdp)`, takes its rows of each batch by `batch_pspecs`, and runs the
step under a `distributed.sharding.TrainPlan`, whose collectives make the
step the unsharded one's in mathematics (the global masked mean, the same
gradients, the same clipped AdamW update). The ranks agree on a SIGTERM
through one all-reduce of the flag a step, so every rank saves the same
step; checkpoints hold whole arrays (rank 0 writes) and restore onto any
mesh; rank 0 alone writes the metrics JSONL. A crash on a mesh saves
nothing (the gather of a save needs every rank): the last committed
checkpoint stays the restart point.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core.salpim import SalPimEngine
from repro_torch.data import tokens as data_lib
from repro_torch.distributed import api as dist_api
from repro_torch.distributed import sharding as shard_lib
from repro_torch.models import api as model_api
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import checkpoint as ckpt_lib
from repro_torch.runtime import optimizer as opt_lib


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    n_micro: int = 1
    straggler_zscore: float = 4.0
    metrics_path: Optional[str] = None
    async_ckpt: bool = True


def batch_to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(model_cfg: ModelConfig, engine: SalPimEngine,
                    opt_cfg: opt_lib.AdamWConfig, *, n_micro: int = 1) -> Callable:
    """(params, opt_state, batch of tensors) -> (params, opt_state, metrics)."""
    if engine.config.quant != "none":
        raise ValueError(f"training runs the float datapath only, not quant="
                         f"{engine.config.quant!r}")

    def loss_fn(params, batch):
        return model_api.loss_fn(params, batch, model_cfg, engine)

    def step(params, opt_state, batch):
        plan = shard_lib.current_plan()
        loss, grads, metrics = opt_lib.accumulate_grads(loss_fn, params, batch, n_micro)
        if plan is not None:
            grads = plan.reduce_grads(grads)
            loss, metrics = _global_metrics(plan, loss, metrics)
        params, opt_state, opt_metrics = opt_lib.adamw_update(opt_cfg, params, grads,
                                                              opt_state, plan=plan)
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss}

    return step


def _global_metrics(plan, loss: torch.Tensor, metrics: dict) -> tuple[torch.Tensor, dict]:
    """A rank's loss and metrics (shares of the global batch's) summed over
    the batch axes; the token count once however often the batch is held."""
    out = dict(metrics)
    for k in ("loss", "accuracy", "tokens"):
        if k in out:
            out[k] = plan.batch_sum(out[k].float())
    if "tokens" in out:
        out["tokens"] = out["tokens"] / (plan.batch_extent // plan.batch_split)
    if "ppl_proxy" in out:
        out["ppl_proxy"] = torch.exp(torch.clamp(out["loss"], max=20.0))
    return plan.batch_sum(loss), out


def shard_train_step(step_fn: Callable, mesh, model_cfg: ModelConfig, params_shape,
                     batch_shape: dict, *, fsdp: bool = False) -> Callable:
    """The step of `make_train_step` on `mesh` (the twin of the reference's
    `jit_train_step`): it takes and returns this rank's slices of the
    parameters and moments by `param_pspecs(params_shape, mesh, fsdp=fsdp)`
    and this rank's rows of a batch shaped `batch_shape` (`shard_batch`),
    and returns the global metrics. `params_shape` is the whole tree
    (`meta` tensors do). Without a mesh, step_fn itself. The sharded
    step's `plan` is an attribute of it."""
    if mesh is None:
        return step_fn
    plan = shard_lib.TrainPlan.create(mesh, model_cfg, params_shape,
                                      fsdp=fsdp).for_batch(batch_shape)

    def step(params, opt_state, batch):
        with dist_api.use_mesh(mesh), shard_lib.use_plan(plan):
            return step_fn(params, opt_state, batch)

    step.plan = plan
    return step


def _any_rank(flag: bool, device) -> bool:
    """Whether any rank of the process group has `flag` (one all-reduce)."""
    on = device if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([int(flag)], dtype=torch.int32, device=on)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


class StragglerWatch:
    """Per-step wall-time EMA + z-score alarm (the mitigation at scale is
    rebalancing/evicting the slow host; here we detect and log)."""

    def __init__(self, zscore: float = 4.0, warmup: int = 5):
        self.z = zscore
        self.warmup = warmup
        self.n = 0
        self.mean = 0.0
        self.m2 = 1e-12

    def observe(self, dt: float) -> Optional[str]:
        self.n += 1
        delta = dt - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (dt - self.mean)
        if self.n <= self.warmup:
            return None
        std = max((self.m2 / (self.n - 1)) ** 0.5, 1e-9)
        if (dt - self.mean) / std > self.z:
            return (f"straggler: step took {dt*1e3:.1f} ms "
                    f"(mean {self.mean*1e3:.1f} ms, z>{self.z})")
        return None


def run_training(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    opt_cfg: opt_lib.AdamWConfig,
    data_cfg: data_lib.DataConfig,
    *,
    engine: Optional[SalPimEngine] = None,
    mesh=None,
    fsdp: bool = False,
    seed: int = 0,
    hooks: Optional[dict] = None,
    device="cuda",
) -> dict:
    """Returns final {params, opt_state, data_state, history}. Resumes
    from the latest committed checkpoint in train_cfg.ckpt_dir. On a mesh
    every rank calls it; params and opt_state are the rank's slices (their
    specs: `param_pspecs(api.init_params(cfg, device="meta"), mesh,
    fsdp=fsdp)`). `fsdp` without a mesh trains on one device, as the
    reference does."""
    if mesh is not None and not shard_lib.is_mesh(mesh):
        raise ValueError(f"mesh= takes a DeviceMesh (launch/mesh.make_test_mesh or "
                         f"make_production_mesh), not {type(mesh).__name__}")
    dev = resolve_device(device) if mesh is None else dist_api.rank_device(device)
    engine = engine or SalPimEngine.create()
    hooks = hooks or {}
    params = model_api.init_params(model_cfg, seed=seed, device=dev)
    shapes = shardings = None
    if mesh is not None:
        shapes = model_api.init_params(model_cfg, device="meta")
        specs = shard_lib.param_pspecs(shapes, mesh, fsdp=fsdp)
        params = shard_lib.shard_tree(params, specs, mesh)
        pshard = shard_lib.to_shardings(specs, mesh)
        shardings = {"params": pshard, "opt": opt_lib.OptState(step=None, mu=pshard,
                                                               nu=pshard)}
    opt_state = opt_lib.init_opt_state(params)
    data_state = data_lib.DataState()

    # --- resume -----------------------------------------------------------
    start_step = 0
    if ckpt_lib.latest_step(train_cfg.ckpt_dir) is not None:
        tree, manifest = ckpt_lib.restore(train_cfg.ckpt_dir,
                                          {"params": params, "opt": opt_state},
                                          shardings=shardings)
        params, opt_state = tree["params"], tree["opt"]
        start_step = manifest["extra"].get("next_step", manifest["step"])
        data_state.step = manifest["extra"].get("data_step", start_step)

    step_fn = shard_train_step(
        make_train_step(model_cfg, engine, opt_cfg, n_micro=train_cfg.n_micro), mesh,
        model_cfg, shapes, data_lib.batch_at(data_cfg, 0), fsdp=fsdp)

    # --- preemption handling ------------------------------------------------
    preempted = {"flag": False}

    def on_term(signum, frame):
        preempted["flag"] = True

    prev_handler = signal.signal(signal.SIGTERM, on_term)

    watch = StragglerWatch(train_cfg.straggler_zscore)
    history = []
    mpath = train_cfg.metrics_path
    mfile = open(mpath, "a") if mpath and shard_lib.world_rank() == 0 else None

    def save(step, blocking=False):
        extra = {"next_step": step, "data_step": data_state.step}
        tree = {"params": params, "opt": opt_state}
        if train_cfg.async_ckpt and not blocking:
            ckpt_lib.save_async(train_cfg.ckpt_dir, step, tree, extra=extra,
                                keep=train_cfg.keep, shardings=shardings)
        else:
            ckpt_lib.save(train_cfg.ckpt_dir, step, tree, extra=extra, keep=train_cfg.keep,
                          shardings=shardings)

    try:
        for step in range(start_step, train_cfg.steps):
            t0 = time.perf_counter()
            batch = data_lib.batch_at(data_cfg, data_state.step)
            if mesh is not None:
                batch = shard_lib.shard_batch(batch, mesh, train_cfg.n_micro)
            batch = batch_to_device(batch, dev)
            data_state.step += 1
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])          # waits for the step
            dt = time.perf_counter() - t0

            warn = watch.observe(dt)
            if warn and "on_straggler" in hooks:
                hooks["on_straggler"](step, warn)

            if step % train_cfg.log_every == 0 or step == train_cfg.steps - 1:
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(loss=loss, step=step, sec_per_step=dt)
                history.append(rec)
                if mfile:
                    mfile.write(json.dumps(rec) + "\n")
                    mfile.flush()
                if "on_log" in hooks:
                    hooks["on_log"](rec)

            if (step + 1) % train_cfg.ckpt_every == 0:
                save(step + 1)
            if mesh is not None:
                preempted["flag"] = _any_rank(preempted["flag"], dev)
            if preempted["flag"]:
                save(step + 1, blocking=True)
                break
    except Exception:
        # Crash-path checkpoint: restartable at the last good step.
        if mesh is None:
            save(int(opt_state.step), blocking=True)
        raise
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
        if mfile:
            mfile.close()

    if not preempted["flag"]:
        save(train_cfg.steps, blocking=True)
    return {"params": params, "opt_state": opt_state, "data_state": data_state,
            "history": history}
