"""Fault-tolerant training loop on one device (the port of
`repro.runtime.train_loop`): the train step, checkpoint/restart, a save
on SIGTERM and on a crash, a straggler watch, a metrics JSONL.

The step runs eagerly (the JAX package jits it; capturing it in a CUDA
graph is later work). Batches come from `data.tokens` as numpy and are
moved to the device here. After a SIGTERM the loop saves at the next
step and returns with that checkpoint as the latest (the reference also
writes its end-of-run save then, labelled `train_cfg.steps`, which a
resume would take for steps never run). `mesh=` and `fsdp=True` (the reference's
sharded training) are refused with a ValueError: the port serves on a
mesh (serving/engine.py) but trains on one device until training under a
mesh is ported.
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

from repro_torch import resolve_device
from repro_torch.core.salpim import SalPimEngine
from repro_torch.data import tokens as data_lib
from repro_torch.models import api as model_api
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import checkpoint as ckpt_lib
from repro_torch.runtime import optimizer as opt_lib

MESH_REFUSAL = ("the port trains on one device: mesh= and fsdp= wait for the next "
                "slice of the port, training under a mesh (FSDP, compressed_psum, "
                "hierarchical_psum, pipeline.py, param_pspecs; ROADMAP.md queue 1)")


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
        loss, grads, metrics = opt_lib.accumulate_grads(loss_fn, params, batch, n_micro)
        params, opt_state, opt_metrics = opt_lib.adamw_update(opt_cfg, params, grads,
                                                              opt_state)
        return params, opt_state, {**metrics, **opt_metrics, "loss": loss}

    return step


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
    from the latest committed checkpoint in train_cfg.ckpt_dir."""
    if mesh is not None or fsdp:
        raise ValueError(MESH_REFUSAL)
    dev = resolve_device(device)
    engine = engine or SalPimEngine.create()
    hooks = hooks or {}
    params = model_api.init_params(model_cfg, seed=seed, device=dev)
    opt_state = opt_lib.init_opt_state(params)
    data_state = data_lib.DataState()

    # --- resume -----------------------------------------------------------
    start_step = 0
    if ckpt_lib.latest_step(train_cfg.ckpt_dir) is not None:
        tree, manifest = ckpt_lib.restore(train_cfg.ckpt_dir,
                                          {"params": params, "opt": opt_state})
        params, opt_state = tree["params"], tree["opt"]
        start_step = manifest["extra"].get("next_step", manifest["step"])
        data_state.step = manifest["extra"].get("data_step", start_step)

    step_fn = make_train_step(model_cfg, engine, opt_cfg, n_micro=train_cfg.n_micro)

    # --- preemption handling ------------------------------------------------
    preempted = {"flag": False}

    def on_term(signum, frame):
        preempted["flag"] = True

    prev_handler = signal.signal(signal.SIGTERM, on_term)

    watch = StragglerWatch(train_cfg.straggler_zscore)
    history = []
    mpath = train_cfg.metrics_path
    mfile = open(mpath, "a") if mpath else None

    def save(step, blocking=False):
        extra = {"next_step": step, "data_step": data_state.step}
        tree = {"params": params, "opt": opt_state}
        if train_cfg.async_ckpt and not blocking:
            ckpt_lib.save_async(train_cfg.ckpt_dir, step, tree, extra=extra,
                                keep=train_cfg.keep)
        else:
            ckpt_lib.save(train_cfg.ckpt_dir, step, tree, extra=extra, keep=train_cfg.keep)

    try:
        for step in range(start_step, train_cfg.steps):
            t0 = time.perf_counter()
            batch = batch_to_device(data_lib.batch_at(data_cfg, data_state.step), dev)
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
            if preempted["flag"]:
                save(step + 1, blocking=True)
                break
    except Exception:
        # Crash-path checkpoint: restartable at the last good step.
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
