"""Dry run of the dry-run cells on the production meshes (the port of
`repro.launch.dryrun`): one rank's step of each (arch x shape) cell, every
tensor on `meta`, with what it moves and computes recorded for the
roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \
        --shape decode_32k --mesh single            # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun
                                                    # every live cell, JSON per cell

The reference lowers and compiles each cell for 256 (or 512) fake devices
in one process. A PyTorch mesh program is one process a rank, so the port
runs rank 0 of the production mesh (`launch/mesh.py`: (16, 16) ("data",
"model"), or (2, 16, 16) with "pod") over torch's `fake` process-group
backend in this one process: the mesh's groups exist, the collectives move
nothing (`distributed/collectives.py` returns a `meta` result for a `meta`
operand and notes its kind and bytes), and every parameter, cache and
activation is a `meta` tensor, so nothing is allocated and no card is
needed. The step of each shape kind is the port's own:

    train_4k     -> the sharded train step (`shard_train_step`, `TrainPlan`;
                    fsdp by `should_fsdp`), the rank's parameter and moment
                    slices and batch rows
    prefill_32k  -> `api.prefill` on the rank's rows of the batch
    decode_32k   -> `api.decode_step(..., mesh=)` on the rank's shard of the
                    dense cache (`shard_cache`)
    long_500k    -> the same with the sequence sharded (B = 1, seq_shard)

Kernel wrappers take their plain versions on `meta` tensors
(`kernels/ops.py`). The record has the reference's fields: argument and
output bytes of the rank (by `spec_bytes` of the specs the reference's
jit places them by: parameters, moments, batch and cache; the serving
steps here hold the parameters whole on each rank), the dot FLOPs and
bytes of the operations the step dispatched (`launch/op_cost.py`;
`cost_expanded` equals `cost`: eager Python runs every layer, there is no
`while` to expand), the collectives by kind, the roofline on the H100's
data-sheet peaks (`launch/roofline.py`: a model, not a measurement),
`model_flops_global`, `useful_flops_ratio`, `params` and `active_params`.
`memory.temp_bytes` is None (a `meta` tensor has no peak) and there is no
`compile_sec` (nothing is compiled).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import configs as cfg_lib
from repro_torch.core.salpim import SalPimConfig, SalPimEngine
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shard_lib
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as roof
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_production_mesh
from repro_torch.models import api as model_api
from repro_torch.models.transformer import shard_cache
from repro_torch.runtime import optimizer as opt_lib
from repro_torch.runtime.train_loop import make_train_step, shard_train_step

_MESHES: dict = {}


def production_mesh(mesh_kind: str):
    """Rank 0's production mesh ("single" or "multi") over a `fake` process
    group of its size in this process (made once; another size takes a new
    group)."""
    multi = mesh_kind == "multi"
    if mesh_kind in _MESHES:
        return _MESHES[mesh_kind]
    shape, _ = PRODUCTION_SHAPES[multi]
    size = 1
    for n in shape:
        size *= n
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized() and dist.get_world_size() != size:
        dist.destroy_process_group()
        _MESHES.clear()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    _MESHES[mesh_kind] = make_production_mesh(multi_pod=multi, device_type="cpu")
    return _MESHES[mesh_kind]


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in opt_lib.tree_leaves(tree))


def _run_step(cfg, shape, mesh, engine, *, fsdp: bool):
    """One rank's step of the cell on `meta` tensors: (argument bytes,
    output bytes) of the rank."""
    params = model_api.init_params(cfg, device="meta")
    pspecs = shard_lib.param_pspecs(params, mesh, fsdp=fsdp)
    specs = cfg_lib.input_specs(cfg, shape)
    bspecs = shard_lib.batch_pspecs(specs, mesh)
    arg_bytes = (shard_lib.spec_bytes(params, pspecs, mesh)
                 + shard_lib.spec_bytes(specs, bspecs, mesh))
    if shape.kind == "train":
        mine = shard_lib.shard_tree(params, pspecs, mesh)
        state = opt_lib.OptState(
            step=torch.zeros((), dtype=torch.int32, device="meta"),
            mu=opt_lib.tree_map(lambda p: p.new_empty(p.shape, dtype=torch.float32), mine),
            nu=opt_lib.tree_map(lambda p: p.new_empty(p.shape, dtype=torch.float32), mine))
        moments = opt_lib.tree_map(lambda p: p.new_empty(p.shape, dtype=torch.float32), params)
        arg_bytes += 2 * shard_lib.spec_bytes(moments, pspecs, mesh) + 4
        step = shard_train_step(make_train_step(cfg, engine, opt_lib.AdamWConfig()), mesh, cfg,
                                params, specs, fsdp=fsdp)
        with torch.no_grad():
            batch = shard_lib.shard_batch(specs, mesh)
        new_params, new_state, _ = step(mine, state, batch)
        return arg_bytes, _nbytes(new_params) + _nbytes(new_state)
    if shape.kind == "prefill":
        with torch.no_grad():
            batch = shard_lib.shard_batch(specs, mesh)
            logits, cache = model_api.prefill(params, batch, cfg, engine,
                                              max_len=shape.seq_len)
        return arg_bytes, _nbytes(logits) + _nbytes(cache)
    B = shape.global_batch
    cache = model_api.init_cache(cfg, B, shape.seq_len, device="meta")
    shard = shard_cache(cache, mesh, seq_shard=B == 1)
    arg_bytes += shard_lib.spec_bytes(cache, shard.specs, mesh)
    with torch.no_grad():
        logits, shard = model_api.decode_step(params, specs["token"], shard, cfg, engine,
                                              mesh=mesh)
    return arg_bytes, _nbytes(logits) + _nbytes(shard)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, lut: bool = True, fsdp=None,
             overrides: dict | None = None) -> dict:
    t_start = time.time()
    cfg = cfg_lib.get_config(arch)
    shape = cfg_lib.SHAPES[shape_name]
    if shape.kind == "decode":
        cfg = dataclasses.replace(cfg, decode_uniform=True)
    if overrides:
        overrides = dict(overrides)
        if "force_fsdp" in overrides:
            fsdp = bool(overrides.pop("force_fsdp"))
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
    mesh = production_mesh(mesh_kind)
    engine = SalPimEngine.create(SalPimConfig(nonlinear_mode="lut" if lut else "exact"))
    if fsdp is None:
        fsdp = shard_lib.should_fsdp(cfg) and shape.kind == "train"
    devices = int(mesh.mesh.numel())
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "kind": shape.kind,
           "fsdp": bool(fsdp), "devices": devices}
    t0 = time.time()
    with collectives.recording() as records, op_cost.OpCounter() as counter:
        arg_bytes, out_bytes = _run_step(cfg, shape, mesh, engine, fsdp=fsdp)
    rec["step_sec"] = time.time() - t0
    cost = counter.cost
    rec["memory"] = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                     "temp_bytes": None, "code_bytes": None}
    rec["host_outputs"] = {"count": cost.host_outputs, "bytes": cost.host_output_bytes}
    rec["cost"] = {"flops": cost.flops, "bytes accessed": cost.dot_bytes}
    rec["cost_expanded"] = {"flops": cost.flops, "dot_bytes": cost.dot_bytes}
    coll = roof.collective_bytes(records)
    rec["collectives"] = coll
    # The memory term: the dot operands streamed (weights and cache read
    # again each layer) or every argument read and output written once,
    # whichever is larger, as the reference takes it.
    rec["roofline"] = roof.roofline_terms(
        {"flops": cost.flops, "bytes accessed": max(cost.dot_bytes, float(arg_bytes + out_bytes))},
        coll["total_bytes"])
    n_tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
    mf = roof.model_flops(cfg, shape.kind, n_tokens)
    rec["model_flops_global"] = mf
    global_flops = rec["roofline"]["flops_per_device"] * devices
    rec["useful_flops_ratio"] = mf / global_flops if global_flops else None
    rec["params"] = cfg.param_count()
    rec["active_params"] = cfg.active_param_count()
    rec["total_sec"] = time.time() - t_start
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", type=str, default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--exact-nl", action="store_true",
                    help="use exact nonlinearities instead of LUT")
    ap.add_argument("--out", type=str, default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--override", type=str, default=None,
                    help="comma-separated cfg overrides, e.g. "
                         "moe_impl=shardmap,remat=none,attn_chunk=2048")
    ap.add_argument("--tag", type=str, default="", help="suffix for the output JSON name")
    args = ap.parse_args()

    overrides = {}
    if args.override:
        for kv in args.override.split(","):
            k, v = kv.split("=")
            if v in ("True", "False"):
                overrides[k] = v == "True"
            else:
                try:
                    overrides[k] = int(v)
                except ValueError:
                    overrides[k] = v

    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = cfg_lib.cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(cfg_lib.normalize(args.arch), args.shape)]

    failures = 0
    for mesh_kind in meshes:
        for arch, shape in cells:
            tag = f"{arch}.{shape}.{mesh_kind}" + (f".{args.tag}" if args.tag else "")
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip] {tag}")
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                rec = run_cell(arch, shape, mesh_kind, lut=not args.exact_nl,
                               overrides=overrides)
                r = rec["roofline"]
                print(f"  ok: step={rec['step_sec']:.1f}s bottleneck={r['bottleneck']} "
                      f"t=(c={r['t_compute']:.3e},m={r['t_memory']:.3e},"
                      f"x={r['t_collective']:.3e})s "
                      f"mem_args={rec['memory']['argument_bytes']}", flush=True)
            except Exception as e:  # noqa: BLE001 -- record and continue
                failures += 1
                rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "error": repr(e),
                       "traceback": traceback.format_exc()}
                print(f"  FAIL: {e!r}", flush=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    print(f"done, failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
