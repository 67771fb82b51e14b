"""Training launcher (the port of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-medium --smoke \\
        --steps 4 --batch 2 --seq 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --steps 50 --batch 8 --seq 1024 --lut
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --mesh test --device cpu
    torchrun --nnodes 16 --nproc-per-node 16 ... -m repro_torch.launch.train --mesh single

It takes the reference's flags and prints its lines, plus `--device`
(`cuda` unless the CPU is asked for; without a GPU it raises). The
published widths train unless `--smoke` asks for the CPU-sized twin.
`--mesh test` spawns the 8 ranks of `make_test_mesh()`'s (2, 4) ("data",
"model") mesh (gloo; on the card the GPUs present, rank % count);
`--mesh single` / `multi` build the production (16, 16) / (2, 16, 16)
mesh over the process group the environment describes (`torchrun`) and
refuse to start without one of that size. `--fsdp` shards the parameters
and moments over "data" too (without a mesh it changes nothing, as in the
reference). Rank 0 prints and writes the metrics.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile

import torch.distributed as dist

from repro_torch import configs as cfg_lib
from repro_torch.core.salpim import SalPimConfig, SalPimEngine
from repro_torch.data import tokens as data_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime import optimizer as opt_lib
from repro_torch.runtime.train_loop import TrainConfig, run_training

TEST_MESH = ((2, 4), ("data", "model"))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="gpt2-medium")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lut", action="store_true",
                    help="run the SAL-PIM LUT nonlinearity path")
    ap.add_argument("--mesh", choices=["none", "single", "multi", "test"], default="none")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--ckpt-dir", type=str,
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--metrics", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def _train(args, mesh=None, rank: int = 0) -> dict:
    cfg = cfg_lib.get_config(args.arch, smoke=args.smoke)
    engine = SalPimEngine.create(SalPimConfig(nonlinear_mode="lut" if args.lut else "exact"))
    data_cfg = data_lib.data_config_for_model(cfg, args.seq, args.batch)
    opt_cfg = opt_lib.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                                  total_steps=args.steps)
    train_cfg = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                            ckpt_every=args.ckpt_every, n_micro=args.micro,
                            metrics_path=args.metrics)

    def log(r):
        if rank == 0:
            print(f"step {r['step']:5d} loss {r['loss']:.4f} "
                  f"lr {r['lr']:.2e} {r['sec_per_step']*1e3:.0f} ms", flush=True)

    def straggler(s, w):
        if rank == 0:
            print(f"[warn] {w}")

    return run_training(cfg, train_cfg, opt_cfg, data_cfg, engine=engine, mesh=mesh,
                        fsdp=args.fsdp, device=args.device,
                        hooks={"on_log": log, "on_straggler": straggler})


def _device_type(args) -> str:
    return "cpu" if args.device == "cpu" else "cuda"


def mesh_test_rank(rank: int, args) -> dict:
    """One rank of `--mesh test` (run by `launch.mesh.World`): its history."""
    mesh = mesh_lib.make_test_mesh(*TEST_MESH, device_type=_device_type(args))
    return {"history": _train(args, mesh, rank)["history"]}


def main(argv=None) -> dict:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.mesh == "test":
        # by its module's name, also when this module runs as __main__
        from repro_torch.launch import train as this
        ranks = mesh_lib.World(this.mesh_test_rank, math.prod(TEST_MESH[0]), (args,)).join()
        result = ranks[0]
    else:
        mesh = None
        if args.mesh in ("single", "multi"):
            shape, _ = mesh_lib.PRODUCTION_SHAPES[args.mesh == "multi"]
            try:
                mesh_lib.init_from_env(math.prod(shape))
            except RuntimeError as e:
                ap.error(f"--mesh {args.mesh}: {e}")
            mesh = mesh_lib.make_production_mesh(multi_pod=args.mesh == "multi",
                                                 device_type=_device_type(args))
        rank = 0 if mesh is None else dist.get_rank()
        result = _train(args, mesh, rank)
        if rank:
            return result
    print(f"final loss: {result['history'][-1]['loss']:.4f}")
    return result


if __name__ == "__main__":
    main()
