"""Training launcher (the port of `repro.launch.train`, one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-medium --smoke \\
        --steps 4 --batch 2 --seq 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --steps 50 --batch 8 --seq 1024 --lut

It takes the reference's flags and prints its lines, plus `--device`
(`cuda` unless the CPU is asked for; without a GPU it raises). The
published widths train unless `--smoke` asks for the CPU-sized twin.
`--mesh` other than `none` and `--fsdp` are refused: training under a
mesh is the port's next slice (serving on a mesh is ported).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import configs as cfg_lib
from repro_torch.core.salpim import SalPimConfig, SalPimEngine
from repro_torch.data import tokens as data_lib
from repro_torch.runtime import optimizer as opt_lib
from repro_torch.runtime.train_loop import MESH_REFUSAL, TrainConfig, run_training


def main(argv=None) -> dict:
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
    args = ap.parse_args(argv)
    if args.mesh != "none" or args.fsdp:
        ap.error(MESH_REFUSAL)

    cfg = cfg_lib.get_config(args.arch, smoke=args.smoke)
    engine = SalPimEngine.create(SalPimConfig(nonlinear_mode="lut" if args.lut else "exact"))
    data_cfg = data_lib.data_config_for_model(cfg, args.seq, args.batch)
    opt_cfg = opt_lib.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                                  total_steps=args.steps)
    train_cfg = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                            ckpt_every=args.ckpt_every, n_micro=args.micro,
                            metrics_path=args.metrics)

    result = run_training(cfg, train_cfg, opt_cfg, data_cfg, engine=engine,
                          device=args.device,
                          hooks={"on_log": lambda r: print(
                              f"step {r['step']:5d} loss {r['loss']:.4f} "
                              f"lr {r['lr']:.2e} {r['sec_per_step']*1e3:.0f} ms",
                              flush=True),
                              "on_straggler": lambda s, w: print(f"[warn] {w}")})
    print(f"final loss: {result['history'][-1]['loss']:.4f}")
    return result


if __name__ == "__main__":
    main()
