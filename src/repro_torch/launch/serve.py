"""Serving driver: batched text generation through the SAL-PIM engine (the
port of `repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --full --requests 8 --slots 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \\
        --requests 12 --slots 4 --lut --int8 --device cpu

It takes the reference's flags and prints its lines. `--full` serves the
published widths (GPT-2 medium by default) with seeded random weights;
`--smoke` (the default) the CPU-sized twin. `--device` is `cuda` unless
the CPU is asked for. `--mode continuous` drains the requests through
`ServingEngine` (the dense arena, `max_len` positions a slot); `--mode
batch` runs `generate()` on prompts of 8 tokens. Every model of the
registry serves (`--arch qwen2-vl-2b` on its text path) but the
encoder-decoder one: `--arch whisper-large-v3` exits at once with
`ServingEngine`'s refusal, which names `generate(...,
extra_inputs={"frames": ...})` as its entry point.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs as cfg_lib
from repro_torch.core.salpim import SalPimConfig, SalPimEngine
from repro_torch.models import api
from repro_torch.serving.config import EngineConfig, GenConfig
from repro_torch.serving.engine import ENCDEC_REFUSAL, ServingEngine, generate
from repro_torch.serving.quantize import quantize_params_int8


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="gpt2-medium")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--lut", action="store_true")
    ap.add_argument("--int8", action="store_true",
                    help="int8 weights + int8 KV cache serving path")
    ap.add_argument("--mode", choices=["batch", "continuous"],
                    default="continuous")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    cfg = cfg_lib.get_config(args.arch, smoke=args.smoke)
    if cfg.family == "encdec":
        ap.error(ENCDEC_REFUSAL)
    if args.int8:
        cfg = dataclasses.replace(cfg, kv_dtype="int8")
    engine = SalPimEngine.create(SalPimConfig(
        nonlinear_mode="lut" if args.lut else "exact"))
    params = api.init_params(cfg, seed=0, device=args.device)
    if args.int8:
        params = quantize_params_int8(params)
    print(f"{cfg.name}: {cfg.param_count():,} params, "
          f"nonlin={'lut' if args.lut else 'exact'}, "
          f"weights={'int8' if args.int8 else cfg.param_dtype}, "
          f"kv={cfg.kv_dtype}")

    gen = GenConfig(max_new_tokens=args.max_new,
                    temperature=args.temperature, stop_on_eos=False)
    rng = np.random.RandomState(0)

    if args.mode == "batch":
        prompts = rng.randint(2, cfg.vocab, size=(args.requests, 8))
        _, stats = generate(params, torch.as_tensor(prompts), cfg, engine, gen,
                            device=args.device)
        print(f"summarization {stats['prefill_sec']*1e3:.1f} ms | "
              f"generation {stats['sec_per_token']*1e3:.2f} ms/token | "
              f"{stats['tokens']} tokens")
        return

    eng = ServingEngine(params, cfg, engine, EngineConfig(
        slots=args.slots, max_len=args.max_len, gen=gen), device=args.device)
    for _ in range(args.requests):
        eng.submit(rng.randint(2, cfg.vocab, size=rng.randint(4, 12)),
                   max_new_tokens=args.max_new)
    t0 = time.perf_counter()
    steps = 0
    while True:
        n = eng.step()
        steps += 1
        if n == 0 and not eng.queue and all(a is None for a in eng.active):
            break
    dt = time.perf_counter() - t0
    if len(eng.finished) != args.requests:
        raise RuntimeError(f"{len(eng.finished)} of {args.requests} requests finished")
    print(f"{args.requests} requests through {args.slots} slots: "
          f"{steps} decode steps in {dt:.2f}s "
          f"({args.requests*args.max_new/dt:.1f} tok/s aggregate)")


if __name__ == "__main__":
    main()
