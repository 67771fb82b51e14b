"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Needs as many CUDA devices as the cell asks
for; without them it exits with code 2 and prints no result. The last
line of standard output is the result object (`correct`, `attempted`,
`failed`, `metrics`, `device`, with `--trace 1` `breakdown`, and last
`checked`: each number compared with its limit); the compared numbers
are also the last lines of standard error.

The program's CUDA kernels build into `build/repro_torch/` inside the
checkout at first use; later runs find them there.
"""
from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them ('' if it
    cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import harness, work

    cell = harness.load("cells", args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"portbench: peaks {work.PEAK_FLOPS / 1e12:g} TFLOP/s bf16, "
          f"{work.PEAK_BYTES / 1e12:g} TB/s; card {power_limit()}", file=sys.stderr)
    result, lines, found = harness.run_cell(args.workload, args.seed, args.seconds,
                                            bool(args.trace), t_proc=T_PROC)
    if found:
        print(f"portbench: the process loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
