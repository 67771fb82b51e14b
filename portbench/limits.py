"""Readings that set a cell's limits and rate, on the card, many runs in
one process (each run draws its own weights and traffic from its seed):

    python3 portbench/limits.py --workload <cell> --seconds <s> \
        --seeds 1,2,3 [--control-seeds 4,5,6] [--rates 2,3,4] [--out FILE]

--seeds          the program as the cell states it: its compared numbers
                 on each seed (the lower readings of the limits)
--control-seeds  the control: the program's own int8 datapath switched on
                 (`SalPimConfig(quant="int8")`), the step below the
                 configuration's bf16 (the upper readings)
--rates          an open-loop cell at each rate (requests/s) in place of
                 its mix's: requests finished per second, the backlog at
                 the window's end, the time to first token (the knee sweep)

One JSON line a run, to standard output and to --out.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--rates", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import harness
    if not torch.cuda.is_available():
        print("portbench.limits: no CUDA device", file=sys.stderr)
        return 2

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    runs = [(s, "none", None) for s in ints(args.seeds)]
    runs += [(s, "int8", None) for s in ints(args.control_seeds)]
    runs += [(1000 + i, "none", float(r)) for i, r in enumerate(args.rates.split(",")) if r]
    out = open(args.out, "a") if args.out else None
    try:
        for seed, quant, rate in runs:
            res, _, found = harness.run_cell(args.workload, seed, args.seconds, False,
                                             quant=quant, rate=rate)
            line = {"workload": args.workload, "seed": seed, "quant": quant, "rate": rate,
                    "correct": res["correct"], "forbidden": found,
                    **{k: v["value"] for k, v in res["checked"].items()},
                    "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                    "load": res["load"], "memory_peak_bytes": res["device"]["memory_peak_bytes"]}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
