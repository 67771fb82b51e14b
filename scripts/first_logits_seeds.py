#!/usr/bin/env python3
"""First-logit readings of chip_smoke.py's paged drains over several seeds,
on one NVIDIA GPU.

    python3 scripts/first_logits_seeds.py [--seeds 0 1 2 3 4]

For each seed, GPT-2 medium at full width gets the seeded random weights and
the 8 requests that `chip_smoke.py --seed N` makes in its phase 4, and serves
them in the drains of its phases 4 and 6: exact, LUT, q1 (int8 weights and
pools), q2 (fixed16) and q3 (int8 per call, LUT), with that script's launch
checks at every step. Each drain's first logits are read against a one-shot
prefill through the plain versions, as chip_smoke.py's gate reads them
(max |diff| / max |logit|), and a LUT-mode drain also against the dense LUT
softmax; each quantized drain's share of greedy tokens with the exact drain
is counted. One JSON line a seed, then the largest reading of each drain
over the seeds with the limits chip_smoke.py holds them to. Gates nothing.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("first_logits_seeds.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke as cs
    from repro_torch.configs import gpt2_medium
    from repro_torch.core import quant
    from repro_torch.core.salpim import SalPimConfig, SalPimEngine
    from repro_torch.kernels import _build
    from repro_torch.models import api
    from repro_torch.serving import quantize

    _build.build_all()
    kernels, mods, plain = cs.serving_handles(torch)
    card = torch.cuda.get_device_name(0)
    cfg = gpt2_medium.config()
    # (label, int8 weights, serve() knobs, pool format), as chip_smoke.py's
    # phases 4 and 6 drive them.
    drains = [("exact", False, dict(), "fp"),
              ("lut", False, dict(mode="lut"), "fp"),
              ("q1", True, dict(gemv="gemv_pim_int8_linear"), "int8/f32"),
              ("q2", False, dict(quant="fixed16", gemv="gemv_pim_fixed_linear"), "fp"),
              ("q3", False, dict(quant="int8", mode="lut", gemv="gemv_pim_int8_linear"), "fp")]
    rows = []
    for seed in args.seeds:
        params = api.init_params(cfg, seed=seed, device="cuda")
        qparams = quantize.quantize_params_int8(params)
        rng = np.random.RandomState(seed)
        prompts = [rng.randint(2, cfg.vocab, size=int(n))
                   for n in rng.randint(32, 129, size=8)]
        row, exact_done = {"seed": seed}, None
        for label, int8_weights, kw, fmt in drains:
            p = qparams if int8_weights else params
            _, done, first, _ = cs.serve(torch, mods, p, cfg, prompts, 32, card,
                                         label=f"{label} seed {seed}", fmt=fmt, **kw)
            sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=kw.get("mode", "exact"),
                                                   quant=kw.get("quant", "none")))
            worst, agree, dense_gap = cs.first_logit_gaps(
                torch, F, p, cfg, sal, prompts, done, first, fmt, quant, quantize, plain)
            row[label] = {"first_logits": worst, "first_token_agreement": agree}
            if dense_gap is not None:
                row[label]["dense_lut_gap"] = dense_gap
            if exact_done is None:
                exact_done = done
            else:
                row[label]["tokens_shared_with_exact"] = sum(
                    a == b for u in done for a, b in zip(done[u].generated,
                                                         exact_done[u].generated))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del params, qparams
    worst = {label: {key: max(r[label][key] for r in rows) for key in rows[0][label]
                     if key in ("first_logits", "dense_lut_gap")}
             for label, *_ in drains}
    print(json.dumps({"card": card, "seeds": args.seeds, "max": worst,
                      "limits": {"first_logits": cs.FIRST_LOGITS_LIMIT,
                                 "dense_lut_gap": cs.DENSE_LUT_GAP_LIMIT}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
