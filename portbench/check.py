"""Whether the tokens the timed window served are right.

After the window has closed and the program's state is freed: a sample,
drawn from the seed, of the requests the window finished, the one with
the most served tokens always in it. The reference runs once over each
prompt followed by its served tokens (teacher-forced) and, at each served
position, reads how far the served token's logit lies below its own best
(`reference.model.gaps`). Greedy tokens of a sound program lie at most a
rounding below the best, at near ties; a wrong token lies by the logits'
spread.

Two numbers are compared, each with its limit from the cell file:
  gap_max   the widest gap over every sampled token
  gap_mean  the mean gap over them
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.model import Reference, gaps


def sample(finished: list, n: int, seed: int) -> list:
    """Up to n of the finished requests: the one with the most served
    tokens, and the rest drawn from the seed."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: (len(finished[i].generated),
                                                       finished[i].uid))
    rest = [i for i in range(len(finished)) if i != longest]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [finished[longest]] + [finished[rest[i]] for i in sorted(pick)]


def readings(reqs: list, weights: dict, model: dict, config: dict, page_size: int,
             device) -> dict:
    """gap_max, gap_mean and the count of tokens compared, over `reqs`
    (each with .prompt and .generated)."""
    ref = Reference(weights, model, nonlinear_mode=config["nonlinear_mode"],
                    lut_sections=config["lut_sections"], page_size=page_size)
    all_gaps = []
    for r in reqs:
        served = torch.as_tensor(np.asarray(r.generated, np.int64), device=device)
        prompt = torch.as_tensor(np.asarray(r.prompt, np.int64), device=device)
        seq = torch.cat([prompt, served[:-1]])
        logits = ref.logits(seq)[len(prompt) - 1:]
        all_gaps.append(gaps(logits, served).double().cpu())
        del logits
    g = torch.cat(all_gaps) if all_gaps else torch.zeros(0, dtype=torch.float64)
    return {"gap_max": float(g.max()) if len(g) else float("nan"),
            "gap_mean": float(g.mean()) if len(g) else float("nan"),
            "tokens": int(len(g))}


def verdict(read: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and some tokens compared."""
    shown = {k: {"value": read[k], "limit": limits[k]} for k in limits}
    ok = read["tokens"] > 0 and all(
        np.isfinite(read[k]) and read[k] <= limits[k] for k in limits)
    shown["tokens"] = {"value": read["tokens"], "min": 1}
    return bool(ok), shown
