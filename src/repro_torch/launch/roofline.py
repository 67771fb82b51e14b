"""Roofline terms of a dry-run cell (the port of `repro.launch.roofline`),
on the H100's data-sheet peaks: NVIDIA H100 SXM 80GB at 700 W.

    compute    = FLOPs a rank / 989 TFLOP/s (bf16 dense, the `h100` spec)
    memory     = bytes a rank / 3.35 TB/s (HBM3, the `h100` spec)
    collective = collective bytes a rank / 450 GB/s (NVLink 4, each way)

The first two are read from `serving/costmodel.HARDWARE_SPECS["h100"]`,
the link rate from `costmodel.H100_LINK_BYTES_PER_SEC`. They are a model
of the card from its data sheet, not a measurement of it. The reference
parses the collectives out of compiled HLO text; the port has none, so
`collective_bytes` sums the collectives `distributed.collectives.
recording()` noted while the step ran, by kind.
"""
from __future__ import annotations

from typing import Any

from repro_torch.serving.costmodel import H100_LINK_BYTES_PER_SEC, HARDWARE_SPECS

_H100 = HARDWARE_SPECS["h100"]
PEAK_FLOPS = _H100.peak_flops
HBM_BW = _H100.peak_bytes_per_sec
LINK_BW = H100_LINK_BYTES_PER_SEC

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(records) -> dict:
    """Operand bytes and calls by collective kind of the (kind, bytes)
    records of `collectives.recording()`."""
    totals = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for kind, nbytes in records:
        totals[kind] = totals.get(kind, 0) + nbytes
        counts[kind] = counts.get(kind, 0) + 1
    return {"per_kind_bytes": totals, "per_kind_count": counts,
            "total_bytes": sum(totals.values())}


def roofline_terms(cost: dict[str, Any], coll_bytes: int) -> dict:
    flops = float(cost.get("flops", 0.0) or 0.0)
    mem = float(cost.get("bytes accessed", 0.0) or 0.0)
    terms = {"compute": flops / PEAK_FLOPS, "memory": mem / HBM_BW,
             "collective": coll_bytes / LINK_BW}
    bottleneck = max(terms, key=terms.get)
    return {
        **{f"t_{k}": v for k, v in terms.items()},
        "bottleneck": bottleneck,
        "t_bound": terms[bottleneck],
        "flops_per_device": flops,
        "bytes_per_device": mem,
        "collective_bytes_per_device": float(coll_bytes),
    }


def model_flops(cfg, shape_kind: str, n_tokens: int) -> float:
    """MODEL_FLOPS: 6·N·D train (fwd+bwd), 2·N_active·D forward-only."""
    n_active = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n_active * n_tokens
    return 2.0 * n_active * n_tokens
