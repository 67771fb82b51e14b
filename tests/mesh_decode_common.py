"""Rank functions of tests/test_torch_mesh_decode.py (the dense decode on a
mesh).

`decode_rank` runs in every process of one gloo world of 8 CPU ranks that
`repro_torch.launch.mesh.World` spawned, once the test process has
written the cases (`decode_rank`). For each case it builds a (2, 4)
("data", "model") mesh, takes the rank's shard of the JAX package's
prefilled dense cache (`transformer.shard_cache`), runs the case's decode
steps through `api.decode_step(..., mesh=)` and returns plain data for the
test process, which holds it to the JAX package's unsharded decode.
Nothing here imports JAX.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.salpim import SalPimConfig, SalPimEngine
from repro_torch.kernels import decode_attention as attn_k
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import api
from repro_torch.models.transformer import gather_cache, shard_cache
from repro_torch.runtime import optimizer as opt


def config(case: dict):
    return dataclasses.replace(get_config(case["name"], smoke=True), **case["overrides"])


def decode_case(case: dict) -> dict:
    """Two decode steps on the rank's shard: each step's logits (every
    rank), the specs, the rank's shard shapes, the partials launched on the
    CPU (none: the plain version), and on rank 0 the gathered cache."""
    cfg = config(case)
    mesh = make_test_mesh(tuple(case["shape"]), ("data", "model"), device_type="cpu")
    params = bridge.params_from_numpy(case["params"], device="cpu")
    whole = bridge.dense_cache_from_numpy(case["cache"], device="cpu")
    shard = shard_cache(whole, mesh, seq_shard=case["seq_shard"])
    engine = SalPimEngine.create(SalPimConfig(nonlinear_mode=case.get("mode", "exact")))
    launches = attn_k.decode_attention_partials.launches
    logits = []
    for tok in case["tokens"]:
        out, shard = api.decode_step(params, torch.from_numpy(tok), shard, cfg, engine,
                                     mesh=mesh)
        logits.append(out.detach().float().numpy())
    gathered = gather_cache(shard, mesh)
    out = {"logits": logits,
           "specs": {p: s for p, s in opt.named_leaves(shard.specs)},
           "shapes": {p: tuple(x.shape) for p, x in opt.named_leaves(shard)},
           "lengths": shard.lengths.numpy(),
           "launches": attn_k.decode_attention_partials.launches - launches}
    if dist.get_rank() == 0:
        out["cache"] = {p: x.detach().float().numpy() for p, x in opt.named_leaves(gathered)}
    return out


def decode_rank(rank: int, source: str, timeout_s: float = 300.0) -> dict:
    """Every case of the file `source`, which the test process writes (in
    one rename) once its JAX side is done: the ranks start meanwhile."""
    path, deadline = pathlib.Path(source), time.monotonic() + timeout_s
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no cases at {source} after {timeout_s} s")
        time.sleep(0.05)
    cases = torch.load(path, weights_only=False)
    return {name: decode_case(case) for name, case in cases.items()}


def np_tokens(rng: np.random.RandomState, batch: int, vocab: int) -> np.ndarray:
    return rng.randint(0, vocab, size=(batch,)).astype(np.int32)
