"""Pipeline parallelism over a mesh dimension (the port of
`repro.distributed.pipeline`: the GPipe schedule).

Pods are the highest-latency boundary of the production mesh; pipeline
stages only need point-to-point transfers, which is exactly the traffic
pattern that survives a slow cross-pod link. With P stages and M
microbatches each rank holds the parameters of its stage and microbatch
activations rotate through the stages; the bubble fraction is
(P-1)/(M+P-1).

`pipeline_forward` is self-contained (a uniform stack of per-stage
functions), as the reference's is: nothing in the port wires it to the
block stack, and tests/test_torch_mesh_train.py holds it against the
sequential stages. It runs eagerly, one process a rank: each tick every
rank runs its stage on its input (or zeros outside the schedule) and the
ring passes each stage's output to the next by `dist.batch_isend_irecv`
(a gloo group moves CUDA tensors through host buffers).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives


def _ring_pass(y: torch.Tensor, group) -> torch.Tensor:
    """Each rank's `y` sent to the next rank of `group` (the last to the
    first); returns what the previous rank sent."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    src = collectives._staged(y, group).contiguous()
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, nxt, group), dist.P2POp(dist.irecv, buf, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf.to(y.device)


def pipeline_forward(stage_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                     stage_params, x_micro: torch.Tensor, group) -> torch.Tensor:
    """Run x through the P sequential stages held by the ranks of `group`
    (this rank is stage `dist.get_rank(group)` and holds `stage_params`),
    the (M, mb, ...) microbatch queue on every rank. The GPipe loop runs
    M + P - 1 ticks; on tick t stage s processes microbatch t - s when it
    is in range. Returns the last stage's outputs (M, mb, ...) on every
    rank."""
    p, stage = dist.get_world_size(group), dist.get_rank(group)
    m = x_micro.shape[0]
    out = torch.zeros_like(x_micro)
    carry = torch.zeros_like(x_micro[0])
    for t in range(m + p - 1):
        mb = t - stage
        active = 0 <= mb < m
        x_in = x_micro[min(max(mb, 0), m - 1)] if stage == 0 else carry
        y = stage_fn(stage_params, x_in) if active else torch.zeros_like(carry)
        if active and stage == p - 1:
            out[mb] = y
        carry = _ring_pass(y, group)
    # Every stage's `out` is zeros except the last's: share the result.
    return collectives.psum(out, group)


def make_pipelined_fn(stage_fn: Callable, mesh, axis_name: str, n_micro: int) -> Callable:
    """fn(stage_params (P, ...) stacked, x (B, ...)) -> (B, ...): x in
    n_micro microbatches through the P stages along `axis_name` of `mesh`,
    each rank running its own stage's slice. B % n_micro == 0."""
    group = mesh.get_group(axis_name)

    def fn(stage_params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        x_micro = x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))
        y = pipeline_forward(stage_fn, stage_params[dist.get_rank(group)], x_micro, group)
        return y.reshape((B,) + tuple(y.shape[2:]))

    return fn
