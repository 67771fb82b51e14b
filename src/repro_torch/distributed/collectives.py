"""Merges across splits of a computation and across ranks (the port of
`repro.distributed.collectives`: `merge_partial_softmax_stacked`,
`gather_heads`, and the one sum the expert-parallel MoE needs).

`merge_partial_softmax_stacked` is the combine of the KV-split decode
kernel: each split of the page walk leaves online-softmax partials (m, l,
acc), and the merge applies the log-sum-exp algebra over the splits axis.
It is also the plain version of the CUDA combine
`kernels/paged_attention.merge_partials`.

`gather_heads` and `psum` run over the ranks of a mesh dimension. A gloo
group moves CUDA tensors through host buffers (gloo gathers host memory);
that is the transport, and the arithmetic around it stays on the card.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def merge_partial_softmax_stacked(m: torch.Tensor, l: torch.Tensor,
                                  acc: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Merge online-softmax partials stacked along `axis`.

    m, l: (..., 1) running max and exp-sum; acc: (..., D) un-normalised
    weighted V. Empty splits hold (m = -1e30, l = 0, acc = 0); the finite
    guard keeps the all-empty case (a fully masked query) at 0, not NaN.
    The exp is exact, also in LUT mode.
    """
    m_glob = torch.amax(m, dim=axis, keepdim=True)
    m_glob = torch.where(m_glob <= -1e30, 0.0, m_glob)
    corr = torch.exp(m - m_glob)
    l_glob = torch.sum(l * corr, dim=axis)
    acc_glob = torch.sum(acc * corr, dim=axis)
    return acc_glob / torch.clamp(l_glob, min=1e-9)


def _group(mesh_or_group):
    """The process group of a mesh's "model" dimension, or the group given."""
    if isinstance(mesh_or_group, dist.ProcessGroup):
        return mesh_or_group
    from repro_torch.distributed import api
    return api.model_shard(mesh_or_group)[2]


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    return x.cpu() if x.is_cuda and dist.get_backend(group) == "gloo" else x


def gather_heads(x: torch.Tensor, mesh_or_group, axis: int) -> torch.Tensor:
    """Tensor-parallel attention-output merge: the ranks' head slices
    concatenated along `axis` in rank order (a tiled all-gather).

    Each rank attends a contiguous block of heads against its own slice of
    the KV pools, so the merge is a concatenation and adds no arithmetic:
    the merged heads are bit for bit one device's, and the output
    projection then runs replicated on them. `mesh_or_group` is a
    `DeviceMesh` (its dimension behind the logical "model" axis) or a
    process group. The gather fills a list (`dist.all_gather`) and
    concatenates it: `all_gather_into_tensor` gathers along dim 0 only."""
    group = _group(mesh_or_group)
    src = _staged(x, group).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=axis).to(x.device)


def psum(x: torch.Tensor, mesh_or_group) -> torch.Tensor:
    """The sum over the ranks of `mesh_or_group` (as `gather_heads` takes
    it) of each rank's `x`: the reference's `jax.lax.psum`. Every rank gets
    the same bits; the order of the float adds is the backend's."""
    group = _group(mesh_or_group)
    out = _staged(x, group).clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.device)
