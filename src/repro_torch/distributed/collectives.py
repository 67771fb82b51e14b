"""Merges across splits of a computation and across ranks (the port of
`repro.distributed.collectives`).

`merge_partial_softmax_stacked` is the combine of the KV-split decode
kernel: each split of the page walk leaves online-softmax partials (m, l,
acc), and the merge applies the log-sum-exp algebra over the splits axis.
It is also the plain version of the CUDA combine
`kernels/paged_attention.merge_partials`.

`gather_heads`, `psum`, `compressed_psum` (int8 error-feedback gradient
reduction: a shared scale by pmax, the int8 payload summed as int32, the
residual carried into the next step), `merge_partial_softmax` (the
sequence-parallel decode merge, the C-ALU reduce generalised to
log-sum-exp algebra) and `hierarchical_psum` (inside the pod, then across)
run over the ranks of a mesh dimension. A gloo group moves CUDA tensors
through host buffers (gloo gathers host memory); that is the transport,
and the arithmetic around it stays on the card.

`recording()` notes each collective's kind ("all-gather", "all-reduce")
and operand bytes while it is active (the dry run's collective term,
`launch/roofline.collective_bytes`); off, it costs one test a call. A
collective on `meta` tensors (the dry run's) moves nothing: it returns a
`meta` result of the right shape.

The sharded train step differentiates through its collectives, so each
has a `torch.autograd.Function` with the backward its math asks for:
`all_gather_grad` (all-gather forward; a reduce-scatter backward where
the ranks' gradients are partial sums, a slice where every rank computed
the whole gradient), `tp_sum` (all-reduce forward, identity backward: the
row-parallel sum) and `tp_enter` (identity forward, all-reduce backward:
a replicated activation entering a column-parallel layer). The
activations' sums run in their dtype, as an XLA all-reduce does; the
gradients' sums of floating tensors narrower than f32 (the reduce-scatter,
`psum(widen=True)`) run in f32 and round once.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_RECORDS: list | None = None


@contextlib.contextmanager
def recording():
    """Note every collective the code it wraps runs, as (kind, operand
    bytes) in the list it yields."""
    global _RECORDS
    prev, _RECORDS = _RECORDS, []
    try:
        yield _RECORDS
    finally:
        _RECORDS = prev


def _note(kind: str, x: torch.Tensor) -> bool:
    """Record one collective of operand x; True when x is a `meta` tensor
    (no values to move: the caller returns a meta result)."""
    if _RECORDS is not None:
        _RECORDS.append((kind, x.numel() * x.element_size()))
    return x.device.type == "meta"


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
    return all_gather_dim(x, _group(mesh_or_group), axis)


def psum(x: torch.Tensor, mesh_or_group, *, widen: bool = False) -> torch.Tensor:
    """The sum over the ranks of `mesh_or_group` (as `gather_heads` takes
    it) of each rank's `x`: the reference's `jax.lax.psum`. Every rank gets
    the same bits; the order of the float adds is the backend's. `widen`
    sums a bf16/f16 x in f32 and rounds once."""
    return _all_reduce(x, _group(mesh_or_group), dist.ReduceOp.SUM, widen=widen)


def pmax(x: torch.Tensor, mesh_or_group) -> torch.Tensor:
    return _all_reduce(x, _group(mesh_or_group), dist.ReduceOp.MAX)


def _all_reduce(x: torch.Tensor, group, op, *, widen: bool = True) -> torch.Tensor:
    wide = widen and x.is_floating_point() and x.element_size() < 4
    src = x.float() if wide else x
    if _note("all-reduce", src):
        return torch.empty_like(x)
    out = _staged(src, group).clone()
    dist.all_reduce(out, op=op, group=group)
    return out.to(device=x.device, dtype=x.dtype)


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim` in rank order (no autograd)."""
    n = dist.get_world_size(group)
    if _note("all-gather", x):
        shape = list(x.shape)
        shape[dim] *= n
        return x.new_empty(shape)
    src = _staged(x, group).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


class _AllGather(torch.autograd.Function):
    """All-gathers of several tensors of one dtype, each along its own dim,
    in one collective: the ranks' flattened shards travel as one buffer,
    and the backward's reduce-scatter is one sum of every gradient's chunks
    in rank order."""

    @staticmethod
    def forward(ctx, group, dims, reduce, *xs):
        dims = tuple(d % x.ndim for x, d in zip(xs, dims))
        ctx.group, ctx.dims, ctx.reduce = group, dims, reduce
        ctx.shapes = [x.shape for x in xs]
        ctx.like = xs[0].new_empty(())
        n = dist.get_world_size(group)
        flat = all_gather_dim(torch.cat([x.reshape(-1) for x in xs]), group, 0).view(n, -1)
        outs, off = [], 0
        for x, d in zip(xs, dims):
            k = x.numel()
            outs.append(torch.cat([flat[r, off:off + k].view(x.shape) for r in range(n)], dim=d))
            off += k
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n, me = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        gs = [ctx.like.new_zeros([k * n if i == d else k for i, k in enumerate(s)])
              if g is None else g for g, s, d in zip(gs, ctx.shapes, ctx.dims)]
        if ctx.reduce:
            buf = torch.cat([g.narrow(d, r * s[d], s[d]).reshape(-1)
                             for r in range(n) for g, s, d in zip(gs, ctx.shapes, ctx.dims)])
            buf = _all_reduce(buf, ctx.group, dist.ReduceOp.SUM)
            total = buf.numel() // n
            own = buf[me * total:(me + 1) * total]
            grads, off = [], 0
            for g, s in zip(gs, ctx.shapes):
                k = s.numel()
                grads.append(own[off:off + k].view(s))
                off += k
        else:
            grads = [g.narrow(d, me * s[d], s[d]).contiguous()
                     for g, s, d in zip(gs, ctx.shapes, ctx.dims)]
        return (None, None, None, *grads)


def all_gather_grad(xs, group, dims, *, backward: str = "sum") -> tuple:
    """The ranks' slices of each of xs (one dtype) concatenated along its
    own dim in rank order, in one collective that autograd sees through:
    the backward takes this rank's chunk of each gradient after summing it
    over the group (`backward="sum"`, a reduce-scatter: the ranks hold
    different tokens) or as it is (`"slice"`: every rank computed the same
    whole gradient)."""
    if backward not in ("sum", "slice"):
        raise ValueError(f"backward must be 'sum' or 'slice', not {backward!r}")
    return _AllGather.apply(group, tuple(dims), backward == "sum", *xs)


class _TpSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, dist.ReduceOp.SUM, widen=False)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TpEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, dist.ReduceOp.SUM, widen=False), None


def tp_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The row-parallel merge: the ranks' partial outputs summed (its
    gradient passes unchanged to every rank)."""
    return _TpSum.apply(x, group)


def tp_enter(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated activation entering a tensor-parallel region: x itself,
    its gradient summed over the ranks that each used it for their part."""
    return _TpEnter.apply(x, group)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.amax(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(grad: torch.Tensor, group, error_feedback=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 error-feedback mean over the ranks of `group`: the ranks agree
    on a scale (the max of the local ones), quantize to int8, sum the
    payload as int32 (a quarter of f32's bytes on the wire), dequantize and
    divide by the rank count, and keep the local quantization residual as
    the feedback for the next call. Returns (mean in f32, new feedback)."""
    group = _group(group)
    g = grad.float()
    if error_feedback is not None:
        g = g + error_feedback
    local_scale = torch.clamp(torch.amax(torch.abs(g)), min=1e-12) / 127.0
    scale = pmax(local_scale, group)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    new_ef = g - q.float() * scale
    total = psum(q.to(torch.int32), group)
    n = float(dist.get_world_size(group))
    return total.float() * scale / n, new_ef


def merge_partial_softmax(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                          group) -> torch.Tensor:
    """Merge the ranks' online-softmax partials: m (..., 1) running max, l
    (..., 1) exp-sum, acc (..., D) weighted V. Returns the exact
    softmax(scores) @ V over every rank's keys. `group` may be a list of
    groups (a sequence split over several mesh dimensions): the max and
    the sums then run over each in turn, outer to inner as given. A rank
    whose keys were all masked passes m = -inf (or -1e30), l = 0, acc = 0
    and weighs nothing; where every rank's were, the result is 0, not
    NaN."""
    groups = [_group(g) for g in (group if isinstance(group, (list, tuple)) else [group])]
    m_glob = m
    for g in groups:
        m_glob = pmax(m_glob, g)
    m_glob = torch.where(torch.isfinite(m_glob), m_glob, 0.0)
    corr = torch.exp(m - m_glob)
    # l and acc travel in one buffer: one sum a group.
    both = torch.cat([l * corr, acc * corr], dim=-1)
    for g in groups:
        both = psum(both, g)
    return both[..., 1:] / torch.clamp(both[..., :1], min=1e-9)


def hierarchical_psum(x: torch.Tensor, inner, outer) -> torch.Tensor:
    """Sum inside the pod first (the fast links), then across pods: the
    two-level C-ALU, bank merge then channel merge."""
    return psum(psum(x, inner), outer)
