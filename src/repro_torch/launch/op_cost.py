"""Dot FLOPs and bytes of the operations a step really dispatches: the
port's counterpart of `repro.launch.hlo_cost`, which re-derives them from
compiled HLO text (expanding each `while` body by its trip count).

Eager PyTorch has no HLO and no `while` to expand: a Python loop runs
every layer, and `OpCounter`, a `TorchDispatchMode`, sees each operation
as it is dispatched, `meta` tensors' (the dry run's) included:

  * dot FLOPs: 2 * output elements * contracted extent, over aten.mm,
    bmm, addmm and baddbmm (einsum and matmul decompose to them before
    the dispatch);
  * dot bytes: the two operands' and the output's bytes (the streamed-
    weights proxy of the HBM term, as the reference counts them);
  * the tensors an operation made that are not `meta` (the dry run
    allocates none of its own: `host_outputs`).

Elementwise and reduction FLOPs are not counted (as the reference's).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten
_DOTS = {_aten.mm.default: (0, 1), _aten.addmm.default: (1, 2),
         _aten.bmm.default: (0, 1), _aten.baddbmm.default: (1, 2)}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    dot_bytes: float = 0.0
    dots: int = 0
    host_outputs: int = 0       # outputs on a device other than `meta`
    host_output_bytes: int = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Count the dots (and the non-meta outputs) of what runs under it
    into `self.cost`."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        at = _DOTS.get(func)
        if at is not None:
            a, b = args[at[0]], args[at[1]]
            self.cost.flops += 2.0 * out.numel() * a.shape[-1]
            self.cost.dot_bytes += _nbytes(a) + _nbytes(b) + _nbytes(out)
            self.cost.dots += 1
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.cost.host_outputs += 1
                self.cost.host_output_bytes += _nbytes(t)
        return out


def analyze(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its `Cost`)."""
    with OpCounter() as counter:
        result = fn(*args, **kwargs)
    return result, counter.cost
