"""The partial-softmax merge (the port of
`repro.distributed.collectives.merge_partial_softmax_stacked`).

It is the combine of the KV-split decode kernel: each split of the page
walk leaves online-softmax partials (m, l, acc), and the merge applies the
log-sum-exp algebra over the splits axis. It is also the plain version of
the CUDA combine `kernels/paged_attention.merge_partials`.
"""
from __future__ import annotations

import torch


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
