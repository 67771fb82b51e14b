"""The benchmark's weights: drawn from the seed on the device, in the type
they are served in, into the tree the program's `init_params(cfg,
device="meta")` describes (shapes and dtypes, no storage).

One `normal_` call fills a single buffer that holds every random leaf
(each leaf's start rounded up to 256 bytes); each leaf is then a view of
it, scaled in place by its standard deviation: 0.02 for the embedding
tables, fan_in ** -0.5 for every matrix (fan_in is its last dimension).
Norm gains are ones, norm shifts and biases zeros. The same tensors go to
the program and to the reference.
"""
from __future__ import annotations

import torch

ALIGN = 128      # elements: 256 bytes of bf16


def _leaves(tree: dict, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _kind(path: tuple) -> str:
    name = path[-1]
    if path[0] in ("final_norm",) or (len(path) > 2 and path[-2].startswith(("ln", "post_ln"))):
        return "ones" if name == "g" else "zeros"
    if name.startswith("b"):
        return "zeros"
    return "normal"


def _std(path: tuple, shape) -> float:
    if path[-1] in ("embed", "pos_embed"):
        return 0.02
    return float(shape[-1]) ** -0.5


def draw(meta: dict, seed: int, device) -> dict:
    """A tree of real tensors shaped as `meta` (whose leaves are `meta`
    tensors), drawn from `seed` on `device`."""
    leaves = list(_leaves(meta))
    dtypes = {t.dtype for _, t in leaves}
    if len(dtypes) != 1:
        raise ValueError(f"one weight dtype expected, got {dtypes}")
    dtype = dtypes.pop()
    offsets, total = {}, 0
    for path, t in leaves:
        if _kind(path) == "normal":
            offsets[path] = total
            total += -(-t.numel() // ALIGN) * ALIGN
    buf = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    buf.normal_(generator=gen)
    out: dict = {}
    for path, t in leaves:
        kind = _kind(path)
        if kind == "normal":
            o = offsets[path]
            leaf = buf[o:o + t.numel()].view(t.shape)
            leaf.mul_(_std(path, t.shape))
        elif kind == "ones":
            leaf = torch.ones(t.shape, dtype=dtype, device=device)
        else:
            leaf = torch.zeros(t.shape, dtype=dtype, device=device)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out

