"""Carry parameters and page pools from numpy into the port.

`params_from_numpy` takes a parameter tree whose leaves are numpy arrays
(for example the JAX package's parameters after
`jax.tree.map(np.asarray, params)`) and returns the same nested dict of
torch tensors. bfloat16 leaves (numpy's `ml_dtypes` bfloat16) keep their
bits. A leaf with `w_i8` and `scale` fields (the JAX package's
`QTensor` of int8 serving, after `jax.tree.map(np.asarray, ...)`) becomes
the port's `QTensor`; it is recognised by its fields, as the JAX engine
recognises it by name. `paged_cache_from_numpy` and
`dense_cache_from_numpy` carry caches the same way. Nothing here imports
JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.transformer import Cache
from repro_torch.serving.kvcache import PagedCache
from repro_torch.serving.quantize import QTensor


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    arr = np.array(arr, order="C")             # a writable copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(resolve_device(device))


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays -> nested dict of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if hasattr(tree, "w_i8") and hasattr(tree, "scale"):
        return QTensor(tensor_from_numpy(tree.w_i8, device),
                       tensor_from_numpy(tree.scale, device))
    return tensor_from_numpy(tree, device)


def paged_cache_from_numpy(lengths, block_tables, k_pages, v_pages,
                           device="cuda") -> PagedCache:
    """A fp PagedCache from numpy lengths (B,), tables (B, n) and pools
    (L, P, Hkv, page, Dh)."""
    return PagedCache(
        lengths=tensor_from_numpy(np.asarray(lengths, np.int32), device),
        block_tables=tensor_from_numpy(np.asarray(block_tables, np.int32), device),
        k_pages=tensor_from_numpy(k_pages, device),
        v_pages=tensor_from_numpy(v_pages, device),
    )


def dense_cache_from_numpy(cache, device="cuda"):
    """The port's dense `Cache` from one whose fields are numpy arrays or
    None (a JAX `Cache` after `jax.tree.map(np.asarray, cache)`): lengths,
    the arena and its scales, the SSM state, the conv window and the
    hybrid's shared KV, whichever it holds."""
    return Cache(**{f.name: None if getattr(cache, f.name, None) is None
                    else tensor_from_numpy(getattr(cache, f.name), device)
                    for f in dataclasses.fields(Cache)})
