"""The mesh registry (the port of `repro.distributed.api`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` whose dimensions
are named by `mesh_dim_names` (the counterpart of a `jax.sharding.Mesh`'s
axis names). Model code names *logical* axes ("batch", "model", ...);
`DEFAULT_RULES` maps each to physical mesh dimensions, and `resolve_spec`
turns a tuple of logical names into what a `PartitionSpec` holds: one
entry a dimension, None (replicated), a physical name, or a tuple of
them. `use_mesh` makes a mesh current for the code it wraps, as the
reference's does; the paged attention layer and the expert-parallel MoE
read `current_mesh()`.

The reference's `constrain` (a `with_sharding_constraint` hint to GSPMD)
has no counterpart: eager PyTorch has no partitioner to hint, so every
sharded path of the port says which slice a rank holds and which
collective merges the slices itself.

`model_shard(mesh)` gives a rank's place on the dimension behind the
logical "model" axis, and `rank_device(device)` the device a rank runs on.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device

_state = threading.local()

# Logical -> physical axis mapping. "batch" spans data (+pod when present).
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "seq_shard": "data",      # sequence-parallel long-context decode
    "seq_tp": "model",        # Megatron-SP residual-stream sequence shard
    "model": "model",         # TP: heads / ffn / vocab / experts
    "expert": "model",
}


def current_mesh():
    return getattr(_state, "mesh", None)


def current_rules() -> dict:
    return getattr(_state, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    prev_mesh = getattr(_state, "mesh", None)
    prev_rules = getattr(_state, "rules", DEFAULT_RULES)
    _state.mesh = mesh
    _state.rules = {**DEFAULT_RULES, **(rules or {})}
    try:
        yield
    finally:
        _state.mesh = prev_mesh
        _state.rules = prev_rules


def resolve_spec(logical: Sequence[Optional[str]], mesh,
                 rules: Optional[dict] = None) -> tuple:
    """Map logical axis names to a spec valid on `mesh`: a tuple with one
    entry a name, None, a physical dimension name, or a tuple of them;
    a physical dimension is used at most once."""
    rules = rules or current_rules()
    names = tuple(mesh.mesh_dim_names or ())
    axes = []
    used: set[str] = set()
    for name in logical:
        if name is None:
            axes.append(None)
            continue
        phys = rules.get(name)
        if phys is None:
            axes.append(None)
            continue
        if isinstance(phys, str):
            phys = (phys,)
        present = tuple(a for a in phys if a in names and a not in used)
        used.update(present)
        if not present:
            axes.append(None)
        elif len(present) == 1:
            axes.append(present[0])
        else:
            axes.append(present)
    return tuple(axes)


def _dims(mesh, logical: str, rules: Optional[dict]) -> tuple[str, ...]:
    axes = resolve_spec((logical,), mesh, rules)[0]
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, logical: str, rules: Optional[dict] = None) -> int:
    """Extent of the physical mesh dimension(s) behind a logical axis name
    (1 with no mesh or when the name maps to nothing). The paged serving
    stack uses `axis_size(mesh, "model")` as the tensor-parallel shard
    count of the pools' KV-head axis."""
    if mesh is None:
        return 1
    extent = 1
    for n in _dims(mesh, logical, rules):
        extent *= mesh.size(mesh.mesh_dim_names.index(n))
    return int(extent)


def model_shard(mesh, rules: Optional[dict] = None):
    """(this rank's index along "model", its extent, the process group of
    that dimension). The logical axis must map to one physical dimension."""
    dims = _dims(mesh, "model", rules)
    if len(dims) != 1:
        raise ValueError(f"the logical 'model' axis maps to mesh dimensions {dims}; "
                         "the port shards over exactly one")
    return (mesh.get_local_rank(dims[0]), axis_size(mesh, "model", rules),
            mesh.get_group(dims[0]))


def rank_device(device) -> torch.device:
    """The device this rank runs on: `cuda` without an index becomes
    `cuda:{rank % device_count}` in an initialised process group; any
    other device is taken as given."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dev.index is None and torch.distributed.is_initialized()
            and torch.cuda.is_available()):
        dev = torch.device("cuda", torch.distributed.get_rank() % torch.cuda.device_count())
    return resolve_device(dev)
