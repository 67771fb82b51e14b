"""Parameter, batch and cache sharding rules, and a rank's part in a
sharded train step (the port of `repro.distributed.sharding`).

The rule set is the reference's, SAL-PIM's mapping scheme (C3) projected
onto the (pod, data, model) mesh:
  * channels get *independent* weights (no accumulation across them)
    -> "model" carries heads / FFN columns / vocab / experts,
  * banks parallelize with cheap merges (C-ALU)
    -> "data" carries the batch (+ FSDP shards, merged by all-gather;
       + the KV sequence for long-context decode, merged by softmax algebra),
  * subarrays stream tiles -> the kernel grid, no mesh dimension.

Rules are path-regex -> logical spec; divisibility is checked per tensor
so one rule set serves every arch. A spec is a tuple with one entry a
dimension: None (replicated), a mesh dimension's name, or a tuple of them
(the reference's `PartitionSpec`). The rules read a mesh only through
`mesh_dim_names` and `size(i)`, so a stand-in with those two and `meta`
tensors give every full-size config's specs without a process group.

`shard_of` cuts a rank's slice of a whole tensor by its spec and
`gather_whole` puts a sharded leaf back together on every rank,
`gather_to_root` on rank 0 alone (the counterparts of `device_put` with a
`NamedSharding` and of reading a sharded array whole); `to_shardings`
pairs a spec tree with its mesh for the checkpoints' `shardings=`.

`TrainPlan` is a rank's part in the sharded train step
(`runtime/train_loop.shard_train_step`). Each rank holds its slice of every
parameter and AdamW moment; `use` gathers a layer's leaves just before the
layer runs, the leaves split over one mesh dimension in one collective:
over "data" (FSDP, and "dshard" for the embedding tables) with a
reduce-scatter as the backward, and over "model" where the layer does not
compute tensor-parallel (a slice as the backward: every "model" rank
computed the same gradient). `TrainPlan.tensor_parallel(part)` says which parts
compute on the rank's heads, columns, experts or vocab rows instead:
attention where the KV heads divide (q's heads ordered (kv head, group)),
the dense FFN where d_ff divides, the experts where they divide, the LM
head where the vocab divides; the SSM, hybrid and encoder-decoder families
gather every weight whole (the GSPMD reshard).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import api as dist_api
from repro_torch.distributed import collectives
from repro_torch.runtime.optimizer import named_leaves, tree_map, tree_map_with_path

# (path regex, logical spec applied to the *trailing* dims of the tensor).
# Stacked layer dims (leading L on the block stacks) are padded with None.
_RULES: list[tuple[str, tuple]] = [
    (r"(^|/)embed$", (None, "dshard")),     # gather table: d on data, always
    (r"pos_embed$|enc_pos$", (None, "dshard")),
    (r"lm_head$", ("model", "fsdp")),
    (r"router$", ("model", None)),
    (r"w[qkv]$", ("model", "fsdp")),
    (r"b[qkv]$", ("model",)),
    (r"wo$", ("fsdp", "model")),
    (r"moe/.*w_(up|gate)$", ("expert", None, "fsdp")),   # EP first
    (r"moe/.*w_down$", ("expert", "fsdp", None)),
    (r"w_(up|gate)$", ("model", "fsdp")),
    (r"w_down$", ("fsdp", "model")),
    (r"in_proj$", ("model", "fsdp")),
    (r"out_proj$", ("fsdp", "model")),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    (r"A_log$|^D$|/D$|dt_bias$", ("model",)),
    (r"norm_g$", ("model",)),
    (r".*", ()),                                # norms, scalars: replicate
]

LOGICAL_TO_PHYS = {
    "model": ("model",),
    "expert": ("model",),
    "fsdp": ("data",),
    "dshard": ("data",),    # like fsdp but applied regardless of the flag
    "batch": ("pod", "data"),
    "seq_shard": ("data",),
}

BATCH_AXES = LOGICAL_TO_PHYS["batch"]
_STACKS = ("blocks", "enc_blocks", "dec_blocks")   # leading layer axis, used a layer at a time


def mesh_shape(mesh) -> dict[str, int]:
    """{dimension name: extent} of a mesh (or a stand-in with
    `mesh_dim_names` and `size(i)`)."""
    names = tuple(mesh.mesh_dim_names or ())
    return {n: int(mesh.size(i)) for i, n in enumerate(names)}


def names_of(entry) -> tuple[str, ...]:
    """The mesh dimensions of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _phys_axes(logical: Optional[str], mesh):
    if logical is None:
        return None
    present = mesh_shape(mesh)
    axes = tuple(a for a in LOGICAL_TO_PHYS.get(logical, ()) if a in present)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _extent(shape: dict, entry) -> int:
    e = 1
    for n in names_of(entry):
        e *= shape[n]
    return e


def _fit_spec(shape: tuple, logical: tuple, mesh, *, fsdp: bool) -> tuple:
    """Right-align the logical spec onto `shape`, dropping invalid axes."""
    sizes = mesh_shape(mesh)
    spec: list = [None] * len(shape)
    offset = len(shape) - len(logical)
    if offset < 0:
        logical = logical[-len(shape):]
        offset = 0
    used: set[str] = set()
    for i, name in enumerate(logical):
        if name is None or (name == "fsdp" and not fsdp):
            continue
        names = tuple(n for n in names_of(_phys_axes(name, mesh)) if n not in used)
        if not names or shape[offset + i] % _extent(sizes, names) != 0:
            continue
        used.update(names)
        spec[offset + i] = names[0] if len(names) == 1 else names
    return tuple(spec)


def param_pspecs(params: Any, mesh, *, fsdp: bool = False) -> Any:
    """The spec tree of a parameter tree (of tensors, `meta` ones too)."""

    def one(path, leaf):
        # Quantized weights (QTensor): the int8 payload shards like its
        # parent weight; the per-row scale inherits the row axis.
        scale_of = path.endswith("/scale")
        if path.endswith("/w_i8") or scale_of:
            path = path.rsplit("/", 1)[0]
        for pat, logical in _RULES:
            if re.search(pat, path):
                if scale_of:
                    row_axis = logical[0] if logical else None
                    logical = ((None,) * max(leaf.ndim - 1, 0) + (row_axis,)
                               if row_axis else ())
                return _fit_spec(tuple(leaf.shape), logical, mesh, fsdp=fsdp)
        return ()

    return tree_map_with_path(one, params)


def batch_pspecs(batch: dict, mesh) -> dict:
    """Train/prefill inputs: the batch dim over (pod, data)."""
    dp = _phys_axes("batch", mesh)
    sizes = mesh_shape(mesh)

    def one(leaf):
        if leaf.ndim == 0:
            return ()
        if dp is not None and leaf.shape[0] % _extent(sizes, dp) == 0:
            return (dp, *([None] * (leaf.ndim - 1)))
        return (None,) * leaf.ndim

    return {k: one(v) for k, v in batch.items()}


def cache_pspecs(cache: Any, mesh, *, seq_shard: bool = False) -> Any:
    """Decode cache: batch on data; long-context (B=1): KV seq on data.

    Cache tensors: k/v (L, B, Hkv, S, D); ssm (L, B, H, N, P); conv (L, B,
    K-1, C); shared_k/v (A, B, Hkv, S, D); cross similar; lengths (B,).
    """
    dp = _phys_axes("batch", mesh)
    model = _phys_axes("model", mesh)
    sizes = mesh_shape(mesh)

    def ext(ax):
        return _extent(sizes, ax)

    def one(_, leaf):
        if leaf.ndim == 1:   # lengths
            return (None,)
        spec = [None] * leaf.ndim
        if leaf.ndim in (4, 5):   # KV (L/A, B, Hkv, S, D) and its scales (L, B, Hkv, S)
            if dp is not None and leaf.shape[1] % ext(dp) == 0:
                spec[1] = dp
            elif seq_shard and dp is not None and leaf.shape[3] % ext(dp) == 0:
                spec[3] = dp
            # model: heads if they divide, else the sequence dim (the
            # distributed flash-decode); with B=1 a 5-d KV's sequence takes
            # BOTH axes.
            if (leaf.ndim == 5 and spec[3] is not None and model is not None
                    and leaf.shape[3] % (ext(dp) * ext(model)) == 0):
                spec[3] = names_of(spec[3]) + names_of(model)
            elif model is not None and leaf.shape[2] % ext(model) == 0:
                spec[2] = model
            elif model is not None and spec[3] is None and leaf.shape[3] % ext(model) == 0:
                spec[3] = model
            return tuple(spec)
        if leaf.ndim >= 2:   # ssm/conv: (L, B, ...)
            if dp is not None and leaf.shape[1] % ext(dp) == 0:
                spec[1] = dp
            return tuple(spec)
        return ()

    return tree_map_with_path(one, cache)


def should_fsdp(cfg, threshold: float = 8e9) -> bool:
    """ZeRO-3 param+optimizer sharding for models past ~8B params."""
    return cfg.param_count() > threshold


def paged_pool_pspecs(mesh, *, quantized: bool = False,
                      rules: Optional[dict] = None) -> dict:
    """Specs of the paged cache (`serving/kvcache.PagedCache`), as tuples
    of `resolve_spec`: payload pools (L, P, Hkv, page, Dh) and scale pools
    (L, P, Hkv, page) shard their KV-head axis over the mesh dimension
    behind the logical "model" name, so each rank holds 1/tp of every page;
    lengths and block tables are replicated (admission, scheduling, COW
    forks, rewind and swap are host-side and run on every rank). Returns
    {"pools", "scales", "lengths", "block_tables"}; "scales" is None for
    fp pools."""
    pool = dist_api.resolve_spec((None, None, "model", None, None), mesh, rules)
    return {"pools": pool, "lengths": (), "block_tables": (),
            "scales": pool[:4] if quantized else None}


# ---------------------------------------------------------------------------
# Slices and gathers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of `jax.sharding.NamedSharding`)."""
    mesh: Any
    spec: tuple


def to_shardings(pspecs: Any, mesh) -> Any:
    """A spec tree as a tree of `NamedSharding`s (None stays None)."""
    return tree_map(lambda s: None if s is None else NamedSharding(mesh, tuple(s)), pspecs)


def _coord(mesh, names: tuple[str, ...]) -> tuple[int, int]:
    """(this rank's row-major index over `names`, their extent)."""
    sizes = mesh_shape(mesh)
    idx, extent = 0, 1
    for n in names:
        idx = idx * sizes[n] + mesh.get_local_rank(n)
        extent *= sizes[n]
    return idx, extent


def shard_of(x, spec: tuple, mesh):
    """This rank's slice of a whole tensor (or numpy array) by `spec`: a
    copy of its own when it is a slice, so the whole tensor can be freed."""
    sl = [slice(None)] * x.ndim
    for d, entry in enumerate(spec):
        names = names_of(entry)
        if not names:
            continue
        idx, extent = _coord(mesh, names)
        if extent == 1:
            continue
        size = x.shape[d] // extent
        sl[d] = slice(idx * size, (idx + 1) * size)
    if all(s == slice(None) for s in sl):
        return x
    out = x[tuple(sl)]
    return out.clone(memory_format=torch.contiguous_format) if isinstance(out, torch.Tensor) \
        else out.copy()


def shard_batch(batch: dict, mesh, n_micro: int = 1) -> dict:
    """This rank's rows of a whole batch by `batch_pspecs`, microbatch by
    microbatch: with n_micro > 1 each of the n_micro slices of the batch
    (the reference's microbatches) is cut alone and the rank's parts are
    concatenated, so the rank's i-th microbatch is its part of the global
    i-th one."""
    specs = batch_pspecs(batch, mesh)

    def one(k, x):
        spec = specs[k]
        if n_micro <= 1 or not spec or spec[0] is None:
            return shard_of(x, spec, mesh)
        mb = x.shape[0] // n_micro
        if mb * n_micro != x.shape[0] or mb % _extent(mesh_shape(mesh), spec[0]):
            raise ValueError(f"a batch of {x.shape[0]} rows does not split into {n_micro} "
                             f"microbatches over the ranks of {spec[0]}")
        parts = [shard_of(x[i * mb:(i + 1) * mb], spec, mesh) for i in range(n_micro)]
        return torch.cat(parts) if isinstance(x, torch.Tensor) else np.concatenate(parts)
    return {k: one(k, v) for k, v in batch.items()}


def gather_whole(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor of a sharded leaf on every rank (a collective of
    every rank that holds a slice)."""
    out = x
    sizes = mesh_shape(mesh)
    for d, entry in enumerate(spec):
        # The row-major index over several names: gather the inner first.
        for n in reversed(names_of(entry)):
            if sizes[n] > 1:
                out = collectives.all_gather_dim(out, mesh.get_group(n), d)
    return out


def gather_to_root(x: torch.Tensor, spec: tuple, mesh) -> Optional[torch.Tensor]:
    """The whole tensor of a sharded leaf on the host of global rank 0 (None
    on the other ranks): one gather of every rank's slice to rank 0, which
    places each by the rank's coordinates (a checkpoint's write, where only
    the writer needs the whole). The mesh spans the process group."""
    sizes = mesh_shape(mesh)
    src = x.detach().to("cpu").contiguous()
    if all(sizes[n] == 1 for e in spec for n in names_of(e)):
        return src if dist.get_rank() == 0 else None
    if dist.get_rank() != 0:
        dist.gather(src, dst=0)
        return None
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.gather(src, parts, dst=0)
    full = [k * _extent(sizes, e) for k, e in zip(src.shape, spec)]
    whole = src.new_empty(full)
    grid = mesh.mesh
    for r, part in enumerate(parts):
        at = dict(zip(mesh.mesh_dim_names, (int(i) for i in (grid == r).nonzero()[0])))
        sl = []
        for k, e in zip(src.shape, spec):
            idx = 0
            for n in names_of(e):
                idx = idx * sizes[n] + at[n]
            sl.append(slice(idx * k, (idx + 1) * k))
        whole[tuple(sl)] = part
    return whole


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    return tree_map(lambda x, s: shard_of(x, s, mesh), tree, specs)


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    return tree_map(lambda x, s: gather_whole(x, s, mesh), tree, specs)


# ---------------------------------------------------------------------------
# Where a rank's shard of the dense decode cache sits
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheSplit:
    """Where a rank's shard of one leaf of a dense cache sits in the whole
    leaf, by the mesh dimensions (of extent > 1, outer first) that split
    its batch rows (dimension 1 of every leaf), its heads (dimension 2: the
    KV heads of an arena) and its dimension 3 (an arena's sequence), each
    () where the rank holds the whole dimension."""

    mesh: Any
    batch: tuple = ()
    heads: tuple = ()
    seq: tuple = ()

    def index(self, axes: tuple) -> tuple[int, int]:
        """(this rank's row-major index over `axes`, their extent)."""
        return _coord(self.mesh, axes) if axes else (0, 1)

    def groups(self, axes: tuple) -> list:
        return [self.mesh.get_group(n) for n in axes]

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-batch tensor (dimension 0)."""
        idx, ext = self.index(self.batch)
        n = x.shape[0] // ext
        return x.narrow(0, idx * n, n) if ext > 1 else x

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The whole batch of every rank's rows (dimension 0), in rank order."""
        return gather_whole(x, (self.batch,), self.mesh)


def cache_split(cache: Any, mesh, name: Optional[str] = None) -> Optional[CacheSplit]:
    """How a rank's shard of a dense cache (a cache whose `specs` field
    holds the spec tree it was cut by) splits its leaf `name` (by default
    the first of "k", "ssm", "shared_k" it holds; every leaf splits the
    batch alike): None for a whole cache; a shard without its mesh raises."""
    if getattr(cache, "specs", None) is None:
        return None
    if mesh is None:
        raise ValueError("a rank's shard of a cache decodes on the mesh it was cut on: "
                         "pass mesh=")
    if name is None:
        name = next(n for n in ("k", "ssm", "shared_k") if getattr(cache, n) is not None)
    spec = getattr(cache.specs, name)
    sizes = mesh_shape(mesh)

    def live(d: int) -> tuple:
        return tuple(n for n in names_of(spec[d]) if sizes[n] > 1) if d < len(spec) else ()
    return CacheSplit(mesh, live(1), live(2), live(3))


def spec_bytes(tree: Any, specs: Any, mesh) -> int:
    """The bytes of this rank's slices of a whole-shaped tree by `specs`."""
    sizes = mesh_shape(mesh)
    total = 0
    for (_, x), (_, spec) in zip(named_leaves(tree), named_leaves(specs)):
        n = x.numel()
        for entry in spec:
            n //= _extent(sizes, entry)
        total += n * x.element_size()
    return total


# ---------------------------------------------------------------------------
# A rank's part in the sharded train step
# ---------------------------------------------------------------------------

_state = threading.local()


def current_plan() -> Optional["TrainPlan"]:
    return getattr(_state, "plan", None)


@contextlib.contextmanager
def use_plan(plan: Optional["TrainPlan"]):
    prev = current_plan()
    _state.plan = plan
    try:
        yield plan
    finally:
        _state.plan = prev


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """The sharded step's view of a mesh on one rank: the parameter specs,
    which parts of `cfg` compute tensor-parallel, and how far the batch is
    split (`batch_split` ranks over the batch axes; 1 when the batch is
    replicated)."""

    mesh: Any
    cfg: Any
    fsdp: bool
    specs: Any
    batch_split: int = 1

    @classmethod
    def create(cls, mesh, cfg, params: Any, *, fsdp: bool = False) -> "TrainPlan":
        """`params` whole-shaped (`meta` tensors do)."""
        plan = cls(mesh, cfg, fsdp, param_pspecs(params, mesh, fsdp=fsdp))
        for part, paths in _TP_LEAVES.items():
            if plan.tensor_parallel(part) is None:
                continue
            for path, spec in named_leaves(plan.specs):
                if re.search(paths, path) and "model" not in spec:
                    raise ValueError(f"{path} computes tensor-parallel but its spec "
                                     f"{spec} does not split it over 'model'")
        return plan

    def for_batch(self, batch: dict) -> "TrainPlan":
        """The plan for the whole-shaped batch `batch`."""
        tokens = batch["tokens"]
        spec = batch_pspecs({"tokens": tokens}, self.mesh)["tokens"]
        return dataclasses.replace(self, batch_split=_extent(mesh_shape(self.mesh), spec[0]))

    # -- the mesh ----------------------------------------------------------
    def size(self, name: str) -> int:
        return mesh_shape(self.mesh).get(name, 1)

    def group(self, name: str):
        return self.mesh.get_group(name)

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return tuple(a for a in BATCH_AXES if self.size(a) > 1)

    @property
    def batch_extent(self) -> int:
        return _extent(mesh_shape(self.mesh), self.batch_axes)

    def tensor_parallel(self, part: str):
        """(rank along "model", its extent, its group) when `part` ("attn",
        "ffn", "experts", "head") of this config computes tensor-parallel,
        else None."""
        tp = self.size("model")
        cfg = self.cfg
        if tp <= 1 or cfg.family not in ("dense", "moe"):
            return None
        ok = {"attn": cfg.n_kv_heads % tp == 0,
              "ffn": cfg.family == "dense" and cfg.d_ff % tp == 0,
              "experts": cfg.family == "moe" and cfg.n_experts % tp == 0,
              "head": cfg.vocab % tp == 0}[part]
        if not ok:
            return None
        return self.mesh.get_local_rank("model"), tp, self.group("model")

    # -- gathers before use --------------------------------------------------
    def _local(self, path: str) -> bool:
        """Whether a leaf stays split over "model" when its layer runs."""
        return any(re.search(pat, path) and self.tensor_parallel(part) is not None
                   for part, pat in _TP_LEAVES.items())

    def use(self, tree: Any, path: str) -> Any:
        """The leaves of `tree` (the subtree at `path`; a layer's of a stack
        has the stack's path) gathered for use: over "data" always (its
        backward a reduce-scatter), over "model" unless the leaf computes
        tensor-parallel (its backward a slice). The leaves gathered over one
        mesh dimension go in one collective a dtype."""
        stacked = path.split("/")[0] in _STACKS
        found: dict[str, list] = {}

        def collect(sub, leaf):
            full = "/".join(x for x in (path, sub) if x)
            spec = _spec_at(self.specs, full)
            found[full] = [leaf, spec[1:] if stacked else spec, self._local(full)]
            return full
        keys = tree_map_with_path(collect, tree)
        for name, mode in (("data", "sum"), ("model", "slice")):
            if self.size(name) <= 1:      # one rank holds the whole dimension
                continue
            by_dtype: dict = {}
            for full, (leaf, spec, keep_model) in found.items():
                if name == "model" and keep_model:
                    continue
                for d, entry in enumerate(spec):
                    if name in names_of(entry):
                        if len(names_of(entry)) > 1:
                            raise ValueError(f"{full}: a parameter dimension split over "
                                             f"{entry}")
                        by_dtype.setdefault(leaf.dtype, []).append((full, d))
            for items in by_dtype.values():
                outs = collectives.all_gather_grad([found[f][0] for f, _ in items],
                                                   self.group(name), [d for _, d in items],
                                                   backward=mode)
                for (full, _), out in zip(items, outs):
                    found[full][0] = out
        return tree_map(lambda full: found[full][0], keys)

    def use_top(self, params: dict) -> dict:
        """The parameters outside the layer stacks gathered for use; the
        stacks stay as they are (`use` gathers them a layer at a time)."""
        return {**self.use({k: v for k, v in params.items() if k not in _STACKS}, ""),
                **{k: v for k, v in params.items() if k in _STACKS}}

    # -- sums over the batch ---------------------------------------------------
    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the batch axes (no autograd)."""
        for a in self.batch_axes:
            x = collectives.psum(x, self.group(a))
        return x

    def reduce_grads(self, grads: Any) -> Any:
        """Sum each gradient over the batch axes its leaf is not split on
        (a leaf split over "data" was reduce-scattered by its gather)."""
        def one(path, g):
            spec = _spec_at(self.specs, path)
            held = {n for e in spec for n in names_of(e)}
            for a in self.batch_axes:
                if a not in held:
                    g = collectives.psum(g, self.group(a), widen=True)
            return g
        return tree_map_with_path(one, grads)

    def sum_over_shards(self, values: dict) -> torch.Tensor:
        """sum over leaves of values[path] (a per-leaf partial, e.g. the sum
        of a shard's squares), each summed over the mesh dimensions its leaf
        is split on and counted once where it is replicated."""
        by_axes: dict[tuple, torch.Tensor] = {}
        for path, v in values.items():
            held = tuple(sorted({n for e in _spec_at(self.specs, path) for n in names_of(e)
                                 if self.size(n) > 1}))
            by_axes[held] = by_axes.get(held, 0.0) + v
        total = None
        for axes, v in sorted(by_axes.items()):
            v = torch.as_tensor(v, dtype=torch.float32)
            for a in axes:
                v = collectives.psum(v, self.group(a))
            # On the host, but a meta partial (the dry run's) stays meta.
            v = v if v.device.type == "meta" else v.cpu()
            total = v if total is None else total + v
        return torch.zeros((), dtype=torch.float32) if total is None else total


# Leaves that stay split over "model" where their part computes tensor-parallel.
_TP_LEAVES = {
    "attn": r"^blocks/attn/(w[qkvo]|b[qkv])$",
    "ffn": r"^blocks/ffn/w_(up|gate|down)$",
    "experts": r"^blocks/moe/w_(up|gate|down)$",
    "head": r"^lm_head$",
}


def _spec_at(specs: Any, path: str) -> tuple:
    node = specs
    for k in path.split("/"):
        node = node[k] if isinstance(node, dict) else getattr(node, k)
    return node


def tensor_parallel(part: str):
    """`TrainPlan.tensor_parallel(part)` of the active plan; None without one."""
    plan = current_plan()
    return None if plan is None else plan.tensor_parallel(part)


def use_layer(fn, path: str):
    """fn(layer_params, ...) under the active plan, its parameters gathered
    for use first (`TrainPlan.use`); fn itself without a plan. Wrap the
    function that `remat` checkpoints, so the backward gathers again. The
    plan is entered again around each call: a checkpoint's recomputation
    runs on autograd's device thread, which does not see this thread's."""
    plan = current_plan()
    if plan is None:
        return fn

    def run(p, *args, **kw):
        with use_plan(plan):
            return fn(plan.use(p, path), *args, **kw)
    return run


def use_params(params: dict) -> dict:
    """`TrainPlan.use_top` of the active plan; the tree itself without one."""
    plan = current_plan()
    return params if plan is None else plan.use_top(params)


def global_mean_denominator(mask_sum: torch.Tensor) -> torch.Tensor:
    """The masked mean's denominator: the mask's sum over the batch axes of
    the active plan (the global batch's), or this batch's without one."""
    plan = current_plan()
    total = mask_sum if plan is None else plan.batch_sum(mask_sum.detach())
    return torch.clamp(total, min=1.0)


def is_mesh(mesh) -> bool:
    return hasattr(mesh, "mesh_dim_names") and hasattr(mesh, "get_group")


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0
