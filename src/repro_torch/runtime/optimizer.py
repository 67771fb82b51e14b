"""AdamW, its schedule, global-norm clipping and microbatch gradient
accumulation (the port of `repro.runtime.optimizer`; on a mesh each rank
updates its own slices, and the clip's norm is summed over them).

Parameters, gradients and moments are nested dicts of tensors with the
parameter tree's keys. The update follows the JAX package's formula, not
`torch.optim.AdamW`'s: fp32 moments; the clip scale min(1, max_norm /
max(norm, 1e-9)) on every gradient, cast back to its dtype; bias-corrected
moments; decoupled weight decay on every leaf with ndim >= 1; the update
computed in fp32 and cast to the parameter's dtype. Microbatch gradients
are summed in fp32 and then divided. The step counter is a 0-d int32
tensor on the host, so the learning rate costs the device nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor   # () int32, on the host
    mu: Any              # fp32 tree like params
    nu: Any              # fp32 tree like params


def _children(tree) -> Optional[list]:
    """[(key, child)] of a tree node, None for a leaf. Nodes: dicts,
    `OptState` (its fields as ".step", ".mu", ".nu", the JAX package's
    checkpoint paths) and dataclasses (`QTensor`, `Cache`: their non-None
    fields, less those marked `metadata={"static": True}`, which ride
    along unchanged). Anything else is a leaf, a spec tuple too."""
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, OptState):
        return [(f".{n}", getattr(tree, n)) for n in OptState._fields]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)
                if getattr(tree, f.name) is not None and not f.metadata.get("static")]
    return None


def _child(tree, key: str):
    if tree is None:
        return None
    return tree[key] if isinstance(tree, dict) else getattr(tree, key.lstrip("."))


def _rebuild(tree, kids: dict):
    if isinstance(tree, dict):
        return kids
    if isinstance(tree, OptState):
        return OptState(*(kids[f".{n}"] for n in OptState._fields))
    return dataclasses.replace(tree, **kids)


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def tree_map_with_path(fn: Callable, tree, *rest, path: str = ""):
    """fn(path, leaf, *rest_leaves) over the leaves of `tree`, the port's
    one walker of parameter, gradient, moment, spec and checkpoint trees.
    Paths are the JAX package's ("blocks/attn/wq", "opt/.mu/embed"). A
    `rest` tree has `tree`'s structure; None in it stands for a subtree
    of Nones."""
    kids = _children(tree)
    if kids is None:
        return fn(path, tree, *rest)
    return _rebuild(tree, {k: tree_map_with_path(fn, v, *(_child(r, k) for r in rest),
                                                 path=_join(path, k)) for k, v in kids})


def tree_map(fn: Callable, tree, *rest):
    """fn(leaf, *rest_leaves) over the leaves of `tree` (`tree_map_with_path`)."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def named_leaves(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) in the JAX package's flatten order (dict keys sorted)."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    if isinstance(tree, dict):
        kids = sorted(kids, key=lambda kv: kv[0])
    return [p for k, v in kids for p in named_leaves(v, _join(prefix, k))]


def tree_leaves(tree) -> list:
    """The leaves in the JAX package's order (`named_leaves`)."""
    return [leaf for _, leaf in named_leaves(tree)]


def init_opt_state(params: Any) -> OptState:
    return OptState(step=torch.zeros((), dtype=torch.int32),
                    mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                      device=p.device), params),
                    nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                      device=p.device), params))


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio, in fp32."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def global_norm(tree: Any, *, plan=None) -> torch.Tensor:
    """The L2 norm over every element of the tree. With a sharded step's
    `plan` (`distributed.sharding.TrainPlan`) the leaves are this rank's
    slices: each slice's squares are summed over the ranks that hold the
    leaf's other slices, and a leaf replicated over a mesh dimension counts
    once."""
    if plan is not None:
        return torch.sqrt(plan.sum_over_shards(
            {path: torch.sum(torch.square(leaf.float())) for path, leaf in named_leaves(tree)}))
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in leaves))


def clip_by_global_norm(grads: Any, max_norm: float, *, plan=None) -> tuple[Any, torch.Tensor]:
    norm = global_norm(grads, plan=plan)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: OptState, *, plan=None) -> tuple[Any, OptState, dict]:
    """One AdamW step. With a sharded step's `plan` the trees hold this
    rank's slices: the update is elementwise, so only the clip's global
    norm crosses ranks."""
    step = state.step + 1
    lr = lr_at(cfg, step)
    grad_norm = step.new_zeros((), dtype=torch.float32)
    if cfg.clip_norm is not None:
        grads, grad_norm = clip_by_global_norm(grads, cfg.clip_norm, plan=plan)
    t = step.float()
    bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32, device=step.device) ** t
    bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32, device=step.device) ** t

    # bc1, bc2 and lr are 0-d tensors on the step counter's device, the
    # host (`meta` in the dry run), which PyTorch passes to a device
    # kernel as scalars.
    def upd(p, g, m, v):
        g32 = g.float()
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 1:     # decoupled weight decay (not on scalars)
            delta = delta + cfg.weight_decay * p.float()
        new_p = p.float() - lr * delta
        return new_p.to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu)
    new_p, mu, nu = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    return new_p, OptState(step=step, mu=mu, nu=nu), {"lr": lr, "grad_norm": grad_norm}


def value_and_grad(loss_fn: Callable, params: Any, batch: dict):
    """((loss, metrics), grads) of loss_fn(params, batch) with respect to
    every leaf of params (the tree itself is not changed)."""
    leaves = []

    def leaf(p):
        t = p.detach().requires_grad_(True)
        leaves.append(t)
        return t

    with torch.enable_grad():
        tracked = tree_map(leaf, params)
        loss, metrics = loss_fn(tracked, batch)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad_of(p):   # a leaf the loss does not reach gets zeros, as in jax.grad
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return (loss.detach(), metrics), tree_map(grad_of, params)


def accumulate_grads(loss_fn: Callable, params: Any, batch: dict,
                     n_micro: int) -> tuple[torch.Tensor, Any, dict]:
    """Split the batch into n_micro microbatches along its first axis; sum
    their gradients in fp32, then divide. Returns (mean loss, grads, the
    last microbatch's metrics); one microbatch keeps the params' dtypes."""
    if n_micro <= 1:
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        return loss, grads, metrics
    size = next(iter(batch.values())).shape[0] // n_micro
    tot_loss, acc, metrics = 0.0, None, {}
    for i in range(n_micro):
        mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
        (loss, metrics), grads = value_and_grad(loss_fn, params, mb)
        tot_loss = tot_loss + loss
        acc = (tree_map(lambda g: g.float(), grads) if acc is None
               else tree_map(lambda a, g: a + g.float(), acc, grads))
    return tot_loss / n_micro, tree_map(lambda g: g / n_micro, acc), metrics
