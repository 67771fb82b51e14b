"""Mixture-of-Experts (olmoe 64e/top-8, phi3.5 16e/top-2): the port of
`repro.models.moe`'s grouped dispatch (`_apply_moe_gspmd`, without the
training-only `return_aux`).

A call's T tokens split into G groups (`_num_groups`); within a group each
expert takes at most C of the group's Tg tokens (`_capacity`, the GShard
capacity at `router_cap_factor`). Which tokens are dropped therefore
depends on every token of the call, as in the reference.

  * routing (`route`): the f32 router through `SalPimEngine.linear` (the
    float GEMV, on the CUDA cores on the card), the engine's softmax (LUT
    exp and reciprocal in LUT mode), the top k by a stable descending sort
    (`jax.lax.top_k` breaks a tie toward the lower index, `torch.topk`
    does not), renormalised;
  * dispatch (`dispatch`): the assignments in slot-major order (every
    token's first choice, then every token's second, ...), so earlier
    tokens win capacity; an assignment's position in its expert is the
    count of earlier ones, and it is kept when that is below C;
  * the expert FFN on an expert-major buffer (E, G*C, d): each kept
    assignment's row written at its own position (one writer a position;
    the dropped ones go to a trash row past the buffer), two or three
    batched products over the experts (`torch.bmm`, as the reference's
    einsums run outside any Pallas kernel) and the activation between them
    (`engine.nl.activation`: the `lut_interp` kernel in LUT mode on the
    card, which takes the products' contiguous (E, G*C, f) outputs);
  * combine: each token's k outputs, times their weights (zero where
    dropped), added in choice order with one rounding a step in the
    compute dtype: bit for bit the reference's bf16 scatter-add on the CPU,
    and deterministic on the card (no atomic adds).

`moe_impl="shardmap"` is the reference's expert-parallel dispatch
(`_apply_moe_shardmap`) under a mesh (`distributed.api.current_mesh()`)
with a "model" dimension of M ranks that divides the experts (and, as
there, a group count that the data ranks divide): rank j routes every
token, as the grouped path does, keeps the assignments to its experts
[j*E/M, (j+1)*E/M) (capacity positions counted against all experts, so
the kept set is the grouped path's), runs their FFN and combines them,
and one `collectives.psum` over "model" adds the ranks' partial outputs.
In a mesh decode whose ranks hold some of the batch's rows (`rows`, the
rank's `sharding.CacheSplit`) the rows are gathered first and each
rank keeps its own of the output, so that the capacity drops are one
device's.
That is the grouped result in mathematics, not in bits (the sum runs in
another order), as in the reference. Each rank computes every token group:
the serving ranks hold the same tokens. Without such a mesh the config
takes the grouped path, as the reference's does.

Under a sharded train step (`distributed.sharding.TrainPlan`) every
`moe_impl` trains the same way: each rank dispatches its own tokens' groups,
routing runs replicated over "model", and where the experts divide over
"model" each rank holds and runs its own (`_apply_moe_train`), their
partial outputs summed with the autograd-aware `collectives.tp_sum`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.salpim import SalPimEngine
from repro_torch.distributed import api as dist_api
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shard_lib
from repro_torch.models.config import ModelConfig
from repro_torch.serving.quantize import QTensor


def init_moe(normal, cfg: ModelConfig, n_layers: int) -> dict:
    """Stacked (L, ...) expert weights with the JAX package's stds, in
    `cfg.pdtype`; the router (L, E, d) stays f32 at every param dtype."""
    d, f, e, L = cfg.d_model, cfg.moe_ff, cfg.n_experts, n_layers
    p = {
        "router": normal((L, e, d), d ** -0.5, torch.float32),
        "w_up": normal((L, e, f, d), d ** -0.5),
        "w_down": normal((L, e, d, f), f ** -0.5),
    }
    if cfg.gated_mlp:
        p["w_gate"] = normal((L, e, f, d), d ** -0.5)
    return p


def _as_weight(w, dtype: torch.dtype) -> torch.Tensor:
    """A weight operand in `dtype`: an int8 `QTensor` dequantized as
    `w_i8 * scale` in `dtype`, as the reference does."""
    if isinstance(w, QTensor):
        return w.w_i8.to(dtype) * w.scale[..., None].to(dtype)
    return w.to(dtype)


def _num_groups(n_tokens: int) -> int:
    for g in (256, 128, 64, 32, 16, 8, 4, 2):
        if n_tokens % g == 0 and n_tokens // g >= 32:
            return g
    return 1


def _capacity(cfg: ModelConfig, group_tokens: int) -> int:
    cap = int(cfg.router_cap_factor * cfg.top_k * group_tokens / cfg.n_experts)
    return min(max(cap, cfg.top_k), group_tokens)


def router_weights(router: torch.Tensor, xt: torch.Tensor,
                   engine: SalPimEngine) -> torch.Tensor:
    """xt (T, d) -> the router's softmax weights (T, E) in f32."""
    return engine.softmax(engine.linear(xt.float(), router), axis=-1)


def route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig,
          engine: SalPimEngine) -> tuple[torch.Tensor, torch.Tensor]:
    """xt (T, d) -> (weights (T, k) f32 renormalised, experts (T, k) int64),
    each row's choices in descending weight, a tie to the lower index."""
    weights = router_weights(router, xt, engine)
    topw, topi = torch.sort(weights, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :cfg.top_k], topi[:, :cfg.top_k]
    return topw / topw.sum(-1, keepdim=True).clamp_min(1e-9), topi


@dataclasses.dataclass
class Dispatch:
    """Where each assignment goes. Rows are (G, k*Tg) in slot-major order:
    column j*Tg + t is token t's j-th choice."""

    capacity: int
    expert: torch.Tensor      # (G, kTg) int64
    pos: torch.Tensor         # (G, kTg) its position in the expert's rows
    keep: torch.Tensor        # (G, kTg) bool: pos < capacity
    weight: torch.Tensor      # (G, kTg) f32, 0 where dropped


def dispatch(topw: torch.Tensor, topi: torch.Tensor, cfg: ModelConfig,
             n_groups: int) -> Dispatch:
    G, k = n_groups, cfg.top_k
    Tg = topi.shape[0] // G
    C = _capacity(cfg, Tg)
    eid = topi.reshape(G, Tg, k).transpose(1, 2).reshape(G, k * Tg)
    w = topw.reshape(G, Tg, k).transpose(1, 2).reshape(G, k * Tg)
    onehot = eid[..., None] == torch.arange(cfg.n_experts, device=eid.device)
    pos = onehot.long().cumsum(1).gather(-1, eid[..., None])[..., 0] - 1
    keep = pos < C
    return Dispatch(C, eid, pos, keep, w * keep)


def _expert_slice(w, lo: int, hi: int):
    """Experts lo..hi-1 of a stacked (E, ...) weight or int8 `QTensor`."""
    if isinstance(w, QTensor):
        return QTensor(w.w_i8[lo:hi], w.scale[lo:hi])
    return w[lo:hi]


def _ep_rank(cfg: ModelConfig, n_tokens: int):
    """(rank along "model", its extent, the mesh) when the expert-parallel
    dispatch runs (the reference's conditions), else None."""
    mesh = dist_api.current_mesh()
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "model" not in names:
        return None
    M = mesh.size(names.index("model"))
    dp = 1
    for a in ("pod", "data"):
        if a in names:
            dp *= mesh.size(names.index(a))
    if cfg.n_experts % M or _num_groups(n_tokens) % dp:
        return None
    return mesh.get_local_rank("model"), M, mesh


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig,
              engine: SalPimEngine, rows=None) -> torch.Tensor:
    """x (..., D) -> (..., D), experts dropping past their capacity.
    `rows`: in a mesh decode, the `sharding.CacheSplit` of the rank's
    cache, whose `batch` says whether x is some of the batch's rows."""
    if cfg.moe_impl not in ("gspmd", "shardmap"):
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}")
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    if shard_lib.current_plan() is not None:
        return _apply_moe_train(p, xt, cfg, engine).reshape(*lead, d)
    if rows is not None and rows.batch:
        # A mesh decode rank holds some of the batch's rows: every row is
        # routed and dispatched, as on one device (capacity counts every
        # token of the call), and the rank keeps its own.
        whole = apply_moe(p, rows.gather_rows(xt), cfg, engine)
        return rows.own_rows(whole).reshape(*lead, d)
    ep = _ep_rank(cfg, xt.shape[0]) if cfg.moe_impl == "shardmap" else None
    if ep is None:
        return _experts(p, xt, cfg, engine, 0, cfg.n_experts).reshape(*lead, d)
    j, M, mesh = ep
    e_loc = cfg.n_experts // M
    part = _experts(p, xt, cfg, engine, j * e_loc, (j + 1) * e_loc)
    return collectives.psum(part, mesh.get_group("model")).reshape(*lead, d)


def _apply_moe_train(p: dict, xt: torch.Tensor, cfg: ModelConfig,
                     engine: SalPimEngine) -> torch.Tensor:
    """The MoE under a sharded train step. The rank's tokens are 1/split of
    the global batch's, so they form 1/split of its token groups (the
    reference's grouped dispatch over the global batch, each group on the
    rank that holds its tokens). Routing runs replicated over "model" (the
    router gathered whole); where the experts split over "model", the rank
    runs its own on every token of its groups, and the ranks' partial
    outputs are summed."""
    plan = shard_lib.current_plan()
    split = plan.batch_split
    G = _num_groups(xt.shape[0] * split)
    if G % split:
        raise ValueError(f"the global batch's {G} token groups do not divide over the "
                         f"{split} ranks that split the batch")
    G //= split
    topw, topi = route(p["router"], xt, cfg, engine)
    tp = shard_lib.tensor_parallel("experts")
    if tp is None:
        return _experts(p, xt, cfg, engine, 0, cfg.n_experts, routing=(topw, topi),
                        n_groups=G)
    j, M, group = tp
    e_loc = cfg.n_experts // M
    part = _experts(p, collectives.tp_enter(xt, group), cfg, engine, j * e_loc,
                    (j + 1) * e_loc, routing=(collectives.tp_enter(topw, group), topi),
                    n_groups=G, local_weights=True)
    return collectives.tp_sum(part, group)


def _experts(p: dict, xt: torch.Tensor, cfg: ModelConfig, engine: SalPimEngine,
             lo: int, hi: int, *, routing=None, n_groups=None,
             local_weights: bool = False) -> torch.Tensor:
    """xt (T, d) -> the outputs (G, Tg, d) of experts lo..hi-1 (all of them
    on the grouped path), every token routed against all experts (or by
    `routing`, (weights, experts) of `route`) in `n_groups` groups
    (`_num_groups` by default). `local_weights`: the expert weights hold
    experts lo..hi-1 alone (a rank's slice), not all of them."""
    T, d = xt.shape
    k = cfg.top_k
    G = n_groups or _num_groups(T)
    Tg = T // G
    plan = dispatch(*(routing or route(p["router"], xt, cfg, engine)), cfg, G)
    C = plan.capacity
    dev, dtype = xt.device, xt.dtype
    n = hi - lo
    local = (plan.expert >= lo) & (plan.expert < hi)
    keep = plan.keep & local

    # Expert-major rows: assignment (g, j*Tg + t) kept at position pos of
    # local expert e is row e*G*C + g*C + pos; the others write row n*G*C.
    base = (plan.expert - lo).clamp(0, n - 1) * (G * C) + torch.arange(G, device=dev)[:, None] * C
    rows = torch.where(keep, base + plan.pos, n * G * C)
    tok = torch.arange(Tg, device=dev).repeat(k)                      # (kTg,)
    xg = xt.reshape(G, Tg, d)
    buf = xt.new_zeros((n * G * C + 1, d))
    buf[rows.reshape(-1)] = xg[:, tok].reshape(-1, d)
    buf = buf[:n * G * C].view(n, G * C, d)

    def weight(name):
        w = p[name] if local_weights else _expert_slice(p[name], lo, hi)
        return _as_weight(w, dtype).transpose(1, 2)

    act = engine.nl.activation(cfg.activation)
    up = torch.bmm(buf, weight("w_up"))
    if cfg.gated_mlp:
        h = act(torch.bmm(buf, weight("w_gate"))) * up
    else:
        h = act(up)
    out_buf = torch.bmm(h, weight("w_down"))

    # Combine in choice order; a dropped or another rank's assignment reads
    # a local expert's last row (as the reference's safe position C - 1) at
    # weight 0.
    gathered = out_buf.reshape(n * G * C, d)[
        (base + torch.where(keep, plan.pos, C - 1)).reshape(-1)].view(G, k * Tg, d)
    contrib = gathered * torch.where(local, plan.weight, 0.0)[..., None].to(dtype)
    out = torch.zeros_like(xg)
    for j in range(k):
        out = out + contrib[:, j * Tg:(j + 1) * Tg]
    return out
