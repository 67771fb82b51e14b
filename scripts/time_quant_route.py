#!/usr/bin/env python3
"""Device times of the quantized linear routes, for comparing two trees of
the port in one call on one NVIDIA GPU.

    python3 scripts/time_quant_route.py [--src DIR] [--label NAME] [--seed N]

Imports `repro_torch` from DIR (default: this checkout's `src`), so that
the same measurements run on another tree, for example a `git archive` of
the parent commit unpacked under `build/`. Prints one JSON line:

  * fixed16_step_ms: the 145 `SalPimEngine.linear` calls of a GPT-2 medium
    decode step (M = 4, bf16 weights, the q/k/v biases) with
    quant="fixed16", weight and x quantization included, replayed as one
    CUDA graph;
  * fixed16_w_up_m64_us: `linear` of `w_up` at M = 64 (a prefill chunk);
  * fixed_kernel_step_ms, fixed_kernel_w_up_m64_us: `gemv_pim_fixed`
    alone on int16 operands quantized beforehand (shift 12);
  * q1_linear_step_ms, q3_linear_step_ms: the 145 `SalPimEngine.linear`
    calls of a decode step with `quantize_params_int8` weights (q1) and
    with quant="int8" and LUT nonlinearities (q3, the weights quantized on
    every call), the biases in bf16, the LUT GELU after w_up in q3;
    int8_w_up_m64_us: q1's `linear` of `w_up` at M = 64;
  * wquant_step_ms: `quantize_int8_rows` of a decode step's 145 bf16
    weights (q3's per-call weight quantization, as q3 calls it), one
    launch each;
  * split_route_us, merge_us: `paged_attention(..., kv_splits=4)` (the
    split kernel and its combine) and the combine alone, B=4, H=16, D=64,
    bf16 pools of 64 pages of 16 keys, lengths 960..1024;
  * q1_step_ms / q1_chunk_ms (int8 weights and int8 pools), q2_step_ms /
    q2_chunk_ms, q3_step_ms / q3_chunk_ms, fp_step_ms / fp_chunk_ms: the
    device time of a decode step (4 slots, 128-token context) and of a
    64-token prefill chunk through the model API, as chip_smoke.py's
    `time_model` takes them (q2: quant="fixed16"; q3: quant="int8" with
    LUT nonlinearities; fp: exact float);
  * lut_interp_us: `lut_interp` on (4, 4096) bf16 (q3's LUT GELU before
    it rode the int8 GEMV); empty_kernel_us: an empty kernel in the same
    CUDA-graph harness (the launch floor; null where the tree has none);
  * launches of the quantized GEMV, quantization and lut_interp kernels
    in one q1, q2 and q3 decode step, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(pathlib.Path(args.src).resolve()), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("time_quant_route.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import gpt2_medium
    from repro_torch.core import quant
    from repro_torch.core.salpim import SalPimConfig, SalPimEngine
    from repro_torch.kernels import _build, gemv_pim, lut_interp, paged_attention
    from repro_torch.models import api
    from repro_torch.serving import quantize

    _build.build_all()
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    cfg = gpt2_medium.config()
    params = api.init_params(cfg, seed=args.seed, device="cuda")
    L, d = cfg.n_layers, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)

    def act(M, C):
        return (torch.randn((M, C), generator=gen, device=dev) * 0.5).to(cfg.cdtype)

    bl = params["blocks"]
    layers = [("attn", "wq", "bq"), ("attn", "wk", "bk"), ("attn", "wv", "bv"),
              ("attn", "wo", None), ("ffn", "w_up", None), ("ffn", "w_down", None)]
    xs = {d: act(4, d), cfg.d_ff: act(4, cfg.d_ff)}
    step = [(bl[g][w][i], bl[g][b][i] if b else None) for i in range(L) for g, w, b in layers]
    step.append((params["lm_head"], None))
    n = len(step)
    q2 = SalPimEngine.create(SalPimConfig(quant="fixed16"))
    out = {"label": args.label, "card": card}
    out["fixed16_step_ms"] = cs.time_graph(
        torch, lambda i: q2.linear(xs[step[i][0].shape[1]], *step[i]), n) * n
    x64 = act(64, d)
    ups = [bl["ffn"]["w_up"][i] for i in range(L)]
    out["fixed16_w_up_m64_us"] = 1e3 * cs.time_graph(torch, lambda i: q2.linear(x64, ups[i]), L)
    w_fmt, x_fmt = quant.QFormat(12), quant.QFormat(10)
    xq = {C: x_fmt.quantize(x) for C, x in xs.items()}
    wq = [w_fmt.quantize(w) for w, _ in step]
    out["fixed_kernel_step_ms"] = cs.time_graph(
        torch, lambda i: gemv_pim.gemv_pim_fixed(xq[wq[i].shape[1]], wq[i], shift=12), n) * n
    x64q, upq = x_fmt.quantize(x64), [w_fmt.quantize(w) for w in ups]
    out["fixed_kernel_w_up_m64_us"] = 1e3 * cs.time_graph(
        torch, lambda i: gemv_pim.gemv_pim_fixed(x64q, upq[i], shift=12), L)
    del wq, upq

    # The int8 datapaths' linears: q1 on QTensor weights, q3 quantizing
    # each weight on every call, as a decode step calls them.
    qparams = quantize.quantize_params_int8(params)
    qb = qparams["blocks"]
    qstep = [(qb[g][w].unbind()[i], bl[g][b][i] if b else None, "gelu" if w == "w_up" else None)
             for i in range(L) for g, w, b in layers]
    qstep.append((qparams["lm_head"], None, None))
    q1 = SalPimEngine.create(SalPimConfig())
    q3 = SalPimEngine.create(SalPimConfig(quant="int8", nonlinear_mode="lut"))
    q3.nl.bank.gelu.wb_on(xs[d].device)   # the table's copy to the card, before any capture
    out["q1_linear_step_ms"] = cs.time_graph(
        torch, lambda i: q1.linear(xs[qstep[i][0].shape[1]], qstep[i][0], qstep[i][1]), n) * n
    out["q3_linear_step_ms"] = cs.time_graph(
        torch, lambda i: q3.linear(xs[step[i][0].shape[1]], *step[i],
                                   act=qstep[i][2]), n) * n
    qups = [qb["ffn"]["w_up"].unbind()[i] for i in range(L)]
    out["int8_w_up_m64_us"] = 1e3 * cs.time_graph(torch, lambda i: q1.linear(x64, qups[i]), L)
    # As q3 quantizes them: where the tree can, reading the weight while the
    # launch before it runs.
    early = ({"static_input": True}
             if "static_input" in inspect.signature(gemv_pim.quantize_int8_rows).parameters
             else {})
    out["wquant_step_ms"] = cs.time_graph(
        torch, lambda i: gemv_pim.quantize_int8_rows(step[i][0], **early), n) * n

    # The KV split's route and its combine at 960..1024 keys.
    H, D, page, n_tbl, B = cfg.n_heads, cfg.head_dim, 16, 64, 4
    P = 1 + B * n_tbl
    tables = ((torch.randperm(P - 1, generator=gen, device=dev) + 1)
              .reshape(B, n_tbl).to(torch.int32).contiguous())
    lengths = torch.tensor([960, 981, 1003, 1024], dtype=torch.int32, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev).to(cfg.cdtype)
    pools = [tuple(torch.randn((P, H, page, D), generator=gen, device=dev).to(cfg.cdtype)
                   for _ in range(2)) for _ in range(L)]
    out["split_route_us"] = 1e3 * cs.time_graph(torch, lambda i: paged_attention.paged_attention(
        q, *pools[i], tables, lengths, kv_splits=4), L)
    parts = paged_attention.paged_attention_split(q, *pools[0], tables, lengths, kv_splits=4)
    out["merge_us"] = 1e3 * cs.time_graph(
        torch, lambda i: paged_attention.merge_partials(*parts, q.dtype), L)
    del pools

    rng = __import__("numpy").random.RandomState(args.seed)
    prompts = [rng.randint(2, cfg.vocab, size=128) for _ in range(4)]
    for name, p, fmt, kw in (("fp", params, "fp", {}),
                             ("q1", qparams, "int8/f32", {}),
                             ("q2", params, "fp", dict(quant="fixed16")),
                             ("q3", params, "fp", dict(quant="int8", nonlinear_mode="lut"))):
        sal = SalPimEngine.create(SalPimConfig(**kw))
        t = cs.time_model(torch, api, p, cfg, sal, prompts, card, label=name, fmt=fmt)
        out[f"{name}_step_ms"], out[f"{name}_chunk_ms"] = t["dev_dec"], t["dev_chunk"]
        out[f"{name}_host_step_ms"] = t["dec"]
        if name != "fp":        # launches in one eager decode step
            kv, sd = cs.POOLS[fmt]
            cache = api.init_paged_cache(cfg, 4, 1 + 4 * 16, 16, 16, kv_dtype=kv,
                                         kv_scale_dtype=sd, device=dev)
            cache.lengths[:] = 16
            cache.block_tables.copy_(torch.arange(1, 65, dtype=torch.int32,
                                                  device=dev).reshape(4, 16))
            counters = {k: getattr(gemv_pim, k) for k in ("gemv_pim_fixed",
                                                         "gemv_pim_fixed_linear",
                                                         "gemv_pim_int8",
                                                         "gemv_pim_int8_linear",
                                                         "quantize_int8_rows")
                        if hasattr(gemv_pim, k)}
            counters["lut_interp"] = lut_interp.lut_interp
            before = {k: f.launches for k, f in counters.items()}
            api.decode_step(p, torch.full((4,), 5, dtype=torch.int32, device=dev),
                            cache, cfg, sal)
            torch.cuda.synchronize()
            out[f"{name}_step_launches"] = {k: f.launches - before[k]
                                            for k, f in counters.items()}

    acts = [act(4, cfg.d_ff) for _ in range(L)]
    bank = SalPimEngine.create(SalPimConfig(nonlinear_mode="lut")).nl.bank
    out["lut_interp_us"] = 1e3 * cs.time_graph(
        torch, lambda i: lut_interp.lut_interp(acts[i], bank.gelu), L)
    empty = getattr(lut_interp, "empty_kernel", None)
    out["empty_kernel_us"] = (None if empty is None else
                              1e3 * cs.time_graph(torch, lambda i: empty(dev), L))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
