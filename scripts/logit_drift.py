#!/usr/bin/env python3
"""Where the first logits of a full-width model drift from the plain path,
on one NVIDIA GPU.

    python3 scripts/logit_drift.py [--model qwen2_1_5b] [--seed 0] [--prompts 8]
                                   [--plain OP,...] [--pools FMT] [--mode exact|lut]

The model at its published widths gets seeded random weights (and, for the
q1 datapath, `quantize_params_int8` of them with int8 pools); the prompts
are the ones `chip_smoke.py --seed N` serves in its phase for that model.
Each prompt is prefilled in 64-token chunks into a page pool twice: once
through the kernels, once with every `kernels.ops` entry replaced by its
plain version (the layer code, the chunks and the pools the same), and
the hidden states are compared after every layer (max |diff| / max |h|).
`--plain` names `kernels.ops` entries that stay plain on the kernels' side
too, so that the gap left is the other kernels'. By default the fp
weights on fp pools and the q1 datapath (int8 weights and pools) run;
`--pools` (fp, int8/f32, int8/bf16 or int4/bf16) runs the fp weights on
that pool format alone, and `--mode lut` the LUT nonlinearities (the plain
side's prefill attention then the page walk the kernels compute,
`paged_prefill_attention_online_plain`).
Then the plain path runs a third time with each token embedding element
moved by one bf16 step (its bit pattern +- 1, the sign at random): how far that
moves the first logits is the model's own amplification of one rounding,
with no kernel involved. Prints one JSON line a datapath and a summary.
Gates nothing.

The SSM and hybrid models (`--model mamba2_370m`, `zamba2_1_2b`) serve on
the dense cache alone: each prompt runs as one dense prefill (the prompts
of `chip_smoke.py`'s phase 15), the hidden states compared at the input
of every norm of the block stack (a Mamba2 layer's block norm, the shared
block's two) and the final one; and the plain path runs once more with
f32 weights and f32 compute, against which both bf16 sides are set.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="qwen2_1_5b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--plain", default="", help="ops held plain on both sides, comma-separated")
    ap.add_argument("--pools", choices=("fp", "int8/f32", "int8/bf16", "int4/bf16"))
    ap.add_argument("--mode", choices=("exact", "lut"), default="exact")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("logit_drift.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.core.salpim import SalPimConfig, SalPimEngine
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decode_attention as attn_k
    from repro_torch.kernels import gemv_pim as gemv_k
    from repro_torch.kernels import layernorm_lut as ln_k
    from repro_torch.kernels import lut_interp as lut_k
    from repro_torch.kernels import paged_attention as paged_k
    from repro_torch.kernels import paged_prefill as pf_k
    from repro_torch.kernels import softmax_lut as sm_k
    from repro_torch.models import api
    from repro_torch.models import blocks as blk
    from repro_torch.models import transformer as tf
    from repro_torch.serving import quantize

    _build.build_all()
    card = torch.cuda.get_device_name(0)
    cfg = get_config(args.model)
    dev = torch.device("cuda")
    params = api.init_params(cfg, seed=args.seed, device=dev)
    # chip_smoke.py's prompts for this model: its phases draw from one
    # RandomState(seed); GPT-2's phase 4 draws first, qwen2's phase 8 after
    # those of phases 4-7.
    rng = np.random.RandomState(args.seed)
    gpt2_vocab = 50257
    prompts = [rng.randint(2, gpt2_vocab, size=int(n)) for n in rng.randint(32, 129, size=8)]
    ssm = cfg.family in ("ssm", "hybrid")
    if ssm and cfg.vocab < gpt2_vocab:           # phase 15's prompts for zamba2
        rng15 = np.random.RandomState(args.seed + 15)
        prompts = [rng15.randint(2, cfg.vocab, size=len(p)) for p in prompts]
    elif cfg.name != "gpt2-medium" and not ssm:
        [rng.randint(2, gpt2_vocab, size=int(n)) for n in rng.randint(896, 961, size=4)]
        [rng.randint(2, gpt2_vocab, size=128) for _ in range(4)]
        prompts = [rng.randint(2, cfg.vocab, size=int(n)) for n in rng.randint(32, 129, size=8)]
    prompts = prompts[:args.prompts]

    plain_ops = {
        "lut_apply": lut_k.lut_interp_plain,
        "pim_linear": gemv_k.gemv_pim_plain,
        "pim_int8_linear": gemv_k.gemv_pim_int8_linear_plain,
        "pim_quantize_int8_rows": lambda x, static_input=False: (
            gemv_k.quantize_int8_rows_plain(x)),
        # The page walk returns f32; the kernel, as the plain version, q's dtype.
        "pim_paged_prefill_attention": (
            (lambda q, *a, **k: pf_k.paged_prefill_attention_online_plain(q, *a, **k).to(
                q.dtype)) if args.mode == "lut" else pf_k.paged_prefill_attention_plain),
        "pim_paged_attention": lambda *a, kv_splits=None, plan_kv_heads=None, **k: (
            paged_k.paged_attention_plain(*a, **k)),
        "pim_layernorm": lambda *a, **k: ln_k.layernorm_lut_plain(*a, wide_sums=True, **k),
        "pim_softmax": sm_k.softmax_lut_plain,
        "pim_decode_attention": lambda *a, plan_kv_heads=None, **k: (
            attn_k.decode_attention_plain(*a, **k)),
    }
    kernel_ops = {name: getattr(ops, name) for name in plain_ops}
    held = [n for n in args.plain.split(",") if n]
    unknown = set(held) - set(plain_ops)
    if unknown:
        raise SystemExit(f"--plain: unknown ops {sorted(unknown)}")
    kernel_side = {**kernel_ops, **{n: plain_ops[n] for n in held}}

    def dense_forward(p, prompt, plain, perturb=None, c=cfg):
        """One dense prefill of the prompt (the SSM and hybrid families);
        returns the last token's hidden state at the input of every norm
        of the stack and the first logits."""
        for name, fn in (plain_ops if plain else kernel_side).items():
            setattr(ops, name, fn)
        hidden, norm, embed = [], blk.apply_norm, tf._embed

        def recording(q, x, *a, **k):
            if x.dim() == 3:
                hidden.append(x[0, -1].float())
            return norm(q, x, *a, **k)

        def perturbed(*a, **k):
            x = embed(*a, **k)
            step = perturb[:x.shape[1]] * (x[0] != 0)
            return (x.view(torch.int16) + step.to(torch.int16)).view(x.dtype)

        blk.apply_norm = recording
        if perturb is not None:
            tf._embed = perturbed
        try:
            toks = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
            sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=args.mode))
            logits, _ = api.prefill(p, {"tokens": toks}, c, sal, max_len=len(prompt))
            return hidden, logits[0].float()
        finally:
            blk.apply_norm, tf._embed = norm, embed
            for name, fn in kernel_ops.items():
                setattr(ops, name, fn)

    def forward(p, prompt, plain, kv, sd, perturb=None):
        """Chunked prefill of one prompt (64-token chunks) into a fresh
        pool; returns the hidden states after each layer (the last
        chunk's) and the first logits."""
        if ssm:
            return dense_forward(p, prompt, plain, perturb)
        for name, fn in (plain_ops if plain else kernel_side).items():
            setattr(ops, name, fn)
        try:
            S, page = len(prompt), 16
            n_pages = -(-S // page)
            cache = api.init_paged_cache(cfg, 1, 1 + n_pages, page, n_pages, kv_dtype=kv,
                                         kv_scale_dtype=sd, device=dev)
            table = torch.arange(1, n_pages + 1, dtype=torch.int32, device=dev)[None]
            toks = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
            sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=args.mode))
            layers = tf._layers(p["blocks"], cfg.n_layers)
            for a in range(0, S, 64):
                tk = toks[:, a:a + 64]
                start = torch.tensor([a], dtype=torch.int32, device=dev)
                pos = start[:, None].long() + torch.arange(tk.shape[1], device=dev)[None]
                x = tf._embed(p, tk, cfg, pos)
                if perturb is not None:         # one bf16 step: the bit pattern +- 1
                    step = perturb[a:a + tk.shape[1]] * (x != 0)
                    x = (x.view(torch.int16) + step.to(torch.int16)).view(x.dtype)
                cos, sin = tf._rope(cfg, pos)
                hidden = []
                for i, bp in enumerate(layers):
                    x, *_ = blk.apply_decoder_block_prefill_chunk_paged(
                        bp, x, cache.k_pages[i], cache.v_pages[i], table, start,
                        start + tk.shape[1], cfg, sal, cos=cos, sin=sin,
                        window=cfg.window_for_layer(i),
                        kv_scales=tf._kv_scales(cache.k_scale, cache.v_scale, i))
                    hidden.append(x[0, -1].float())
            return hidden, tf._logits(p, x[:, -1], cfg, sal)[0].float()
        finally:
            for name, fn in kernel_ops.items():
                setattr(ops, name, fn)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    if args.pools is None:
        datapaths = [("fp", params, "model", "float32"),
                     ("q1", quantize.quantize_params_int8(params), "int8", "float32")]
    else:
        kv, sd = {"fp": ("model", "float32"), "int8/f32": ("int8", "float32"),
                  "int8/bf16": ("int8", "bfloat16"),
                  "int4/bf16": ("int4", "bfloat16")}[args.pools]
        datapaths = [(f"fp weights, {args.pools} pools", params, kv, sd)]
    if ssm:
        import dataclasses
        cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")

        def f32(tree):
            return {k: f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}
        params32 = f32(params)
    summary = {}
    for label, p, kv, sd in datapaths:
        per_layer = None
        kernel_gap, ulp_gap, f32_gap = [], [], []
        for j, prompt in enumerate(prompts):
            h_k, lg_k = forward(p, prompt, False, kv, sd)
            h_p, lg_p = forward(p, prompt, True, kv, sd)
            gen = torch.Generator(device=dev).manual_seed(j)
            sign = (torch.randint(0, 2, (len(prompt), cfg.d_model), generator=gen, device=dev)
                    * 2 - 1).to(torch.int16)
            _, lg_u = forward(p, prompt, True, kv, sd, perturb=sign)
            gaps = [rel(a, b) for a, b in zip(h_k, h_p)]
            per_layer = gaps if per_layer is None else np.maximum(per_layer, gaps)
            kernel_gap.append(rel(lg_k, lg_p))
            ulp_gap.append(rel(lg_u, lg_p))
            if ssm and label == "fp":
                _, lg_32 = dense_forward(params32, prompt, True, c=cfg32)
                f32_gap.append((rel(lg_k, lg_32), rel(lg_p, lg_32)))
        row = {"model": cfg.name, "datapath": label, "mode": args.mode, "seed": args.seed,
               "card": card,
               "held_plain": held,
               "first_logits_kernel_vs_plain": kernel_gap,
               "first_logits_plain_one_step_vs_plain": ulp_gap,
               "hidden_kernel_vs_plain_by_layer": [float(v) for v in per_layer]}
        if f32_gap:
            row["first_logits_kernel_and_plain_vs_f32_plain"] = f32_gap
        print(json.dumps(row), flush=True)
        summary[label] = (max(kernel_gap), max(ulp_gap))
    for label, (k, u) in summary.items():
        print(f"{cfg.name} {label} ({args.mode}): first logits, kernels vs plain at most "
              f"{k:.3e}; the plain "
              f"path against itself with the embeddings one bf16 step off at most {u:.3e} "
              f"({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
