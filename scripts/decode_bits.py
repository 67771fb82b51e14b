"""Hold `decode_attention`'s outputs on one tree against another's, bit for
bit: the dense-arena decode kernel of two checkouts on the same seeded
inputs (the dense path's arenas of phase 3: 256 / 161 / 1024 positions, a
window with a softcap, the int8 arena, the RoPE models' heads), exact and
LUT, f32 and bf16.

    python3 scripts/decode_bits.py --src build/parent/src --src src

Each tree runs in a process of its own (its kernels built from its own
sources into its own build directory) and writes its outputs; this
process compares them and prints one JSON line: the cases, and for each
the elements that differ. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent

# (label, B, H, Hkv, S, D, lengths, options)
CASES = [("gpt2 arena 256", 4, 16, 16, 256, 64, [128, 137, 151, 160], {}),
         ("gpt2 arena 161", 4, 16, 16, 161, 64, [96, 120, 150, 161], {}),
         ("gpt2 arena 1024", 4, 16, 16, 1024, 64, [960, 981, 1003, 1020], {}),
         ("gqa window softcap", 4, 16, 4, 256, 64, [1, 100, 200, 256],
          {"window": 90, "softcap": 30.0}),
         ("danube heads", 3, 8, 2, 4800, 120, [4700, 1500, 1], {"window": 4096}),
         ("qwen2 heads", 3, 12, 2, 4800, 128, [4700, 1500, 1], {})]


def run_tree(out: str) -> None:
    """In a tree's process: every case's outputs into `out`."""
    import torch
    from repro_torch.core import lut as tlut
    from repro_torch.kernels import decode_attention as attn
    dev = torch.device("cuda")
    bank = tlut.LutBank.create(64)
    gen = torch.Generator(device=dev).manual_seed(31)
    res = {}
    for label, B, H, Hkv, S, D, lens, opts in CASES:
        q32 = torch.randn((B, H, D), generator=gen, device=dev)
        k32, v32 = (torch.randn((B, Hkv, S, D), generator=gen, device=dev) for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            for lut in (False, True):
                kw = dict(opts, exp_table=bank.exp if lut else None)
                name = f"{label} {str(dtype).split('.')[1]} lut={lut}"
                res[name] = attn.decode_attention(q, k, v, lengths, **kw).cpu()
        # The int8 arena with bf16 scale rows, read in the kernel.
        k8, v8 = (torch.randint(-127, 128, (B, Hkv, S, D), generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = ((torch.rand((B, Hkv, S), generator=gen, device=dev) * 0.05 + 1e-3)
                  .bfloat16() for _ in range(2))
        res[f"{label} int8 arena"] = attn.decode_attention(
            q32.bfloat16(), k8, v8, lengths, ks, vs, **opts).cpu()
    torch.cuda.synchronize()
    torch.save(res, out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a tree's src/ directory (twice: the two trees)")
    ap.add_argument("--out", default=None, help="internal: write this tree's outputs")
    args = ap.parse_args()
    if args.out:
        run_tree(args.out)
        return 0
    if len(args.src) != 2:
        ap.error("--src twice: the two trees")
    outs = []
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for i, src in enumerate(args.src):
            out = os.path.join(tmp, f"tree{i}.pt")
            env = dict(os.environ, PYTHONPATH=str(pathlib.Path(src).resolve()))
            subprocess.run([sys.executable, __file__, "--src", src, "--out", out], env=env,
                           check=True, cwd=pathlib.Path(src).resolve().parent)
            outs.append(out)
        import torch
        a, b = (torch.load(o) for o in outs)
    diff = {name: int((a[name].view(torch.int16 if a[name].dtype == torch.bfloat16
                                    else torch.int32)
                       != b[name].view(torch.int16 if b[name].dtype == torch.bfloat16
                                       else torch.int32)).sum())
            for name in a}
    print(json.dumps({"trees": args.src, "cases": len(diff),
                      "elements": sum(t.numel() for t in a.values()),
                      "differing": {k: v for k, v in diff.items() if v},
                      "bit_for_bit": not any(diff.values())}))
    return 0 if not any(diff.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
