"""The work a served step needs, counted from its shape: FLOPs and HBM
bytes by operation class, and the least time the card could take for it.

What a model needs, not what a kernel happens to read:

- linear: each weight read once a call (R x C), plus its input (M x C)
  and its output (M x R); 2 M R C FLOPs. M is the rows that need the
  product: a decode step's live rows (slots that emitted a token and go
  on), a chunk's tokens, the chunk's last position for the LM head.
- decode_attn: a live row's valid keys, K and V once (not whole pages),
  its q and its output; 4 H D keys FLOPs (Q K^T and P V).
- prefill_attn: a chunk of S queries from position s over s + S keys:
  the valid K and V once, q and the output; 4 H D sum_i (s + i + 1)
  FLOPs, causal.
- norm: each LayerNorm row read and written once (2 a layer + the final
  one on the LM head's rows), 8 FLOPs an element.

Peaks are the H100 SXM data sheet's, dense: 989 TFLOP/s bf16 and 3.35
TB/s of HBM3. A call's least time is max(FLOPs / 989e12, bytes /
3.35e12); a class's roofline share is the sum of its calls' least times
over the time its kernels took.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12     # bf16 dense, H100 SXM
PEAK_BYTES = 3.35e12    # HBM3, H100 SXM
CLASSES = ("linear", "decode_attn", "prefill_attn", "norm")


@dataclasses.dataclass(frozen=True)
class Dims:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qkv_bias: bool
    itemsize: int = 2

    @classmethod
    def of(cls, model: dict, itemsize: int = 2) -> "Dims":
        return cls(**{f.name: model[f.name] for f in dataclasses.fields(cls)
                      if f.name != "itemsize"}, itemsize=itemsize)


@dataclasses.dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def add(self, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes

    @property
    def least_s(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES)


def linear(m: int, r: int, c: int, itemsize: int) -> tuple[float, float]:
    """(FLOPs, bytes) of y (m, r) = x (m, c) @ w (r, c)^T."""
    return 2.0 * m * r * c, float(itemsize) * (r * c + m * c + m * r)


def decode_attn(rows: int, keys: int, d: Dims) -> tuple[float, float]:
    """(FLOPs, bytes) of one layer's decode attention over `rows` live rows
    holding `keys` valid keys between them."""
    qo = 2 * rows * d.n_heads * d.head_dim
    kv = 2 * keys * d.n_kv_heads * d.head_dim
    return 4.0 * d.n_heads * d.head_dim * keys, float(d.itemsize) * (qo + kv)


def prefill_attn(start: int, s: int, d: Dims) -> tuple[float, float]:
    """(FLOPs, bytes) of one layer's causal attention of a chunk of s
    queries at positions start.. over start + s keys."""
    pairs = s * start + s * (s + 1) // 2
    qo = 2 * s * d.n_heads * d.head_dim
    kv = 2 * (start + s) * d.n_kv_heads * d.head_dim
    return 4.0 * d.n_heads * d.head_dim * pairs, float(d.itemsize) * (qo + kv)


def _layer_linears(m: int, d: Dims) -> list[tuple[int, int, int]]:
    nq, nkv = d.n_heads * d.head_dim, d.n_kv_heads * d.head_dim
    return [(m, nq, d.d_model), (m, nkv, d.d_model), (m, nkv, d.d_model),
            (m, d.d_model, nq), (m, d.d_ff, d.d_model), (m, d.d_model, d.d_ff)]


def forward(rows: int, lm_rows: int, d: Dims, out: dict) -> None:
    """Add the linears and norms of `rows` tokens through every layer, with
    the LM head on `lm_rows` of them, into out[class]."""
    for shape in _layer_linears(rows, d) * d.n_layers + [(lm_rows, d.vocab, d.d_model)]:
        if shape[0]:
            out["linear"].add(*linear(*shape, d.itemsize))
    norm_rows = rows * 2 * d.n_layers + lm_rows
    out["norm"].add(8.0 * norm_rows * d.d_model, 2.0 * d.itemsize * norm_rows * d.d_model)


def step(d: Dims, decode_rows: int, decode_keys: int,
         chunk: tuple[int, int] | None) -> dict:
    """Work by class of one engine step: a decode over `decode_rows` live
    rows attending `decode_keys` keys in all (per layer), and a prompt
    chunk (start, tokens) or None."""
    out = {c: Work() for c in CLASSES}
    if decode_rows:
        forward(decode_rows, decode_rows, d, out)
        f, b = decode_attn(decode_rows, decode_keys, d)
        out["decode_attn"].add(f * d.n_layers, b * d.n_layers)
    if chunk is not None:
        start, s = chunk
        forward(s, 1, d, out)
        f, b = prefill_attn(start, s, d)
        out["prefill_attn"].add(f * d.n_layers, b * d.n_layers)
    return out


def total(work: dict) -> Work:
    """The step as one: its FLOPs and bytes summed over the classes."""
    w = Work()
    for c in work.values():
        w.add(c.flops, c.bytes)
    return w
