"""Per-operation cost functions for SAL-PIM (and the bank-level baseline).

Times in ns, energy in pJ. Mapping follows paper Fig. 6:
  * matrix-vector: rows -> (P_Ch, P_Sub), cols -> P_Ba, bank partials
    merged in C-ALU;
  * multi-head: heads -> P_Ch, rows/cols -> (P_Ba, P_Sub);
  * non-linear: LUT-embedded subarray flow of Fig. 9.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.pimsim.hbm import SalPimConfigHW, STREAM_EFFICIENCY


@dataclasses.dataclass
class Cost:
    time_ns: float = 0.0
    energy_pj: float = 0.0
    bytes_read: float = 0.0

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.time_ns + other.time_ns,
                    self.energy_pj + other.energy_pj,
                    self.bytes_read + other.bytes_read)

    def __mul__(self, k: float) -> "Cost":
        return Cost(self.time_ns * k, self.energy_pj * k, self.bytes_read * k)

    __rmul__ = __mul__


def _stream_cost(hw: SalPimConfigHW, bytes_per_salu: float) -> float:
    """Time for one S-ALU to stream bytes from its subarray group."""
    accesses = bytes_per_salu / hw.access_bytes
    return accesses * hw.t_ccdl / STREAM_EFFICIENCY


def _read_energy(hw: SalPimConfigHW, total_bytes: float) -> float:
    rows = total_bytes / hw.row_bytes
    # Subarray -> GBL -> S-ALU stays in-die: pre- and post-GSA energy,
    # no IO pin energy (that is the whole point of PIM).
    per_bit = hw.e_pre_gsa + hw.e_post_gsa
    return rows * hw.e_act + total_bytes * 8 * per_bit


def gemv(hw: SalPimConfigHW, rows: int, cols: int, *,
         multihead_parallel: int = 1) -> Cost:
    """y[rows] = W[rows, cols] @ x[cols] (weights streamed once).

    multihead_parallel: independent GEMVs mapped to channels (heads).
    """
    w_bytes = rows * cols * hw.elem_bytes * multihead_parallel
    # parallel engines: all channels work; heads split channels first.
    n_engines = hw.total_salus
    bytes_per_salu = w_bytes / n_engines
    t_stream = _stream_cost(hw, bytes_per_salu)
    # MAC keep-up: 8 MACs @ 500 MHz process 16 lanes / 2 cycles = streamed
    # rate; never the bottleneck by construction (shared-MAC design).
    # C-ALU merge: per channel, banks_per_channel partials per output row.
    out_rows_per_channel = max(
        rows * multihead_parallel / hw.n_channels, 1.0)
    merge_ops = out_rows_per_channel * hw.banks_per_channel
    t_merge = merge_ops / hw.calu_adders / hw.calu_clock_ghz
    # broadcast of the input vector to banks (row reads of x):
    x_bytes = cols * hw.elem_bytes * multihead_parallel
    t_bcast = _stream_cost(hw, x_bytes / hw.n_channels / hw.banks_per_channel)
    # result writeback through the GBLs (shift/truncate path, Sec. 4.1)
    out_bytes = rows * hw.elem_bytes * multihead_parallel
    t_wb = _stream_cost(hw, out_bytes / hw.total_salus) + hw.t_ccdl * 4
    t = (t_stream + t_merge + t_bcast + t_wb + hw.t_rcd + hw.t_rp
         + hw.cmd_overhead_ns)
    e = (_read_energy(hw, w_bytes + x_bytes)
         + rows * cols * multihead_parallel * 2 * 0.1)  # MAC pJ/op est.
    return Cost(t, e, w_bytes + x_bytes)


def lut_op(hw: SalPimConfigHW, n: int, *, mode: str = "lut_subarray") -> Cost:
    """Apply a 64-section LUT nonlinearity to n elements (Fig. 9 / Fig. 13).

    modes: lut_subarray (per-MAT column select, 16 lookups/access),
           select (one element per access), scan (read all sections per
           16-element register batch).
    """
    lanes = 16
    batches_per_bank = math.ceil(
        n / (hw.n_channels * hw.banks_per_channel * lanes))
    # Select mode runs on an ORIGINAL subarray: one element at a time per
    # bank — per lookup, serialize the per-element address decode and two
    # column accesses (W then B). Scan reads every section per batch.
    t_decode = 3.5                      # bank-register -> column-decoder, ns
    per_batch = {
        # read src + LUT fetch (1 access: all 16 MATs select independently)
        # + writeback; S-ALU MAC overlaps the streams.
        "lut_subarray": 3 * hw.t_ccdl,
        "select": lanes * (2 * hw.t_ccdl + t_decode) + 2 * hw.t_ccdl,
        "scan": 2 * hw.lut_sections * hw.t_ccdl + 2 * hw.t_ccdl,
    }[mode]
    t = (hw.t_rcd + batches_per_bank * per_batch + hw.t_rp
         + hw.cmd_overhead_ns)
    bytes_r = n * hw.elem_bytes * 3
    return Cost(t, _read_energy(hw, bytes_r), bytes_r)


def reduce_channel(hw: SalPimConfigHW, n: int) -> Cost:
    """C-ALU reduce-sum of n elements scattered over banks (softmax/LN)."""
    per_channel = max(n / hw.n_channels, 1.0)
    t = (per_channel / hw.calu_adders / hw.calu_clock_ghz + hw.t_ccds * 4
         + hw.cmd_overhead_ns)
    return Cost(t, n * 0.2, n * hw.elem_bytes)


def elementwise(hw: SalPimConfigHW, n: int, n_ops: int = 1) -> Cost:
    """S-ALU elementwise add/mul over n elements (residuals, scaling)."""
    per_salu = max(n / hw.total_salus, 1.0)
    accesses = per_salu * hw.elem_bytes / hw.access_bytes * 16
    t = (hw.t_rcd + max(accesses, 1.0) * hw.t_ccdl * (1 + 0.5 * (n_ops - 1))
         + hw.t_rp + hw.cmd_overhead_ns)
    b = n * hw.elem_bytes * (n_ops + 1)
    return Cost(t, _read_energy(hw, b), b)


def broadcast_scalar(hw: SalPimConfigHW) -> Cost:
    """C-ALU scalar broadcast back to banks (mean, softmax denom, ...)."""
    return Cost(hw.t_ccds * hw.banks_per_channel, 50.0,
                hw.access_bytes * hw.banks_per_channel)


def softmax(hw: SalPimConfigHW, n: int, heads: int = 1) -> Cost:
    """max -> exp LUT -> C-ALU sum -> recip LUT -> mul (paper Sec. 3.2.1)."""
    total = n * heads
    c = reduce_channel(hw, total)            # max
    c = c + lut_op(hw, total)                # exp
    c = c + reduce_channel(hw, total)        # sum
    c = c + lut_op(hw, heads)                # reciprocal of the denom
    c = c + broadcast_scalar(hw) * heads
    c = c + elementwise(hw, total)           # multiply
    return c


def layernorm(hw: SalPimConfigHW, n: int) -> Cost:
    c = reduce_channel(hw, n)                # mean
    c = c + reduce_channel(hw, n)            # var
    c = c + lut_op(hw, 1)                    # rsqrt
    c = c + broadcast_scalar(hw) * 2
    c = c + elementwise(hw, n, n_ops=2)      # (x-mu)*inv
    return c


# ---------------------------------------------------------------------------
# Bank-level PIM baseline (Newton-style: adder tree per bank, no S-ALUs,
# no LUT-embedded subarrays) — paper Sec. 5.4 comparison.
# ---------------------------------------------------------------------------

def gemv_banklevel(hw: SalPimConfigHW, rows: int, cols: int) -> Cost:
    w_bytes = rows * cols * hw.elem_bytes
    n_engines = hw.n_channels * hw.banks_per_channel  # one ALU per bank
    t_stream = _stream_cost(hw, w_bytes / n_engines)
    # bank-level PIM needs no cross-bank merge (adder tree in-bank; rows
    # mapped whole to banks) — that is exactly its small-vector advantage.
    t = t_stream + hw.t_rcd + hw.t_rp + hw.cmd_overhead_ns
    return Cost(t, _read_energy(hw, w_bytes), w_bytes)
