"""SAL-PIM hardware model: HBM2 organization + timing (paper Table 2).

First-order command-level model (the paper used Ramulator; we reproduce
the same evaluation at command granularity with overlap assumptions that
are unit-tested against the paper's headline ratios).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SalPimConfigHW:
    # organization (Table 2)
    n_channels: int = 16          # pseudo-channels used as compute channels
    banks_per_channel: int = 16
    subarrays_per_bank: int = 64
    rows_per_subarray: int = 512
    row_bytes: int = 1024         # 1 KB row
    dq_bits: int = 128

    # timing, ns (Table 2)
    t_bl: float = 4.0
    t_rc: float = 45.0
    t_rcd: float = 16.0
    t_ras: float = 29.0
    t_cl: float = 16.0
    t_rrd: float = 2.0
    t_ccds: float = 2.0           # 500 MHz burst (bank interleaved)
    t_ccdl: float = 4.0           # 250 MHz same-bank stream (PIM mode)
    t_rp: float = 16.0

    # compute units
    p_sub: int = 4                # S-ALUs per bank (1 / 2 / 4)
    macs_per_salu: int = 8        # shared MACs @ 500 MHz serving 16 lanes
    salu_clock_ghz: float = 0.5
    calu_adders: int = 16         # C-ALU configurable adders @ ~1 GHz
    calu_clock_ghz: float = 1.0

    # data
    elem_bytes: int = 2           # 16-bit fixed point
    access_bytes: int = 32        # 16 lanes x 16-bit per column access
    lut_sections: int = 64

    # Per-op command-sequence overhead: the memory controller issues the
    # PIM command stream (mode switch, bank-register load/drain, sync
    # barrier) before/after every compute op. Dominant for small ops —
    # this is what keeps achieved bandwidth well under the 8 TB/s peak
    # (paper Fig. 14 shows ~2x avg-bandwidth gain for 4x P_Sub).
    cmd_overhead_ns: float = 200.0

    # energy, pJ (Sec. 6.2)
    e_act: float = 909.0
    e_pre_gsa: float = 1.51       # pJ/bit
    e_post_gsa: float = 1.17
    e_io: float = 0.80
    power_budget_w: float = 60.0
    refresh_fraction: float = 0.26

    @property
    def salus_per_channel(self) -> int:
        return self.banks_per_channel * self.p_sub

    @property
    def total_salus(self) -> int:
        return self.n_channels * self.salus_per_channel

    @property
    def salu_stream_gbps(self) -> float:
        """Bytes/ns one S-ALU can consume (32 B per t_ccdl)."""
        return self.access_bytes / self.t_ccdl

    @property
    def internal_bandwidth(self) -> float:
        """Aggregate subarray-level bandwidth, bytes/s."""
        return self.total_salus * self.salu_stream_gbps * 1e9

    @property
    def external_bandwidth(self) -> float:
        """Standard HBM2 external bandwidth (what a host would get)."""
        # 16 pch x 128-bit DQ @ 1 GHz DDR = 256 GB/s (paper: GPU has 2.63x)
        return 256e9


# Activation/stream overlap: while a subarray streams its 1 KB row
# (32 accesses x 4 ns = 128 ns), the next row's ACT (tRCD=16) overlaps in
# a different subarray; the residual non-overlap per row is small. We
# charge a utilization factor instead of simulating per-command:
STREAM_EFFICIENCY = 0.87
