"""`repro_torch.pimsim`, the port's copy of the SAL-PIM simulator, against
the paper and against `repro.pimsim`.

The paper gates of tests/test_pimsim.py (Fig. 11-15: the 4.72x max and
1.83x mean speedup, the P_Sub scaling, bandwidth under peak, the LUT
subarray against select and scan, the GEMV against bank level, linear
generation time, energy and bytes, the power budget) hold on the port's
copy; and every number of the Fig. 11 grid (inputs 32/64/128 x outputs
1..256) and of Fig. 12-15's quantities equals `repro.pimsim`'s exactly:
the same arithmetic in the same order.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np
import pytest

from repro.pimsim import gpt2 as jgpt2
from repro.pimsim import gpu_model as jgpu
from repro.pimsim import hbm as jhbm
from repro.pimsim import ops as jops
from repro_torch.pimsim import gpt2, gpu_model, hbm, ops

M = gpt2.Gpt2Medium()
GPU = gpu_model.GpuConfig()
HW4 = hbm.SalPimConfigHW(p_sub=4)
HW1 = hbm.SalPimConfigHW(p_sub=1)
GRID = list(itertools.product((32, 64, 128), (1, 2, 4, 8, 16, 32, 64, 128, 256)))


# Each grid point is computed once: the gates and the equality share it.
@functools.lru_cache(maxsize=None)
def _pim(p_sub, n_in, n_out):
    return gpt2.text_generation_cost(hbm.SalPimConfigHW(p_sub=p_sub), M, n_in, n_out)


@functools.lru_cache(maxsize=None)
def _gpu(n_in, n_out):
    return gpu_model.text_generation_time(GPU, M, n_in, n_out)


def _speedup(n_in, n_out, p_sub=4):
    return _gpu(n_in, n_out)["total_s"] / _pim(p_sub, n_in, n_out)["total_s"]


# -- the paper's gates (tests/test_pimsim.py) on the port's copy -------------

def test_paper_fig11_max_speedup():
    assert 4.2 <= _speedup(32, 128) <= 5.2


def test_paper_fig11_average_speedup():
    assert 1.55 <= float(np.mean([_speedup(i, o) for i, o in GRID])) <= 2.1


def test_paper_fig11_trends():
    assert _speedup(32, 128) > _speedup(32, 8) > _speedup(32, 1)
    assert _speedup(32, 64) > _speedup(128, 64)
    assert _speedup(128, 1) < 1.0


def test_paper_fig14_psub_scaling():
    t1, t2, t4 = (_pim(p, 32, 32)["total_s"] for p in (1, 2, 4))
    assert 1.95 <= t1 / t4 <= 2.3
    assert t1 > t2 > t4


def test_paper_fig14_bandwidth_under_peak():
    r = _pim(4, 32, 64)
    assert r["avg_bandwidth_gbps"] * 1e9 < HW4.internal_bandwidth
    r1 = _pim(1, 32, 64)
    assert 1.7 <= r["avg_bandwidth_gbps"] / r1["avg_bandwidth_gbps"] <= 2.6


def test_paper_fig13_lut_subarray_speedup():
    base = ops.lut_op(HW4, 16384, mode="lut_subarray").time_ns
    sel = ops.lut_op(HW4, 16384, mode="select").time_ns
    scan = ops.lut_op(HW4, 16384, mode="scan").time_ns
    assert 3.2 <= sel / base <= 4.0
    assert scan > sel


def test_paper_fig12_gemv_vs_banklevel():
    ratios = [ops.gemv_banklevel(HW4, n, n).time_ns / ops.gemv(HW4, n, n).time_ns
              for n in (1024, 4096, 12288)]
    assert all(b >= a - 0.05 for a, b in zip(ratios, ratios[1:]))
    assert ratios[0] >= 1.5
    assert 3.5 <= ratios[-1] <= 4.0 + 0.1


def test_generation_time_scales_linearly_with_output():
    t64 = _pim(4, 32, 64)["generate_s"]
    t128 = _pim(4, 32, 128)["generate_s"]
    assert 1.9 <= t128 / t64 <= 2.25


def test_energy_and_bytes_positive_and_scale():
    r_small = _pim(4, 32, 8)
    r_big = _pim(4, 32, 64)
    assert 0 < r_small["energy_j"] < r_big["energy_j"]
    assert r_small["bytes"] < r_big["bytes"]
    assert r_big["bytes"] > 350e6 * 2 * 60


def test_paper_fig15_power_budget():
    over4 = gpt2.average_power_w(HW4, M, 32, 32)["over_budget_frac"]
    assert 0.15 <= over4 <= 0.40, over4
    assert gpt2.average_power_w(HW1, M, 32, 32)["over_budget_frac"] < 0.0
    assert gpt2.average_power_w(hbm.SalPimConfigHW(p_sub=2), M, 32, 32)[
        "over_budget_frac"] < 0.05


# -- equal to repro.pimsim ---------------------------------------------------

def _as_dict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def test_fig11_grid_equals_the_reference():
    """Fig. 11 (P_Sub 4, the paper's SAL-PIM): every point of the grid."""
    jhw, jm, jg = jhbm.SalPimConfigHW(p_sub=4), jgpt2.Gpt2Medium(), jgpu.GpuConfig()
    assert dataclasses.asdict(HW4) == dataclasses.asdict(jhw)
    assert dataclasses.asdict(M) == dataclasses.asdict(jm)
    assert dataclasses.asdict(GPU) == dataclasses.asdict(jg)
    for n_in, n_out in GRID:
        assert _pim(4, n_in, n_out) == jgpt2.text_generation_cost(jhw, jm, n_in, n_out)
        assert _gpu(n_in, n_out) == jgpu.text_generation_time(jg, jm, n_in, n_out)


def test_fig12_to_15_quantities_equal_the_reference():
    for p_sub in (1, 2, 4):
        hw, jhw = hbm.SalPimConfigHW(p_sub=p_sub), jhbm.SalPimConfigHW(p_sub=p_sub)
        assert dataclasses.asdict(hw) == dataclasses.asdict(jhw)
        # Fig. 14's P_Sub scaling and bandwidth points.
        for n_in, n_out in ((32, 32), (32, 64)):
            assert _pim(p_sub, n_in, n_out) == jgpt2.text_generation_cost(
                jhw, jgpt2.Gpt2Medium(), n_in, n_out)
        for n in (256, 1024, 4096, 12288):
            for m in (n, 4 * n):
                assert _as_dict(ops.gemv(hw, n, m)) == _as_dict(jops.gemv(jhw, n, m))
                assert (_as_dict(ops.gemv_banklevel(hw, n, m))
                        == _as_dict(jops.gemv_banklevel(jhw, n, m)))
        for n, mode in itertools.product((1024, 4096, 16384),
                                         ("lut_subarray", "select", "scan")):
            assert _as_dict(ops.lut_op(hw, n, mode=mode)) == _as_dict(jops.lut_op(jhw, n,
                                                                                  mode=mode))
        for n_in, n_out in ((32, 32), (32, 64), (64, 128)):
            assert (gpt2.average_power_w(hw, M, n_in, n_out)
                    == jgpt2.average_power_w(jhw, jgpt2.Gpt2Medium(), n_in, n_out))


def test_the_copy_imports_no_framework_and_nothing_of_repro():
    import pathlib
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|torch|repro)(\.|\s|$)", re.M)
    root = pathlib.Path(gpt2.__file__).parent
    assert not [f.name for f in root.glob("*.py") if pat.search(f.read_text())]
