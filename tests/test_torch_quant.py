"""The port's quantized S-ALU datapaths against the JAX package, bit for
bit, with inputs made by numpy from a seed:

  * `repro_torch.core.quant` against `repro.core.quant` (Q-format quantize
    and dequantize with .5 ties and saturation, the int32->int16
    writeback, `fixed_gemv` and `fixed_linear` with an int32 sum that
    wraps, the fixed weight and bias quantizers, `quantize_int8_rowwise`
    and `int8_linear`), in f32 and bf16;
  * the plain int8 and fixed16 GEMVs against `ref.gemv_pim_int8_ref` and
    `ref.gemv_pim_fixed_ref` (with the saturating and wrapping rows of
    `quant_gemv_inputs`), and against the Pallas kernels in interpret
    mode at the block-dividing shapes of tests/test_kernels.py;
  * `SalPimEngine.linear` on the QTensor, `quant="int8"` and
    `quant="fixed16"` branches, with and without bias and GELU, in exact
    and LUT mode, against the JAX engine's, in f32 and bf16;
  * `quantize_params_int8` of bridged fp params against the bridged JAX
    `quantize_params_int8`;
  * the plain versions of the fused routes that the card runs in one
    launch: the fixed16 linear layer (`gemv_pim_fixed_linear_plain`) and
    the int8 GEMV with q3's epilogue (scales and bias in x's dtype, the
    cast, the LUT) against the JAX engine's branches, and the byte-plane
    arithmetic of the fixed16 tensor-core kernel against the wrapping
    int32 product.

The JAX functions run eagerly, one operation at a time. Inside `jit`,
XLA on the CPU multiplies by f32(1/127) instead of dividing and fuses the
bias add into an FMA, which moves the last f32 bit of some values (see
`repro_torch.core.quant`); the greedy drains of test_torch_engine.py hold
the port to the jitted JAX engine by its tokens.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import fixed_linear_inputs, quant_gemv_inputs

from repro.core import quant as jq
from repro.core.salpim import SalPimConfig, SalPimEngine
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import api as jax_api
from repro.configs import gpt2_medium as jax_gpt2
from repro.serving import quantize as jquant
from repro_torch import bridge
from repro_torch.core import lut as tlut
from repro_torch.core import quant as tq
from repro_torch.core.salpim import SalPimConfig as TSalPimConfig
from repro_torch.core.salpim import SalPimEngine as TSalPimEngine
from repro_torch.kernels import gemv_pim, ops
from repro_torch.serving import quantize as tquant

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x) -> np.ndarray:
    """A JAX array or torch tensor as numpy, bf16 kept as ml_dtypes."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return np.asarray(jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16))
        return x.numpy()
    return np.asarray(x)


def _same(got, want):
    """Equal bit patterns (and dtypes)."""
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


def _pair(a: np.ndarray, dtype: str):
    """The same f32 numpy values as a JAX array and a torch tensor of dtype."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _floats(*shape, std=1.0, seed=0) -> np.ndarray:
    return (np.random.RandomState(seed).randn(*shape) * std).astype(np.float32)


# ---------------------------------------------------------------------------
# core/quant.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("frac", [10, 12])
def test_qformat_quantize_dequantize(dtype, frac):
    """Round half to even at exact ties, saturation both ways, int16 out."""
    x = _floats(6, 40, std=4.0)
    x[0, :8] = (np.arange(8) - 3.5) / 2 ** frac          # .5 ties
    x[1, :4] = [40.0, -40.0, 1e6, -1e6]                   # saturate
    jx, tx = _pair(x, dtype)
    jfmt, tfmt = jq.QFormat(frac), tq.QFormat(frac)
    assert (tfmt.scale, tfmt.min_int, tfmt.max_int) == (jfmt.scale, jfmt.min_int, jfmt.max_int)
    _same(tfmt.quantize(tx), jfmt.quantize(jx))
    q = tfmt.quantize(tx)
    assert q.dtype == torch.int16 and int(q[1, 0]) == 32767 and int(q[1, 1]) == -32768
    _same(tfmt.dequantize(q), jfmt.dequantize(jfmt.quantize(jx)))
    # 32 bits, short of the range: the f32 clip bound 2^31 - 1 rounds up to
    # 2^31, whose cast to int32 is undefined
    _same(tq.QFormat(frac, bits=32).quantize(tx[2:]), jq.QFormat(frac, bits=32).quantize(jx[2:]))
    assert tq.DEFAULT_WEIGHT_Q == tq.QFormat(12) and tq.DEFAULT_ACT_Q == tq.QFormat(10)


def test_requantize_i32_to_i16():
    acc = np.array([0, 1, -1, 4095, 4096, -4097, 2 ** 31 - 1, -2 ** 31,
                    32767 << 12, (32767 << 12) + 4096, -32768 << 12,
                    (-32768 << 12) - 1], np.int64).astype(np.int32)
    for shift in (0, 10, 12):
        _same(tq.requantize_i32_to_i16(torch.from_numpy(acc), shift),
              jq.requantize_i32_to_i16(jnp.asarray(acc), shift))


@pytest.mark.parametrize("C,shift", [(64, 12), (1001, 10), (4096, 12)])
def test_fixed_gemv_wraps_and_saturates(C, shift):
    qi = quant_gemv_inputs(1, C, 5)
    x_q, w_q = qi.xq[0], qi.wq
    got = tq.fixed_gemv(torch.from_numpy(w_q), torch.from_numpy(x_q), shift=shift)
    _same(got, jq.fixed_gemv(jnp.asarray(w_q), jnp.asarray(x_q), shift=shift))
    assert int(got[0]) == 32767 and int(got[1]) == -32768
    exact = int(x_q.astype(np.int64) @ w_q[2].astype(np.int64))
    assert not -2 ** 31 <= exact < 2 ** 31                    # row 2 wraps


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bias", [False, True])
def test_fixed_linear(dtype, bias):
    x = _floats(2, 3, 96, std=2.0)
    w = _floats(40, 96, std=96 ** -0.5, seed=1)
    b = _floats(40, seed=2)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    jb, tb = _pair(b, dtype)
    jwq, twq = jq.quantize_weights_fixed(jw), tq.quantize_weights_fixed(tw)
    _same(twq, jwq)
    jbq = jq.quantize_bias_fixed(jb) if bias else None
    tbq = tq.quantize_bias_fixed(tb) if bias else None
    if bias:
        _same(tbq, jbq)
    _same(tq.fixed_linear(tx, twq, tbq), jq.fixed_linear(jx, jwq, jbq))
    # a wrapping accumulator, with and without the 32-bit bias add
    big = np.full((1, 96), 31.0, np.float32)
    jbig, tbig = _pair(big, dtype)
    wbig = np.full((2, 96), 32767, np.int16)
    _same(tq.fixed_linear(tbig, torch.from_numpy(wbig), tbq[:2] if bias else None),
          jq.fixed_linear(jbig, jnp.asarray(wbig), jbq[:2] if bias else None))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_int8_rowwise(dtype):
    """In the weight's dtype: bf16 weights give bf16-rounded scales."""
    w = _floats(48, 80, std=0.05)
    w[0] = 0.0                                             # scale from the 1e-8 floor
    w[1, :6] = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 127.0]) / 127 * 0.3   # ties
    jw, tw = _pair(w, dtype)
    (jw8, js), (tw8, ts) = jq.quantize_int8_rowwise(jw), tq.quantize_int8_rowwise(tw)
    _same(tw8, jw8)
    _same(ts, js)
    assert ts.dtype == torch.float32


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bias", [False, True])
def test_int8_linear(dtype, bias):
    x = _floats(3, 4, 80)
    w = _floats(48, 80, std=0.05, seed=1)
    b = _floats(48, seed=2)
    jx, tx = _pair(x, dtype)
    jw8, js = jq.quantize_int8_rowwise(jnp.asarray(w))
    tw8, ts = tq.quantize_int8_rowwise(torch.from_numpy(w))
    jb, tb = _pair(b, dtype) if bias else (None, None)
    _same(tq.int8_linear(tx, tw8, ts, tb), jq.int8_linear(jx, jw8, js, jb))


# ---------------------------------------------------------------------------
# The plain GEMVs against the JAX oracles and the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,C,R", [(1, 64, 16), (4, 1001, 37), (3, 4096, 8)])
@pytest.mark.parametrize("bias", [False, True])
def test_gemv_int8_plain_matches_oracle(M, C, R, bias):
    qi = quant_gemv_inputs(M, C, R)
    b = qi.b if bias else None
    want = jref.gemv_pim_int8_ref(jnp.asarray(qi.x8), jnp.asarray(qi.xs), jnp.asarray(qi.w8),
                                  jnp.asarray(qi.ws), None if b is None else jnp.asarray(b))
    got = gemv_pim.gemv_pim_int8_plain(torch.from_numpy(qi.x8), torch.from_numpy(qi.xs),
                                       torch.from_numpy(qi.w8), torch.from_numpy(qi.ws),
                                       None if b is None else torch.from_numpy(b))
    _same(got, want)


@pytest.mark.parametrize("M,C,R", [(1, 64, 16), (4, 1001, 37), (3, 4096, 8)])
@pytest.mark.parametrize("shift", [10, 12])
def test_gemv_fixed_plain_matches_oracle(M, C, R, shift):
    """Including rows that saturate both ways and one whose sum wraps."""
    qi = quant_gemv_inputs(M, C, R)
    want = jref.gemv_pim_fixed_ref(jnp.asarray(qi.xq), jnp.asarray(qi.wq), shift=shift)
    got = gemv_pim.gemv_pim_fixed_plain(torch.from_numpy(qi.xq), torch.from_numpy(qi.wq),
                                        shift=shift)
    _same(got, want)
    assert int(got[0, 0]) == 32767 and int(got[0, 1]) == -32768


@pytest.mark.parametrize("B,C,R", [(2, 512, 256), (4, 2048, 512)])
def test_pim_linear_int8_matches_pallas_interpret(B, C, R):
    qi = quant_gemv_inputs(B, C, R, seed=3)
    want = jops.pim_linear_int8(jnp.asarray(qi.x8), jnp.asarray(qi.xs), jnp.asarray(qi.w8),
                                jnp.asarray(qi.ws), impl="interpret")
    got = ops.pim_linear_int8(torch.from_numpy(qi.x8), torch.from_numpy(qi.xs),
                              torch.from_numpy(qi.w8), torch.from_numpy(qi.ws))
    _same(got, want)


@pytest.mark.parametrize("B,C,R,shift", [(2, 512, 256, 12), (4, 1024, 512, 10)])
def test_pim_linear_fixed_matches_pallas_interpret(B, C, R, shift):
    qi = quant_gemv_inputs(B, C, R, seed=3)
    want = jops.pim_linear_fixed(jnp.asarray(qi.xq), jnp.asarray(qi.wq), shift=shift,
                                 impl="interpret")
    got = ops.pim_linear_fixed(torch.from_numpy(qi.xq), torch.from_numpy(qi.wq), shift=shift)
    _same(got, want)


# ---------------------------------------------------------------------------
# SalPimEngine.linear on the quantized branches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["exact", "lut"])
@pytest.mark.parametrize("act", [None, "gelu"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("branch", ["qtensor", "int8", "fixed16"])
def test_engine_linear_matches_jax_engine(branch, bias, act, mode, dtype):
    x = _floats(2, 3, 64, std=1.5)
    w = _floats(48, 64, std=64 ** -0.5, seed=1)
    b = _floats(48, std=0.5, seed=2)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    jb, tb = _pair(b, dtype) if bias else (None, None)
    quant = "none" if branch == "qtensor" else branch
    if branch == "qtensor":
        jw = jquant.quantize_leaf(jw)
        tw = bridge.params_from_numpy({"w": jax.tree.map(np.asarray, jw)}, device="cpu")["w"]
        assert isinstance(tw, tquant.QTensor)
    jeng = SalPimEngine.create(SalPimConfig(quant=quant, nonlinear_mode=mode))
    teng = TSalPimEngine.create(TSalPimConfig(quant=quant, nonlinear_mode=mode))
    got = teng.linear(tx, tw, tb, act=act)
    want = jeng.linear(jx, jw, jb, act=act)
    assert got.shape == (2, 3, 48)
    if act is None or mode == "lut":
        _same(got, want)
        return
    # The exact tanh GELU runs after the product, on the same bits...
    _same(got, teng.nl.gelu(teng.linear(tx, tw, tb)))
    # ...but torch's GELU is not jax.nn.gelu: in f32 their tanh differs by
    # an ulp or two; in bf16 jax.nn.gelu rounds each of its seven
    # operations to bf16, torch rounds once, up to two bf16 ulps apart.
    tol = 1e-6 if dtype == "float32" else 2 ** -6
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_quantize_params_int8_matches_jax():
    """The port's quantize_params_int8 of bridged fp params equals the
    bridged JAX quantize_params_int8: the same leaves become QTensors, with
    the same int8 payloads and f32 scales."""
    jparams = jax_api.init_params(jax.random.PRNGKey(0), jax_gpt2.smoke_config())
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    want = bridge.params_from_numpy(
        jax.tree.map(np.asarray, jquant.quantize_params_int8(jparams)), device="cpu")
    got = tquant.quantize_params_int8(tparams)
    n = 0

    def walk(g, w, path):
        nonlocal n
        if isinstance(w, dict):
            assert g.keys() == w.keys(), path
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
        elif isinstance(w, tquant.QTensor):
            n += 1
            assert isinstance(g, tquant.QTensor), path
            assert g.shape == w.shape and g.ndim == w.ndim
            assert torch.equal(g.w_i8, w.w_i8) and g.w_i8.dtype == torch.int8, path
            assert torch.equal(g.scale.view(torch.int32), w.scale.view(torch.int32)), path
        else:
            assert not isinstance(g, tquant.QTensor), path
            assert torch.equal(g, w), path

    walk(got, want, "")
    assert n == 7            # wq, wk, wv, wo, w_up, w_down, lm_head
    assert got["blocks"]["attn"]["wq"].unbind()[1].shape == (64, 64)


# ---------------------------------------------------------------------------
# The fused quantized routes' plain versions
# ---------------------------------------------------------------------------

TBANK = tlut.LutBank.create(64)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("lut", [False, True])
@pytest.mark.parametrize("M,C,R", [(3, 64, 40), (4, 1001, 37), (2, 4096, 9)])
def test_fixed_linear_plain_matches_jax_engine(M, C, R, lut, bias, dtype):
    """`gemv_pim_fixed_linear_plain` (the kernel's plain version) is the
    JAX engine's fixed16 branch, LUT GELU and all, bit for bit, with sums
    that saturate both ways and sums that wrap past +-2^31."""
    x, w, b = fixed_linear_inputs(M, C, R)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    jb, tb = _pair(b, dtype) if bias else (None, None)
    mode = "lut" if lut else "exact"
    jeng = SalPimEngine.create(SalPimConfig(quant="fixed16", nonlinear_mode=mode))
    want = jeng.linear(jx, jw, jb, act="gelu" if lut else None)
    got = gemv_pim.gemv_pim_fixed_linear_plain(tx, tw, tb, frac_x=10, frac_w=12,
                                               act_table=TBANK.gelu if lut else None)
    _same(got, want)
    xq, wq = tq.QFormat(10).quantize(tx), tq.QFormat(12).quantize(tw)
    sums = xq.double() @ wq.double().t()
    out_q = gemv_pim.gemv_pim_fixed_plain(xq, wq, shift=12)
    assert int(out_q[0, 0]) == 32767 and int(out_q[0, 1]) == -32768
    assert float(sums[0, 2]) >= 2 ** 31 and float(sums[-1, 3]) < -2 ** 31


def _byte_plane_product(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The int32 product as the fixed16 tensor-core kernel forms it: each
    int16 v split into hi = v >> 8 (s8) and lo = v & 0xFF (u8); three s32
    accumulators that wrap (hi.hi; hi.lo + lo.hi; lo.lo); then 65536 hh +
    256 md + ll modulo 2^32, as int32."""
    xh, xl = x_q.long() >> 8, x_q.long() & 0xFF
    wh, wl = w_q.long() >> 8, w_q.long() & 0xFF
    assert int(xh.min()) >= -128 and int(xh.max()) <= 127 and int(xl.min()) >= 0
    hh = tq.int32_matmul(xh, wh)
    md = tq.wrap_int32(tq.int32_matmul(xh, wl).long() + tq.int32_matmul(xl, wh).long())
    ll = tq.int32_matmul(xl, wl)
    return tq.wrap_int32((hh.long() << 16) + (md.long() << 8) + ll.long())


@pytest.mark.parametrize("M,C,R", [(4, 1024, 64), (3, 4096, 16), (3, 1001, 9)])
def test_byte_planes_make_the_wrapping_int32_product(M, C, R):
    """The identity the fixed16 tensor-core kernel relies on, bit for bit:
    four 8-bit products combined modulo 2^32 are XLA's wrapping int32 dot,
    on planted operands (the formats' extremes, negative values whose low
    byte is 0x00 or 0xFF, sums past +-2^31)."""
    qi = quant_gemv_inputs(M, C, R)
    xq, wq = torch.from_numpy(qi.xq), torch.from_numpy(qi.wq)
    xq[1] = 32767
    xq[2, ::2], xq[2, 1::2] = -32768, -1
    wq[3] = -32768
    wq[4] = -256
    wq[5] = 255
    want = tq.int32_matmul(xq, wq)
    assert torch.equal(_byte_plane_product(xq, wq), want)
    exact = xq.double() @ wq.double().t()
    assert bool((exact.abs() >= 2 ** 31).any())
    assert torch.equal(gemv_pim.gemv_pim_fixed_plain(xq, wq, shift=12),
                       tq.requantize_i32_to_i16(want, 12))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("M,C,R", [(3, 64, 40), (4, 1001, 37)])
def test_int8_lut_epilogue_matches_jax_engine(M, C, R, bias, dtype):
    """The q3 route's one GEMV (`gemv_pim_int8_plain` with the scales of
    `quantize_int8_rows` in x's dtype, the bias, the cast to x's dtype and
    the LUT GELU) is the JAX engine's int8 LUT linear, bit for bit."""
    x = _floats(M, C, std=1.5)
    w = _floats(R, C, std=C ** -0.5, seed=1)
    b = _floats(R, std=0.5, seed=2)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    jb, tb = _pair(b, dtype) if bias else (None, None)
    jeng = SalPimEngine.create(SalPimConfig(quant="int8", nonlinear_mode="lut"))
    want = jeng.linear(jx, jw, jb, act="gelu")
    x_i8, xs = tq.quantize_int8_rows(tx)
    w_i8, ws = tq.quantize_int8_rows(tw)
    got = gemv_pim.gemv_pim_int8_plain(x_i8, xs, w_i8, ws, tb, out_dtype=tx.dtype,
                                       act_table=TBANK.gelu)
    _same(got, want)
    assert got.dtype == tx.dtype and xs.dtype == tx.dtype


# ---------------------------------------------------------------------------
# The int8 linear layer in one launch (`gemv_pim_int8_linear`): its plain
# twin against both JAX routes, and its planners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lut", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("route", ["q1", "q3"])
@pytest.mark.parametrize("M,C,R", [(4, 64, 40), (3, 1001, 37)])
def test_int8_linear_plain_matches_jax_routes(M, C, R, route, bias, lut, dtype):
    """`gemv_pim_int8_linear_plain`, the function the card runs in one
    launch, is bit for bit the JAX engine's int8 route (q3: x quantized in
    its own dtype, the weight by `quantize_int8_rowwise`) and
    `qtensor_linear` (q1: x quantized in f32, QTensor weights, the bias in
    its own dtype added in f32), each followed by the LUT GELU in LUT mode."""
    x = _floats(M, C, std=1.5)
    w = _floats(R, C, std=C ** -0.5, seed=1)
    b = _floats(R, std=0.5, seed=2)
    jx, tx = _pair(x, dtype)
    jw, tw = _pair(w, dtype)
    jb, tb = _pair(b, dtype) if bias else (None, None)
    mode = "lut" if lut else "exact"
    act = "gelu" if lut else None
    table = TBANK.gelu if lut else None
    if route == "q3":
        want = SalPimEngine.create(SalPimConfig(quant="int8", nonlinear_mode=mode)).linear(
            jx, jw, jb, act=act)
        w_i8, w_scale = tq.quantize_int8_rows(tw)
        got = gemv_pim.gemv_pim_int8_linear_plain(tx, w_i8, w_scale, tb, act_table=table)
    else:
        jqw = jquant.quantize_leaf(jw)
        want = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode)).linear(
            jx, jqw, jb, act=act)
        qw = bridge.params_from_numpy({"w": jax.tree.map(np.asarray, jqw)}, device="cpu")["w"]
        got = gemv_pim.gemv_pim_int8_linear_plain(tx, qw.w_i8, qw.scale, tb,
                                                  compute=torch.float32, act_table=table)
        assert torch.equal(got, tquant.qtensor_linear(tx, qw, tb, act_table=table))
    _same(got, want)
    assert got.dtype == tx.dtype


@pytest.mark.parametrize("rows,C,itemsize,want", [
    (4, 1024, 2, (1, 4, 1)),          # x of a decode step, bf16: spread over 4 warps
    (4, 1024, 4, (2, 4, 1)),          # q1's f32 x: 4 warps, 8 values a lane
    (4, 4096, 4, (4, 8, 1)),          # f32 x before w_down
    (4096, 1024, 2, (2, 2, 2)),       # w_up's rows: 2 warps a row, 16 values a lane
    (50257, 1024, 2, (2, 2, 2)),      # the LM head
    (1024, 4096, 2, (2, 8, 1)),       # w_down: 8 warps a row
    (1024, 1024, 2, (2, 2, 2)),       # q/k/v/o
    (4, 1000, 2, (1, 4, 1)),          # a ragged C
    (7, 1001, 4, (2, 4, 1)),          # a ragged C, f32
    (3, 20000, 2, (0, 8, 1)),         # past 8 warps' registers: streamed
])
def test_quant_plan(rows, C, itemsize, want):
    """`quant_plan`'s pieces a lane, warps a row and rows a block."""
    got = gemv_pim.quant_plan(rows, C, itemsize)
    assert got == want
    chunks, warps, rows_pb = got
    assert warps * rows_pb <= 8
    if chunks:
        assert chunks * 32 * warps * (16 // itemsize) >= C


@pytest.mark.parametrize("M,C,R,want", [
    (4, 1024, 1024, (8, 8)),          # q/k/v/o at decode: one tile of 8 tokens
    (4, 1024, 4096, (8, 2)),          # w_up
    (4, 4096, 1024, (8, 8)),          # w_down: C over a cluster of 8
    (4, 1024, 50257, (8, 1)),         # the LM head
    (1, 1024, 50257, (8, 1)),         # a chunk's LM head: its last token
    (1, 16, 1000, (8, 1)),
    (8, 4096, 1024, (8, 8)),
    (32, 1024, 1024, (32, 8)),
])
def test_gemv_int8_linear_plan(M, C, R, want):
    """One token tile holds every row of x, and a block's share of x is at
    most INT8_LINEAR_PIECES pieces of 16 elements."""
    plan = gemv_pim.gemv_int8_linear_plan(M, C, R)
    assert plan is not None and (plan.n_tile, plan.cluster) == want
    assert plan.n_tiles == 1 and plan.route == "tensor_core"
    assert M * -(-plan.k_tiles // plan.cluster) * 8 <= gemv_pim.INT8_LINEAR_PIECES


@pytest.mark.parametrize("M,C,R,aligned", [(64, 1024, 4096, True), (33, 1024, 1024, True),
                                           (32, 1536, 8960, True), (16, 8960, 1536, True),
                                           (512, 1024, 1024, True), (4, 1000, 1024, True),
                                           (4, 1024, 1024, False), (0, 1024, 1024, True)])
def test_gemv_int8_linear_plan_refuses(M, C, R, aligned):
    """A prefill chunk's x, a block share past INT8_LINEAR_PIECES pieces
    (qwen2-1.5B's `w_gate` at 32 rows, its `w_down` at 16), C % 16 != 0
    and a misaligned row take two launches: `quantize_int8_rows`, then
    `gemv_pim_int8`."""
    assert gemv_pim.gemv_int8_linear_plan(M, C, R, aligned=aligned) is None
