"""The gradients of the port's kernels for training, without JAX (the
parity of the plain versions' gradients with `jax.grad` is in
test_torch_train.py).

Here on the CPU: each autograd Function (`nonlinear.LutApply`, `Norm`,
`LutSoftmax`, `salpim.Linear`), run on CPU tensors, gives the gradients
plain autograd gives; a whole model's gradients through the Functions
equal plain autograd's; the fused GEMV epilogue stays where autograd does
not record; the quantized datapaths refuse to train; the backward
launchers refuse CPU tensors. On the card (`-m gpu`): each backward
kernel against its plain twin (`lut_interp_backward` bit for bit, the
norm and the softmax at 1e-5 in f32 and 3e-2 in bf16; ties, masked rows,
every norm form), and a GPT-2 smoke step's gradients on the card, through
the kernels, against plain autograd on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import lut as tlut
from repro_torch.core import nonlinear as nl
from repro_torch.core import salpim
from repro_torch.core.salpim import SalPimConfig, SalPimEngine
from repro_torch.data import tokens as data_lib
from repro_torch.kernels import layernorm_lut, lut_interp, ops, softmax_lut
from repro_torch.models import api
from repro_torch.runtime import optimizer as opt
from repro_torch.serving.quantize import quantize_params_int8

BANK = tlut.LutBank.create(64)


def _rand(shape, seed, scale=1.0, dtype=torch.float32, device="cpu"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _grads(fn, *inputs, dy):
    """Gradients of fn(*inputs) against dy, for the inputs that are tensors."""
    leaves = [t.detach().requires_grad_(True) if isinstance(t, torch.Tensor) else t
              for t in inputs]
    out = fn(*leaves)
    return torch.autograd.grad(out, [t for t in leaves if isinstance(t, torch.Tensor)], dy)


def _same(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().float().cpu().numpy(),
                                   w.detach().float().cpu().numpy(), rtol=tol, atol=tol)


NORMS = [dict(rms=False, beta=True), dict(rms=False, beta=False),
         dict(rms=True, beta=False), dict(rms=True, beta=False, plus_one=True)]


def _norm_inputs(n, d, form, seed=0, dtype=torch.float32, device="cpu"):
    x = _rand((n, d), seed, 2.0, dtype, device) + 0.5
    gamma = _rand((d,), seed + 1, 0.5, dtype, device) + 1.0
    beta = _rand((d,), seed + 2, 0.5, dtype, device) if form["beta"] else None
    dy = _rand((n, d), seed + 3, 1.0, dtype, device)
    return x, gamma, beta, dy


def _norm_kw(form, mode):
    return dict(eps=1e-5, rsqrt_table=BANK.rsqrt if mode == "lut" else None,
                rms=form["rms"], plus_one=form.get("plus_one", False))


# ---------------------------------------------------------------------------
# On the CPU: the Functions against plain autograd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gelu", "silu", "exp", "softplus", "tanh"])
def test_lut_apply_function_matches_autograd(name):
    table = getattr(BANK, name)
    x, dy = _rand((7, 33), 0, 5.0), _rand((7, 33), 1)
    got = _grads(lambda t: nl.LutApply.apply(t, table), x, dy=dy)
    want = _grads(lambda t: lut_interp.lut_interp_plain(t, table), x, dy=dy)
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("form", NORMS)
@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_norm_function_matches_autograd(form, mode):
    x, gamma, beta, dy = _norm_inputs(5, 48, form)
    kw = _norm_kw(form, mode)
    got = _grads(lambda a, g, b: nl.Norm.apply(a, g, b, kw["eps"], kw["rsqrt_table"],
                                               kw["rms"], kw["plus_one"]),
                 x, gamma, beta, dy=dy)
    want = _grads(lambda a, g, b: layernorm_lut.layernorm_lut_plain(a, g, b, **kw),
                  x, gamma, beta, dy=dy)
    assert len(got) == (3 if beta is not None else 2)
    _same(got, want, 0)


@pytest.mark.parametrize("mask", [dict(causal=True), dict(causal=True, window=3, q_offset=4),
                                  dict(causal=False)])
def test_softmax_function_matches_autograd(mask):
    x, dy = _rand((2, 3, 6, 9), 0, 3.0), _rand((2, 3, 6, 9), 1)
    x[0, 0, 5, :4] = 2.5                       # a row whose max is tied
    kw = dict(q_offset=mask.get("q_offset", 0), causal=mask["causal"],
              window=mask.get("window"))
    got = _grads(lambda t: nl.LutSoftmax.apply(t, BANK.exp, BANK.recip, kw["q_offset"],
                                               kw["causal"], kw["window"]), x, dy=dy)
    want = _grads(lambda t: softmax_lut.softmax_lut_plain(t, BANK.exp, BANK.recip, **kw),
                  x, dy=dy)
    _same(got, want, 0)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_function_matches_autograd(bias):
    x, w = _rand((6, 40), 0), _rand((24, 40), 1, 0.2)
    b = _rand((24,), 2) if bias else None
    dy = _rand((6, 24), 3)
    got = _grads(lambda a, ww, bb: salpim.Linear.apply(a, ww, bb), x, w, b, dy=dy)
    want = _grads(lambda a, ww, bb: ops.pim_linear(a, ww, bb), x, w, b, dy=dy)
    _same(got, want, 1e-6)


def _route_anywhere(monkeypatch):
    """Route every recorded kernel call through its Function, as on the card."""
    calls = []

    def route(x, *others):
        r = nl.records(x, *others)
        calls.append(r)
        return r
    monkeypatch.setattr(nl, "autograd_route", route)
    return calls


@pytest.mark.parametrize("name", ["gpt2_medium", "zamba2_1_2b", "olmoe_1b_7b"])
@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_model_gradients_through_the_functions(monkeypatch, name, mode):
    """A smoke model's loss and gradients with every kernel call in its
    Function (the card's route, plain forwards and backward twins here)
    equal plain autograd's, each layer under `torch.utils.checkpoint`
    (remat "block"). `bk` is left out: its gradient is 0 in exact
    arithmetic (a key bias shifts a query's scores by one constant, which
    the softmax cancels), so both sides are rounding noise of ~1e-9."""
    cfg = dataclasses.replace(get_config(name, smoke=True), remat="block")
    params = api.init_params(cfg, seed=3, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in
             data_lib.batch_at(data_lib.data_config_for_model(cfg, 16, 2), 0).items()}
    eng = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))

    def loss_fn(p, b):
        return api.loss_fn(p, b, cfg, eng)

    (l0, _), g0 = opt.value_and_grad(loss_fn, params, batch)
    calls = _route_anywhere(monkeypatch)
    (l1, _), g1 = opt.value_and_grad(loss_fn, params, batch)
    assert sum(calls) > 0
    assert float(l0) == float(l1)
    flat0 = dict(_named(g0))
    for key, g in _named(g1):
        if key.endswith("/bk"):
            continue
        want = flat0[key]
        scale = float(want.abs().max())
        assert float((g - want).abs().max()) <= 1e-5 * max(scale, 1e-30), key


def _named(tree, pre=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named(tree[k], f"{pre}{k}/")
        else:
            yield f"{pre}{k}", tree[k]


def test_fused_epilogue_stays_without_recording(monkeypatch):
    """With no autograd recording the linear takes its fused launch (the
    serving path); while autograd records, `Linear` and the LUT activation
    on its own."""
    _route_anywhere(monkeypatch)
    seen = []
    real = ops.pim_linear

    def spy(x, w, b=None, *, act_table=None, act=None):
        seen.append((act_table is not None, act))
        return real(x, w, b, act_table=act_table, act=act)
    monkeypatch.setattr(ops, "pim_linear", spy)
    eng = SalPimEngine.create(SalPimConfig(nonlinear_mode="lut"))
    x, w = _rand((3, 16), 0), _rand((8, 16), 1)
    eng.linear(x, w, act="gelu")
    assert seen == [(True, None)]
    with torch.no_grad():
        eng.linear(x, w.requires_grad_(True), act="gelu")
    assert seen[-1] == (True, None)
    eng.linear(x, w, act="gelu")              # w requires grad: recorded
    assert seen[-1] == (False, None)
    exact = SalPimEngine.create(SalPimConfig())
    exact.linear(x, w.detach(), act="gelu")
    assert seen[-1] == (False, "gelu")
    exact.linear(x, w, act="gelu")
    assert seen[-1] == (False, None)


def test_quantized_datapaths_refuse_to_train():
    cfg = get_config("gpt2_medium", smoke=True)
    params = api.init_params(cfg, device="cpu")
    x = _rand((2, cfg.d_model), 0)
    w = params["lm_head"].detach().requires_grad_(True)
    for quant in ("int8", "fixed16"):
        with pytest.raises(ValueError, match="float datapath"):
            SalPimEngine.create(SalPimConfig(quant=quant)).linear(x, w)
    q = quantize_params_int8(params)["blocks"]["ffn"]["w_up"].unbind()[0]
    with pytest.raises(ValueError, match="float datapath"):
        SalPimEngine.create().linear(x.requires_grad_(True), q)
    from repro_torch.runtime.train_loop import make_train_step
    with pytest.raises(ValueError, match="float datapath"):
        make_train_step(cfg, SalPimEngine.create(SalPimConfig(quant="int8")),
                        opt.AdamWConfig())


def test_backward_launchers_refuse_cpu_tensors():
    x, dy = _rand((4, 8), 0), _rand((4, 8), 1)
    with pytest.raises(ValueError, match="CUDA"):
        lut_interp.lut_interp_backward(x, dy, BANK.gelu)
    with pytest.raises(ValueError, match="CUDA"):
        layernorm_lut.layernorm_lut_backward(x, torch.ones(8), None, dy)
    with pytest.raises(ValueError, match="CUDA"):
        softmax_lut.softmax_lut_backward(x, dy, BANK.exp, BANK.recip, causal=True)


# ---------------------------------------------------------------------------
# On the card: each backward kernel against its plain twin
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m gpu` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1,), (5, 33), (64, 4096), (3, 1001)])
@pytest.mark.parametrize("name", ["gelu", "silu", "softplus", "exp"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lut_backward_kernel_bit_for_bit(cuda, shape, name, dtype):
    table = getattr(BANK, name)
    x = _rand(shape, 0, 6.0, dtype, cuda)
    dy = _rand(shape, 1, 1.0, dtype, cuda)
    got = lut_interp.lut_interp_backward(x, dy, table)
    torch.cuda.synchronize()
    want = lut_interp.lut_interp_backward_plain(x, dy, table)
    assert got.dtype == x.dtype and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(1, 64), (7, 1000), (300, 1024), (3, 4097)])
@pytest.mark.parametrize("form", NORMS)
@pytest.mark.parametrize("mode", ["exact", "lut"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_backward_kernel_matches_plain(cuda, n, d, form, mode, dtype):
    x, gamma, beta, dy = _norm_inputs(n, d, form, dtype=dtype, device=cuda)
    kw = _norm_kw(form, mode)
    got = layernorm_lut.layernorm_lut_backward(x, gamma, beta, dy, **kw)
    torch.cuda.synchronize()
    want = layernorm_lut.layernorm_lut_backward_plain(x, gamma, beta, dy, **kw)
    assert (got[2] is None) == (beta is None)
    _same([g for g in got if g is not None], [w for w in want if w is not None], TOL[dtype])
    again = layernorm_lut.layernorm_lut_backward(x, gamma, beta, dy, **kw)
    assert torch.equal(again[1], got[1])       # no atomics: the same bits


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    dict(shape=(2, 4, 64, 64), causal=True),
    dict(shape=(3, 17, 300), causal=True, q_offset=283),
    dict(shape=(2, 33, 40), causal=True, window=8, q_offset=5),
    dict(shape=(4, 8, 8), causal=True, window=4, q_offset=20),   # rows with no key
    dict(shape=(5, 1500), causal=False),
    dict(shape=(2, 16, 1024), causal=True)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_softmax_backward_kernel_matches_plain(cuda, case, dtype):
    x = _rand(case["shape"], 0, 4.0, dtype, cuda)
    x[..., 0, :3] = 3.0                         # ties at the max of some rows
    dy = _rand(case["shape"], 1, 1.0, dtype, cuda)
    kw = dict(q_offset=case.get("q_offset", 0), causal=case["causal"],
              window=case.get("window"))
    got = softmax_lut.softmax_lut_backward(x, dy, BANK.exp, BANK.recip, **kw)
    torch.cuda.synchronize()
    want = softmax_lut.softmax_lut_backward_plain(x, dy, BANK.exp, BANK.recip, **kw)
    _same([got], [want], TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_train_step_gradients_on_the_card(cuda, mode):
    """GPT-2 smoke (f32): the loss and gradients on the card, through the
    kernels and their backward kernels, against plain autograd on the
    CPU (1e-4 of each leaf's largest element; `bk` as in the CPU test)."""
    from repro_torch.kernels import gemv_pim
    cfg = dataclasses.replace(get_config("gpt2_medium", smoke=True), remat="block")
    params = api.init_params(cfg, seed=3, device="cpu")
    batch = data_lib.batch_at(data_lib.data_config_for_model(cfg, 64, 2), 0)
    eng = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))

    def run(device):
        p = {k: v for k, v in _to(params, device).items()}
        b = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        return opt.value_and_grad(lambda pp, bb: api.loss_fn(pp, bb, cfg, eng), p, b)

    before = (gemv_pim.gemv_pim_float.launches, layernorm_lut.layernorm_lut_backward.launches)
    (lc, _), gc = run(cuda)
    torch.cuda.synchronize()
    assert gemv_pim.gemv_pim_float.launches > before[0]
    assert layernorm_lut.layernorm_lut_backward.launches > before[1]
    (lp, _), gp = run("cpu")
    assert abs(float(lc) - float(lp)) <= 1e-5 * abs(float(lp))
    want = dict(_named(gp))
    for key, g in _named(gc):
        if key.endswith("/bk"):
            continue
        scale = float(want[key].abs().max())
        assert float((g.cpu() - want[key]).abs().max()) <= 1e-4 * scale, key


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}
