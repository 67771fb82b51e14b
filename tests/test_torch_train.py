"""The port's training path against the JAX package on the CPU (f32 smoke
configs, parameters from the JAX package's init through `bridge.py`,
batches from `data.tokens` at one seed).

  * `loss_fn` and its gradients against `jax.value_and_grad` of the JAX
    loss, exact and LUT, for a model of every family: GPT-2 (dense,
    learned positions), qwen2 (RoPE, GQA), olmoe (MoE), mamba2 (SSM),
    zamba2 (hybrid), whisper (encoder-decoder, frames) and qwen2-vl (the
    VLM's splice of patch_embeds, M-RoPE), and the registry's other four
    (gemma2: softcaps, local windows, 1 + w norms, post-norms; danube:
    a window; nemotron: squared ReLU; phi-3.5-MoE): loss at rtol 1e-5, every
    gradient leaf within 1e-4 of its largest element. A key bias's
    gradient is 0 in exact arithmetic wherever the scores are not rotated
    (learned positions: it shifts a query's scores by one constant, which
    the softmax cancels), so both packages give rounding noise there
    (~1e-9): those leaves are held below 1e-6 of the whole gradient's
    largest element instead.
  * the backward plain twins (`*_backward_plain`) against `jax.grad` /
    `jax.vjp` of the reference functions: `apply_table`,
    `Nonlinear.layernorm` and `rmsnorm` (plus_one too), exact and LUT,
    `Nonlinear.softmax` with the attention mask, a tied max among them;
    the LUT reciprocal and rsqrt have gradient 0 in both;
  * three steps of `make_train_step` (AdamW) with 1 and 2 microbatches
    against the JAX step: parameters at 1e-5;
  * `forward_logits` at 1e-5; remat "block" against "none"; the training
    launcher on the CPU (the refusal of a missing GPU is beside the serving
    entry points' in test_torch_engine.py).
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import lut as jlut
from repro.core.nonlinear import Nonlinear as JNonlinear
from repro.core.salpim import SalPimConfig as JSalPimConfig
from repro.core.salpim import SalPimEngine as JSalPimEngine
from repro.data import tokens as jdata
from repro.models import api as japi
from repro.runtime import optimizer as jopt
from repro.runtime.train_loop import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import lut as tlut
from repro_torch.core.salpim import SalPimConfig, SalPimEngine
from repro_torch.kernels import layernorm_lut, lut_interp, softmax_lut
from repro_torch.models import api
from repro_torch.runtime import optimizer as opt
from repro_torch.runtime.train_loop import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JBANK = jlut.LutBank.create(64)
TBANK = tlut.LutBank.create(64)
MODELS = ["gpt2_medium", "qwen2_1_5b", "olmoe_1b_7b", "mamba2_370m", "zamba2_1_2b",
          "whisper_large_v3", "qwen2_vl_2b", "gemma2_2b", "h2o_danube3_4b", "nemotron_4_340b",
          "phi35_moe_42b"]


def _named(tree, pre=""):
    """(path, leaf) of nested dicts, sorted keys (the JAX flatten order)."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named(tree[k], f"{pre}{k}/")
        else:
            yield f"{pre}{k}", tree[k]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _setup(name, seq=16, batch=2, step=0):
    jcfg, cfg = jax_get_config(name, smoke=True), get_config(name, smoke=True)
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    b = jdata.batch_at(jdata.data_config_for_model(jcfg, seq, batch), step)
    return jcfg, cfg, jparams, tparams, b


def _tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _engines(mode):
    return (JSalPimEngine.create(JSalPimConfig(nonlinear_mode=mode)),
            SalPimEngine.create(SalPimConfig(nonlinear_mode=mode)))


def _zero_in_exact_arithmetic(cfg, key):
    """A key bias's gradient where no rotation follows it (learned positions)."""
    return key.endswith("/bk") and cfg.learned_pos_emb


def _check_grads(cfg, jgrads, tgrads, tol=1e-4):
    want = dict(_named(jax.tree.map(np.asarray, jgrads)))
    got = dict(_named(tgrads))
    assert set(got) == set(want)
    top = max(float(np.abs(np.asarray(w, np.float32)).max()) for w in want.values())
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        g = _np(got[key])
        assert g.shape == w.shape, key
        if _zero_in_exact_arithmetic(cfg, key):
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-6 * top, key
            continue
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{key}: {err:.3e} against {scale:.3e}"


# ---------------------------------------------------------------------------
# Loss and gradients of every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "lut"])
@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_jax(name, mode):
    jcfg, cfg, jparams, tparams, b = _setup(name)
    jeng, teng = _engines(mode)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(p, _jb(b), jcfg, jeng), has_aux=True))(jparams)
    (tl, tm), tg = opt.value_and_grad(lambda p, bb: api.loss_fn(p, bb, cfg, teng),
                                      tparams, _tb(b))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    _check_grads(cfg, jg, tg)


@pytest.mark.parametrize("name", ["gpt2_medium", "whisper_large_v3", "qwen2_vl_2b",
                                  "zamba2_1_2b"])
def test_forward_logits_match_jax(name):
    jcfg, cfg, jparams, tparams, b = _setup(name)
    jeng, teng = _engines("lut")
    want = japi.forward_logits(jparams, _jb(b), jcfg, jeng)
    got = api.forward_logits(tparams, _tb(b), cfg, teng)
    assert got.shape == want.shape == (2, 16, cfg.vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    if name == "qwen2_vl_2b":
        # The splice matters: without patch_embeds the logits differ.
        plain = api.forward_logits(tparams, {"tokens": _tb(b)["tokens"]}, cfg, teng)
        assert float((plain - got).abs().max()) > 1e-3


@pytest.mark.parametrize("name", ["gpt2_medium", "mamba2_370m", "whisper_large_v3"])
def test_remat_block_matches_none(name):
    """remat "block" (each layer under torch.utils.checkpoint) gives the
    gradients of keeping every activation, bit for bit."""
    _, cfg, _, tparams, b = _setup(name)
    _, teng = _engines("lut")
    out = []
    for remat in ("none", "block"):
        c = dataclasses.replace(cfg, remat=remat)
        out.append(opt.value_and_grad(lambda p, bb: api.loss_fn(p, bb, c, teng), tparams,
                                      _tb(b)))
    (l0, _), g0 = out[0]
    (l1, _), g1 = out[1]
    assert float(l0) == float(l1)
    for (k, a), (_, c) in zip(_named(g0), _named(g1)):
        assert torch.equal(a, c), k


# ---------------------------------------------------------------------------
# The backward plain twins against jax.grad of the reference functions
# ---------------------------------------------------------------------------

def _rand(shape, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale


@pytest.mark.parametrize("name", ["gelu", "silu", "exp", "tanh", "softplus", "sigmoid"])
def test_lut_backward_plain_matches_jax_grad(name):
    x, dy = _rand((9, 37), 0, 6.0), _rand((9, 37), 1)
    _, vjp = jax.vjp(lambda t: jlut.apply_table(t, getattr(JBANK, name)), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    got = lut_interp.lut_interp_backward_plain(torch.from_numpy(x), torch.from_numpy(dy),
                                               getattr(TBANK, name))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_lut_gradient_is_the_section_slope():
    """jax.grad of the LUT GELU at 0.3 is its section's slope, 0.78415465,
    not GELU's derivative; the port's twin reads the same."""
    want = float(jax.grad(lambda t: jlut.apply_table(t, JBANK.gelu))(jnp.float32(0.3)))
    got = lut_interp.lut_interp_backward_plain(torch.tensor([0.3]), torch.tensor([1.0]),
                                               TBANK.gelu)
    assert want == pytest.approx(0.78415465, abs=1e-7)
    assert float(got[0]) == want


@pytest.mark.parametrize("fn", ["recip", "rsqrt"])
def test_range_reduced_luts_have_zero_gradient(fn):
    """lut_reciprocal and lut_rsqrt read the float's bits: gradient 0 in
    both packages (the norm's inv and the softmax's 1/sum are constants
    under the gradient in LUT mode)."""
    x = np.abs(_rand((64,), 0, 3.0)) + 0.05
    jf = jlut.lut_reciprocal if fn == "recip" else jlut.lut_rsqrt
    tf = tlut.lut_reciprocal if fn == "recip" else tlut.lut_rsqrt
    want = jax.grad(lambda t: jnp.sum(jf(t, getattr(JBANK, fn))))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tf(xt, getattr(TBANK, fn))
    assert not out.requires_grad
    assert not np.asarray(want).any()


NORMS = [("layernorm", False, True), ("layernorm", False, False),
         ("rmsnorm", False, False), ("rmsnorm", True, False)]


@pytest.mark.parametrize("kind,plus_one,with_beta", NORMS)
@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_norm_backward_plain_matches_jax_grad(kind, plus_one, with_beta, mode):
    n, d = 6, 40
    x, dy = _rand((n, d), 0, 2.0) + 0.3, _rand((n, d), 1)
    g, beta = _rand((d,), 2, 0.5) + 1.0, _rand((d,), 3, 0.5)
    jnl = JNonlinear.create(mode)
    eps = 1e-5

    def jf(xx, gg, bb):
        if kind == "layernorm":
            return jnl.layernorm(xx, gg, bb if with_beta else None, eps)
        return jnl.rmsnorm(xx, gg, eps, plus_one=plus_one)

    _, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(g), jnp.asarray(beta))
    want = vjp(jnp.asarray(dy))
    got = layernorm_lut.layernorm_lut_backward_plain(
        torch.from_numpy(x), torch.from_numpy(g),
        torch.from_numpy(beta) if with_beta else None, torch.from_numpy(dy), eps=eps,
        rsqrt_table=TBANK.rsqrt if mode == "lut" else None, rms=kind == "rmsnorm",
        plus_one=plus_one)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    if with_beta:
        np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), rtol=1e-5, atol=1e-5)
    else:
        assert got[2] is None
    if mode == "lut" and kind == "layernorm":
        # inv is a constant: dx = inv * (g dy - mean(g dy))
        xc = x - x.mean(-1, keepdims=True)
        inv = _np(tlut.lut_rsqrt(torch.from_numpy((xc * xc).mean(-1, keepdims=True) + eps),
                                 TBANK.rsqrt))
        gdy = g * dy
        np.testing.assert_allclose(_np(got[0]), inv * (gdy - gdy.mean(-1, keepdims=True)),
                                   rtol=1e-5, atol=1e-5)


def _jax_attention_softmax(x, q_offset, causal, window, mode="lut"):
    Sq, Sk = x.shape[-2:]
    q_pos = jnp.arange(Sq) + q_offset
    k_pos = jnp.arange(Sk)
    mask = jnp.ones((Sq, Sk), bool)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return JNonlinear.create(mode).softmax(x, axis=-1, where=mask)


@pytest.mark.parametrize("mask", [dict(causal=True), dict(causal=True, q_offset=3, window=4),
                                  dict(causal=False), dict(causal=True, q_offset=12, window=3)])
def test_softmax_backward_plain_matches_jax_grad(mask):
    x, dy = _rand((2, 3, 7, 10), 0, 3.0), _rand((2, 3, 7, 10), 1)
    x[0, 1, 6, [2, 5, 6]] = 4.0                 # a tied max
    kw = dict(q_offset=mask.get("q_offset", 0), causal=mask["causal"],
              window=mask.get("window"))
    _, vjp = jax.vjp(lambda t: _jax_attention_softmax(t, **kw), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(dy))
    got = softmax_lut.softmax_lut_backward_plain(torch.from_numpy(x), torch.from_numpy(dy),
                                                 TBANK.exp, TBANK.recip, **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_softmax_backward_ties_share_the_max_gradient():
    """On a row whose max is tied, each max element gets its own term
    plus an equal share of -sum_j t_j (JAX's reduce_max rule), where
    t_j = dy_j * r * W_exp[sec(x_j - m)]; masked keys get 0."""
    x = np.array([[1.0, 3.0, -2.0, 3.0, 0.5, 9.0]], np.float32)   # key 5 masked
    dy = np.array([[0.3, -1.0, 2.0, 0.7, -0.4, 5.0]], np.float32)
    kw = dict(q_offset=4, causal=True, window=None)
    got = _np(softmax_lut.softmax_lut_backward_plain(
        torch.from_numpy(x), torch.from_numpy(dy), TBANK.exp, TBANK.recip, **kw))
    vis = x[0, :5]
    m = vis.max()
    e = _np(tlut.apply_table(torch.from_numpy(vis - m), TBANK.exp))
    r = float(tlut.lut_reciprocal(torch.tensor([float(e.sum())]), TBANK.recip)[0])
    idx = tlut.section_index(torch.from_numpy(vis - m), TBANK.exp).numpy()
    t = dy[0, :5] * r * TBANK.exp.wb[idx, 0]
    want = t.copy()
    want[[1, 3]] -= t.sum() / 2
    np.testing.assert_allclose(got[0, :5], want, rtol=1e-5, atol=1e-6)
    assert got[0, 5] == 0.0
    _, vjp = jax.vjp(lambda xx: _jax_attention_softmax(xx, **kw), jnp.asarray(x[None]))
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(dy[None]))[0])[0],
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# AdamW steps against the JAX step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gpt2_medium", "qwen2_1_5b"])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_match_jax(name, n_micro):
    """Three AdamW steps (clipping, warmup, weight decay) of the port's
    step against the JAX step from the same parameters and batches:
    parameters within 1e-5. The key biases are held to 3 lr instead: their
    gradient is 0 in exact arithmetic under learned positions (GPT-2, as
    above) and nearly so in RoPE's slowly turning dimensions (qwen2), where
    a key bias barely changes the scores' differences; Adam divides by the
    gradient's own size, so rounding noise of either sign there becomes a
    step of up to lr (their gradients are held at 1e-4 in
    test_loss_and_grads_match_jax)."""
    jcfg, cfg, jparams, tparams, _ = _setup(name)
    ocfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10, clip_norm=1.0)
    tocfg = opt.AdamWConfig(**dataclasses.asdict(ocfg))
    jeng, teng = _engines("exact")
    jstep = jax.jit(jax_make_train_step(jcfg, jeng, ocfg, n_micro=n_micro))
    tstep = make_train_step(cfg, teng, tocfg, n_micro=n_micro)
    jstate, tstate = jopt.init_opt_state(jparams), opt.init_opt_state(tparams)
    dcfg = jdata.data_config_for_model(jcfg, 16, 4)
    for s in range(3):
        b = jdata.batch_at(dcfg, s)
        jparams, jstate, jm = jstep(jparams, jstate, b)
        tparams, tstate, tm = tstep(tparams, tstate, _tb(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 3
    want = dict(_named(jax.tree.map(np.asarray, jparams)))
    for key, got in _named(tparams):
        tol = 3 * ocfg.lr if key.endswith("/bk") else 1e-5
        np.testing.assert_allclose(_np(got), want[key], rtol=1e-5, atol=tol, err_msg=key)
    for key, got in _named(tstate.mu):
        if not _zero_in_exact_arithmetic(cfg, key):
            w = np.asarray(dict(_named(jax.tree.map(np.asarray, jstate.mu)))[key])
            np.testing.assert_allclose(_np(got), w, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(w).max()) + 1e-12,
                                       err_msg=key)


# ---------------------------------------------------------------------------
# The launcher and the device default
# ---------------------------------------------------------------------------

def test_launch_train_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), TMPDIR=str(tmp_path))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gpt2-medium",
           "--smoke", "--steps", "4", "--device", "cpu", "--batch", "2", "--seq", "32"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "final loss:" in out.stdout and out.stdout.count("step ") == 2
    assert (tmp_path / "repro_ckpt" / "step_00000004" / "_COMMITTED").exists()
    # --mesh single needs a process group of the production mesh's 256 ranks
    # (torchrun); run_training(fsdp=True) without a mesh trains on one device
    # (tests/test_torch_engine.py), as the reference does
    bad = subprocess.run(cmd + ["--mesh", "single"], env=env, capture_output=True, text=True,
                         timeout=300)
    assert bad.returncode == 2 and "256 ranks" in bad.stderr
