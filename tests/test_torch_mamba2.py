"""The SSM and hybrid families of the port (`models/mamba2.py`; mamba2-370m
and zamba2-1.2B) against the JAX package, on the CPU: the layer, the
configs and parameters, and the model entry points. (The greedy drains
against the JAX engine: tests/test_torch_ssm_drains.py.)

  * `_causal_conv`, `ssd_chunked` (chunks 8 and 16, S not a multiple of
    the chunk, with and without a carried state) and `apply_mamba2` with
    its state and conv tail, exact and LUT, f32 within 1e-5 of the JAX
    functions relative to their largest |value|; `mamba2_decode_step`
    from one carried state, writing it in place;
  * the registry, the parameter tree (keys, shapes, dtypes) and the
    analytic parameter counts against the JAX package's;
  * `prefill` and three `decode_step`s within 1e-4 of the JAX functions'
    logits, exact and LUT, and decode steps from a JAX cache carried
    across by `bridge.dense_cache_from_numpy`;
  * the paged entry points and `ServingEngine(paged=True)` raise the
    reference's `ValueError`;
  * prompts of 1 and 2 tokens: `prefill(S)` and a decode step give
    `prefill(S + 1)`'s logits (the conv tail zero-padded on the left,
    where the reference keeps fewer rows);
  * `launch/serve.py` serves both models on the CPU.

On the card (`-m gpu`): the float GEMV, `layernorm_lut` and `lut_interp`
at the slice's shapes, and `decode_attention` at zamba2's heads.

JAX is imported inside the `jx` fixture only (tests/ssm_common.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from ssm_common import SSM_MODELS, assert_close, engine_pair, jx, model  # noqa: F401
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import lut as tlut
from repro_torch.core.salpim import SalPimEngine as TSalPimEngine
from repro_torch.kernels import decode_attention, gemv_pim, layernorm_lut, lut_interp
from repro_torch.launch import serve
from repro_torch.models import api, mamba2, transformer
from repro_torch.serving import engine as tengine
from repro_torch.serving.config import EngineConfig, GenConfig

TOL = 1e-5
LOGIT_TOL = 1e-4


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _layer(tree, i=0):
    """Layer i of a stacked parameter tree (numpy, JAX or torch leaves)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# models/mamba2.py
# ---------------------------------------------------------------------------

def test_causal_conv_matches_jax(jx):
    rng = np.random.RandomState(0)
    x, w, b = _np(rng, 2, 11, 40), _np(rng, 4, 40, scale=0.1), _np(rng, 40)
    want = jx.m2._causal_conv(jx.jnp.asarray(x), jx.jnp.asarray(w), jx.jnp.asarray(b))
    got = mamba2._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert_close(got, want, TOL)


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("S", [21, 32])
@pytest.mark.parametrize("carried", [False, True])
def test_ssd_chunked_matches_jax(jx, chunk, S, carried):
    """y and the final state, padding past S to a chunk multiple (S 21),
    from zeros or from a carried state."""
    rng = np.random.RandomState(S + chunk)
    B, H, P, N = 2, 3, 5, 6
    x, Bm, Cm = _np(rng, B, S, H, P), _np(rng, B, S, N), _np(rng, B, S, N)
    dt = rng.uniform(0.0, 0.5, size=(B, S, H)).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 2.5, size=(H,))).astype(np.float32)
    h0 = _np(rng, B, H, N, P) if carried else None
    j = jx.jnp.asarray
    y_w, st_w = jx.m2.ssd_chunked(j(x), j(dt), j(A), j(Bm), j(Cm), chunk,
                                  None if h0 is None else j(h0))
    t = torch.from_numpy
    y, st = mamba2.ssd_chunked(t(x), t(dt), t(A), t(Bm), t(Cm), chunk,
                               None if h0 is None else t(h0))
    assert y.shape == (B, S, H, P) and st.shape == (B, H, N, P)
    assert_close(y, y_w, TOL)
    assert_close(st, st_w, TOL)


def test_ssd_chunked_masked_decay_stays_finite():
    """A large dt * |A| makes the masked-out exp(seg) overflow; under the
    causal mask it is clamped first, so no inf * 0 turns into NaN."""
    B, S, H, P, N = 1, 16, 2, 4, 3
    x, Bm, Cm = torch.ones(B, S, H, P), torch.ones(B, S, N), torch.ones(B, S, N)
    dt = torch.full((B, S, H), 20.0)
    y, st = mamba2.ssd_chunked(x, dt, -torch.full((H,), 16.0), Bm, Cm, 8)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())


@pytest.mark.parametrize("mode", ["exact", "lut"])
@pytest.mark.parametrize("S", [2, 5, 13])
def test_apply_mamba2_matches_jax(jx, model, mode, S):
    """Layer 0 over (2, S, d): the output, the final SSM state and, for S
    of at least K - 1 tokens, the conv tail; for S = 2 the port's tail is
    one zero row and the prompt's two rows, the last of them the
    reference's one row."""
    _, jcfg, jparams, cfg, tparams = model
    jeng, teng = engine_pair(jx, mode)
    x = _np(np.random.RandomState(S), 2, S, cfg.d_model)
    jp, tp = _layer(jparams["blocks"]["mamba"]), _layer(tparams["blocks"]["mamba"])
    out_w, st_w, tail_w = jx.jax.jit(lambda p, x: jx.m2.apply_mamba2(
        p, x, jcfg, jeng, return_state=True))(jp, jx.jnp.asarray(x))
    out, st, tail = mamba2.apply_mamba2(tp, torch.from_numpy(x), cfg, teng, return_state=True)
    assert_close(out, out_w, TOL)
    assert_close(st, st_w, TOL)
    K = cfg.ssm_conv
    assert tail.shape == (2, K - 1, cfg.d_inner + 2 * cfg.ssm_state)
    tail_w = np.asarray(tail_w)
    if S < K - 1:
        # The reference keeps xbc_raw[:, S - (K - 1):], its last row alone.
        assert tail_w.shape[1] == 1
        assert float(tail[:, :K - 1 - S].abs().max()) == 0.0
        tail = tail[:, -1:]
    assert_close(tail, tail_w, TOL)
    assert torch.equal(mamba2.apply_mamba2(tp, torch.from_numpy(x), cfg, teng), out)


@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_mamba2_decode_step_matches_jax(jx, model, mode):
    """One step from one carried state (random SSM state and conv window):
    the output and both new states; the port writes them in place."""
    _, jcfg, jparams, cfg, tparams = model
    jeng, teng = engine_pair(jx, mode)
    rng = np.random.RandomState(3)
    x = _np(rng, 3, cfg.d_model)
    ssm = _np(rng, 3, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim, scale=0.3)
    conv = _np(rng, 3, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
    j = jx.jnp.asarray
    jp, tp = _layer(jparams["blocks"]["mamba"], 1), _layer(tparams["blocks"]["mamba"], 1)
    out_w, ssm_w, conv_w = jx.jax.jit(lambda *a: jx.m2.mamba2_decode_step(*a, jcfg, jeng))(
        jp, j(x), j(ssm), j(conv))
    t_ssm, t_conv = torch.from_numpy(ssm.copy()), torch.from_numpy(conv.copy())
    out, s2, c2 = mamba2.mamba2_decode_step(tp, torch.from_numpy(x), t_ssm, t_conv, cfg, teng)
    assert s2 is t_ssm and c2 is t_conv
    assert_close(out, out_w, TOL)
    assert_close(t_ssm, ssm_w, TOL)
    assert_close(t_conv, conv_w, TOL)


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mamba2-370m", "zamba2-1.2b"])
@pytest.mark.parametrize("smoke", [True, False])
def test_registry_matches_jax_configs(jx, name, smoke):
    cfg, jcfg = get_config(name, smoke=smoke), jx.get_config(name, smoke=smoke)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert (cfg.d_inner, cfg.ssm_heads) == (jcfg.d_inner, jcfg.ssm_heads)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def test_published_counts():
    """mamba2-370m: 419,713,024 parameters, in_proj 4384 rows; zamba2-1.2B:
    1,170,310,912, in_proj 8384 rows, 7 segments."""
    m, z = get_config("mamba2-370m"), get_config("zamba2-1.2b")
    assert m.param_count() == 419_713_024 and z.param_count() == 1_170_310_912
    assert 2 * m.d_inner + 2 * m.ssm_state + m.ssm_heads == 4384
    assert 2 * z.d_inner + 2 * z.ssm_state + z.ssm_heads == 8384
    assert transformer._hybrid_segments(z) == [(0, 6), (6, 12), (12, 18), (18, 24),
                                               (24, 30), (30, 36), (36, 38)]
    assert transformer._hybrid_segments(m) == [(0, 48)]


def _tree(t):
    return {k: _tree(v) if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in t.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_mirror_jax_tree(jx, model, dtype):
    """The port's tree has the JAX tree's keys, shapes and dtypes (A_log, D
    and dt_bias f32 at bf16 parameters), and its counted tensors sum to
    param_count (the conv bias and dt_bias are not counted)."""
    name, jcfg, _, cfg, _ = model
    jcfg = dataclasses.replace(jcfg, param_dtype=dtype, compute_dtype=dtype)
    cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    jtree = jx.jax.tree.map(np.asarray, jx.api.init_params(jx.jax.random.PRNGKey(0), jcfg))
    tp = api.init_params(cfg, device="cpu")
    assert _tree(tp) == _tree(bridge.params_from_numpy(jtree, device="cpu"))
    m = tp["blocks"]["mamba"]
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    assert_close(m["A_log"][0], np.asarray(jtree["blocks"]["mamba"]["A_log"][0]), 1e-6)
    assert_close(m["dt_bias"][0], np.asarray(jtree["blocks"]["mamba"]["dt_bias"][0]), 1e-6)
    total = sum(v.numel() for v in jx.jax.tree.leaves(tp))
    uncounted = (m["conv_b"].numel() + m["dt_bias"].numel())
    assert total - uncounted == cfg.param_count()


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _jax_entry_points(jx, jcfg, jeng, max_len):
    """The JAX package's prefill and decode step, each under jax.jit (one
    compilation each instead of eager dispatch's one a primitive)."""
    prefill = jx.jax.jit(lambda p, t: jx.api.prefill(p, {"tokens": t}, jcfg, jeng,
                                                     max_len=max_len))
    decode = jx.jax.jit(lambda p, t, c: jx.api.decode_step(p, t, c, jcfg, jeng))
    return (lambda p, t: prefill(p, jx.jnp.asarray(t)),
            lambda p, t, c: decode(p, jx.jnp.asarray(t), c))


def _prompts(cfg, B, S, seed=0):
    return np.random.RandomState(seed).randint(2, cfg.vocab, size=(B, S)).astype(np.int32)


def _cache_fields(cache):
    return {f.name: getattr(cache, f.name) for f in dataclasses.fields(transformer.Cache)
            if getattr(cache, f.name) is not None}


@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_prefill_then_decode_match_jax(jx, model, mode):
    """A 2 x 13 prompt (two ssm chunks and a part) into a 24-position
    cache: the logits, every cache field (SSM state, conv window, shared
    KV, lengths) and three greedy decode steps' logits."""
    _, jcfg, jparams, cfg, tparams = model
    jeng, teng = engine_pair(jx, mode)
    toks = _prompts(cfg, 2, 13)
    jprefill, jdecode = _jax_entry_points(jx, jcfg, jeng, 24)
    jl, jc = jprefill(jparams, toks)
    tl, tc = api.prefill(tparams, {"tokens": torch.from_numpy(toks)}, cfg, teng, max_len=24)
    assert_close(tl, jl, LOGIT_TOL)
    got, want = _cache_fields(tc), {k: v for k, v in _cache_fields(jc).items()}
    assert set(got) == set(want) == ({"lengths", "ssm", "conv"} if cfg.family == "ssm" else
                                      {"lengths", "ssm", "conv", "shared_k", "shared_v"})
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert_close(got[k], want[k], LOGIT_TOL)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(3):
        jl, jc = jdecode(jparams, tok, jc)
        tl, tc = api.decode_step(tparams, torch.from_numpy(tok), tc, cfg, teng)
        assert_close(tl, jl, LOGIT_TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert tc.lengths.tolist() == [16, 16]


def test_decode_from_a_carried_jax_cache(jx, model):
    """`bridge.dense_cache_from_numpy` carries a JAX cache (lengths 9 and
    parked 0: the SSM state runs on for a parked slot) into the port; two
    decode steps from it match the JAX ones."""
    _, jcfg, jparams, cfg, tparams = model
    jeng, teng = engine_pair(jx)
    toks = _prompts(cfg, 2, 9, seed=4)
    jprefill, jdecode = _jax_entry_points(jx, jcfg, jeng, 16)
    _, jc = jprefill(jparams, toks)
    jc = dataclasses.replace(jc, lengths=jx.jnp.asarray([9, 0], jx.jnp.int32))
    tc = bridge.dense_cache_from_numpy(jx.jax.tree.map(np.asarray, jc), device="cpu")
    assert set(_cache_fields(tc)) == set(_cache_fields(jc))
    tok = np.array([7, 11], np.int32)
    for _ in range(2):
        jl, jc = jdecode(jparams, tok, jc)
        tl, tc = api.decode_step(tparams, torch.from_numpy(tok), tc, cfg, teng)
        assert_close(tl, jl, LOGIT_TOL)
    assert tc.lengths.tolist() == [11, 0]


def test_paged_entry_points_refuse(jx, model):
    """The reference's ValueError from init_paged_cache, the paged
    ServingEngine, prefill_chunk, verify_tokens and a paged decode step;
    the JAX package raises it at the same places."""
    _, jcfg, jparams, cfg, tparams = model
    jeng, teng = engine_pair(jx)
    with pytest.raises(ValueError, match="paged cache unsupported"):
        jx.api.init_paged_cache(jcfg, 2, 8, 4, 4)
    with pytest.raises(ValueError, match="paged cache unsupported"):
        api.init_paged_cache(cfg, 2, 8, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="paged cache unsupported"):
        jx.engine.ServingEngine(jparams, jcfg, jeng, jx.EngineConfig(slots=2, max_len=16,
                                                                    paged=True))
    with pytest.raises(ValueError, match="paged cache unsupported"):
        tengine.ServingEngine(tparams, cfg, teng, EngineConfig(slots=2, max_len=16, paged=True),
                              device="cpu")
    toks, table = torch.ones((1, 3), dtype=torch.int64), torch.ones((1, 2), dtype=torch.int32)
    pool = torch.zeros((cfg.n_layers, 3, 1, 4, 8))
    start = torch.zeros(1, dtype=torch.int32)
    for fn in (api.prefill_chunk, api.verify_tokens):
        with pytest.raises(ValueError, match="paged prefill unsupported"):
            fn(tparams, toks, table, start, pool, pool, cfg, teng)
    from repro_torch.serving.kvcache import PagedCache
    paged = PagedCache(lengths=start, block_tables=table, k_pages=pool, v_pages=pool)
    with pytest.raises(ValueError, match="paged cache unsupported"):
        api.decode_step(tparams, torch.ones(1, dtype=torch.int32), paged, cfg, teng)


@pytest.mark.parametrize("S", [1, 2, 3])
def test_short_prompt_decode_continues_prefill(jx, model, S):
    """prefill(S) and one decode step of token S + 1 give prefill(S + 1)'s
    logits and state: the conv window of a prompt shorter than K - 1 is
    zero-padded on the left, as the conv pads. (The reference keeps
    min(S, 1) rows there, and its next decode step fails on the shape; at
    S = 3 the two packages agree.)"""
    _, jcfg, jparams, cfg, tparams = model
    _, teng = engine_pair(jx)
    toks = torch.from_numpy(_prompts(cfg, 2, S + 1, seed=S))
    _, cache = api.prefill(tparams, {"tokens": toks[:, :S]}, cfg, teng, max_len=8)
    assert cache.conv.shape[2] == cfg.ssm_conv - 1
    logits, cache = api.decode_step(tparams, toks[:, S].int(), cache, cfg, teng)
    want, wcache = api.prefill(tparams, {"tokens": toks}, cfg, teng, max_len=8)
    assert_close(logits, want.numpy(), LOGIT_TOL)
    assert_close(cache.ssm, wcache.ssm.numpy(), LOGIT_TOL)
    assert_close(cache.conv, wcache.conv.numpy(), LOGIT_TOL)
    _, jc = _jax_entry_points(jx, jcfg, engine_pair(jx)[0], 8)[0](jparams, toks[:, :S].numpy())
    assert np.asarray(jc.conv).shape[2] == (1 if S < cfg.ssm_conv - 1 else cfg.ssm_conv - 1)


def test_reused_slot_takes_the_new_request_whole(model):
    """A dense slot admitted after another request holds exactly a fresh
    prefill's state once admitted: SSM state, conv window, shared KV over
    every position, length and logits."""
    _, _, _, cfg, tparams = model
    teng = TSalPimEngine.create()
    eng = tengine.ServingEngine(tparams, cfg, teng, EngineConfig(
        slots=1, max_len=24, gen=GenConfig(stop_on_eos=False)), device="cpu")
    a, b = _prompts(cfg, 1, 11, seed=5)[0], _prompts(cfg, 1, 4, seed=6)[0]
    placed, place = [], eng._place_dense

    def place_and_copy(slot, req):
        place(slot, req)
        placed.append(({k: v.clone() for k, v in _cache_fields(eng.cache).items()},
                       eng.last_logits[slot].clone()))

    eng._place_dense = place_and_copy
    eng.submit(a, max_new_tokens=5)
    eng.run()
    eng.submit(b, max_new_tokens=2)
    eng.run()
    logits, fresh = api.prefill(tparams, {"tokens": torch.as_tensor(b[None], dtype=torch.int64)},
                                cfg, teng, max_len=24)
    state, last = placed[1]
    assert set(state) == set(_cache_fields(fresh))
    for k, v in _cache_fields(fresh).items():
        assert torch.equal(state[k][:, 0] if k != "lengths" else state[k], v[:, 0]
                           if k != "lengths" else v), k
    assert torch.equal(last, logits[0])


@pytest.mark.parametrize("argv,want", [
    (["--device", "cpu", "--smoke", "--arch", "mamba2-370m"],
     ["mamba2-370m-smoke: 121,568 params, nonlin=exact", "8 requests through 4 slots: "]),
    (["--device", "cpu", "--smoke", "--arch", "zamba2-1.2b", "--lut", "--requests", "3",
      "--slots", "2", "--max-new", "5"],
     ["zamba2-1.2b-smoke: 218,624 params, nonlin=lut", "3 requests through 2 slots: "]),
    (["--device", "cpu", "--arch", "zamba2-1.2b", "--mode", "batch", "--requests", "2",
      "--max-new", "3"],
     ["zamba2-1.2b-smoke: 218,624 params", "| 6 tokens"]),
])
def test_serve_main_serves_ssm_on_the_cpu(capsys, argv, want):
    serve.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    for line, start in zip(lines, want):
        assert start in line, (line, start)


# The slice's linears (R, C): mamba2-370m's in_proj, out_proj and LM head;
# zamba2-1.2B's in_proj, out_proj, LM head, shared q/k/v/o, GeGLU w_gate /
# w_up and w_down.
SSM_GEMV_SHAPES = [(4384, 1024), (1024, 2048), (50280, 1024),
                   (8384, 2048), (2048, 4096), (32000, 2048),
                   (2048, 2048), (8192, 2048), (2048, 8192)]


@pytest.mark.parametrize("R,C", SSM_GEMV_SHAPES)
def test_gemv_plan_takes_the_tensor_cores_at_the_slice_shapes(R, C):
    """bf16 at a decode step's M 4, an admission's 128 and generate()'s 512:
    the tensor-core kernel, every row tile and K tile covered."""
    for M in (1, 4, 128, 512):
        plan = gemv_pim.gemv_plan(M, C, R, torch.bfloat16)
        assert plan.route == "tensor_core"
        assert plan.row_tiles == -(-R // gemv_pim.TC_ROWS)
        assert plan.k_tiles == -(-C // gemv_pim.TC_K)
        assert plan.n_tiles * plan.n_tile >= M


# ---------------------------------------------------------------------------
# On the card: the kernels at the slice's shapes
# ---------------------------------------------------------------------------

TBANK = tlut.LutBank.create(64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m gpu` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("R,C", SSM_GEMV_SHAPES)
def test_gemv_kernel_at_the_slice_shapes(cuda, R, C):
    """bf16 at M 4 on the tensor cores, within 3e-2 of the plain version."""
    rng = np.random.RandomState(R + C)
    x = torch.from_numpy(_np(rng, 4, C)).to(cuda, torch.bfloat16)
    w = torch.from_numpy(_np(rng, R, C, scale=C ** -0.5)).to(cuda, torch.bfloat16)
    before = gemv_pim.gemv_pim_float.tc_launches
    got = gemv_pim.gemv_pim_float(x, w)
    assert gemv_pim.gemv_pim_float.tc_launches == before + 1
    want = gemv_pim.gemv_pim_plain(x, w)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("M,d", [(4, 1024), (4, 2048), (4, 4096), (128, 2048), (128, 4096)])
@pytest.mark.parametrize("lut", [False, True])
def test_layernorm_kernel_at_the_slice_shapes(cuda, M, d, lut):
    """RMSNorm over d_model and the gated norm over d_inner, bf16, bit for
    bit its plain version."""
    rng = np.random.RandomState(M + d)
    x = torch.from_numpy(_np(rng, M, d)).to(cuda, torch.bfloat16)
    g = torch.from_numpy(1 + _np(rng, d, scale=0.1)).to(cuda, torch.bfloat16)
    kw = dict(eps=1e-6, rsqrt_table=TBANK.rsqrt if lut else None, rms=True)
    got = layernorm_lut.layernorm_lut(x, g, None, **kw)
    assert torch.equal(got, layernorm_lut.layernorm_lut_plain(x, g, None, wide_sums=True,
                                                              **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,name", [
    ((4, 2304), torch.bfloat16, "silu"),      # mamba2's conv SiLU at a decode step
    ((4, 4224), torch.bfloat16, "silu"),      # zamba2's
    ((1, 128, 2304), torch.bfloat16, "silu"),  # an admission's
    ((4, 32), torch.float32, "softplus"),     # mamba2's dt
    ((4, 64), torch.float32, "softplus")])    # zamba2's dt
def test_lut_interp_at_the_slice_shapes(cuda, shape, dtype, name):
    """Bit for bit its plain version; `ops.lut_apply` on the gate, a
    strided slice of in_proj's output, as on its contiguous copy."""
    from repro_torch.kernels import ops
    table = getattr(TBANK, name)
    x = torch.from_numpy(_np(np.random.RandomState(7), *shape, scale=4.0)).to(cuda, dtype)
    got = lut_interp.lut_interp(x, table)
    assert torch.equal(got, lut_interp.lut_interp_plain(x, table))
    wide = torch.cat([x, x], dim=-1)[..., :shape[-1]]
    assert not wide.is_contiguous()
    assert torch.equal(ops.lut_apply(wide, table), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lut", [False, True])
def test_decode_attention_at_zamba2_heads(cuda, dtype, lut):
    """The shared block's decode over one application's arena (4 slots, 32
    heads x 64, 256 positions) against the plain version (LUT: the online
    block walk)."""
    rng = np.random.RandomState(11)
    q = torch.from_numpy(_np(rng, 4, 32, 64)).to(cuda, dtype)
    k = torch.from_numpy(_np(rng, 4, 32, 256, 64)).to(cuda, dtype)
    v = torch.from_numpy(_np(rng, 4, 32, 256, 64)).to(cuda, dtype)
    lens = torch.tensor([1, 33, 129, 256], dtype=torch.int32, device=cuda)
    kw = dict(scale=64 ** -0.5, exp_table=TBANK.exp if lut else None)
    got = decode_attention.decode_attention(q, k, v, lens, **kw)
    plain = (decode_attention.decode_attention_online_plain if lut
             else decode_attention.decode_attention_plain)
    want = plain(q, k, v, lens, **kw)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               rtol=tol, atol=tol)
