"""The port's dense-cache path against the JAX package: the four kernels'
plain versions (`decode_attention`, `softmax_lut`, `layernorm_lut`,
`lut_interp`), the dense `prefill`/`decode_step`, `generate()` and
`ServingEngine(paged=False)`.

Here on the CPU, with inputs made by numpy from a seed and the JAX weights
carried across by `bridge.params_from_numpy`:

  * each plain kernel version against the JAX function run as the JAX
    tests run it (the Pallas kernel in interpret mode) and against its
    `ref` oracle, within 1e-5 in f32; `lut_interp_plain` bit for bit to
    its oracle run eagerly;
    `decode_attention_online_plain` (the kernel's 256-key block walk)
    against the Pallas kernel, which walks the same blocks, also in LUT
    mode; the masked `softmax_lut_plain` against `Nonlinear.softmax(where=)`
    in LUT mode under a causal window mask;
  * the dense prefill and decode steps at S = 13 and S = 64 (the
    attn_chunk = 32 query loop) in exact and LUT mode, on the fp and the
    int8 arena: logits within 1e-4 and fp caches within 1e-5 of JAX (int8
    caches to within one rounding step, see `_close_cache`);
  * greedy `generate()` and `ServingEngine(paged=False)` drains token for
    token against the JAX package's, and the JAX config errors word for
    word;
  * the launch plans of the two row kernels (`softmax_plan`,
    `layernorm_plan`, `_build.row_plan`) and their 16-byte piece check.

On the card (`-m gpu`): each of the four CUDA kernels against its plain
version; `lut_interp` and `layernorm_lut` bit for bit (the norm also on
strided rows of odd stride), `softmax_lut` on both sides of each limit of
its plan, two launches bit for bit, LUT-mode `decode_attention` held to
the online plain version, also at the RoPE models' heads (g x head_dim 6 x
128, 2 x 256, 4 x 120, 12 x 192) over 4800 positions, on the bf16 and the
int8 arena; the norm's rows past 8 warps' registers (8200 f32, 16392 and
18432 bf16) streamed, bit for bit. JAX is imported inside fixtures only, so the card,
which has no JAX, collects this file.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import gpt2_medium
from repro_torch.core import lut as tlut
from repro_torch.core.nonlinear import Nonlinear
from repro_torch.core.salpim import SalPimConfig as TSalPimConfig
from repro_torch.core.salpim import SalPimEngine as TSalPimEngine
from repro_torch.kernels import decode_attention, layernorm_lut, lut_interp, ops, softmax_lut
from repro_torch.kernels import _build, paged_attention
from repro_torch.models import api
from repro_torch.serving import engine as tengine
from repro_torch.serving import quantize
from repro_torch.serving.config import EngineConfig, GenConfig

TBANK = tlut.LutBank.create(64)
TOL = 1e-5
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card, which has no JAX, can
    collect this file and run its `gpu` tests."""
    import jax
    import jax.numpy as jnp

    from repro.configs import gpt2_medium as jax_gpt2
    from repro.core import lut as jlut
    from repro.core.nonlinear import Nonlinear as JNonlinear
    from repro.core.salpim import SalPimConfig, SalPimEngine
    from repro.kernels import decode_attention as jattn
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import api as jax_api
    from repro.serving import config as jconfig
    from repro.serving import engine as jengine
    jcfg = jax_gpt2.smoke_config()
    jparams = jax_api.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return SimpleNamespace(jax=jax, jnp=jnp, ops=jops, ref=jref, attn=jattn,
                           bank=jlut.LutBank.create(64), Nonlinear=JNonlinear,
                           SalPimConfig=SalPimConfig, SalPimEngine=SalPimEngine,
                           api=jax_api, config=jconfig, engine=jengine, cfg=jcfg,
                           params=jparams, tparams=tparams)


def _t(x, device="cpu"):
    return torch.from_numpy(np.array(x)).to(device)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach().float().cpu()),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Inputs, made with numpy from a seed
# ---------------------------------------------------------------------------

def _lut_input(shape, table, seed=0):
    """Values over the table's range and 25% past each end, plus -0.0 and
    both range edges."""
    rng = np.random.RandomState(seed)
    span = table.hi - table.lo
    x = rng.uniform(table.lo - span / 4, table.hi + span / 4, size=shape).astype(np.float32)
    x.flat[:3] = [-0.0, table.lo, table.hi]
    return x


def _ln_input(M, d, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(M, d) * 3.0 + 0.5).astype(np.float32)
    g = (rng.randn(d) * 0.2 + 1.0).astype(np.float32)
    b = (rng.randn(d) * 0.2).astype(np.float32)
    return x, g, b


def _scores(N, S, seed=0):
    return (np.random.RandomState(seed).randn(N, S) * 4.0).astype(np.float32)


def _arena_inputs(B, H, Hkv, S, D, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, D).astype(np.float32)
    k = rng.randn(B, Hkv, S, D).astype(np.float32)
    v = rng.randn(B, Hkv, S, D).astype(np.float32)
    return q, k, v


LUT_TABLES = ["gelu", "silu", "tanh", "sigmoid", "softplus", "exp"]
ATTN_OPTS = [{}, {"lut": True}, {"window": 70, "softcap": 5.0},
             {"lut": True, "window": 300}]


def _attn_kw(opts, bank):
    kw = {k: v for k, v in opts.items() if k != "lut"}
    if opts.get("lut"):
        kw["exp_table"] = bank.exp
    return kw


# ---------------------------------------------------------------------------
# Plain kernel versions against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", LUT_TABLES)
def test_lut_interp_plain_bit_exact_to_jax(jx, name):
    """Bit for bit against `ref.lut_interp_ref` run eagerly, op by op, on a
    ragged shape; within 1e-5 of `ops.lut_apply` through the Pallas kernel
    in interpret mode, whose jitted w * x + b XLA contracts into one FMA."""
    x = _lut_input((7, 45), getattr(TBANK, name))
    jtable = getattr(jx.bank, name)
    got = lut_interp.lut_interp_plain(_t(x), getattr(TBANK, name)).numpy()
    pallas = np.asarray(jx.ops.lut_apply(jx.jnp.asarray(x), jtable, impl="interpret"))
    ref = np.asarray(jx.ref.lut_interp_ref(jx.jnp.asarray(x), jtable))
    np.testing.assert_array_equal(got, ref)
    _close(_t(got), pallas)
    assert torch.equal(ops.lut_apply(_t(x), getattr(TBANK, name)), _t(got))


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("lut", [False, True])
@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("wide_sums", [False, True])
def test_layernorm_plain_matches_jax(jx, rms, lut, plus_one, wide_sums):
    """Both forms of the plain version: the CPU path's fp32 sums and the
    kernel's twin, fp64 sums."""
    x, g, b = _ln_input(16, 96)
    beta = None if rms else b
    kw = dict(eps=1e-5, rms=rms, plus_one=plus_one)
    got = layernorm_lut.layernorm_lut_plain(
        _t(x), _t(g), None if beta is None else _t(beta),
        rsqrt_table=TBANK.rsqrt if lut else None, wide_sums=wide_sums, **kw)
    jnp = jx.jnp
    jb = None if beta is None else jnp.asarray(beta)
    jt = jx.bank.rsqrt if lut else None
    pallas = jx.ops.pim_layernorm(jnp.asarray(x), jnp.asarray(g), jb, rsqrt_table=jt,
                                  impl="interpret", **kw)
    ref = jx.ops.pim_layernorm(jnp.asarray(x), jnp.asarray(g), jb, rsqrt_table=jt,
                               impl="reference", **kw)
    _close(got, pallas)
    _close(got, ref)


@pytest.mark.parametrize("lut", [False, True])
def test_norms_of_nonlinear_are_the_jax_code(jx, lut):
    """`Nonlinear.layernorm`/`rmsnorm`, which go through `ops.pim_layernorm`,
    against the JAX package's inline code."""
    x, g, b = _ln_input(8, 64, seed=3)
    mode = "lut" if lut else "exact"
    mine, theirs = Nonlinear.create(mode), jx.Nonlinear.create(mode)
    jnp = jx.jnp
    _close(mine.layernorm(_t(x), _t(g), _t(b)),
           theirs.layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    _close(mine.rmsnorm(_t(x), _t(g), plus_one=True),
           theirs.rmsnorm(jnp.asarray(x), jnp.asarray(g), plus_one=True))


@pytest.mark.parametrize("lut", [False, True])
@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("wide_sums", [False, True])
def test_rmsnorm_plain_matches_jax_at_qwen2_width(jx, lut, plus_one, wide_sums):
    """RMSNorm at qwen2-1.5B's d = 1536, a row past one warp's registers in
    f32 and within them in bf16 (`layernorm_plan`)."""
    x, g, _ = _ln_input(4, 1536, seed=2)
    kw = dict(eps=1e-6, rms=True, plus_one=plus_one)
    got = layernorm_lut.layernorm_lut_plain(_t(x), _t(g), None,
                                            rsqrt_table=TBANK.rsqrt if lut else None,
                                            wide_sums=wide_sums, **kw)
    jnp = jx.jnp
    jt = jx.bank.rsqrt if lut else None
    for impl in ("interpret", "reference"):
        _close(got, jx.ops.pim_layernorm(jnp.asarray(x), jnp.asarray(g), None,
                                         rsqrt_table=jt, impl=impl, **kw))


@pytest.mark.parametrize("N,S", [(8, 128), (6, 77)])
def test_softmax_plain_matches_jax(jx, N, S):
    x = _scores(N, S)
    got = softmax_lut.softmax_lut_plain(_t(x), TBANK.exp, TBANK.recip)
    jnp = jx.jnp
    pallas = jx.ops.pim_softmax(jnp.asarray(x), jx.bank.exp, jx.bank.recip,
                                impl="interpret")
    ref = jx.ops.pim_softmax(jnp.asarray(x), jx.bank.exp, jx.bank.recip,
                             impl="reference")
    _close(got, pallas)
    _close(got, ref)


@pytest.mark.parametrize("q_offset,causal,window", [(0, True, None), (5, True, 7),
                                                    (0, False, 4), (-12, True, 3)])
def test_masked_softmax_plain_matches_nonlinear(jx, q_offset, causal, window):
    """The kernel's mask (queries at q_offset + i; keys k <= q, k > q - w)
    against the JAX `Nonlinear.softmax(where=...)` in LUT mode; at
    q_offset -12 no row sees a key and every row comes out 0."""
    B, Sq, Sk = 3, 9, 12
    x = _scores(B * Sq, Sk, seed=1).reshape(B, Sq, Sk)
    kw = dict(q_offset=q_offset, causal=causal, window=window)
    got = softmax_lut.softmax_lut_plain(_t(x), TBANK.exp, TBANK.recip, **kw)
    qp = np.arange(Sq)[:, None] + q_offset
    kp = np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    want = jx.Nonlinear.create("lut").softmax(jx.jnp.asarray(x),
                                              where=jx.jnp.asarray(mask)[None])
    _close(got, want)
    if not mask.any():
        assert float(got.abs().max()) == 0.0
    assert torch.equal(Nonlinear.create("lut").attention_softmax(_t(x), **kw), got)


@pytest.mark.parametrize("opts", ATTN_OPTS)
def test_decode_attention_plain_matches_jax(jx, opts):
    """Dense plain version against `ref.decode_attention_ref`, and the
    online block walk against the Pallas kernel in interpret mode (two
    256-key blocks, GQA 2, lengths that skip a block, a window)."""
    B, H, Hkv, S, D = 4, 4, 2, 512, 16
    q, k, v = _arena_inputs(B, H, Hkv, S, D)
    lens = np.asarray([1, 200, 300, 512], np.int32)
    kw = _attn_kw(opts, TBANK)
    jkw = _attn_kw(opts, jx.bank)
    tq, tk, tv, tl = _t(q), _t(k), _t(v), _t(lens)
    jnp = jx.jnp
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens))
    dense = decode_attention.decode_attention_plain(tq, tk, tv, tl, **kw)
    _close(dense, jx.ref.decode_attention_ref(*args, **jkw))
    _close(ops.pim_decode_attention(tq, tk, tv, tl, **kw), jx.ref.decode_attention_ref(
        *args, **jkw))
    online = decode_attention.decode_attention_online_plain(tq, tk, tv, tl, **kw)
    _close(online, jx.attn.decode_attention(*args, interpret=True, **jkw))
    if not opts.get("lut"):
        _close(online, dense)


def _int8_arena(B, Hkv, S, D, seed=0):
    """An int8 arena with bf16 scale rows, made with numpy from a seed."""
    rng = np.random.RandomState(seed)
    k8, v8 = (rng.randint(-127, 128, size=(B, Hkv, S, D)).astype(np.int8) for _ in range(2))
    ks, vs = ((rng.rand(B, Hkv, S) * 0.05 + 1e-3).astype(np.float32) for _ in range(2))
    return k8, v8, ks, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opts", ATTN_OPTS)
def test_int8_arena_plain_matches_jax_on_the_dequantized_arena(jx, dtype, opts):
    """The plain version on the int8 arena (its scale rows passed) runs the
    JAX package's eager dequantization: the dequantized arena equals JAX's
    `k.astype(q.dtype) * k_scale[..., None].astype(q.dtype)` bit for bit in
    f32 and bf16, and the output matches `ref.decode_attention_ref` on it
    within 1e-5 in f32."""
    B, H, Hkv, S, D = 4, 4, 2, 512, 16
    q, _, _ = _arena_inputs(B, H, Hkv, S, D, seed=5)
    k8, v8, ks, vs = _int8_arena(B, Hkv, S, D, seed=5)
    lens = np.asarray([0, 1, 257, 512], np.int32)
    jnp = jx.jnp
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    tq = _t(q).to(dtype)
    tks, tvs = _t(ks).bfloat16(), _t(vs).bfloat16()
    jks, jvs = jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16)
    jk = jnp.asarray(k8).astype(jdt) * jks[..., None].astype(jdt)
    jv = jnp.asarray(v8).astype(jdt) * jvs[..., None].astype(jdt)
    tk, tv = decode_attention.dequantize_arena(tq, _t(k8), _t(v8), tks, tvs)
    assert tk.dtype == dtype
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))
    if dtype == torch.bfloat16:
        return
    kw = _attn_kw(opts, TBANK)
    got = decode_attention.decode_attention_plain(tq, _t(k8), _t(v8), _t(lens), tks, tvs, **kw)
    want = jx.ref.decode_attention_ref(jnp.asarray(q), jk, jv, jnp.asarray(lens),
                                       **_attn_kw(opts, jx.bank))
    _close(got, want)
    assert torch.equal(ops.pim_decode_attention(tq, _t(k8), _t(v8), _t(lens), tks, tvs, **kw),
                       got)
    online = decode_attention.decode_attention_online_plain(tq, _t(k8), _t(v8), _t(lens), tks,
                                                            tvs, **kw)
    _close(online, jx.attn.decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(lens),
                                            interpret=True, **_attn_kw(opts, jx.bank)))


# (B, Hkv, S, g, D, row bytes) -> (cluster, window blocks): GPT-2's 4 slots at
# both arena widths (bf16 and f32 rows), and qwen2-1.5B's 131072-key arena
# at g = 6, head_dim 128, walked in windows.
ARENA_PLANS = [((4, 16, 256, 1, 64, 128), (1, 1)), ((4, 16, 1024, 1, 64, 128), (4, 1)),
               ((4, 16, 1024, 1, 64, 256), (4, 1)), ((4, 16, 161, 1, 64, 128), (1, 1)),
               ((1, 2, 131072, 6, 128, 256), (8, 15)), ((4, 2, 4100, 6, 128, 256), (8, 3))]


@pytest.mark.parametrize("shape,want", ARENA_PLANS)
def test_arena_plan_at_model_widths(shape, want):
    """`arena_plan` grows the cluster until the grid covers the card while
    every block keeps a 256-key block, then walks runs that outgrow shared
    memory in windows of whole ring stages, every window within it."""
    B, Hkv, S, g, D, row_bytes = shape
    cs, win = paged_attention.arena_plan(*shape)
    assert (cs, win) == want
    blocks = -(-S // 256)
    run = -(-blocks // cs)
    assert cs <= blocks and win <= run
    assert paged_attention.decode_smem_bytes(g, D, 256, win, row_bytes, cs, arena=True) <= \
        paged_attention.DECODE_SMEM_MAX
    ck = paged_attention.decode_chunk_keys(256, row_bytes, win, paged_attention.ARENA_STAGE_BYTES)
    assert (win * 256) % ck == 0 and ck * row_bytes <= 32768


def test_arena_plan_refuses_with_a_named_error():
    """Not one ring stage of g x D fits a block: a ValueError that names the
    kernel and the shape."""
    with pytest.raises(ValueError, match="decode_attention: not one page of 64 query heads"):
        paged_attention.arena_plan(1, 1, 1024, 64, 512, 1024)


# ---------------------------------------------------------------------------
# The dense model path against the JAX model
# ---------------------------------------------------------------------------

def _configs(jx, kv_dtype="model", uniform=False):
    tcfg = dataclasses.replace(gpt2_medium.smoke_config(), kv_dtype=kv_dtype,
                               decode_uniform=uniform)
    jcfg = dataclasses.replace(jx.cfg, kv_dtype=kv_dtype, decode_uniform=uniform)
    return jcfg, tcfg


def _close_cache(tcache, jcache):
    """fp arenas within 1e-5. The int8 arena is rounded twice from the
    projected K/V (payload to an integer, scale to bf16), so a 1e-7
    difference upstream flips a rounding now and then: payloads within 1
    and scales within one bf16 step (2^-7 relative), in at most 1% of the
    elements."""
    for name in ("k", "v", "k_scale", "v_scale"):
        want = getattr(jcache, name)
        got = getattr(tcache, name)
        if want is None:
            assert got is None
            continue
        want = np.asarray(want, np.float32)
        got = np.asarray(got.float())
        if not tcache.quantized:
            _close(torch.from_numpy(got), want)
            continue
        step = 1.0 if name in ("k", "v") else np.abs(want) * 2.0 ** -7
        off = np.abs(got - want)
        assert np.all(off <= step), name
        assert np.mean(off > 0) <= 0.01, name
    np.testing.assert_array_equal(tcache.lengths.numpy(), np.asarray(jcache.lengths))


@pytest.mark.parametrize("mode", ["exact", "lut"])
@pytest.mark.parametrize("S", [13, 64])
@pytest.mark.parametrize("kv_dtype,uniform", [("model", False), ("int8", False),
                                              ("model", True)])
def test_dense_prefill_then_decode_match_jax(jx, mode, S, kv_dtype, uniform):
    """Prefill at S = 13 (one query block) and S = 64 (two of attn_chunk =
    32), then three decode steps, the last with slot 1 parked at length 0."""
    jcfg, tcfg = _configs(jx, kv_dtype, uniform)
    jeng = jx.SalPimEngine.create(jx.SalPimConfig(nonlinear_mode=mode))
    teng = TSalPimEngine.create(TSalPimConfig(nonlinear_mode=mode))
    B, max_len = 2, S + 6
    prompts = np.random.RandomState(11).randint(2, jcfg.vocab, size=(B, S)).astype(np.int32)
    jnp = jx.jnp
    jlog, jcache = jx.api.prefill(jx.params, {"tokens": jnp.asarray(prompts)}, jcfg, jeng,
                                  max_len=max_len)
    tlog, tcache = api.prefill(jx.tparams, {"tokens": _t(prompts).long()}, tcfg, teng,
                               max_len)
    _close(tlog, jlog, LOGIT_TOL)
    _close_cache(tcache, jcache)
    for step in range(3):
        if step == 2 and not uniform:
            tcache.lengths[1] = 0
            jcache.lengths = jcache.lengths.at[1].set(0)
        if tcache.quantized:
            # Decode from JAX's own int8 arena, so that a rounding flip in
            # an earlier write does not carry into this step's logits.
            tcache = dataclasses.replace(tcache, **{
                f: bridge.tensor_from_numpy(np.asarray(getattr(jcache, f)), "cpu")
                for f in ("lengths", "k", "v", "k_scale", "v_scale")})
        tok = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
        jlog, jcache = jx.api.decode_step(jx.params, jnp.asarray(tok), jcache, jcfg, jeng)
        tlog, tcache = api.decode_step(jx.tparams, _t(tok), tcache, tcfg, teng)
        _close(tlog, jlog, LOGIT_TOL)
        _close_cache(tcache, jcache)


@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_generate_matches_jax(jx, mode):
    """Greedy `generate()`: the same tokens as the JAX `engine.generate`, and
    with an EOS that one sequence emits early, the same padding and the
    same token accounting."""
    jcfg, tcfg = _configs(jx)
    jeng = jx.SalPimEngine.create(jx.SalPimConfig(nonlinear_mode=mode))
    teng = TSalPimEngine.create(TSalPimConfig(nonlinear_mode=mode))
    prompts = np.random.RandomState(5).randint(2, jcfg.vocab, size=(3, 13)).astype(np.int32)
    base = dict(max_new_tokens=7, stop_on_eos=False)
    jtoks, _ = jx.engine.generate(jx.params, jx.jnp.asarray(prompts), jcfg, jeng,
                                  jx.config.GenConfig(**base))
    ttoks, _ = tengine.generate(jx.tparams, _t(prompts), tcfg, teng, GenConfig(**base),
                                device="cpu")
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    eos = dict(max_new_tokens=7, stop_on_eos=True, eos_id=int(np.asarray(jtoks)[0, 2]))
    jtoks, jst = jx.engine.generate(jx.params, jx.jnp.asarray(prompts), jcfg, jeng,
                                    jx.config.GenConfig(**eos))
    ttoks, tst = tengine.generate(jx.tparams, _t(prompts), tcfg, teng, GenConfig(**eos),
                                  device="cpu")
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert (tst["tokens"], tst["tokens_budget"]) == (jst["tokens"], jst["tokens_budget"])
    assert tst["tokens"] < tst["tokens_budget"]


def _drain(eng, prompts, new):
    uids = [eng.submit(p.copy(), max_new_tokens=n) for p, n in zip(prompts, new)]
    done = eng.run(max_steps=400)
    assert sorted(r.uid for r in done) == sorted(uids)
    by = {r.uid: list(r.generated) for r in done}
    return [by[u] for u in uids]


@pytest.mark.parametrize("mode,kv_dtype", [("exact", "model"), ("lut", "model"),
                                           ("exact", "int8")])
def test_dense_engine_drain_matches_jax(jx, mode, kv_dtype):
    """`ServingEngine(paged=False)` against the JAX dense engine: FIFO
    admission into 2 slots, whole-prompt admission prefill, released slots
    parked at length 0; the same greedy tokens."""
    jcfg, tcfg = _configs(jx, kv_dtype)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(2, jcfg.vocab, size=n) for n in (5, 11, 3, 17, 8)]
    new = [6, 4, 8, 5, 7]
    kw = dict(slots=2, max_len=32)
    jeng = jx.engine.ServingEngine(
        jx.params, jcfg, jx.SalPimEngine.create(jx.SalPimConfig(nonlinear_mode=mode)),
        jx.config.EngineConfig(gen=jx.config.GenConfig(stop_on_eos=False), **kw))
    want = _drain(jeng, prompts, new)
    teng = tengine.ServingEngine(
        jx.tparams, tcfg, TSalPimEngine.create(TSalPimConfig(nonlinear_mode=mode)),
        EngineConfig(gen=GenConfig(stop_on_eos=False), **kw), device="cpu")
    got = _drain(teng, prompts, new)
    assert got == want
    st = teng.stats()
    assert st["tokens"] == sum(new)
    assert st["prefill_tokens"] == sum(len(p) for p in prompts)
    assert teng.allocator is None and teng.cache.quantized == (kv_dtype == "int8")
    assert teng.cache.lengths.tolist() == [0, 0]


@pytest.mark.parametrize("change", [
    {"prefill_chunk_tokens": 4}, {"kv_splits": 2}, {"kv_cache_dtype": "int8"},
])
def test_dense_config_errors_match_jax(jx, change):
    """What the JAX engine refuses in dense mode, with its message."""
    kw = dict(slots=1, max_len=16, **change)
    with pytest.raises(ValueError) as jerr:
        jx.config.EngineConfig(**kw).validate(jx.cfg)
    with pytest.raises(ValueError) as terr:
        tengine.ServingEngine(jx.tparams, gpt2_medium.smoke_config(),
                              TSalPimEngine.create(), EngineConfig(**kw), device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "paged=True" in str(terr.value) or "paged pool" in str(terr.value)


@pytest.mark.parametrize("q_offset,window", [(64, None), (952, 300), (-3, None)])
def test_masked_softmax_plain_matches_nonlinear_at_960_keys(jx, q_offset, window):
    """The causal mask at a 960-key prefill's width (rows of a chunk at
    q_offset + i; at -3 the first rows see no key and come out 0) against
    `Nonlinear.softmax(where=...)` in LUT mode."""
    B, Sq, Sk = 2, 8, 960
    x = _scores(B * Sq, Sk, seed=4).reshape(B, Sq, Sk)
    kw = dict(q_offset=q_offset, causal=True, window=window)
    got = softmax_lut.softmax_lut_plain(_t(x), TBANK.exp, TBANK.recip, **kw)
    qp = np.arange(Sq)[:, None] + q_offset
    kp = np.arange(Sk)[None, :]
    mask = kp <= qp
    if window is not None:
        mask &= kp > qp - window
    want = jx.Nonlinear.create("lut").softmax(jx.jnp.asarray(x),
                                              where=jx.jnp.asarray(mask)[None])
    _close(got, want)
    dead = torch.from_numpy(~mask.any(axis=1))
    assert float(got[:, dead].abs().sum()) == 0.0


# (n_rows, width, itemsize) -> (chunks, warps a row, rows a block): the main
# paths' calls (a decode step's 4 norm rows, the paged chunk's 64,
# generate()'s 512; a 128- and a 960-token prefill's scores), qwen2's 1536,
# and both sides of each limit (a warp: 32 values a lane for the softmax, 8
# pieces for the norm; a block of 8 warps). Calls of few rows spread a row
# until a lane holds 8 values.
SOFTMAX_PLANS = [((2048, 128, 4), (1, 1, 8)), ((15360, 960, 4), (8, 1, 1)),
                 ((2048, 128, 2), (1, 1, 8)), ((6, 77, 4), (1, 1, 1)),
                 ((8, 1024, 4), (2, 4, 1)), ((8, 1025, 4), (2, 8, 1)),
                 ((2048, 1024, 4), (8, 1, 1)), ((2048, 1025, 4), (8, 2, 1)),
                 ((4, 8192, 4), (8, 8, 1)), ((4, 8193, 4), (0, 8, 1)),
                 ((4, 8192, 2), (4, 8, 1)), ((4, 8193, 2), (0, 8, 1))]
LAYERNORM_PLANS = [((4, 1024, 2), (1, 4, 1)), ((64, 1024, 2), (1, 4, 1)),
                   ((512, 1024, 2), (1, 4, 1)), ((512, 1024, 4), (2, 4, 1)),
                   ((4, 1536, 2), (1, 8, 1)), ((4, 1536, 4), (2, 8, 1)),
                   ((5, 96, 4), (1, 1, 1)), ((4, 2048, 2), (1, 8, 1)),
                   ((4, 2049, 2), (2, 8, 1)), ((4096, 2048, 2), (8, 1, 1)),
                   ((4096, 2049, 2), (8, 2, 1)), ((4, 16384, 2), (8, 8, 1)),
                   ((4, 8192, 4), (8, 8, 1)), ((4, 2304, 2), (2, 8, 1)),
                   ((4, 3840, 2), (2, 8, 1)), ((4, 16392, 2), (0, 8, 1)),
                   ((4, 18432, 2), (0, 8, 1)), ((4, 8200, 4), (0, 8, 1))]


@pytest.mark.parametrize("shape,want", SOFTMAX_PLANS)
def test_softmax_plan(shape, want):
    n_rows, S, itemsize = shape
    chunks, warps, rows = plan = softmax_lut.softmax_plan(*shape)
    assert plan == want
    if chunks:
        n = 16 // itemsize
        assert chunks * n <= softmax_lut.MAX_VALUES_PER_LANE
        assert chunks * 32 * warps * n >= S and warps * rows <= 8


@pytest.mark.parametrize("shape,want", LAYERNORM_PLANS)
def test_layernorm_plan(shape, want):
    n_rows, d, itemsize = shape
    chunks, warps, rows = plan = layernorm_lut.layernorm_plan(*shape)
    assert plan == want
    assert chunks <= layernorm_lut.MAX_CHUNKS and warps * rows <= 8
    if chunks:
        assert chunks * 32 * warps * (16 // itemsize) >= d


@pytest.mark.parametrize("itemsize,limit", [(2, 16384), (4, 8192)])
def test_layernorm_plan_refuses_rows_past_a_block(itemsize, limit):
    """Rows up to 8 warps' registers keep the register plan; one element
    more and the row is streamed through a block (chunks 0, 8 warps, one
    row a block), at any width: the plan no longer refuses a row."""
    assert layernorm_lut.layernorm_plan(4, limit, itemsize) == (
        layernorm_lut.MAX_CHUNKS, 8, 1)
    for d in (limit + 1, 2 * limit + 3, 18432):
        assert layernorm_lut.layernorm_plan(4, d, itemsize) == (0, 8, 1)


def test_row_plan_covers_every_width():
    """Every width up to a block's registers gets a power of two of pieces
    and of warps that hold it: the fewest warps, spread while the call has
    fewer than 8 warps an SM and a lane holds more than 8 values; rows of
    one warp and fewer than 16 values a lane share a block, as many as
    still give each SM a block; wider rows get None."""
    for itemsize, max_chunks in ((4, 8), (2, 4), (2, 8)):
        n = 16 // itemsize
        top = max_chunks * n * 32 * 8
        for width in list(range(1, 2100, 7)) + [top - 1, top]:
            fewest = next(w for w in (1, 2, 4, 8)
                          if _build._pow2_at_least(-(-width // (32 * w * n))) <= max_chunks)
            for n_rows in (1, 4, 131, 132, 263, 264, 2048, 8448):
                chunks, warps, rows = _build.row_plan(n_rows, width, itemsize, max_chunks)
                assert chunks * 32 * warps * n >= width and chunks <= max_chunks
                assert chunks & (chunks - 1) == 0 and rows & (rows - 1) == 0
                if chunks > 1:
                    assert (chunks // 2) * 32 * warps * n < width
                assert warps >= fewest
                if warps > fewest:
                    spread = warps // 2
                    assert n_rows * spread < 8 * 132
                    assert _build._pow2_at_least(-(-width // (32 * spread * n))) * n > 8
                elif warps < 8:
                    assert chunks * n <= 8 or n_rows * warps >= 8 * 132
                assert warps * rows <= 8
                if warps > 1 or chunks * n >= 16:
                    assert rows == 1
                else:
                    assert rows == 1 or -(-n_rows // rows) >= 132
                    assert rows == 8 or -(-n_rows // (2 * rows)) < 132
        assert _build.row_plan(4, top + 1, itemsize, max_chunks) is None


def test_vector_ok_needs_aligned_starts_and_whole_pieces():
    """16-byte pieces only where every start is aligned and every row and
    stride spans whole pieces: an odd stride, a row of 100 bf16 values or
    a view one element in takes the element path."""
    x = torch.zeros(8, 1032)
    assert _build.vector_ok(4, (1024, x.stride(0)), x, None)
    assert not _build.vector_ok(4, (1024, 1025), x)
    assert not _build.vector_ok(2, (100,), x.bfloat16())
    assert not _build.vector_ok(4, (1024,), x[:, 1:])
    assert _build.vector_ok(4, (1024,), x[:, 4:])


def test_dense_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gpt2_medium.smoke_config()
    params = api.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.generate(params, torch.ones((1, 3), dtype=torch.int64), cfg,
                         TSalPimEngine.create(), GenConfig(max_new_tokens=2))
    assert api.init_cache(cfg, 1, 8, device="cpu").k.device.type == "cpu"


def test_launchers_refuse_cpu_tensors():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        lut_interp.lut_interp(x, TBANK.gelu)
    with pytest.raises(ValueError, match="CUDA"):
        layernorm_lut.layernorm_lut(x, torch.ones(8))
    with pytest.raises(ValueError, match="CUDA"):
        softmax_lut.softmax_lut(x, TBANK.exp, TBANK.recip)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.decode_attention(torch.zeros(1, 2, 8), torch.zeros(1, 2, 4, 8),
                                          torch.zeros(1, 2, 4, 8),
                                          torch.ones(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `pytest -m gpu` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return 1e-4 if dtype == torch.float32 else 3e-2


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 4096), (64, 4096), (3, 45)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["gelu", "exp", "tanh"])
def test_lut_interp_kernel_bit_exact(cuda, shape, dtype, name):
    table = getattr(TBANK, name)
    x = _t(_lut_input(shape, table), cuda).to(dtype)
    got = lut_interp.lut_interp(x, table)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, lut_interp.lut_interp_plain(x, table))


# Rows on both sides of each limit of `layernorm_plan` (a warp: 1024 f32 or
# 2048 bf16 values; 8 warps: 8192 or 16384, past which rows are streamed),
# widths that are not whole 16-byte pieces (98 in f32, 98 and 1030 in
# bf16), and the main paths' rows (GPT-2 1024, qwen2 1536, gemma2 2304,
# danube 3840, nemotron 18432).
LN_CARD_SHAPES = [(4, 1024), (64, 1024), (512, 1024), (5, 96), (3, 98), (3, 1030),
                  (4, 1028), (4, 1536), (4, 2048), (4, 2056), (2, 8192), (2, 16384),
                  (4, 2304), (4, 3840), (4, 8200), (4, 16392), (4, 18432), (3, 18438)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,d", LN_CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rms,lut,plus_one", [(False, False, False), (False, True, False),
                                              (True, False, True), (True, True, False)])
def test_layernorm_kernel_matches_plain(cuda, M, d, dtype, rms, lut, plus_one):
    """Bit for bit, rows past 8 warps' registers (f32 past 8192, bf16 past
    16384) streamed through a block."""
    x, g, b = (_t(a, cuda).to(dtype) for a in _ln_input(M, d))
    kw = dict(eps=1e-5, rsqrt_table=TBANK.rsqrt if lut else None, rms=rms,
              plus_one=plus_one)
    beta = None if rms else b
    got = layernorm_lut.layernorm_lut(x, g, beta, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, layernorm_lut.layernorm_lut_plain(x, g, beta, wide_sums=True,
                                                              **kw))
    # A strided view of rows, as the final norm takes x[:, -1]; an odd
    # stride, which takes the element path.
    x3 = x.reshape(M, 1, d).expand(M, 3, d).contiguous()[:, -1]
    assert torch.equal(layernorm_lut.layernorm_lut(x3, g, beta, **kw), got)
    xo = torch.cat([x, x[:, :1]], dim=1)[:, :d]
    assert xo.stride(0) == d + 1
    assert torch.equal(layernorm_lut.layernorm_lut(xo, g, beta, **kw), got)


# Rows on both sides of each limit of `softmax_plan` (a warp: 1024 keys; 8
# warps: 8192, past which rows are streamed), keys that are not whole
# 16-byte pieces (77, 1026), and the 128- and 960-token prefills' scores.
SM_CARD_SHAPES = [(16 * 128, 128), (6, 77), (8, 1024), (8, 1026), (4, 8192), (4, 8193),
                  (16 * 960, 960)]


@pytest.mark.gpu
@pytest.mark.parametrize("N,S", SM_CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", [None, (0, True, None), (64, True, 40), (-3, True, 2)])
def test_softmax_kernel_matches_plain(cuda, N, S, dtype, mask):
    """Masked and not; at q_offset -3 the first three rows of each block
    of queries see no key and come out 0; two launches agree bit for
    bit."""
    x = _t(_scores(N, S), cuda).to(dtype)
    kw = {} if mask is None else dict(zip(("q_offset", "causal", "window"), mask))
    if mask is not None:
        x = x.reshape(-1, min(N, S), S)            # (..., Sq, Sk)
    got = softmax_lut.softmax_lut(x, TBANK.exp, TBANK.recip, **kw)
    torch.cuda.synchronize()
    want = softmax_lut.softmax_lut_plain(x, TBANK.exp, TBANK.recip, **kw)
    _close(got, want.float().cpu(), _tol(dtype))
    assert torch.equal(softmax_lut.softmax_lut(x, TBANK.exp, TBANK.recip, **kw), got)
    if mask is not None and mask[0] < 0:
        assert float(got[..., :-mask[0], :].float().abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    dict(B=4, H=16, Hkv=16, S=256, D=64, lens=[128, 140, 151, 160]),
    dict(B=4, H=16, Hkv=16, S=161, D=64, lens=[96, 120, 150, 161]),
    dict(B=4, H=16, Hkv=16, S=1024, D=64, lens=[960, 981, 1003, 1020]),
    dict(B=3, H=8, Hkv=2, S=300, D=36, lens=[0, 1, 300]),     # scalar path in bf16
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opts", ATTN_OPTS)
def test_decode_attention_kernel_matches_plain(cuda, case, dtype, opts):
    """Exact mode against the dense plain version; LUT mode against the
    online block walk (the kernel's function), both at the exact-mode
    tolerance."""
    q, k, v = (_t(a, cuda).to(dtype) for a in _arena_inputs(
        case["B"], case["H"], case["Hkv"], case["S"], case["D"]))
    lens = _t(np.asarray(case["lens"], np.int32), cuda)
    kw = _attn_kw(opts, TBANK)
    got = decode_attention.decode_attention(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    plain = (decode_attention.decode_attention_online_plain if opts.get("lut")
             else decode_attention.decode_attention_plain)
    _close(got, plain(q, k, v, lens, **kw).float().cpu(), _tol(dtype))


def _plant_arena(rng, q, k, v, lens, hot, window=None, target=18.0):
    """Give each query row (q (B, H, D)) `hot` keys of its valid span (the
    last `window` of its length), spread over it, whose scores stand near
    `target` (the rest score about N(0, 1)), with V rows of std 4: the
    output is a mix of those few rows, O(1), so a walk that drops a run or
    a window of blocks, or merges them wrongly, misses by O(1)."""
    B, H, D = q.shape
    g = H // k.shape[1]
    for b, n in enumerate(lens):
        lo = max(0, n - window) if window else 0
        if n <= lo:
            continue
        for h in range(H):
            for j in range(hot):
                pos = lo + min(int((j + 0.1 + 0.8 * rng.rand()) / hot * (n - lo)), n - lo - 1)
                c = (target + rng.uniform(-1.5, 1.5)) * np.sqrt(D) / float(q[b, h] @ q[b, h])
                k[b, h // g, pos] = c * q[b, h]
                v[b, h // g, pos] = 4.0 * rng.randn(D)


# Arenas that are not a multiple of the 256-key block, lengths 0, 1, 255,
# 256, 257 and S; a 4100-key arena whose runs span several blocks.
PLANTED = [dict(S=557, lens=[0, 1, 255, 256, 257, 557]),
           dict(S=4100, lens=[1, 257, 3000, 4100])]


@pytest.mark.gpu
@pytest.mark.parametrize("case", PLANTED)
@pytest.mark.parametrize("g", [1, 6, 12])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opts", ATTN_OPTS)
def test_decode_attention_kernel_on_planted_keys(cuda, case, g, D, dtype, opts):
    """The arena walk over 12 query heads (g = 1, 6, 12: clusters of 4 and
    8 blocks at 4100 keys) on planted keys: exact mode against the plain
    version, LUT mode against the online block walk, within 1e-4 (f32) and
    3e-2 (bf16); one launch a call."""
    S, lens = case["S"], case["lens"]
    B, H = len(lens), 12
    rng = np.random.RandomState(S + g + D)
    q, k, v = _arena_inputs(B, H, H // g, S, D, seed=S + g)
    _plant_arena(rng, q, k, v, lens, hot=6, window=opts.get("window"))
    q, k, v = (_t(a, cuda).to(dtype) for a in (q, k, v))
    lengths = _t(np.asarray(lens, np.int32), cuda)
    kw = _attn_kw(opts, TBANK)
    before = decode_attention.decode_attention.launches
    got = decode_attention.decode_attention(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    assert decode_attention.decode_attention.launches == before + 1
    plain = (decode_attention.decode_attention_online_plain if opts.get("lut")
             else decode_attention.decode_attention_plain)
    want = plain(q, k, v, lengths, **kw)
    assert float(want[lengths > 1].float().abs().amax()) > 0.5
    _close(got, want.float().cpu(), _tol(dtype))


# The RoPE models' heads, 2 kv heads each: (g, head_dim, their layers'
# options): qwen2-1.5B, gemma2-2B (softcap 50, a 4096-token window),
# h2o-danube3-4B (the window), nemotron-4-340B.
MODEL_HEADS = [(6, 128, {}), (2, 256, {"softcap": 50.0, "window": 4096}),
               (4, 120, {"window": 4096}), (12, 192, {})]


@pytest.mark.gpu
@pytest.mark.parametrize("heads", MODEL_HEADS)
@pytest.mark.parametrize("arena", ["bf16", "int8"])
@pytest.mark.parametrize("lut", [False, True])
def test_decode_attention_kernel_at_model_heads(cuda, heads, arena, lut):
    """A 4800-position arena, lengths 4700, 1500 and 1, planted keys (in
    the window's span), bf16 queries, the bf16 arena and the int8 one with
    bf16 scale rows: exact mode against the plain version, LUT mode against
    the online block walk, within 3e-2; one launch a call."""
    g, D, opts = heads
    lens = [4700, 1500, 1]
    B, H, S = 3, 2 * g, 4800
    rng = np.random.RandomState(g + D)
    q, k, v = _arena_inputs(B, H, 2, S, D, seed=g + D)
    _plant_arena(rng, q, k, v, lens, hot=6, window=opts.get("window"))
    q, k, v = (_t(a, cuda) for a in (q, k, v))
    q = q.bfloat16()
    if arena == "int8":
        (k, ks), (v, vs) = (quantize.quantize_vec(t, torch.bfloat16) for t in (k, v))
    else:
        k, v, ks, vs = k.bfloat16(), v.bfloat16(), None, None
    lengths = _t(np.asarray(lens, np.int32), cuda)
    kw = _attn_kw(dict(opts, lut=lut), TBANK)
    before = decode_attention.decode_attention.launches
    got = decode_attention.decode_attention(q, k, v, lengths, ks, vs, **kw)
    torch.cuda.synchronize()
    assert decode_attention.decode_attention.launches == before + 1
    plain = (decode_attention.decode_attention_online_plain if lut
             else decode_attention.decode_attention_plain)
    want = plain(q, k, v, lengths, ks, vs, **kw)
    assert float(want[:2].float().abs().amax()) > 0.5
    _close(got, want.float().cpu(), 3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 36, 40, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opts", ATTN_OPTS)
def test_decode_attention_int8_arena_bit_exact(cuda, D, dtype, opts):
    """The kernel on the int8 arena and its bf16 scale rows is bit for bit
    the kernel on the arena dequantized first (`dequantize_arena`, the
    eager expression the plain version runs), at head_dims whose rows are
    16-byte vectors in both arenas (64, 128), in neither (36 in bf16) and
    in the dequantized one only (40); and within the tolerance of the
    plain version."""
    B, H, Hkv, S = 4, 4, 2, 557
    q, _, _ = _arena_inputs(B, H, Hkv, S, D, seed=D)
    k8, v8, ks, vs = (_t(a, cuda) for a in _int8_arena(B, Hkv, S, D, seed=D))
    ks, vs = ks.bfloat16(), vs.bfloat16()
    q = _t(q, cuda).to(dtype)
    lengths = _t(np.asarray([1, 256, 400, 557], np.int32), cuda)
    kw = _attn_kw(opts, TBANK)
    got = decode_attention.decode_attention(q, k8, v8, lengths, ks, vs, **kw)
    k, v = decode_attention.dequantize_arena(q, k8, v8, ks, vs)
    want = decode_attention.decode_attention(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    plain = (decode_attention.decode_attention_online_plain if opts.get("lut")
             else decode_attention.decode_attention_plain)
    _close(got, plain(q, k8, v8, lengths, ks, vs, **kw).float().cpu(), _tol(dtype))
