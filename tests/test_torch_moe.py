"""The MoE family of the port (`models/moe.py`; olmoe-1B-7B and
phi-3.5-MoE) against the JAX package, on the CPU: the layer, the configs
and parameters, and the model entry points. (The greedy drains against
the JAX engine: tests/test_torch_moe_drains.py.)

  * `apply_moe` on both smoke configs at their own cap factor (64: no
    token is dropped) and at the published 1.25 (tokens are dropped, the
    share equal to the reference's `drop_fraction`): f32 within 1e-5 of
    the JAX function relative to its largest |value|, exact and LUT, bf16
    within 1e-2; top-k ties on planted equal router logits break toward
    the lower expert, as `jax.lax.top_k` breaks them;
  * the registry and the parameter tree (the router f32 at bf16 params)
    against the JAX package's; `params_from_numpy` carries the MoE tree,
    int8 experts as 4-D `QTensor`s; `quantize_params_int8` quantizes it
    as the reference does, bit for bit;
  * logits of paged chunks, the dense prefill and the decode steps after
    them within 1e-4 of the JAX functions';
  * `launch/serve.py` serves both models on the CPU.

JAX is imported inside the `jx` fixture only (tests/moe_common.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from moe_common import (CAPS, MOE_MODELS, assert_close, engine_pair, jx,  # noqa: F401
                        model, smoke_configs)
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import quant as tquant
from repro_torch.core.salpim import SalPimEngine as TSalPimEngine
from repro_torch.models import api, moe
from repro_torch.models.config import ModelConfig
from repro_torch.serving.quantize import QTensor, quantize_params_int8

LOGIT_TOL = 1e-4
PAGE, N_PAGES, MAX_PAGES = 4, 24, 10


# ---------------------------------------------------------------------------
# models/moe.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE_MODELS)
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("mode,dtype,tol", [("exact", "float32", 1e-5),
                                            ("lut", "float32", 1e-5),
                                            ("exact", "bfloat16", 1e-2)])
def test_apply_moe_matches_jax(jx, name, cap, mode, dtype, tol):
    """Both functions on the same numpy-seeded weights and inputs (three
    shapes: a decode step's 4 tokens, a chunk's 2 x 8 and 80 tokens in 2
    groups): within `tol` of the JAX output relative to its largest
    |value|, f32 exact and LUT, bf16 exact. The port's keep mask drops the
    reference's `drop_fraction`: none at the smoke cap factor, some at
    1.25."""
    jcfg, cfg = smoke_configs(jx, name, cap, param_dtype=dtype, compute_dtype=dtype)
    jp = jx.moe.init_moe(jx.jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_numpy(jx.jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["router"].dtype == torch.float32 and tp["w_up"].dtype == getattr(torch, dtype)
    jeng, teng = engine_pair(jx, mode)
    rng = np.random.RandomState(len(name) + (cap is None))
    dropped = []
    for shape in ((4,), (2, 8), (80,)):
        jxin = jx.jnp.asarray(rng.randn(*shape, jcfg.d_model).astype(np.float32)).astype(dtype)
        xin = bridge.tensor_from_numpy(np.asarray(jxin), device="cpu")
        want, aux = jx.moe.apply_moe(jp, jxin, jcfg, jeng, return_aux=True)
        got = moe.apply_moe(tp, xin, cfg, teng)
        assert got.dtype == xin.dtype and got.shape == xin.shape
        want = np.asarray(want.astype(jx.jnp.float32))
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert err <= tol, (shape, err)
        xt = xin.reshape(-1, cfg.d_model)
        plan = moe.dispatch(*moe.route(tp["router"], xt, cfg, teng), cfg,
                            moe._num_groups(xt.shape[0]))
        drop = 1.0 - float(plan.keep.float().mean())
        assert drop == pytest.approx(float(aux["drop_fraction"]), abs=1e-7)
        dropped.append(drop)
    if cap is None:
        assert max(dropped) == 0.0
    else:
        assert max(dropped) > 0.0


@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_top_k_ties_break_toward_the_lower_expert(jx, mode):
    """Router rows planted equal (small integers over 8, exact in f32 with
    an integer x) give equal weights; the port's choices are
    `jax.lax.top_k`'s (lower index first) where `torch.topk` may differ,
    and the layer's output is the JAX function's."""
    jcfg, cfg = smoke_configs(jx, "olmoe_1b_7b", 1.25)
    jp = jx.moe.init_moe(jx.jax.random.PRNGKey(5), jcfg)
    rng = np.random.RandomState(5)
    router = rng.randint(-3, 4, size=(cfg.n_experts, cfg.d_model)).astype(np.float32) / 8
    router[[2, 4, 6]] = router[1]
    router[7] = router[5]
    jp = dict(jp, router=jx.jnp.asarray(router))
    tp = bridge.params_from_numpy(jx.jax.tree.map(np.asarray, jp), device="cpu")
    x = rng.randint(-2, 3, size=(40, cfg.d_model)).astype(np.float32)
    jeng, teng = engine_pair(jx, mode)
    logits = jeng.linear(jx.jnp.asarray(x), jp["router"])
    jw, ji = jx.jax.lax.top_k(jeng.softmax(logits, axis=-1), cfg.top_k)
    tw, ti = moe.route(tp["router"], torch.from_numpy(x), cfg, teng)
    assert ti.tolist() == np.asarray(ji).tolist()
    ties = (np.asarray(jw)[:, 0] == np.asarray(jw)[:, 1]).sum()
    assert ties > 0, "no tie was planted at the top"
    assert_close(moe.apply_moe(tp, torch.from_numpy(x), cfg, teng),
           jx.moe.apply_moe(jp, jx.jnp.asarray(x), jcfg, jeng), 1e-5)


def test_combine_is_deterministic_choice_order():
    """The same call twice gives the same bits, and the bf16 combine adds
    the k weighted outputs one rounding at a time in choice order."""
    cfg = dataclasses.replace(get_config("olmoe_1b_7b", smoke=True), param_dtype="bfloat16",
                              compute_dtype="bfloat16", router_cap_factor=1.25)
    p = {k: v[0] for k, v in api.init_params(cfg, seed=2, device="cpu")["blocks"]["moe"].items()}
    x = torch.randn(24, cfg.d_model, generator=torch.Generator().manual_seed(2)).bfloat16()
    teng = TSalPimEngine.create()
    a, b = moe.apply_moe(p, x, cfg, teng), moe.apply_moe(p, x, cfg, teng)
    assert torch.equal(a, b) and a.dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["shardmap", "bogus"])
def test_moe_impl(jx, impl):
    """"shardmap" with no mesh is the grouped dispatch, as in the
    reference; an unknown implementation raises."""
    jcfg, cfg = smoke_configs(jx, "phi35_moe_42b", 1.25, moe_impl=impl)
    p = {k: v[0] for k, v in api.init_params(cfg, seed=4, device="cpu")["blocks"]["moe"].items()}
    x = torch.randn(12, cfg.d_model, generator=torch.Generator().manual_seed(4))
    teng = TSalPimEngine.create()
    if impl == "bogus":
        with pytest.raises(ValueError, match="moe_impl"):
            moe.apply_moe(p, x, cfg, teng)
        return
    want = moe.apply_moe(p, x, dataclasses.replace(cfg, moe_impl="gspmd"), teng)
    assert torch.equal(moe.apply_moe(p, x, cfg, teng), want)


# ---------------------------------------------------------------------------
# Configs, parameters, quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE_MODELS)
@pytest.mark.parametrize("smoke", [False, True])
def test_registry_matches_jax_configs(jx, name, smoke):
    """Every field of the port's config equals the JAX config's, under the
    module name and the published names."""
    got, want = get_config(name, smoke=smoke), jx.get_config(name, smoke=smoke)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.moe_ff == want.moe_ff
    if not smoke:
        assert get_config(want.name) == got
        assert get_config(want.name.split("-a")[0]) == got    # phi3.5-moe-42b


def test_olmoe_counts():
    """olmoe-1B-7B: 6.92 B parameters, of which a token reads 8 of each
    layer's 64 experts. (tests/test_torch_costmodel.py holds both counts
    to the JAX package's for every config of the registry.)"""
    cfg = get_config("olmoe-1b-7b")
    assert cfg.param_count() == 6_919_096_320
    assert cfg.active_param_count() == 6_919_096_320 - 16 * 56 * 3 * 2048 * 1024


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_mirror_jax_tree(jx, dtype):
    """The port's tree has the JAX keys, shapes and dtypes: experts stacked
    (L, E, f, d) / (L, E, d, f) in the param dtype, the router (L, E, d)
    f32; the router's std is d ** -0.5."""
    jcfg, cfg = smoke_configs(jx, "phi35_moe_42b", param_dtype=dtype)
    jp = jx.api.init_params(jx.jax.random.PRNGKey(0), jcfg)
    mine = api.init_params(cfg, seed=1, device="cpu")
    flat = jx.jax.tree_util.tree_leaves_with_path
    jflat = {jx.jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)) for k, v in flat(jp)}
    tflat = {jx.jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).removeprefix("torch."))
             for k, v in flat(mine)}
    assert tflat == jflat and "ffn" not in mine["blocks"]
    router = mine["blocks"]["moe"]["router"]
    assert router.dtype == torch.float32
    assert float(router.std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.1)


def test_quantize_params_int8_matches_jax_and_round_trips(jx):
    """`quantize_params_int8` on the MoE tree: every expert weight a 4-D
    `QTensor` (scales (L, E, R)), the router left f32, bit for bit the JAX
    package's; `params_from_numpy` carries the JAX tree across as the same
    QTensors, and quantizing a stacked leaf a layer at a time gives the
    bits of quantizing it whole."""
    jcfg, cfg = smoke_configs(jx, "olmoe_1b_7b", param_dtype="bfloat16")
    jp = jx.api.init_params(jx.jax.random.PRNGKey(0), jcfg)
    jq = jx.quant.quantize_params_int8(jp)
    carried = bridge.params_from_numpy(jx.jax.tree.map(np.asarray, jq), device="cpu")
    mine = quantize_params_int8(bridge.params_from_numpy(jx.jax.tree.map(np.asarray, jp),
                                                         device="cpu"))
    m = mine["blocks"]["moe"]
    assert m["router"].dtype == torch.float32 and not isinstance(m["router"], QTensor)
    for key in ("w_up", "w_gate", "w_down"):
        q = m[key]
        assert isinstance(q, QTensor) and q.w_i8.ndim == 4 and q.scale.ndim == 3
        c = carried["blocks"]["moe"][key]
        assert isinstance(c, QTensor)
        assert torch.equal(q.w_i8, c.w_i8) and torch.equal(q.scale, c.scale)
        w = bridge.tensor_from_numpy(np.asarray(jp["blocks"]["moe"][key]), device="cpu")
        whole_i8, whole_scale = tquant.quantize_int8_rows(w.float())
        assert torch.equal(q.w_i8, whole_i8) and torch.equal(q.scale, whole_scale)
    assert torch.equal(carried["blocks"]["moe"]["router"], m["router"])
    layers = q.unbind()
    assert len(layers) == cfg.n_layers and layers[0].w_i8.shape == q.w_i8.shape[1:]


# ---------------------------------------------------------------------------
# Logits of the model entry points
# ---------------------------------------------------------------------------

def test_paged_chunks_then_decode_match_jax(jx, model):
    """Two chunks (positions 0..7, 8..20) of a paged prefill into scattered
    pages, then four decode steps over 3 slots: logits within 1e-4 of the
    JAX functions', the pools within 1e-5. (LUT mode: the drains.)"""
    _, jcfg, jparams, cfg, tparams = model
    jnp = jx.jnp
    jeng, teng = engine_pair(jx)
    B, S = 3, 21
    prompts = np.random.RandomState(11).randint(2, jcfg.vocab, size=(B, S)).astype(np.int32)
    rows = np.asarray([[3, 7, 1, 9, 12, 14, 16, 0, 0, 0],
                       [2, 11, 5, 4, 13, 15, 17, 0, 0, 0],
                       [6, 8, 10, 18, 19, 20, 21, 0, 0, 0]], np.int32)
    jcache = jx.api.init_paged_cache(jcfg, B, N_PAGES, PAGE, MAX_PAGES)
    tcache = api.init_paged_cache(cfg, B, N_PAGES, PAGE, MAX_PAGES, device="cpu")
    jkp, jvp = jcache.k_pages, jcache.v_pages
    for a, b in ((0, 8), (8, S)):
        st = np.full((B,), a, np.int32)
        jlog, jkp, jvp = jx.api.prefill_chunk(
            jparams, jnp.asarray(prompts[:, a:b]), jnp.asarray(rows), jnp.asarray(st),
            jkp, jvp, jcfg, jeng)
        tlog, _, _ = api.prefill_chunk(
            tparams, torch.from_numpy(prompts[:, a:b]), torch.from_numpy(rows),
            torch.from_numpy(st), tcache.k_pages, tcache.v_pages, cfg, teng)
        assert_close(tlog, jlog, LOGIT_TOL)
    assert_close(tcache.k_pages, jkp, 1e-5)
    jcache = dataclasses.replace(jcache, lengths=jnp.full((B,), S, jnp.int32),
                                 block_tables=jnp.asarray(rows), k_pages=jkp, v_pages=jvp)
    tcache.lengths.fill_(S)
    tcache.block_tables.copy_(torch.from_numpy(rows))
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    for _ in range(4):
        jlog, jcache = jx.api.decode_step(jparams, jnp.asarray(tok), jcache, jcfg, jeng)
        tlog, tcache = api.decode_step(tparams, torch.from_numpy(tok), tcache, cfg, teng)
        assert_close(tlog, jlog, LOGIT_TOL)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    assert_close(tcache.v_pages, jcache.v_pages, 1e-5)


def test_dense_prefill_then_decode_match_jax(jx, model):
    """The dense prefill of 2 x 40 tokens (80 tokens in 2 groups) and four
    decode steps over the arena: logits within 1e-4, the arena within 1e-5."""
    _, jcfg, jparams, cfg, tparams = model
    jeng, teng = engine_pair(jx)
    prompts = np.random.RandomState(5).randint(2, jcfg.vocab, size=(2, 40)).astype(np.int32)
    jlog, jcache = jx.api.prefill(jparams, {"tokens": jx.jnp.asarray(prompts)}, jcfg, jeng,
                                  max_len=48)
    tlog, tcache = api.prefill(tparams, {"tokens": torch.from_numpy(prompts)}, cfg, teng,
                               max_len=48)
    assert_close(tlog, jlog, LOGIT_TOL)
    assert_close(tcache.k, jcache.k, 1e-5)
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    for _ in range(4):
        jlog, jcache = jx.api.decode_step(jparams, jx.jnp.asarray(tok), jcache, jcfg, jeng)
        tlog, tcache = api.decode_step(tparams, torch.from_numpy(tok), tcache, cfg, teng)
        assert_close(tlog, jlog, LOGIT_TOL)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)


@pytest.mark.parametrize("argv,want", [
    (["--arch", "olmoe-1b-7b", "--requests", "5", "--slots", "2", "--max-new", "6"],
     ["olmoe-1b-7b-smoke: 394,560 params, nonlin=exact", "5 requests through 2 slots: "]),
    (["--arch", "phi3.5-moe-42b", "--lut", "--int8", "--requests", "3", "--slots", "2",
      "--max-new", "4"],
     ["phi3.5-moe-smoke: ", "3 requests through 2 slots: "]),
    (["--arch", "olmoe-1b-7b", "--mode", "batch", "--requests", "3", "--max-new", "4"],
     ["olmoe-1b-7b-smoke: ", "| 12 tokens"]),
])
def test_serve_main_serves_moe_on_the_cpu(capsys, argv, want):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--smoke", *argv])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    for line, start in zip(lines, want):
        assert start in line, (line, start)
