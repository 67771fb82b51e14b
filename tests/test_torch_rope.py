"""RoPE and the dense RoPE models of the port against the JAX package.

  * `models/rope.py`: `rope_freqs`, `rope_cos_sin`, `mrope_cos_sin` and
    `apply_rope` (f32 and bf16) against `repro.models.rope` on the same
    numpy-seeded inputs; text-only M-RoPE equals RoPE; `transformer._rope`
    with M-RoPE (positions broadcast to the three streams) within 1e-6 of
    the JAX `_rope` at the dense prefill's, a chunk's and a decode step's
    positions;
  * the five RoPE smoke configs (`qwen2_1_5b`, `gemma2_2b`,
    `h2o_danube3_4b`, `nemotron_4_340b` and `qwen2_vl_2b`, the VLM's text
    path on M-RoPE), the JAX weights carried across
    by `bridge.params_from_numpy`: the registry's fields equal the JAX
    package's; the parameter tree has the JAX keys (no `pos_embed`); the
    logits of a paged chunk prefill (two chunks) and of the dense prefill,
    and of the decode steps after each, within 1e-4 of the JAX functions;
    greedy drains token for token with the JAX `ServingEngine`, paged
    (exact and LUT, whole and chunked prompts; qwen2 also on int8 and int4
    pools and with `kv_splits`) and dense (`generate()` and
    `ServingEngine(paged=False)`), on prompts long enough that the smoke
    sliding window of 16 cuts keys;
  * qwen2-vl-2b smoke on the paged engine's other paths (int8 and int4
    pools, the KV split, `ngram` speculation with prefix sharing, the SLO
    scheduler, telemetry) token for token with the JAX engine;
  * `_check_supported` serves every family of the JAX registry, refuses
    an unknown one, and refuses the paged entry points for the
    encoder-decoder family (tests/test_torch_encdec.py), and an MoE
    config's expert-parallel `moe_impl="shardmap"` meets the reference's
    mesh validation word for word.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.salpim import SalPimConfig, SalPimEngine
from repro.models import api as jax_api
from repro.models import rope as jrope
from repro.models import transformer as jtf
from repro.serving import scheduler as jsched
from repro.serving import telemetry as jtel
from repro.serving.speculative import SpecConfig as JaxSpecConfig
from repro.serving import engine as jengine
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.config import GenConfig as JaxGenConfig
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.salpim import SalPimConfig as TSalPimConfig
from repro_torch.core.salpim import SalPimEngine as TSalPimEngine
from repro_torch.models import api, rope, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serving import engine as tengine
from repro_torch.serving.config import EngineConfig, GenConfig
from repro_torch.serving.scheduler import SloScheduler
from repro_torch.serving.speculative import SpecConfig
from repro_torch.serving.telemetry import Telemetry

ROPE_MODELS = ["qwen2_1_5b", "gemma2_2b", "h2o_danube3_4b", "nemotron_4_340b", "qwen2_vl_2b"]
LOGIT_TOL = 1e-4
PAGE, N_PAGES, MAX_PAGES = 4, 24, 10


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# models/rope.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim,theta", [(16, 1e6), (120, 5e5), (128, 1e6),
                                            (192, 1e4), (256, 1e4)])
def test_rope_freqs_and_cos_sin_match_jax(head_dim, theta):
    """Frequencies within 1e-6 relative (each is one f32 pow, and the two
    libraries' pows may differ in the last bit). cos/sin over positions up
    to 131071: where the frequencies agree, within 2e-6; where they differ
    the f32 angle pos * freq may differ by that bit times pos and one
    rounding of the angle, and the value is held within that much + 2e-6;
    over the smoke configs' positions (< 256) within 1e-6."""
    tf, jf = rope.rope_freqs(head_dim, theta).numpy(), np.asarray(jrope.rope_freqs(head_dim,
                                                                                   theta))
    np.testing.assert_allclose(tf, jf, rtol=1e-6)
    pos = np.random.RandomState(head_dim).randint(0, 131072, size=(3, 37)).astype(np.int32)
    pos[0, :5] = [0, 1, 2, 4095, 4096]
    tc, ts = rope.rope_cos_sin(torch.from_numpy(pos), head_dim, theta)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), head_dim, theta)
    assert tc.dtype == torch.float32 and tuple(tc.shape) == (3, 37, head_dim // 2)
    ang = pos[..., None].astype(np.float32) * jf
    limit = np.where(tf == jf, 0.0, pos[..., None] * np.abs(tf.astype(np.float64) - jf)
                     + np.spacing(ang)) + 2e-6
    assert (np.abs(tc.numpy() - np.asarray(jc)) <= limit).all()
    assert (np.abs(ts.numpy() - np.asarray(js)) <= limit).all()
    tc, ts = rope.rope_cos_sin(torch.arange(256), head_dim, theta)
    jc, js = jrope.rope_cos_sin(jnp.arange(256), head_dim, theta)
    _close(tc, jc, 1e-6)
    _close(ts, js, 1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("lead", [(2, 9), (9,), (3, 1)])
def test_apply_rope_matches_jax(dtype, tol, lead):
    """x (..., S, H, D) rotated by cos/sin (..., S, D/2) cast to x's dtype
    first: f32 within 1e-6, bf16 within one bf16 rounding (1e-2) of the
    JAX function on the same bf16 inputs."""
    rng = np.random.RandomState(len(lead))
    D, H = 16, 3
    x = rng.randn(*lead, H, D).astype(np.float32)
    pos = rng.randint(0, 4096, size=lead).astype(np.int32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), D, 1e4)
    tc, ts = rope.rope_cos_sin(torch.from_numpy(pos), D, 1e4)
    jx = jnp.asarray(x).astype(dtype)
    tx = bridge.tensor_from_numpy(np.asarray(jx), device="cpu")
    got = rope.apply_rope(tx, tc, ts)
    want = jrope.apply_rope(jx, jc, js)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == x.shape
    _close(got, np.asarray(want.astype(jnp.float32)), tol)


def test_mrope_matches_jax_and_text_mrope_equals_rope():
    """M-RoPE on distinct streams against the JAX function; on three equal
    streams (text) it is RoPE exactly."""
    rng = np.random.RandomState(3)
    pos3 = rng.randint(0, 1000, size=(3, 2, 13)).astype(np.int32)
    for sections, hd in (((4, 6, 6), 32), ((16, 24, 24), 128)):
        tc, ts = rope.mrope_cos_sin(torch.from_numpy(pos3), hd, 1e6, sections)
        jc, js = jrope.mrope_cos_sin(jnp.asarray(pos3), hd, 1e6, sections)
        _close(tc, jc, 1e-5)
        _close(ts, js, 1e-5)
        pos = torch.arange(13)
        c1, s1 = rope.rope_cos_sin(pos, hd, 1e6)
        c2, s2 = rope.mrope_cos_sin(pos[None].expand(3, 13), hd, 1e6, sections)
        assert torch.equal(c1, c2) and torch.equal(s1, s2)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("shape", [(40,), (3,), (2, 9)])
def test_mrope_rope_helper_matches_jax(smoke, shape):
    """`transformer._rope` of qwen2-vl-2b (M-RoPE) at the positions of a
    dense prefill (S,), a decode step (B,) and a paged chunk (B, S):
    cos/sin within 1e-6 of the JAX `_rope`, which broadcasts the text
    positions to the three streams."""
    cfg, jcfg = get_config("qwen2_vl_2b", smoke=smoke), jax_get_config("qwen2_vl_2b",
                                                                      smoke=smoke)
    pos = np.random.RandomState(len(shape)).randint(0, 4000, size=shape).astype(np.int32)
    tc, ts = transformer._rope(cfg, torch.from_numpy(pos))
    jc, js = jtf._rope(jcfg, jnp.asarray(pos))
    assert tuple(tc.shape) == (*shape, cfg.head_dim // 2)
    _close(tc, jc, 1e-6)
    _close(ts, js, 1e-6)


# ---------------------------------------------------------------------------
# The RoPE models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ROPE_MODELS)
def model(request):
    name = request.param
    jcfg = jax_get_config(name, smoke=True)
    jparams = jax_api.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return name, jcfg, jparams, get_config(name, smoke=True), tparams


def _engines(mode, **kw):
    return (SalPimEngine.create(SalPimConfig(nonlinear_mode=mode, **kw)),
            TSalPimEngine.create(TSalPimConfig(nonlinear_mode=mode, **kw)))


@pytest.mark.parametrize("name", ROPE_MODELS + ["gpt2_medium"])
@pytest.mark.parametrize("smoke", [False, True])
def test_registry_matches_jax_configs(name, smoke):
    """Every field of the port's config equals the JAX config's, under the
    module name and the JAX package's alias."""
    got, want = get_config(name, smoke=smoke), jax_get_config(name, smoke=smoke)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    alias = want.name.removesuffix("-smoke")
    if not smoke:
        assert get_config(alias) == got


def test_init_params_mirror_jax_tree(model):
    """RoPE models carry no `pos_embed`: the port's tree has the JAX keys
    and shapes."""
    _, _, jparams, cfg, _ = model
    mine = api.init_params(cfg, seed=1, device="cpu")
    jflat = {jax.tree_util.keystr(k): v.shape
             for k, v in jax.tree_util.tree_leaves_with_path(jparams)}
    tflat = {jax.tree_util.keystr(k): tuple(v.shape)
             for k, v in jax.tree_util.tree_leaves_with_path(mine)}
    assert tflat == jflat and "pos_embed" not in mine


@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_paged_chunks_then_decode_match_jax(model, mode):
    """Two chunks (positions 0..7, 8..20) of a paged prefill into scattered
    pages, then four decode steps: logits within 1e-4 of the JAX
    functions', the pools within 1e-5."""
    _, jcfg, jparams, cfg, tparams = model
    jeng, teng = _engines(mode)
    rng = np.random.RandomState(11)
    B, S = 2, 21
    prompts = rng.randint(2, jcfg.vocab, size=(B, S)).astype(np.int32)
    rows = np.asarray([[3, 7, 1, 9, 12, 14, 16, 0, 0, 0],
                       [2, 11, 5, 4, 13, 15, 17, 0, 0, 0]], np.int32)
    jcache = jax_api.init_paged_cache(jcfg, B, N_PAGES, PAGE, MAX_PAGES)
    tcache = api.init_paged_cache(cfg, B, N_PAGES, PAGE, MAX_PAGES, device="cpu")
    jkp, jvp = jcache.k_pages, jcache.v_pages
    for a, b in ((0, 8), (8, S)):
        st = np.full((B,), a, np.int32)
        jlog, jkp, jvp = jax_api.prefill_chunk(
            jparams, jnp.asarray(prompts[:, a:b]), jnp.asarray(rows), jnp.asarray(st),
            jkp, jvp, jcfg, jeng)
        tlog, _, _ = api.prefill_chunk(
            tparams, torch.from_numpy(prompts[:, a:b]), torch.from_numpy(rows),
            torch.from_numpy(st), tcache.k_pages, tcache.v_pages, cfg, teng)
        _close(tlog, jlog, LOGIT_TOL)
    _close(tcache.k_pages, jkp, 1e-5)
    _close(tcache.v_pages, jvp, 1e-5)
    jcache = dataclasses.replace(jcache, lengths=jnp.full((B,), S, jnp.int32),
                                 block_tables=jnp.asarray(rows), k_pages=jkp, v_pages=jvp)
    tcache.lengths.fill_(S)
    tcache.block_tables.copy_(torch.from_numpy(rows))
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    for _ in range(4):
        jlog, jcache = jax_api.decode_step(jparams, jnp.asarray(tok), jcache, jcfg, jeng)
        tlog, tcache = api.decode_step(tparams, torch.from_numpy(tok), tcache, cfg, teng)
        _close(tlog, jlog, LOGIT_TOL)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    _close(tcache.k_pages, jcache.k_pages, 1e-5)


@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_dense_prefill_then_decode_match_jax(model, mode):
    """The dense prefill at S = 40 (past the window of 16 and one query
    chunk of 32: S is not a multiple of it) and four decode steps over the
    arena: logits within 1e-4, the arena within 1e-5."""
    _, jcfg, jparams, cfg, tparams = model
    jeng, teng = _engines(mode)
    prompts = np.random.RandomState(5).randint(2, jcfg.vocab, size=(2, 40)).astype(np.int32)
    jlog, jcache = jax_api.prefill(jparams, {"tokens": jnp.asarray(prompts)}, jcfg, jeng,
                                   max_len=48)
    tlog, tcache = api.prefill(tparams, {"tokens": torch.from_numpy(prompts)}, cfg, teng,
                               max_len=48)
    _close(tlog, jlog, LOGIT_TOL)
    _close(tcache.k, jcache.k, 1e-5)
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    for _ in range(4):
        jlog, jcache = jax_api.decode_step(jparams, jnp.asarray(tok), jcache, jcfg, jeng)
        tlog, tcache = api.decode_step(tparams, torch.from_numpy(tok), tcache, cfg, teng)
        _close(tlog, jlog, LOGIT_TOL)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    _close(tcache.v, jcache.v, 1e-5)


# Five requests; prompts of up to 23 tokens plus up to 9 new ones pass the
# smoke sliding window of 16, so gemma2's local layers and danube's every
# layer cut keys in prefill and in decode.
LENS, NEW = (5, 11, 3, 23, 17), (6, 4, 8, 9, 7)


def _drain(eng, prompts, new):
    uids = [eng.submit(p.copy(), max_new_tokens=n) for p, n in zip(prompts, new)]
    done = eng.run(max_steps=600)
    assert sorted(r.uid for r in done) == sorted(uids)
    by = {r.uid: list(r.generated) for r in done}
    return [by[u] for u in uids]


def _same_tokens(got, want):
    """Token for token, naming the first request and step that differ."""
    for i, (g, w) in enumerate(zip(got, want)):
        k = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        assert g == w, f"request {i} differs first at token {k}: {g} != {w}"


def _drain_both(model, mode="exact", jkw=None, tkw=None, **kw):
    """The same requests through the JAX and the port's ServingEngine (2
    slots, max_len 40): the same greedy tokens, every page back. `jkw` and
    `tkw` go to one side's EngineConfig alone (each package's own
    speculative, scheduler or telemetry object)."""
    name, jcfg, jparams, cfg, tparams = model
    rng = np.random.RandomState(7)
    prompts = [rng.randint(2, jcfg.vocab, size=n) for n in LENS]
    kw = dict(dict(slots=2, max_len=40), **kw)
    if kw.get("paged"):
        kw = dict(dict(page_size=PAGE, prefix_sharing=False), **kw)
    jeng, teng = _engines(mode)
    want = _drain(jengine.ServingEngine(
        jparams, jcfg, jeng, JaxEngineConfig(gen=JaxGenConfig(stop_on_eos=False), **kw,
                                             **(jkw or {}))),
        prompts, NEW)
    eng = tengine.ServingEngine(tparams, cfg, teng,
                                EngineConfig(gen=GenConfig(stop_on_eos=False), **kw,
                                             **(tkw or {})),
                                device="cpu")
    _same_tokens(_drain(eng, prompts, NEW), want)
    assert eng.stats()["tokens"] == sum(NEW)
    if eng.paged:
        assert eng.allocator.used_pages == 0
    else:
        assert eng.cache.lengths.tolist() == [0, 0]
    return eng


@pytest.mark.parametrize("mode,chunk", [("exact", None), ("exact", 8), ("lut", 8)])
def test_paged_drain_matches_jax_engine(model, mode, chunk):
    _drain_both(model, mode, paged=True, prefill_chunk_tokens=chunk)


@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_dense_engine_drain_matches_jax(model, mode):
    """`ServingEngine(paged=False)`: whole-prompt admissions into the arena."""
    _drain_both(model, mode)


def test_generate_matches_jax(model):
    """Greedy `generate()` over a batch of 25-token prompts, 9 new tokens."""
    _, jcfg, jparams, cfg, tparams = model
    jeng, teng = _engines("exact")
    prompts = np.random.RandomState(9).randint(2, jcfg.vocab, size=(3, 25)).astype(np.int32)
    gen = dict(max_new_tokens=9, stop_on_eos=False)
    jtoks, _ = jengine.generate(jparams, jnp.asarray(prompts), jcfg, jeng, JaxGenConfig(**gen))
    ttoks, _ = tengine.generate(tparams, torch.from_numpy(prompts), cfg, teng,
                                GenConfig(**gen), device="cpu")
    _same_tokens(ttoks.tolist(), np.asarray(jtoks).tolist())


@pytest.fixture(scope="module")
def qwen2():
    jcfg = jax_get_config("qwen2_1_5b", smoke=True)
    jparams = jax_api.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return "qwen2_1_5b", jcfg, jparams, get_config("qwen2_1_5b", smoke=True), tparams


@pytest.mark.parametrize("kv,scales", [("int8", "float32"), ("int4", "bfloat16")])
def test_qwen2_quantized_pool_drain_matches_jax_engine(qwen2, kv, scales):
    eng = _drain_both(qwen2, paged=True, prefill_chunk_tokens=8, kv_cache_dtype=kv,
                      kv_scale_dtype=scales)
    assert eng.cache.quantized


def test_qwen2_split_decode_drain_matches_jax_engine(qwen2):
    """kv_splits=4 at max_len 1024, page 16: every decode step of both
    engines takes the KV-split path over g = 2 query heads a kv head."""
    eng = _drain_both(qwen2, paged=True, max_len=1024, page_size=16, kv_splits=4,
                      prefill_chunk_tokens=8)
    assert eng.engine.config.kv_splits == 4 and eng.max_pages * 16 >= 1024


@pytest.fixture(scope="module")
def qwen2_vl():
    jcfg = jax_get_config("qwen2_vl_2b", smoke=True)
    jparams = jax_api.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return "qwen2_vl_2b", jcfg, jparams, get_config("qwen2_vl_2b", smoke=True), tparams


def _telemetry_pair():
    clock = [iter(np.arange(1e6) * 1e-3) for _ in range(2)]
    return (dict(telemetry=jtel.Telemetry(enabled=True, clock=lambda: float(next(clock[0])))),
            dict(telemetry=Telemetry(enabled=True, clock=lambda: float(next(clock[1])))))


# qwen2-vl-2b on the paged engine's other paths: (nonlinear mode, the
# options both engines take, a function of no arguments giving each side's
# own objects (JAX's, the port's)).
VL_PATHS = {
    "int8/f32 pools, chunks of 8": ("exact", dict(kv_cache_dtype="int8",
                                                  prefill_chunk_tokens=8), None),
    "int4/bf16 pools, lut": ("lut", dict(kv_cache_dtype="int4", kv_scale_dtype="bfloat16"),
                             None),
    "kv_splits=4 at max_len 1024": ("exact", dict(max_len=1024, page_size=16, kv_splits=4,
                                                  prefill_chunk_tokens=8), None),
    "ngram k=4 with sharing": ("exact", dict(prefix_sharing=True, prefill_chunk_tokens=8),
                               lambda: (dict(speculative=JaxSpecConfig(mode="ngram", k=4)),
                                        dict(speculative=SpecConfig(mode="ngram", k=4)))),
    "slo on 12 pages": ("exact", dict(num_pages=12, prefill_chunk_tokens=8),
                        lambda: (dict(scheduler=jsched.SloScheduler()),
                                 dict(scheduler=SloScheduler()))),
    "telemetry": ("exact", dict(prefill_chunk_tokens=8), _telemetry_pair),
}


@pytest.mark.parametrize("path", list(VL_PATHS))
def test_qwen2_vl_serving_paths_match_jax_engine(qwen2_vl, path):
    """The VLM's text path on the paged engine's paths beyond those of the
    ROPE_MODELS drains: token for token with the JAX engine, every page
    back (telemetry: the same counters)."""
    mode, kw, sides = VL_PATHS[path]
    jkw, tkw = sides() if sides is not None else (None, None)
    eng = _drain_both(qwen2_vl, mode, jkw=jkw, tkw=tkw, paged=True, **kw)
    if "telemetry" in path:
        got = tkw["telemetry"].snapshot()["counters"]
        want = jkw["telemetry"].snapshot()["counters"]
        assert got == want and got
    if "kv_cache_dtype" in kw:
        assert eng.cache.quantized


@pytest.mark.parametrize("name", ["whisper_large_v3", "qwen2_vl_2b"])
def test_check_supported_refuses_other_families(name):
    """The port's config built from the JAX config's fields it carries:
    served (the encoder-decoder family and M-RoPE, the VLM's text path,
    were the last two families refused); a family the JAX registry does
    not have is refused, and the encoder-decoder family is refused on the
    paged entry points, as the reference refuses it there."""
    jcfg = jax_get_config(name, smoke=True)
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ModelConfig)})
    assert cfg == get_config(name, smoke=True)
    transformer._check_supported(cfg)
    assert api.init_params(cfg, device="cpu")["embed"].shape == (cfg.vocab, cfg.d_model)
    with pytest.raises(ValueError, match="unknown model family"):
        transformer._check_supported(dataclasses.replace(cfg, family="vlm"))
    if cfg.family == "encdec":
        with pytest.raises(ValueError, match="paged prefill unsupported"):
            transformer._check_supported(cfg, paged="paged prefill")
    else:
        transformer._check_supported(cfg, paged="paged prefill")


@pytest.mark.parametrize("paged", [True, False])
def test_moe_shardmap_with_mesh_is_refused(paged):
    """An MoE config asking for the expert-parallel dispatch serves without
    a mesh (the grouped dispatch, as the reference without one); with a
    mesh the reference's validation applies, word for word: the dense
    engine refuses it, and so does the paged one when the "model" extent
    (3) does not divide olmoe's KV heads. (The expert-parallel dispatch on
    a mesh: tests/test_torch_mesh.py.)"""
    cfg = dataclasses.replace(get_config("olmoe_1b_7b", smoke=True), moe_impl="shardmap")
    jcfg = dataclasses.replace(jax_get_config("olmoe_1b_7b", smoke=True), moe_impl="shardmap")
    params = api.init_params(cfg, device="cpu")
    sal = TSalPimEngine.create()
    tengine.ServingEngine(params, cfg, sal, EngineConfig(slots=2, max_len=32, paged=paged),
                          device="cpu")
    n = 3 if paged else 2

    class ModelAxis:
        mesh_dim_names = ("model",)

        def size(self, dim=0):
            return n

    with pytest.raises(ValueError) as jerr:
        JaxEngineConfig(slots=2, max_len=32, paged=paged, mesh=jax.sharding.Mesh(
            np.asarray(jax.devices()[:n]), ("model",))).validate(jcfg)
    with pytest.raises(ValueError) as terr:
        tengine.ServingEngine(params, cfg, sal, EngineConfig(slots=2, max_len=32, paged=paged,
                                                             mesh=ModelAxis()), device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert ("must divide" if paged else "requires paged=True") in str(terr.value)


@pytest.mark.parametrize("mode", ["exact", "lut"])
@pytest.mark.parametrize("act", ["silu", "gelu", "squared_relu"])
def test_linear_activation_matches_jax_engine(mode, act):
    """`SalPimEngine.linear(..., act=)` against the JAX engine's: the LUT
    bank has no squared-ReLU table (nemotron's MLP), so in LUT mode that
    activation runs exactly after the GEMV, as the JAX engine runs it;
    SiLU and GELU take their tables (the exact SiLU runs after the GEMV)."""
    rng = np.random.RandomState(3)
    x = rng.randn(5, 48).astype(np.float32)
    w = (rng.randn(40, 48) * 48 ** -0.5).astype(np.float32)
    b = rng.randn(40).astype(np.float32)
    jeng, teng = _engines(mode)
    want = jeng.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act=act)
    got = teng.linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), act=act)
    _close(got, want, 1e-5)
