"""The encoder-decoder family of the port (`models/encdec.py`, whisper-large-v3
smoke) against the JAX package, on the CPU, in f32, with the JAX weights
and numpy-seeded frames carried across by `bridge`:

  * the config's fields, the parameter tree's keys and shapes, and
    `param_count` (smoke and published widths) equal the reference's;
  * the cross-attention: `attention_fullseq(kv_x=...)` and
    `attention_decode(update_cache=False)` over a static arena within 1e-5
    of the JAX functions, exact and LUT;
  * `encode`, `prefill` and `decode_step` logits within 1e-4, the self and
    cross arenas within 1e-5, also decoding from a JAX cache carried across
    by `bridge.dense_cache_from_numpy`;
  * a decode step runs 8 linears a decoder layer (the cross block's K/V of
    the new token are not projected) and leaves the cross arena bit for
    bit as the prefill wrote it;
  * greedy `generate(extra_inputs={"frames": ...})` token for token with
    the JAX `generate` (exact, LUT, int8 weights, `quant="int8"`);
  * the refusals raise where the reference's do: `ServingEngine` (paged or
    dense; the reference's dense admission prefills without frames),
    `prefill_chunk`, `verify_tokens`, `init_paged_cache`, and
    `launch/serve.py --arch whisper-large-v3`.
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
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.serving import engine as jengine
from repro.serving import quantize as jquant
from repro.serving.config import GenConfig as JaxGenConfig
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.salpim import SalPimConfig as TSalPimConfig
from repro_torch.core.salpim import SalPimEngine as TSalPimEngine
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import api, encdec
from repro_torch.models import attention as tattn
from repro_torch.models.config import ModelConfig
from repro_torch.serving import engine as tengine
from repro_torch.serving.config import EngineConfig, GenConfig
from repro_torch.serving.quantize import quantize_params_int8

NAME = "whisper_large_v3"
LOGIT_TOL, MODULE_TOL = 1e-4, 1e-5


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _engines(mode="exact", **kw):
    return (SalPimEngine.create(SalPimConfig(nonlinear_mode=mode, **kw)),
            TSalPimEngine.create(TSalPimConfig(nonlinear_mode=mode, **kw)))


@pytest.fixture(scope="module")
def model():
    """(JAX config, JAX params, port config, the same params)."""
    jcfg, cfg = jax_get_config(NAME, smoke=True), get_config(NAME, smoke=True)
    jparams = jax_api.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, tparams


def _frames(cfg, B, seed=0):
    return np.random.RandomState(seed).randn(B, cfg.enc_seq, cfg.d_model).astype(np.float32)


def _batch(cfg, B, S, seed=0):
    toks = np.random.RandomState(seed + 100).randint(2, cfg.vocab, size=(B, S)).astype(np.int32)
    return toks, _frames(cfg, B, seed)


# ---------------------------------------------------------------------------
# Config and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
def test_config_and_param_count_match_jax(smoke):
    """Every field of the port's config equals the JAX config's (the new
    n_enc_layers and enc_seq among them), under both names; param_count
    is the reference's formula (enc_seq x d counted, pos_embed not)."""
    got, want = get_config(NAME, smoke=smoke), jax_get_config(NAME, smoke=smoke)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    if not smoke:
        assert get_config("whisper-large-v3") == got
        assert got.param_count() == 1_603_278_080


def test_init_params_mirror_jax_tree(model):
    """The tree's keys and shapes are the reference's; its tensors hold
    param_count plus what the reference's formula leaves out: the
    decoder's positions, the LayerNorm shifts and the encoder's final
    norm."""
    jcfg, jparams, cfg, _ = model
    mine = api.init_params(cfg, seed=1, device="cpu")
    jflat = {jax.tree_util.keystr(k): v.shape
             for k, v in jax.tree_util.tree_leaves_with_path(jparams)}
    tflat = {jax.tree_util.keystr(k): tuple(v.shape)
             for k, v in jax.tree_util.tree_leaves_with_path(mine)}
    assert tflat == jflat
    left_out = sum(int(np.prod(s)) for k, s in tflat.items()
                   if k in ("['pos_embed']", "['enc_norm']['g']") or k.endswith("['b']"))
    assert sum(int(np.prod(s)) for s in tflat.values()) == cfg.param_count() + left_out
    assert mine["embed"].dtype == torch.float32 and mine["enc_pos"].shape == (cfg.enc_seq,
                                                                              cfg.d_model)


# ---------------------------------------------------------------------------
# Cross-attention
# ---------------------------------------------------------------------------

def _attn_params(cfg, seed):
    rng = np.random.RandomState(seed)
    d, n = cfg.d_model, cfg.n_heads * cfg.head_dim
    p = {"wq": rng.randn(n, d) * d ** -0.5, "wk": rng.randn(n, d) * d ** -0.5,
         "wv": rng.randn(n, d) * d ** -0.5, "wo": rng.randn(d, n) * n ** -0.5,
         "bq": rng.randn(n) * 0.1, "bk": rng.randn(n) * 0.1, "bv": rng.randn(n) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_cross_attention_fullseq_matches_jax(model, mode):
    """Queries of a 7-token prompt against K/V projected from a 16-frame
    encoder output, not causal: the output and the returned K/V (the
    cross arena's layout) within 1e-5."""
    jcfg, _, cfg, _ = model
    jp, tp = _attn_params(cfg, 3)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 7, cfg.d_model).astype(np.float32)
    enc = rng.randn(2, cfg.enc_seq, cfg.d_model).astype(np.float32)
    jeng, teng = _engines(mode)
    jout, (jk, jv) = jattn.attention_fullseq(jp, jnp.asarray(x), jcfg, jeng, cos=None, sin=None,
                                             causal=False, kv_x=jnp.asarray(enc),
                                             return_kv=True)
    tout, (tk, tv) = tattn.attention_fullseq(tp, torch.from_numpy(x), cfg, teng, causal=False,
                                             kv_x=torch.from_numpy(enc), return_kv=True)
    assert tuple(tk.shape) == (2, cfg.n_kv_heads, cfg.enc_seq, cfg.head_dim)
    _close(tout, jout, MODULE_TOL)
    _close(tk, jk, MODULE_TOL)
    _close(tv, jv, MODULE_TOL)


@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_cross_attention_decode_matches_jax(model, mode):
    """One decode step over a static arena of enc_seq keys
    (update_cache=False): within 1e-5 of the JAX function, and the arena
    is not written."""
    jcfg, _, cfg, _ = model
    jp, tp = _attn_params(cfg, 5)
    rng = np.random.RandomState(6)
    B, shape = 3, (3, cfg.n_kv_heads, cfg.enc_seq, cfg.head_dim)
    x = rng.randn(B, cfg.d_model).astype(np.float32)
    ck, cv = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    lengths = np.full((B,), cfg.enc_seq, np.int32)
    jeng, teng = _engines(mode)
    jout, _, _ = jattn.attention_decode(jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                        jnp.asarray(lengths), jcfg, jeng, cos=None, sin=None,
                                        update_cache=False)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tout, *_ = tattn.attention_decode(tp, torch.from_numpy(x), tk, tv,
                                      torch.from_numpy(lengths), cfg, teng, update_cache=False)
    _close(tout, jout, MODULE_TOL)
    assert np.array_equal(tk.numpy(), ck) and np.array_equal(tv.numpy(), cv)


# ---------------------------------------------------------------------------
# The model's entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_encode_matches_jax(model, mode):
    jcfg, jparams, cfg, tparams = model
    jeng, teng = _engines(mode)
    frames = _frames(cfg, 2, seed=2)
    want = jencdec.encode(jparams, jnp.asarray(frames), jcfg, jeng)
    got = encdec.encode(tparams, torch.from_numpy(frames), cfg, teng)
    _close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_prefill_then_decode_match_jax(model, mode):
    """A prefill of 2 x 37 tokens (past one query chunk of 32, not a
    multiple of it) over 16 frames, then five decode steps: logits within
    1e-4, the self and cross arenas within 1e-5."""
    jcfg, jparams, cfg, tparams = model
    jeng, teng = _engines(mode)
    toks, frames = _batch(cfg, 2, 37, seed=1)
    jlog, jcache = jax_api.prefill(jparams, {"tokens": jnp.asarray(toks),
                                             "frames": jnp.asarray(frames)}, jcfg, jeng,
                                   max_len=44)
    tlog, tcache = api.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                         "frames": torch.from_numpy(frames)}, cfg, teng,
                               max_len=44)
    _close(tlog, jlog, LOGIT_TOL)
    _close(tcache.cross_k, jcache.cross_k, MODULE_TOL)
    _close(tcache.cross_v, jcache.cross_v, MODULE_TOL)
    _close(tcache.k, jcache.k, MODULE_TOL)
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    for _ in range(5):
        jlog, jcache = jax_api.decode_step(jparams, jnp.asarray(tok), jcache, jcfg, jeng)
        tlog, tcache = api.decode_step(tparams, torch.from_numpy(tok), tcache, cfg, teng)
        _close(tlog, jlog, LOGIT_TOL)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    assert tcache.lengths.tolist() == np.asarray(jcache.lengths).tolist() == [42, 42]
    _close(tcache.v, jcache.v, MODULE_TOL)


@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_decode_from_jax_cache_matches_jax(model, mode):
    """The JAX prefill's cache (self and cross arenas) carried across by
    `bridge.dense_cache_from_numpy`: the port's decode steps on it within
    1e-4 of the JAX decode steps."""
    jcfg, jparams, cfg, tparams = model
    jeng, teng = _engines(mode)
    toks, frames = _batch(cfg, 3, 9, seed=3)
    jlog, jcache = jax_api.prefill(jparams, {"tokens": jnp.asarray(toks),
                                             "frames": jnp.asarray(frames)}, jcfg, jeng,
                                   max_len=16)
    tcache = bridge.dense_cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    assert tcache.cross_k is not None and tcache.k_scale is None
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    for _ in range(4):
        jlog, jcache = jax_api.decode_step(jparams, jnp.asarray(tok), jcache, jcfg, jeng)
        tlog, tcache = api.decode_step(tparams, torch.from_numpy(tok), tcache, cfg, teng)
        _close(tlog, jlog, LOGIT_TOL)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)


def test_decode_runs_eight_linears_a_layer_and_keeps_the_cross_arena(model, monkeypatch):
    """An admission runs 6 linears an encoder layer, 10 a decoder layer and
    the LM head; a decode step 8 a decoder layer (self q, k, v, o; cross
    q, o; w_up; w_down) and the LM head. The cross arenas after three
    decode steps are the prefill's bit for bit."""
    _, _, cfg, tparams = model
    calls = []
    linear = ops.pim_linear

    def counted(x, *a, **k):
        calls.append(x.shape[0])
        return linear(x, *a, **k)

    monkeypatch.setattr(ops, "pim_linear", counted)
    teng = TSalPimEngine.create()
    toks, frames = _batch(cfg, 2, 5)
    logits, cache = api.prefill(tparams, {"tokens": torch.from_numpy(toks),
                                          "frames": torch.from_numpy(frames)}, cfg, teng,
                                max_len=9)
    assert len(calls) == 6 * cfg.n_enc_layers + 10 * cfg.n_layers + 1
    xk, xv = cache.cross_k.clone(), cache.cross_v.clone()
    tok = logits.argmax(-1).to(torch.int32)
    for _ in range(3):
        calls.clear()
        logits, cache = api.decode_step(tparams, tok, cache, cfg, teng)
        assert calls == [2] * (8 * cfg.n_layers + 1)
        tok = logits.argmax(-1).to(torch.int32)
    assert torch.equal(cache.cross_k, xk) and torch.equal(cache.cross_v, xv)


# ---------------------------------------------------------------------------
# generate()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["exact", "lut", "q1", "int8"])
def test_generate_matches_jax(model, route):
    """Greedy generate() of 3 prompts of 11 tokens over their frames, 8 new
    tokens, token for token with the JAX generate: exact and LUT, int8
    weights (`quantize_params_int8` on both sides) and quant="int8"."""
    jcfg, jparams, cfg, tparams = model
    mode = "lut" if route == "lut" else "exact"
    jeng, teng = _engines(mode, quant="int8" if route == "int8" else "none")
    if route == "q1":
        jparams, tparams = jquant.quantize_params_int8(jparams), quantize_params_int8(tparams)
    toks, frames = _batch(cfg, 3, 11, seed=7)
    gen = dict(max_new_tokens=8, stop_on_eos=False)
    jtoks, _ = jengine.generate(jparams, jnp.asarray(toks), jcfg, jeng, JaxGenConfig(**gen),
                                extra_inputs={"frames": jnp.asarray(frames)})
    ttoks, stats = tengine.generate(tparams, torch.from_numpy(toks), cfg, teng,
                                    GenConfig(**gen), extra_inputs={"frames": frames},
                                    device="cpu")
    assert ttoks.tolist() == np.asarray(jtoks).tolist()
    assert stats["tokens"] == 3 * 8


def test_generate_needs_frames(model):
    """Without frames the prefill has no encoder input: a KeyError, as in
    the reference's prefill."""
    _, _, cfg, tparams = model
    toks, _ = _batch(cfg, 1, 4)
    with pytest.raises(KeyError, match="frames"):
        tengine.generate(tparams, torch.from_numpy(toks), cfg, TSalPimEngine.create(),
                         GenConfig(max_new_tokens=2), device="cpu")


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [True, False])
def test_serving_engine_refuses_encdec(model, paged):
    _, _, cfg, tparams = model
    with pytest.raises(ValueError, match=r"generate\(.*extra_inputs=\{\"frames\""):
        tengine.ServingEngine(tparams, cfg, TSalPimEngine.create(),
                              EngineConfig(slots=2, max_len=32, paged=paged), device="cpu")


def test_paged_entry_points_raise_the_references_errors(model):
    """prefill_chunk, verify_tokens and init_paged_cache raise the JAX
    package's ValueError with its message; a decode step on a paged cache
    raises too."""
    jcfg, jparams, cfg, tparams = model
    jeng, teng = _engines()
    toks = np.zeros((1, 4), np.int32)
    table, start = np.zeros((1, 2), np.int32), np.zeros((1,), np.int32)
    pools = np.zeros((cfg.n_layers, 3, cfg.n_kv_heads, 4, cfg.head_dim), np.float32)
    for fn_name in ("prefill_chunk", "verify_tokens"):
        with pytest.raises(ValueError) as want:
            getattr(jax_api, fn_name)(jparams, jnp.asarray(toks), jnp.asarray(table),
                                      jnp.asarray(start), jnp.asarray(pools),
                                      jnp.asarray(pools), jcfg, jeng)
        with pytest.raises(ValueError) as got:
            getattr(api, fn_name)(tparams, torch.from_numpy(toks), torch.from_numpy(table),
                                  torch.from_numpy(start), torch.from_numpy(pools),
                                  torch.from_numpy(pools), cfg, teng)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_api.init_paged_cache(jcfg, 2, 8, 4, 4)
    with pytest.raises(ValueError) as got:
        api.init_paged_cache(cfg, 2, 8, 4, 4, device="cpu")
    assert str(got.value) == str(want.value)
    paged = api.init_paged_cache(get_config("gpt2_medium", smoke=True), 1, 4, 4, 2,
                                 device="cpu")
    with pytest.raises(ValueError, match="paged cache"):
        api.decode_step(tparams, torch.zeros(1, dtype=torch.int32), paged, cfg, teng)


def test_serve_main_refuses_whisper(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", "--arch", "whisper-large-v3"])
    assert exc.value.code == 2
    assert tengine.ENCDEC_REFUSAL in capsys.readouterr().err
