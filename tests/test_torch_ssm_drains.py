"""Greedy drains of the port's SSM and hybrid models against the JAX
engine, on the CPU: mamba2-370m and zamba2-1.2B smoke on the dense cache
(`ServingEngine(paged=False)`, the one serving mode the reference has for
them), token for token, every slot parked at length 0 after the drain:
exact and LUT, `generate()`, int8 weights (`quantize_params_int8`) and
`quant="int8"`, and telemetry on (equal counters, request summaries and
modeled bytes). Five requests of at least 3 prompt tokens through 2
slots, so that slots are reused (a prompt shorter than the conv window
is where the reference's conv tail is short; see
tests/test_torch_mamba2.py); prompts of 1 and 2 tokens drain on the port
as `generate()` runs them one at a time.

JAX is imported inside the `jx` fixture only (tests/ssm_common.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from ssm_common import engine_pair, jx, model  # noqa: F401
from repro_torch.core.salpim import SalPimEngine as TSalPimEngine
from repro_torch.serving import engine as tengine
from repro_torch.serving.config import EngineConfig, GenConfig
from repro_torch.serving.quantize import quantize_params_int8
from repro_torch.serving.telemetry import Telemetry

# Five requests of 3..13 prompt tokens (three lengths, so that the JAX
# engine compiles few admissions) and 4..7 new ones: with 2 slots a
# request finishes while the other decodes, and its slot is reused.
LENS, NEW = (3, 13, 8, 13, 3), (6, 4, 7, 5, 4)


def _prompts(vocab, lens=LENS, seed=8):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, vocab, size=n) for n in lens]


def _drain(eng, prompts, new):
    uids = [eng.submit(p.copy(), max_new_tokens=n) for p, n in zip(prompts, new)]
    done = eng.run(max_steps=400)
    assert sorted(r.uid for r in done) == sorted(uids)
    by = {r.uid: list(r.generated) for r in done}
    return [by[u] for u in uids]


def _same_tokens(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        k = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        assert g == w, f"request {i} differs first at token {k}: {g} != {w}"


def _pair(jx, model, mode="exact", quant="none", q1=False, telemetry=False):
    """The JAX engine and the port's, dense, 2 slots, max_len 24; `q1`:
    both on their package's `quantize_params_int8` weights."""
    _, jcfg, jparams, cfg, tparams = model
    if q1:
        jparams, tparams = jx.quant.quantize_params_int8(jparams), quantize_params_int8(tparams)
    jkw, tkw = {}, {}
    if telemetry:
        clock = [iter(np.arange(1e6) * 1e-3) for _ in range(2)]
        jkw["telemetry"] = jx.tel.Telemetry(enabled=True, clock=lambda: float(next(clock[0])))
        tkw["telemetry"] = Telemetry(enabled=True, clock=lambda: float(next(clock[1])))
    jeng, teng = engine_pair(jx, mode, quant=quant)
    kw = dict(slots=2, max_len=24)
    return (jx.engine.ServingEngine(jparams, jcfg, jeng, jx.EngineConfig(
                gen=jx.GenConfig(stop_on_eos=False), **kw, **jkw)),
            tengine.ServingEngine(tparams, cfg, teng, EngineConfig(
                gen=GenConfig(stop_on_eos=False), **kw, **tkw), device="cpu"))


def _drain_both(jx, model, **kw):
    jeng, eng = _pair(jx, model, **kw)
    prompts = _prompts(model[1].vocab)
    _same_tokens(_drain(eng, prompts, NEW), _drain(jeng, prompts, NEW))
    assert eng.stats()["tokens"] == sum(NEW)
    assert eng.cache.lengths.tolist() == [0, 0]
    return jeng, eng


@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_dense_drain_matches_jax_engine(jx, model, mode):
    """Whole-prompt admissions into the dense cache, the reused slots'
    state replaced whole."""
    _drain_both(jx, model, mode=mode)


def test_telemetry_drain_matches_jax_engine(jx, model):
    """Telemetry on under a fake clock: equal counters, request summaries
    and the roofline's modeled bytes and FLOPs a phase."""
    jeng, eng = _drain_both(jx, model, telemetry=True)
    got, want = eng.telemetry.snapshot(), jeng.telemetry.snapshot()
    assert got["counters"] == want["counters"] and got["requests"] == want["requests"]
    groof, wroof = eng.stats()["roofline"], jeng.stats()["roofline"]
    assert set(groof) == set(wroof) == {"admit", "decode"}
    for phase, row in groof.items():
        ref = wroof[phase]
        assert (row["modeled_bytes"], row["modeled_flops"]) == (
            ref["modeled_bytes"], ref["modeled_flops"]), phase


@pytest.mark.parametrize("weights", ["q1", "int8"])
def test_quantized_drain_matches_jax_engine(jx, model, weights):
    """q1: `quantize_params_int8` weights (in_proj, out_proj, the LM head
    and zamba2's shared block as `QTensor`s); int8: every weight quantized
    on every call (`quant="int8"`)."""
    kw = dict(q1=True) if weights == "q1" else dict(quant="int8")
    _, eng = _drain_both(jx, model, **kw)
    quantized = type(eng.params["blocks"]["mamba"]["in_proj"]).__name__ == "QTensor"
    assert quantized == (weights == "q1")


def test_generate_matches_jax(jx, model):
    """Greedy `generate()` over 3 prompts of 11 tokens, 6 new tokens."""
    _, jcfg, jparams, cfg, tparams = model
    jeng, teng = engine_pair(jx)
    prompts = np.random.RandomState(9).randint(2, jcfg.vocab, size=(3, 11)).astype(np.int32)
    gen = dict(max_new_tokens=6, stop_on_eos=False)
    jtoks, _ = jx.engine.generate(jparams, jx.jnp.asarray(prompts), jcfg, jeng,
                                  jx.GenConfig(**gen))
    ttoks, _ = tengine.generate(tparams, torch.from_numpy(prompts), cfg, teng,
                                GenConfig(**gen), device="cpu")
    _same_tokens(ttoks.tolist(), np.asarray(jtoks).tolist())


def test_short_prompts_drain_as_generate_runs_them(model):
    """Prompts of 1 and 2 tokens (shorter than the conv window) through 2
    dense slots, one reused: each request's tokens are `generate()`'s on
    that prompt alone."""
    _, _, _, cfg, tparams = model
    teng = TSalPimEngine.create()
    eng = tengine.ServingEngine(tparams, cfg, teng, EngineConfig(
        slots=2, max_len=16, gen=GenConfig(stop_on_eos=False)), device="cpu")
    prompts, new = _prompts(cfg.vocab, lens=(1, 2, 1)), (5, 3, 4)
    got = _drain(eng, prompts, new)
    for p, n, g in zip(prompts, new, got):
        want, _ = tengine.generate(tparams, torch.as_tensor(p[None]), cfg, teng,
                                   GenConfig(max_new_tokens=n, stop_on_eos=False),
                                   device="cpu")
        assert g == want[0].tolist()
    assert eng.cache.lengths.tolist() == [0, 0]
