"""Greedy drains of the port's MoE models against the JAX engine, on the
CPU: olmoe-1B-7B and phi-3.5-MoE smoke at their own cap factor (64) and
at the published 1.25, token for token, every page back: paged with
8-token chunks (exact with telemetry on: equal counters, request
summaries and modeled bytes; LUT), the dense arena, `generate()`, int8
weights (`quantize_params_int8`) and `quant="int8"`, `ngram` speculation
with prefix sharing, and the SLO scheduler under pressure at 3 slots.
(The layer and the entry points: tests/test_torch_moe.py.)

JAX is imported inside the `jx` fixture only (tests/moe_common.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from moe_common import engine_pair, jx, model  # noqa: F401
from repro_torch.serving import engine as tengine
from repro_torch.serving.config import EngineConfig, GenConfig
from repro_torch.serving.quantize import quantize_params_int8
from repro_torch.serving.scheduler import SloScheduler
from repro_torch.serving.speculative import SpecConfig
from repro_torch.serving.telemetry import Telemetry

PAGE = 4


# ---------------------------------------------------------------------------
# Greedy drains against the JAX engine
# ---------------------------------------------------------------------------

# Five requests of 8..21 prompt tokens (8-token chunks of 8 and 5 tokens;
# three prompt lengths, so that the JAX engine compiles few programs) and
# 4..9 new ones: with 2 slots a request finishes while the others decode,
# and its parked slot's token still takes part in every decode step's
# routing.
LENS, NEW = (8, 13, 8, 21, 13), (6, 4, 8, 9, 7)


def _prompts(vocab, seed=8, repeat=False):
    """The drains' prompts. A greedy drain compares discrete routing
    decisions, so two experts whose f32 router logits fall within the two
    packages' last-bit differences may be ordered either way. Seed 7 (with
    lengths 8, 13, 5, 21, 16) met one: phi's LUT drain, layer 1 of its
    12th step, logits 1.0e-6 apart; the tokens parted there. Seed 8 meets
    none."""
    rng = np.random.RandomState(seed)
    ps = [rng.randint(2, vocab, size=n) for n in LENS]
    if repeat:          # motifs the n-gram drafter matches, and a shared prefix
        ps = [np.concatenate([p, p[:4], p[:4]]) for p in ps]
        ps[1] = np.concatenate([ps[0][:8], ps[1]])
    return ps


def _drain(eng, prompts, new):
    uids = [eng.submit(p.copy(), max_new_tokens=n) for p, n in zip(prompts, new)]
    done = eng.run(max_steps=800)
    assert sorted(r.uid for r in done) == sorted(uids)
    by = {r.uid: list(r.generated) for r in done}
    return [by[u] for u in uids]


def _same_tokens(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        k = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        assert g == w, f"request {i} differs first at token {k}: {g} != {w}"


def _pair(jx, model, mode="exact", quant="none", q1=False, spec=False, slo=False,
          telemetry=False, **kw):
    """The JAX engine and the port's on the same settings (paged unless
    `paged=False`); `q1`: both on their package's `quantize_params_int8`
    weights."""
    _, jcfg, jparams, cfg, tparams = model
    if q1:
        jparams, tparams = jx.quant.quantize_params_int8(jparams), quantize_params_int8(tparams)
    kw = dict(dict(slots=2, max_len=48), **kw)
    if kw.get("paged"):
        kw = dict(dict(page_size=PAGE, prefix_sharing=False), **kw)
    jkw, tkw = dict(kw), dict(kw)
    if spec:
        jkw["speculative"], tkw["speculative"] = (jx.SpecConfig(mode="ngram", k=4),
                                                  SpecConfig(mode="ngram", k=4))
    if slo:
        jkw["scheduler"], tkw["scheduler"] = jx.sched.SloScheduler(0), SloScheduler(0)
    if telemetry:
        clock = [iter(np.arange(1e6) * 1e-3) for _ in range(2)]
        jkw["telemetry"] = jx.tel.Telemetry(enabled=True, clock=lambda: float(next(clock[0])))
        tkw["telemetry"] = Telemetry(enabled=True, clock=lambda: float(next(clock[1])))
    jeng, teng = engine_pair(jx, mode, quant=quant)
    return (jx.engine.ServingEngine(jparams, jcfg, jeng, jx.EngineConfig(
                gen=jx.GenConfig(stop_on_eos=False), **jkw)),
            tengine.ServingEngine(tparams, cfg, teng, EngineConfig(
                gen=GenConfig(stop_on_eos=False), **tkw), device="cpu"))


def _drain_both(jx, model, prompts=None, new=NEW, **kw):
    jeng, eng = _pair(jx, model, **kw)
    prompts = prompts if prompts is not None else _prompts(model[1].vocab)
    want = _drain(jeng, prompts, new)
    _same_tokens(_drain(eng, prompts, new), want)
    assert eng.stats()["tokens"] == sum(new)
    if eng.paged:
        a = eng.allocator
        assert (a.used_pages, a._reserved, len(eng.swap_tier)) == (0, 0, 0)
    else:
        assert eng.cache.lengths.tolist() == [0] * eng.slots
    return jeng, eng


@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_paged_drain_matches_jax_engine(jx, model, mode):
    """8-token chunks into pages. The exact drain runs with telemetry on
    under a fake clock: equal counters, request summaries and the
    roofline's modeled bytes and FLOPs a phase (the weight stream priced
    at the active experts, `active_param_count`)."""
    tel = mode == "exact"
    jeng, eng = _drain_both(jx, model, mode=mode, paged=True, prefill_chunk_tokens=8,
                            telemetry=tel)
    if not tel:
        return
    got, want = eng.telemetry.snapshot(), jeng.telemetry.snapshot()
    assert got["counters"] == want["counters"] and got["requests"] == want["requests"]
    groof, wroof = eng.stats()["roofline"], jeng.stats()["roofline"]
    assert set(groof) == set(wroof) == {"chunk_prefill", "decode"}
    for phase, row in groof.items():
        ref = wroof[phase]
        assert (row["modeled_bytes"], row["modeled_flops"]) == (
            ref["modeled_bytes"], ref["modeled_flops"]), phase


def test_dense_engine_drain_matches_jax(jx, model):
    """`ServingEngine(paged=False)`: whole-prompt admissions into the arena."""
    _drain_both(jx, model)


def test_generate_matches_jax(jx, model):
    """Greedy `generate()` over 3 prompts of 25 tokens (one group of 75),
    9 new tokens."""
    _, jcfg, jparams, cfg, tparams = model
    jeng, teng = engine_pair(jx)
    prompts = np.random.RandomState(9).randint(2, jcfg.vocab, size=(3, 25)).astype(np.int32)
    gen = dict(max_new_tokens=9, stop_on_eos=False)
    jtoks, _ = jx.engine.generate(jparams, jx.jnp.asarray(prompts), jcfg, jeng,
                                  jx.GenConfig(**gen))
    ttoks, _ = tengine.generate(tparams, torch.from_numpy(prompts), cfg, teng,
                                GenConfig(**gen), device="cpu")
    _same_tokens(ttoks.tolist(), np.asarray(jtoks).tolist())


@pytest.mark.parametrize("weights", ["q1", "int8"])
def test_quantized_drain_matches_jax_engine(jx, model, weights):
    """q1: `quantize_params_int8` weights (the experts dequantized in the
    compute dtype, the router f32) with int8 pools; int8: every weight
    quantized per call (`quant="int8"`), the router too."""
    kw = (dict(q1=True, kv_cache_dtype="int8") if weights == "q1" else dict(quant="int8"))
    _, eng = _drain_both(jx, model, paged=True, prefill_chunk_tokens=8, **kw)
    assert eng.cache.quantized == (weights == "q1")


def test_ngram_spec_with_sharing_matches_jax_engine(jx, model):
    """`ngram` k=4 with prefix sharing: every verify pass routes 2 x 5
    tokens, parked slots' rows included."""
    jeng, eng = _drain_both(jx, model, _prompts(model[1].vocab, repeat=True), paged=True,
                            prefill_chunk_tokens=8, prefix_sharing=True, spec=True)
    st, jst = eng.stats(), jeng.stats()
    keys = ("proposed", "accepted", "verify_passes", "prefill_tokens_saved")
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    assert st["verify_passes"] > 0 and st["prefill_tokens_saved"] > 0


def test_slo_under_pressure_matches_jax_engine(jx, model):
    """The SLO scheduler on 12 pages at 3 slots (a decode step's experts can
    overflow at cap factor 1.25): preemptions and swaps, the same
    decisions as the JAX engine's."""
    jeng, eng = _drain_both(jx, model, paged=True, prefill_chunk_tokens=4, slots=3,
                            num_pages=12, slo=True)
    st, jst = eng.stats(), jeng.stats()
    keys = ("preemptions", "swap_outs", "swap_ins", "swap_bytes_peak", "peak_pages")
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    assert st["preemptions"] > 0 and st["swap_ins"] > 0
