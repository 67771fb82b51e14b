"""The SLO scheduler and the host swap tier in the port against the JAX
package (the twin of `tests/test_scheduler.py`, less its telemetry).

  * `BlockAllocator.admission_probe` and `admit_restored` decision for
    decision with the JAX allocator over seeded random op streams (seeds
    0-2), and the reference's allocator scenarios (optimistic admission,
    pins, the probe, restored pages, `unregister`) on both allocators;
  * `swap_out_slot` / `swap_in_slot` on fp, int8 (f32 and bf16 scale rows)
    and int4 pools: the blob bit for bit the JAX blob (bf16 as uint16
    bits), the same bytes, the restored cache bit for bit the JAX cache;
    `HostSwapTier`'s accounting;
  * greedy drains with `SloScheduler` token for token with the JAX
    `ServingEngine`, with equal scheduler stats (`scheduler`,
    `preemptions`, `swap_outs`, `swap_ins`, `swapped`, `swap_bytes_peak`,
    `pinned_pages`), `peak_pages` and `prefill_tokens_saved`: an
    oversubscribed pool on {fp, int8, int4/bf16} pools x sharing {on, off}
    on qwen2_1_5b and gpt2_medium smoke; a priority burst submitted
    mid-drain (victims aborted mid-prefill, a shared prefix re-hit); SLO
    with the ngram and the self-draft drafters; SLO without pressure equal
    to FIFO; urgent admission preempting a lower class; one class never
    preempting for admission; an infeasible candidate evicting no one;
    pins kept across requests; swapped requests counted by `stats()` and
    `step()`. Every drain returns every page, reservation and blob.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.salpim import SalPimConfig, SalPimEngine
from repro.models import api as jax_api
from repro.serving import kvcache as jkv
from repro.serving import scheduler as jsched
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.config import GenConfig as JaxGenConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.speculative import SpecConfig as JaxSpecConfig
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.salpim import SalPimEngine as TSalPimEngine
from repro_torch.serving import kvcache as tkv
from repro_torch.serving.config import EngineConfig, GenConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import (FifoScheduler, Scheduler, SloScheduler,
                                           SwappedRequest)
from repro_torch.serving.speculative import SpecConfig

PAGE, MAX_LEN = 4, 32
MODELS = ["qwen2_1_5b", "gpt2_medium"]
POOLS = [("model", "float32"), ("int8", "float32"), ("int8", "bfloat16"),
         ("int4", "bfloat16")]
SCHED_KEYS = ("scheduler", "preemptions", "swap_outs", "swap_ins", "swapped",
              "swap_bytes_peak", "pinned_pages", "peak_pages", "prefill_tokens_saved",
              "prefill_tokens", "tokens", "tokens_budget", "proposed", "accepted",
              "verify_passes", "spec_rounds")
ALLOCATORS = [jkv.BlockAllocator, tkv.BlockAllocator]
RAISES = (AssertionError, RuntimeError, ValueError)


def test_schedulers_satisfy_protocol():
    assert isinstance(FifoScheduler(), Scheduler)
    assert isinstance(SloScheduler(), Scheduler)
    assert FifoScheduler().reserve and not FifoScheduler().preemptive
    assert SloScheduler().preemptive and not SloScheduler().reserve
    for ours, ref in ((FifoScheduler(), jsched.FifoScheduler()),
                      (SloScheduler(5), jsched.SloScheduler(5))):
        assert ((ours.name, ours.preemptive, ours.reserve, ours.pin_budget_pages)
                == (ref.name, ref.preemptive, ref.reserve, ref.pin_budget_pages))
    assert FifoScheduler().pick_victim(None, None) is None


# ---------------------------------------------------------------------------
# BlockAllocator: admission_probe and admit_restored against the JAX one
# ---------------------------------------------------------------------------

def _state(a) -> dict:
    return {"free": list(a._free), "reserved": a._reserved,
            "pages": {u: list(p) for u, p in a._pages.items()},
            "quota": dict(a._quota), "owned": dict(a._owned),
            "mode": dict(a._reserve_mode), "ref": dict(a._ref),
            "cache": dict(a._prefix_cache), "key": dict(a._page_key),
            "pinned": list(a._pinned)}


def _call(a, op, args):
    try:
        return getattr(a, op)(*args), None
    except RAISES as e:
        return None, type(e).__name__


def _ops(rng, n_ops, reserve, ref):
    """A seeded op stream over prompts sharing page-aligned prefixes: probes
    before most admissions, restored admissions, extends, forks of shared
    pages, unregisters, pin reclaims and releases. One admission mode a
    stream, as the engine has one a policy."""
    bases = [rng.randint(2, 50, size=12) for _ in range(3)]
    uid, live = 0, []
    for _ in range(n_ops):
        r = rng.rand()
        if r < 0.35 or not live:
            base = bases[rng.randint(len(bases))]
            cut = int(rng.choice([0, 4, 8, 12]))
            toks = np.concatenate([base[:cut], rng.randint(2, 50, size=rng.randint(0, 6))])
            if len(toks) == 0:
                toks = base[:4].copy()
            new = int(rng.randint(1, 10))
            yield "admission_probe", (toks, new, reserve)
            uid += 1
            if rng.rand() < 0.25:
                n = int(rng.randint(1, 4))
                yield "admit_restored", (uid, n, n + int(rng.randint(0, 3)), reserve)
            else:
                yield "admit_tokens", (uid, toks, new, reserve)
            live.append(uid)
        elif r < 0.55:
            yield "extend", (int(rng.choice(live)),)
        elif r < 0.65:
            shared = [(u, i) for u, pages in ref._pages.items()
                      for i, p in enumerate(pages) if ref._ref[p] > 1]
            if shared:
                yield "fork_page", shared[rng.randint(len(shared))]
        elif r < 0.7:
            yield "unregister", (int(rng.choice(live)), int(rng.randint(0, 3)))
        elif r < 0.75:
            yield "reclaim_pinned", (int(rng.randint(0, 3)),)
        else:
            u = int(rng.choice(live))
            live.remove(u)
            yield "release", (u,)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("sharing", [True, False])
@pytest.mark.parametrize("pin", [0, 3])
@pytest.mark.parametrize("reserve", [True, False])
def test_probe_and_restore_decisions_match_jax(seed, sharing, pin, reserve):
    """Seeds 0-2: every op's result and the whole bookkeeping equal the JAX
    allocator's after it; a probe changes nothing and predicts exactly the
    draw (optimistic) or watermark drop (reserve) of the admission after
    it, whenever that admission maps no fully covered prompt."""
    rng = np.random.RandomState(seed)
    ja = jkv.BlockAllocator(20, PAGE, prefix_sharing=sharing, pin_budget_pages=pin)
    ta = tkv.BlockAllocator(20, PAGE, prefix_sharing=sharing, pin_budget_pages=pin)
    seen = {"probe": 0, "restored": 0, "refused": 0, "pinned": 0, "exact": 0}
    probe = None
    for step, (op, args) in enumerate(_ops(rng, 200, reserve, ja)):
        if op in ("extend", "fork_page", "unregister", "release") and args[0] not in ja._pages:
            continue
        before = (ta.available_pages, ta.free_pages, ta.pinned_pages)
        want, jerr = _call(ja, op, args)
        got, terr = _call(ta, op, args)
        assert (terr is None) == (jerr is None), (step, op, jerr, terr)
        assert got == want, (step, op, args)
        assert _state(ta) == _state(ja), (step, op, args)
        seen["pinned"] += ta.pinned_pages > 0
        if op == "admission_probe":
            seen["probe"] += 1
            probe = got
            continue
        if op == "admit_tokens" and got is None:
            seen["refused"] += 1
        elif op == "admit_tokens" and not before[2] and (reserve or got[1] < len(args[1])):
            # No pin to reclaim and, when optimistic, no fully covered
            # prompt (its fork page is needed now, drawn later).
            charged = before[0] - ta.available_pages if reserve else before[1] - ta.free_pages
            assert charged == probe[0], (step, args)
            seen["exact"] += 1
        elif op == "admit_restored" and got is not None:
            seen["restored"] += 1
            assert all(ta.refcount(p) == 1 and p not in ta._page_key for p in got)
        probe = None
    assert seen["probe"] and seen["restored"] and seen["refused"] and seen["exact"], seen
    assert (seen["pinned"] > 0) == (pin > 0 and sharing), seen


@pytest.mark.parametrize("A", ALLOCATORS, ids=["jax", "port"])
def test_optimistic_admission_scenarios(A):
    """The reference's optimistic-admission scenarios, on both allocators."""
    a = A(num_pages=16, page_size=4)
    res = a.admit_tokens(1, np.arange(6), max_new_tokens=20, reserve=False)
    assert res is not None and len(res[0]) == 2
    assert (a._reserved, a.free_pages, a.available_pages) == (0, 13, 13)
    p = a.extend(1)                     # drawn from the live free list
    assert p not in res[0] and a.free_pages == 12 and a._reserved == 0
    a.release(1)
    assert a.used_pages == 0 and a.free_pages == 15

    a = A(num_pages=4, page_size=4)     # worst case 6 pages, prompt 2
    assert a.admit_tokens(1, np.arange(8), max_new_tokens=16) is None
    res = a.admit_tokens(1, np.arange(8), max_new_tokens=16, reserve=False)
    assert res is not None and len(res[0]) == 2
    a.release(1)

    a = A(num_pages=3, page_size=4)
    assert a.admit_tokens(1, np.arange(8), max_new_tokens=4, reserve=False) is not None
    with pytest.raises((AssertionError, RuntimeError), match="dry pool"):
        a.extend(1)                     # the engine must preempt first
    a.release(1)

    a = A(num_pages=16, page_size=4)
    assert a.admit_tokens(1, np.arange(6), max_new_tokens=8) is not None
    assert a.admit_tokens(2, np.arange(6), max_new_tokens=8, reserve=False) is not None
    a.extend(2)
    a.release(1)
    a.release(2)
    assert (a.used_pages, a._reserved, a.free_pages) == (0, 0, 15)


@pytest.mark.parametrize("A", ALLOCATORS, ids=["jax", "port"])
def test_pin_scenarios(A):
    """The reference's pin lifecycle, oldest-first reclaim with protect, and
    reclaim on an admission shortage, on both allocators."""
    a = A(num_pages=16, page_size=2, prefix_sharing=True)
    a.admit_tokens(1, np.arange(6), max_new_tokens=2)
    a.release(1)
    assert (a.pinned_pages, a.used_pages, a.free_pages) == (0, 0, 15)

    a = A(num_pages=16, page_size=2, prefix_sharing=True, pin_budget_pages=2)
    pages = a.admit_tokens(1, np.arange(6), max_new_tokens=2)[0]
    a.release(1)
    assert a.pinned_pages == 2 and a.free_pages == 13
    res = a.admit_tokens(2, np.arange(6), max_new_tokens=2)
    assert res[1] == 4 and res[0][:2] == pages[:2] and a.pinned_pages == 0
    assert all(a.refcount(p) == 1 for p in pages[:2])
    a.release(2)

    a = A(num_pages=16, page_size=2, prefix_sharing=True, pin_budget_pages=8)
    a.admit_tokens(1, np.arange(6), max_new_tokens=2)
    p0, p1, p2 = a.pages_of(1)
    a.release(1)
    assert a.reclaim_pinned(1) == 1 and p0 not in a._pinned
    assert a.reclaim_pinned(1, protect=frozenset((p1,))) == 1
    assert p1 in a._pinned and p2 not in a._pinned
    assert a.admit_tokens(2, np.arange(6), max_new_tokens=2)[1] == 0
    a.release(2)

    a = A(num_pages=6, page_size=2, prefix_sharing=True, pin_budget_pages=8)
    a.admit_tokens(1, np.arange(6), max_new_tokens=2)
    a.release(1)
    assert a.pinned_pages == 3 and a.free_pages == 2
    res = a.admit_tokens(2, np.arange(100, 108), max_new_tokens=0)
    assert res is not None and res[1] == 0 and a.pinned_pages == 1
    a.release(2)


@pytest.mark.parametrize("A", ALLOCATORS, ids=["jax", "port"])
def test_admission_probe_scenarios(A):
    """The probe is a pure lookup equal to what admission charges; a fully
    covered prompt needs its fork page; pinned hits cost nothing and are
    not reclaimable."""
    a = A(num_pages=16, page_size=2, prefix_sharing=True)
    donor = np.arange(8)
    a.admit_tokens(1, donor, max_new_tokens=2)
    for toks, new in [(np.concatenate([donor, [99, 98]]), 4), (donor[:5], 2),
                      (np.arange(50, 60), 4)]:
        for reserve in (True, False):
            before = (list(a._free), dict(a._ref))
            need, _ = a.admission_probe(toks, new, reserve=reserve)
            assert (list(a._free), dict(a._ref)) == before
            avail0, free0 = a.available_pages, a.free_pages
            assert a.admit_tokens(9, toks, new, reserve=reserve) is not None
            charged = avail0 - a.available_pages if reserve else free0 - a.free_pages
            assert charged == need
            a.release(9)
    assert a.admission_probe(donor, 4, reserve=False)[0] == 1
    assert (a.admission_probe(donor, 4, reserve=True)[0]
            == a.pages_for(a.worst_case_tokens(8, 4)) - 4 + 1)

    a = A(num_pages=8, page_size=2, prefix_sharing=True, pin_budget_pages=4)
    a.admit_tokens(1, np.arange(8), max_new_tokens=0)
    a.release(1)
    assert a.admission_probe(np.arange(8), 0, reserve=False) == (1, 0)
    assert a.admission_probe(np.arange(50, 58), 0, reserve=False) == (4, 4)


@pytest.mark.parametrize("A", ALLOCATORS, ids=["jax", "port"])
def test_admit_restored_and_unregister_scenarios(A):
    a = A(num_pages=16, page_size=4, prefix_sharing=True)
    pages = a.admit_restored(5, n_pages=3, worst_pages=6, reserve=False)
    assert pages is not None and a._reserved == 0 and a.free_pages == 12
    assert all(a.refcount(p) == 1 and p not in a._page_key for p in pages)
    a.extend(5)
    a.release(5)
    assert a.used_pages == 0 and a.free_pages == 15

    a = A(num_pages=8, page_size=4)
    assert a.admit_restored(5, n_pages=2, worst_pages=5) is not None and a._reserved == 3
    assert a.admit_restored(6, n_pages=3, worst_pages=3) is None
    a.release(5)
    assert a.admit_restored(6, n_pages=9, worst_pages=9) is None
    assert a.used_pages == 0 and a._reserved == 0
    with pytest.raises(RAISES):
        a.admit_restored(7, n_pages=3, worst_pages=2)

    a = A(num_pages=16, page_size=2, prefix_sharing=True)
    a.admit_tokens(1, np.arange(8), max_new_tokens=2)
    a.unregister(1, from_logical=2)
    assert a.admit_tokens(2, np.arange(8), max_new_tokens=2)[1] == 4
    a.release(1)
    a.release(2)


# ---------------------------------------------------------------------------
# The swap tier against the JAX one
# ---------------------------------------------------------------------------

def _random_caches(kv, sd, seed=7):
    """A JAX PagedCache (2 slots, 8 pages of 4) with random payload and
    scales, slot 0 holding 10 tokens on pages [2, 5, 3], and the port's
    copy of it."""
    cfg = jax_get_config("qwen2_1_5b", smoke=True)
    jc = jax_api.init_paged_cache(cfg, 2, num_pages=8, page_size=PAGE, max_pages=4,
                                  kv_dtype=kv, kv_scale_dtype=sd)
    rng = np.random.RandomState(seed)
    fill = {}
    for n in ("k_pages", "v_pages", "k_scale", "v_scale"):
        x = getattr(jc, n)
        if x is not None:
            arr = np.asarray(x)
            fill[n] = (rng.randint(-128, 128, arr.shape).astype(np.int8)
                       if arr.dtype == np.int8 else rng.randn(*arr.shape).astype(arr.dtype))
    jc = jkv.PagedCache(jax.numpy.asarray([10, 0], jax.numpy.int32),
                        jax.numpy.asarray([[2, 5, 3, 0], [0, 0, 0, 0]], jax.numpy.int32),
                        *(jax.numpy.asarray(fill[n]) if n in fill else None
                          for n in ("k_pages", "v_pages", "k_scale", "v_scale")))
    tc = tkv.PagedCache(*(None if getattr(jc, n) is None else
                          bridge.tensor_from_numpy(np.asarray(getattr(jc, n)), "cpu")
                          for n in ("lengths", "block_tables", "k_pages", "v_pages",
                                    "k_scale", "v_scale")))
    return jc, tc


def _bits(x):
    """A tensor or array as integers of its own width (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _same(tc, jc, names=("lengths", "block_tables", "k_pages", "v_pages", "k_scale",
                         "v_scale")):
    for n in names:
        j, t = getattr(jc, n), getattr(tc, n)
        assert (j is None) == (t is None), n
        if j is not None:
            np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=n)


@pytest.mark.parametrize("kv,sd", POOLS)
def test_swap_roundtrip_matches_jax(kv, sd):
    """Swap slot 0 out, then into pages [6, 1, 4] of slot 1: each blob bit
    for bit the JAX blob and the pools' pages, with the same bytes, and the
    cache after each step bit for bit the JAX cache."""
    jc, tc = _random_caches(kv, sd)
    want = {n: _bits(getattr(tc, n)[:, [2, 5, 3]]).copy()
            for n in ("k_pages", "v_pages", "k_scale", "v_scale") if getattr(tc, n) is not None}
    jc, jblob = jkv.swap_out_slot(jc, 0, [2, 5, 3], 10)
    same_cache, blob = tkv.swap_out_slot(tc, 0, [2, 5, 3], 10)
    assert same_cache is tc
    _same(tc, jc)
    assert (blob.n_tokens, blob.n_pages, blob.nbytes) == (10, 3, jblob.nbytes)
    for field, pool in (("k", "k_pages"), ("v", "v_pages"), ("k_scale", "k_scale"),
                        ("v_scale", "v_scale")):
        got, ref = getattr(blob, field), getattr(jblob, field)
        assert (got is None) == (ref is None) == (pool not in want), field
        if got is not None:
            assert got.device.type == "cpu" and got.dtype == getattr(tc, pool).dtype
            np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=field)
            np.testing.assert_array_equal(_bits(got), want[pool], err_msg=field)
    assert int(tc.lengths[0]) == 0 and (tc.block_tables[0] == tkv.TRASH_PAGE).all()
    jc = jkv.swap_in_slot(jc, 1, [6, 1, 4], jblob)
    assert tkv.swap_in_slot(tc, 1, [6, 1, 4], blob) is tc
    _same(tc, jc)
    assert int(tc.lengths[1]) == 10 and tc.block_tables[1].tolist() == [6, 1, 4, 0]
    for pool, bits in want.items():
        np.testing.assert_array_equal(_bits(getattr(tc, pool)[:, [6, 1, 4]]), bits)
    with pytest.raises(ValueError, match="pages for a blob"):
        tkv.swap_in_slot(tc, 0, [6, 1], blob)


def test_host_swap_tier_accounting():
    tier = tkv.HostSwapTier()
    blob = tkv.SwappedKV(n_tokens=4, k=torch.zeros((1, 2, 1, 4, 8)),
                         v=torch.zeros((1, 2, 1, 4, 8)))
    jblob = jkv.SwappedKV(n_tokens=4, k=np.zeros((1, 2, 1, 4, 8), np.float32),
                          v=np.zeros((1, 2, 1, 4, 8), np.float32))
    assert blob.nbytes == jblob.nbytes == 2 * 64 * 4
    tier.put(3, blob)
    assert len(tier) == 1 and tier.bytes_used == blob.nbytes
    with pytest.raises(ValueError, match="already swapped"):
        tier.put(3, blob)
    assert tier.pop(3) is blob
    assert len(tier) == 0 and tier.bytes_used == 0 and tier.bytes_peak == blob.nbytes


# ---------------------------------------------------------------------------
# Drains against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MODELS)
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def qwen():
    return _model("qwen2_1_5b")


_MODELS = {}


def _model(name):
    if name not in _MODELS:
        jcfg = jax_get_config(name, smoke=True)
        jparams = jax_api.init_params(jax.random.PRNGKey(0), jcfg)
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
        _MODELS[name] = (name, jcfg, jparams, get_config(name, smoke=True), tparams)
    return _MODELS[name]


def _engines(model, slo=None, spec=None, **kw):
    """(JAX engine, port engine) with the same settings; `slo` is None
    (FIFO) or the SloScheduler's pin budget; `spec` None, "ngram" or
    "self-draft" (k 2)."""
    _, jcfg, jparams, cfg, tparams = model
    kw = dict(dict(slots=2, max_len=MAX_LEN, paged=True, page_size=PAGE), **kw)
    jspec = tspec = None
    if spec == "ngram":
        jspec, tspec = JaxSpecConfig(mode="ngram", k=4), SpecConfig(mode="ngram", k=4)
    elif spec == "self-draft":
        jspec = JaxSpecConfig(mode="draft-model", k=2, draft_cfg=jcfg, draft_params=jparams)
        tspec = SpecConfig(mode="draft-model", k=2, draft_cfg=cfg, draft_params=tparams)
    jeng = JaxServingEngine(jparams, jcfg, SalPimEngine.create(SalPimConfig()), JaxEngineConfig(
        gen=JaxGenConfig(temperature=0.0, stop_on_eos=False), speculative=jspec,
        scheduler=None if slo is None else jsched.SloScheduler(slo), **kw))
    teng = ServingEngine(tparams, cfg, TSalPimEngine.create(), EngineConfig(
        gen=GenConfig(stop_on_eos=False), speculative=tspec,
        scheduler=None if slo is None else SloScheduler(slo), **kw), device="cpu")
    return jeng, teng


def _count_aborts(eng):
    """Wrap eng._preempt to count the victims taken mid-prefill."""
    eng.aborts = 0
    preempt = eng._preempt

    def counted(slot):
        eng.aborts += eng.active[slot].prefilling
        preempt(slot)
    eng._preempt = counted
    return eng


def _drain(eng, requests, late=(), at_step=None, max_steps=800):
    """Submit `requests` [(prompt, max_new, priority)], step, submit `late`
    before step `at_step`, drain; check every request finished and every
    page, reservation and blob came back. Returns the tokens by submission
    order."""
    uids = [eng.submit(p.copy(), max_new_tokens=n, priority=pr) for p, n, pr in requests]
    steps = 0
    while late and steps < at_step:
        eng.step()
        steps += 1
    uids += [eng.submit(p.copy(), max_new_tokens=n, priority=pr) for p, n, pr in late]
    eng.run(max_steps=max_steps)
    by = {r.uid: list(r.generated) for r in eng.finished}
    assert set(uids) <= set(by) and not eng.queue and not any(eng.active)
    a = eng.allocator
    assert a.used_pages == a.pinned_pages and a._reserved == 0
    assert len(eng.swap_tier) == 0 and not eng.swapped
    return [by[u] for u in uids]


def _both(model, requests, late=(), at_step=None, **kw):
    """Drain through both engines: equal tokens and scheduler stats."""
    jeng, teng = (_count_aborts(e) for e in _engines(model, **kw))
    want = _drain(jeng, requests, late, at_step)
    got = _drain(teng, requests, late, at_step)
    assert got == want
    js, ts = jeng.stats(), teng.stats()
    assert {k: ts[k] for k in SCHED_KEYS} == {k: js[k] for k in SCHED_KEYS}
    assert teng.aborts == jeng.aborts
    assert [r.preemptions for r in teng.finished] == [r.preemptions for r in jeng.finished]
    return got, teng


def _workload(vocab, seed=0, n=4, priority=0):
    """The reference's scheduler workload: prompts of 6..10 tokens, 8..12
    new tokens."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(2, vocab, size=rng.randint(6, 11)) for _ in range(n)]
    return [(p, int(rng.randint(8, 13)), priority) for p in prompts]


def _calm(model, requests, late=(), at_step=None, **kw):
    """The port's FIFO drain of the same requests with pages to spare."""
    kw = dict(kw, slots=2, num_pages=64)
    return _drain(_engines(model, **kw)[1], requests, late, at_step)


@pytest.mark.parametrize("kv,sd", [("model", "float32"), ("int8", "float32"),
                                   ("int4", "bfloat16")])
@pytest.mark.parametrize("sharing", [True, False])
def test_slo_preempt_swap_matches_jax(model, kv, sd, sharing):
    """An oversubscribed pool forces preempt-and-swap; the drain equals the
    JAX engine's, and a calm FIFO drain on the same pool format."""
    reqs = _workload(model[1].vocab)
    pools = dict(prefix_sharing=sharing, kv_cache_dtype=kv, kv_scale_dtype=sd)
    got, eng = _both(model, reqs, slo=0, slots=3, num_pages=12, **pools)
    assert got == _calm(model, reqs, **pools)
    st = eng.stats()
    assert st["preemptions"] > 0 and st["swap_ins"] > 0 and st["swap_bytes_peak"] > 0


def _burst(vocab):
    """Three background requests (priority 1) and, later, three urgent ones
    (priority 0), two of them on one 8-token (2-page) prefix."""
    rng = np.random.RandomState(11)
    bg = [(rng.randint(2, vocab, size=int(n)), 10, 1) for n in (10, 9, 11)]
    prefix = rng.randint(2, vocab, size=8)
    urgent = [(np.concatenate([prefix, rng.randint(2, vocab, size=3)]), 5, 0),
              (np.concatenate([prefix, rng.randint(2, vocab, size=2)]), 4, 0),
              (rng.randint(2, vocab, size=7), 6, 0)]
    return bg, urgent


@pytest.mark.parametrize("kv,sd", [("model", "float32"), ("int8", "bfloat16")])
def test_slo_priority_burst_mid_drain_matches_jax(model, kv, sd):
    """A priority burst submitted mid-drain under a tight pool with chunked
    prompts: victims decoding (swapped) and mid-prefill (aborted), the
    urgent pair's shared prefix; the drain equals the JAX engine's and the
    calm FIFO drain."""
    bg, urgent = _burst(model[1].vocab)
    pools = dict(kv_cache_dtype=kv, kv_scale_dtype=sd, prefill_chunk_tokens=4)
    got, eng = _both(model, bg, urgent, 5, slo=0, slots=3, num_pages=11, **pools)
    assert got == _calm(model, bg, urgent, 5, **pools)
    st = eng.stats()
    assert eng.aborts > 0 and st["swap_ins"] > 0 and st["prefill_tokens_saved"] > 0, st


@pytest.mark.parametrize("spec", ["ngram", "self-draft"])
def test_slo_with_speculation_matches_jax(model, spec):
    """Speculation under preempt-and-swap: preempted slots drop their
    drafter state; the drain equals the JAX engine's and spec-off FIFO."""
    reqs = _workload(model[1].vocab)
    got, eng = _both(model, reqs, slo=0, spec=spec, slots=3, num_pages=12)
    assert got == _calm(model, reqs)
    assert eng.stats()["preemptions"] > 0


def test_slo_without_pressure_matches_fifo(qwen):
    reqs = _workload(qwen[1].vocab)
    got, eng = _both(qwen, reqs, slo=0, num_pages=64)
    assert got == _calm(qwen, reqs)
    st = eng.stats()
    assert st["scheduler"] == "slo" and st["preemptions"] == 0 and eng.swap_outs == 0


def test_slo_priority_admission_preempts_lower_class(qwen):
    """An urgent request finds both slots decoding background work: a
    background victim is swapped out for it and still finishes, each output
    equal to a solo drain; the urgent one finishes first and never waits."""
    vocab = qwen[1].vocab
    rng = np.random.RandomState(23)
    bg = [(rng.randint(2, vocab, size=6), 16, 2) for _ in range(2)]
    hi = [(rng.randint(2, vocab, size=6), 4, 0)]
    got, eng = _both(qwen, bg, hi, 4, slo=0, num_pages=64)
    assert eng.preemptions >= 1 and eng.swap_ins >= 1
    order = [r.uid for r in eng.finished]
    assert order.index(3) < max(order.index(1), order.index(2))
    assert next(r for r in eng.finished if r.uid == 3).preemptions == 0
    for toks, req in zip(got, bg + hi):
        assert toks == _calm(qwen, [req])[0]


def test_slo_same_class_never_preempts_for_admission(qwen):
    reqs = _workload(qwen[1].vocab, seed=3, n=5, priority=1)
    _, eng = _both(qwen, reqs, slo=0, num_pages=64)
    assert eng.preemptions == 0


def test_slo_infeasible_candidate_never_evicts(qwen):
    """A candidate needing more pages than the free list plus everything
    evicting the small background tenant would free waits; nobody is
    preempted."""
    vocab = qwen[1].vocab
    rng = np.random.RandomState(31)
    first = [(rng.randint(2, vocab, size=8), 12, 0), (rng.randint(2, vocab, size=4), 2, 2)]
    mid = [(rng.randint(2, vocab, size=20), 2, 1)]
    _, eng = _both(qwen, first, mid, 3, slo=0, num_pages=7)
    assert eng.preemptions == 0
    assert all(r.preemptions == 0 for r in eng.finished)


def test_pinning_keeps_hot_prefix_across_requests(qwen):
    """A system prompt's 2 pages outlive refcount 0 under the pin budget and
    the next request revives them: 8 prompt tokens not prefilled, and the
    output equals a pinless drain's."""
    vocab = qwen[1].vocab
    rng = np.random.RandomState(29)
    system = rng.randint(2, vocab, size=8)
    p1 = np.concatenate([system, rng.randint(2, vocab, size=2)])
    p2 = np.concatenate([system, rng.randint(2, vocab, size=3)])
    engines = _engines(qwen, slo=4, num_pages=64)
    outs = []
    for eng in engines:
        eng.submit(p1.copy(), max_new_tokens=4)
        eng.run(max_steps=200)
        assert (eng.allocator.pinned_pages, eng.allocator.used_pages) == (2, 2)
        assert eng.stats()["pinned_pages"] == 2 and eng.prefill_tokens_saved == 0
        outs.append(_drain(eng, [(p2, 4, 0)]))
        assert eng.prefill_tokens_saved == 8
    assert outs[1] == outs[0] == [_calm(qwen, [(p2, 4, 0)])[0]]
    js, ts = (e.stats() for e in engines)
    assert {k: ts[k] for k in SCHED_KEYS} == {k: js[k] for k in SCHED_KEYS}


def test_swapped_requests_counted_in_stats_and_step_return(qwen):
    """A swapped request is outstanding work: step() counts it and stats()
    counts its tokens, as the JAX engine does."""
    vocab = qwen[1].vocab
    rng = np.random.RandomState(41)
    bg, hi = rng.randint(2, vocab, size=6), rng.randint(2, vocab, size=6)
    seen = []
    for eng in _engines(qwen, slo=0, slots=1, num_pages=64):
        eng.submit(bg.copy(), max_new_tokens=16, priority=2)
        for _ in range(3):
            eng.step()
        eng.submit(hi.copy(), max_new_tokens=4, priority=0)
        n = eng.step()                  # preempts the background slot
        st = eng.stats()
        assert st["swapped"] == 1 and n >= 2
        assert isinstance(eng.swapped[0], SwappedRequest if isinstance(
            eng, ServingEngine) else jsched.SwappedRequest)
        seen.append((n, st["tokens"], st["tokens_budget"], st["swapped"]))
        eng.run(max_steps=400)
        assert eng.stats()["swapped"] == 0 and len(eng.finished) == 2
    assert seen[1] == seen[0]
    assert seen[0][1] > 0
