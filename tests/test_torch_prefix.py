"""Prefix sharing in the port against the JAX package.

  * `BlockAllocator`: the decisions of the port's allocator (pages,
    refcounts, reservations, the prefix cache, pinned pages, what
    `fork_page` and `rewind` return) against the JAX allocator over seeded
    random sequences of `admit_tokens`, `admit`, `extend`, `fork_page`,
    `rewind`, `unregister`, `reclaim_pinned` and `release`, with sharing on
    and off and pin budgets 0 and 3; the reference's allocator scenarios
    (watermark net of shared pages, the fork page of a fully covered
    prompt, rewind refusing shared and cached pages) on both allocators;
  * the in-place device ops `copy_page` and `rewind_slot` on fp, int8
    (f32/bf16 scale rows) and int4 pools, and `write_prompt_pages` on fp
    pools, bit for bit with the JAX ops;
  * greedy drains with `prefix_sharing=True` token for token with the JAX
    `ServingEngine` (the same prefill tokens saved, page peak, all pages
    and reservations back), on gpt2_medium and qwen2_1_5b smoke, fp and
    int8 pools, whole and chunked prompts; a drain with sharing off gives
    the same tokens; the decode-boundary COW fork, forced as the
    reference test forces it, leaves the donor page's bits unchanged.
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
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.config import GenConfig as JaxGenConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.salpim import SalPimEngine as TSalPimEngine
from repro_torch.serving import kvcache as tkv
from repro_torch.serving.config import EngineConfig, GenConfig
from repro_torch.serving.engine import ServingEngine

PAGE = 4
MODELS = ["gpt2_medium", "qwen2_1_5b"]


# ---------------------------------------------------------------------------
# BlockAllocator against the JAX allocator
# ---------------------------------------------------------------------------

def _state(a) -> dict:
    """Every piece of an allocator's bookkeeping, in comparable form."""
    return {"free": list(a._free), "reserved": a._reserved,
            "pages": {u: list(p) for u, p in a._pages.items()},
            "quota": dict(a._quota), "owned": dict(a._owned),
            "mode": dict(a._reserve_mode), "ref": dict(a._ref),
            "cache": dict(a._prefix_cache), "key": dict(a._page_key),
            "pinned": list(a._pinned), "available": a.available_pages,
            "used": a.used_pages, "cached": a.cached_pages,
            "n_pinned": a.pinned_pages}


def _call(a, op, args):
    """(result, None) or (None, exception type name)."""
    try:
        return getattr(a, op)(*args), None
    except (AssertionError, RuntimeError, ValueError) as e:
        return None, type(e).__name__


def _random_ops(rng, n_ops, reserve, ref):
    """A seeded op stream over prompts that share page-aligned prefixes;
    most forks aim at a page the reference allocator `ref` holds shared.
    One admission mode a stream: optimistic admissions (reserve=False)
    draw on pages the watermark promised, so the modes do not mix."""
    bases = [rng.randint(2, 50, size=12) for _ in range(3)]
    uid, live, ops = 0, [], []
    for _ in range(n_ops):
        r = rng.rand()
        if r < 0.3 or not live:
            uid += 1
            base = bases[rng.randint(len(bases))]
            cut = int(rng.choice([0, 4, 7, 8, 12]))
            toks = np.concatenate([base[:cut], rng.randint(2, 50, size=rng.randint(0, 6))])
            if len(toks) == 0:
                toks = base[:4].copy()
            new = int(rng.randint(1, 10))
            if reserve and rng.rand() < 0.15:
                ops.append(("admit", (uid, len(toks), new)))
            else:
                ops.append(("admit_tokens", (uid, toks, new, reserve)))
            live.append(uid)
        elif r < 0.5:
            ops.append(("extend", (int(rng.choice(live)),)))
        elif r < 0.6:
            shared = [(u, i) for u, pages in ref._pages.items()
                      for i, p in enumerate(pages) if ref._ref[p] > 1]
            if shared and rng.rand() < 0.7:
                u, i = shared[rng.randint(len(shared))]
                ops.append(("fork_page", (u, i)))
            else:
                ops.append(("fork_page", (int(rng.choice(live)), int(rng.randint(0, 3)))))
        elif r < 0.72:
            ops.append(("rewind", (int(rng.choice(live)), int(rng.randint(1, 24)))))
        elif r < 0.76:
            ops.append(("unregister", (int(rng.choice(live)), int(rng.randint(0, 3)))))
        elif r < 0.8:
            ops.append(("reclaim_pinned", (int(rng.randint(0, 3)),)))
        else:
            u = int(rng.choice(live))
            live.remove(u)
            ops.append(("release", (u,)))
        yield ops.pop()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("sharing", [True, False])
@pytest.mark.parametrize("pin", [0, 3])
@pytest.mark.parametrize("reserve", [True, False])
def test_allocator_decisions_match_jax(seed, sharing, pin, reserve):
    rng = np.random.RandomState(seed)
    ja = jkv.BlockAllocator(24, PAGE, prefix_sharing=sharing, pin_budget_pages=pin)
    ta = tkv.BlockAllocator(24, PAGE, prefix_sharing=sharing, pin_budget_pages=pin)
    done = {"refused": 0, "shared": 0, "fork_page": 0, "rewind": 0, "extend": 0}
    for step, (op, args) in enumerate(_random_ops(rng, 160, reserve, ja)):
        if op in ("extend", "fork_page", "rewind", "unregister") and args[0] not in ja._pages:
            continue                      # admission was refused: no such uid
        if op == "fork_page" and args[1] >= len(ja._pages[args[0]]):
            continue
        if op == "rewind":
            keep = ja.pages_for(args[1])
            tail = ja._pages[args[0]][keep:]
            if any(ja._ref[p] != 1 or p in ja._page_key for p in tail):
                # The reference asserts after popping a page; the port
                # refuses before touching anything.
                before = _state(ta)
                _, err = _call(ta, op, args)
                assert err == "RuntimeError" and _state(ta) == before, step
                done["refused"] += 1
                continue
        if op == "release" and args[0] not in ja._pages:
            continue
        want, jerr = _call(ja, op, args)
        got, terr = _call(ta, op, args)
        assert (terr is None) == (jerr is None), (step, op, jerr, terr)
        assert got == want, (step, op, args)
        assert _state(ta) == _state(ja), (step, op, args)
        if jerr is not None:
            done["refused"] += 1
        elif op in done:
            done[op] += 1
        elif op == "admit_tokens" and want is not None and want[1]:
            done["shared"] += 1
    # The stream reached every kind of decision.
    assert done["refused"] and done["extend"] and done["rewind"], done
    assert (done["shared"] > 0) == sharing, done
    if sharing and reserve:      # an optimistic stream may run the pool dry
        assert done["fork_page"] > 0, done


def test_allocator_scenarios_match_jax():
    """The reference's allocator scenarios, on both allocators."""
    for A in (jkv.BlockAllocator, tkv.BlockAllocator):
        a = A(num_pages=7, page_size=4, prefix_sharing=True)
        toks = np.arange(30, 42)                    # 3 full pages
        assert a.admit_tokens(1, toks, max_new_tokens=5) is not None
        assert a.available_pages == 2 and not a.can_admit(12, 5)
        pages, shared = a.admit_tokens(2, toks.copy(), max_new_tokens=4)
        assert shared == 12 and a.available_pages == 0   # fork + 1 decode page
        a.release(1)
        a.release(2)
        assert a.available_pages == 6 and a.cached_pages == 0

        a = A(num_pages=4, page_size=4, prefix_sharing=True)
        toks = np.arange(10, 18)
        assert a.admit_tokens(1, toks, max_new_tokens=1) is not None
        assert a.admit_tokens(2, toks.copy(), max_new_tokens=1)[1] == 8
        assert a.admit_tokens(3, toks.copy(), max_new_tokens=1) is None

        a = A(num_pages=16, page_size=2, prefix_sharing=True)
        a.admit_tokens(1, np.arange(4), max_new_tokens=4)
        with pytest.raises((AssertionError, RuntimeError)):
            a.rewind(1, 2)                         # a cached prompt page
        assert a.admit_tokens(2, np.arange(4), max_new_tokens=4)[1] == 4
        with pytest.raises((AssertionError, RuntimeError)):
            a.rewind(2, 2)                         # a shared page


def test_fifo_pin_budget_never_pins():
    """FIFO's pin budget is 0: a released prefix page goes back to the free
    list and leaves the prefix cache, as in the JAX allocator."""
    from repro_torch.serving.scheduler import FifoScheduler
    a = tkv.BlockAllocator(8, 4, prefix_sharing=True,
                           pin_budget_pages=FifoScheduler.pin_budget_pages)
    a.admit_tokens(1, np.arange(8), 2)
    assert a.cached_pages == 2
    a.release(1)
    assert (a.pinned_pages, a.cached_pages, a.used_pages) == (0, 0, 0)


# ---------------------------------------------------------------------------
# Device ops against the JAX ops
# ---------------------------------------------------------------------------

POOLS = [("model", "float32"), ("int8", "float32"), ("int8", "bfloat16"),
         ("int4", "bfloat16")]


def _pools(kv, sd, seed=0):
    """A JAX PagedCache of 3 slots with random payload, scales and tables,
    and the port's copy of it."""
    cfg = jax_get_config("gpt2_medium", smoke=True)
    rng = np.random.RandomState(seed)
    jc = jkv.init_paged_cache(cfg, 3, 9, PAGE, 4, kv_dtype=kv, kv_scale_dtype=sd)
    fill = {}
    for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        x = getattr(jc, name)
        if x is None:
            continue
        arr = np.asarray(x)
        if arr.dtype == np.int8:
            fill[name] = rng.randint(-128, 128, size=arr.shape).astype(np.int8)
        else:
            fill[name] = rng.randn(*arr.shape).astype(arr.dtype)
    tables = rng.randint(1, 9, size=(3, 4)).astype(np.int32)
    lengths = np.array([5, 13, 9], np.int32)
    jc = jkv.PagedCache(jax.numpy.asarray(lengths), jax.numpy.asarray(tables),
                        *(jax.numpy.asarray(fill[n]) if n in fill else None
                          for n in ("k_pages", "v_pages", "k_scale", "v_scale")))
    tc = tkv.PagedCache(*(bridge.tensor_from_numpy(np.asarray(getattr(jc, n)), "cpu")
                          if getattr(jc, n) is not None else None
                          for n in ("lengths", "block_tables", "k_pages", "v_pages",
                                    "k_scale", "v_scale")))
    return jc, tc


def _same_bits(tc, jc):
    for n in ("lengths", "block_tables", "k_pages", "v_pages", "k_scale", "v_scale"):
        j, t = getattr(jc, n), getattr(tc, n)
        assert (j is None) == (t is None), n
        if j is None:
            continue
        want = np.asarray(j)
        got = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        if want.dtype.name == "bfloat16":
            want = want.view(np.int16)
        np.testing.assert_array_equal(got, want, err_msg=n)


@pytest.mark.parametrize("kv,sd", POOLS)
def test_copy_page_matches_jax(kv, sd):
    jc, tc = _pools(kv, sd)
    jc = jkv.copy_page(jc, 3, 7)
    assert tkv.copy_page(tc, 3, 7) is tc
    _same_bits(tc, jc)


@pytest.mark.parametrize("kv,sd", POOLS)
def test_rewind_slot_matches_jax(kv, sd):
    jc, tc = _pools(kv, sd, seed=1)
    for slot, new_len, keep in ((1, 6, 2), (0, 4, 1), (2, 0, 0)):
        jc = jkv.rewind_slot(jc, slot, new_len, keep)
        tkv.rewind_slot(tc, slot, new_len, keep)
        _same_bits(tc, jc)


@pytest.mark.parametrize("S,length", [(7, 7), (8, 8), (12, 10)])
def test_write_prompt_pages_matches_jax(S, length):
    jc, tc = _pools("model", "float32", seed=2)
    rng = np.random.RandomState(S)
    shape = (jc.k_pages.shape[0], jc.k_pages.shape[2], S, jc.k_pages.shape[4])
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    ids = [6, 2, 5][:-(-length // PAGE)]
    jc = jkv.write_prompt_pages(jc, 1, ids, jax.numpy.asarray(k), jax.numpy.asarray(v),
                                length)
    tkv.write_prompt_pages(tc, 1, ids, torch.from_numpy(k), torch.from_numpy(v), length)
    _same_bits(tc, jc)
    _, tq = _pools("int8", "float32")
    with pytest.raises(ValueError, match="fp-only"):
        tkv.write_prompt_pages(tq, 0, [1], torch.zeros(shape), torch.zeros(shape), 4)


# ---------------------------------------------------------------------------
# Greedy drains with sharing on, against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MODELS)
def model(request):
    name = request.param
    jcfg = jax_get_config(name, smoke=True)
    jparams = jax_api.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return name, jcfg, jparams, get_config(name, smoke=True), tparams


def _workload(vocab):
    """Two donors' 8-token (2-page) prefixes with distinct tails, an exact
    repeat of a page-aligned donor prompt (the fully covered path: the
    last token recomputed through a COW fork), and an unrelated prompt."""
    rng = np.random.RandomState(3)
    pa, pb = rng.randint(2, vocab, size=8), rng.randint(2, vocab, size=8)
    prompts = [np.concatenate([pa, rng.randint(2, vocab, size=3)]),
               np.concatenate([pa, rng.randint(2, vocab, size=6)]),
               pb.copy(), pb.copy(),
               np.concatenate([pa, rng.randint(2, vocab, size=1)]),
               rng.randint(2, vocab, size=9)]
    return prompts, [6, 5, 7, 4, 6, 5]


def _drain(eng, prompts, new):
    uids = [eng.submit(p.copy(), max_new_tokens=n) for p, n in zip(prompts, new)]
    done = eng.run(max_steps=600)
    assert sorted(r.uid for r in done) == sorted(uids)
    by = {r.uid: list(r.generated) for r in done}
    a = eng.allocator
    assert (a.used_pages, a._reserved, a.pinned_pages, a.cached_pages) == (0, 0, 0, 0)
    return [by[u] for u in uids]


@pytest.fixture(scope="module")
def jax_drains():
    """Each JAX drain once per module, by (model, settings)."""
    memo = {}

    def get(model, **kw):
        name, jcfg, jparams, _, _ = model
        key = (name, tuple(sorted(kw.items())))
        if key not in memo:
            eng = JaxServingEngine(
                jparams, jcfg, SalPimEngine.create(SalPimConfig()),
                JaxEngineConfig(slots=2, max_len=32, paged=True, page_size=PAGE,
                                gen=JaxGenConfig(stop_on_eos=False), **kw))
            memo[key] = (_drain(eng, *_workload(jcfg.vocab)), eng)
        return memo[key]
    return get


def _port(model, **kw):
    _, jcfg, _, cfg, tparams = model
    return ServingEngine(tparams, cfg, TSalPimEngine.create(), EngineConfig(
        slots=2, max_len=32, paged=True, page_size=PAGE,
        gen=GenConfig(stop_on_eos=False), **kw), device="cpu")


@pytest.mark.parametrize("kv", ["model", "int8"])
@pytest.mark.parametrize("chunk", [None, 3])
def test_sharing_drain_matches_jax_engine(model, jax_drains, kv, chunk):
    kw = dict(kv_cache_dtype=kv, prefill_chunk_tokens=chunk)
    want, jeng = jax_drains(model, **kw)
    eng = _port(model, **kw)
    assert eng.config.prefix_sharing and eng.allocator.prefix_sharing
    got = _drain(eng, *_workload(model[1].vocab))
    assert got == want
    st = eng.stats()
    assert st["prefill_tokens_saved"] == jeng.prefill_tokens_saved > 0
    assert st["prefill_tokens"] == jeng.prefill_tokens
    assert st["peak_pages"] == jeng.peak_pages


def test_sharing_off_gives_the_same_tokens(model, jax_drains):
    want, _ = jax_drains(model, kv_cache_dtype="model", prefill_chunk_tokens=None)
    eng = _port(model, prefix_sharing=False)
    assert _drain(eng, *_workload(model[1].vocab)) == want
    assert eng.stats()["prefill_tokens_saved"] == 0


def _pools_of(cache):
    return [t for t in (cache.k_pages, cache.v_pages, cache.k_scale, cache.v_scale)
            if t is not None]


def test_forked_pages_leave_the_donor_intact(model, monkeypatch):
    """Every COW fork copies the donor page bit for bit, and a page a
    sharer borrowed reads, after every chunk and step, what the donor had
    written when the sharer's first chunk ran."""
    eng = _port(model, kv_cache_dtype="int8", prefill_chunk_tokens=3)
    copy_page, tick = tkv.copy_page, eng._prefill_tick
    snaps, n_forks = {}, []

    def spy_copy(cache, src, dst):
        before = [t[:, src].clone() for t in _pools_of(cache)]
        out = copy_page(cache, src, dst)
        for t, b in zip(_pools_of(cache), before):
            assert torch.equal(t[:, src], b) and torch.equal(t[:, dst], b)
        n_forks.append(src)
        return out

    def check():
        for p, saved in list(snaps.items()):
            if eng.allocator.refcount(p) == 0:
                del snaps[p]               # freed: its bits may be reused
                continue
            for t, b in zip(_pools_of(eng.cache), saved):
                assert torch.equal(t[:, p], b), p

    def spy_tick():
        cand = [(r.uid, i) for i, r in enumerate(eng.active)
                if r is not None and r.prefilling]
        if cand:
            req = eng.active[min(cand)[1]]
            if req.prefill_cursor == min(req.shared_prompt_tokens, len(req.prompt) - 1):
                for p in eng.allocator.pages_of(req.uid)[:req.shared_prompt_tokens // PAGE]:
                    snaps.setdefault(p, [t[:, p].clone() for t in _pools_of(eng.cache)])
        tick()
        check()

    monkeypatch.setattr(tkv, "copy_page", spy_copy)
    eng._prefill_tick = spy_tick
    prompts, new = _workload(model[1].vocab)
    for p, n in zip(prompts, new):
        eng.submit(p.copy(), max_new_tokens=n)
    while True:
        n = eng.step()
        check()
        if n == 0 and not eng.queue and all(r is None for r in eng.active):
            break
    assert n_forks and eng.prefill_tokens_saved > 0


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_decode_boundary_fork_matches_jax(model):
    """A decode append into a page another sequence holds forks it first
    (forced as the reference test forces it): the old page keeps its bits,
    and the tokens are the JAX engine's under the same forcing."""
    name, jcfg, jparams, cfg, tparams = model
    prompt = np.random.RandomState(5).randint(2, jcfg.vocab, size=6)
    outs = []
    for eng in (JaxServingEngine(jparams, jcfg, SalPimEngine.create(SalPimConfig()),
                                 JaxEngineConfig(slots=1, max_len=32, paged=True,
                                                 page_size=PAGE,
                                                 gen=JaxGenConfig(stop_on_eos=False))),
                _port(model)):
        eng.submit(prompt.copy(), max_new_tokens=4)
        eng.step()
        req = eng.active[0]
        pos = int(eng._host_len[0])
        page = eng.allocator.pages_of(req.uid)[pos // PAGE]
        eng.allocator._ref[page] += 1
        eng.allocator._quota[req.uid] += 1
        eng.allocator._reserved += 1
        before = _host(eng.cache.k_pages[:, page]).copy()
        eng.step()
        assert eng.allocator.pages_of(req.uid)[pos // PAGE] != page
        np.testing.assert_array_equal(_host(eng.cache.k_pages[:, page]), before)
        eng.allocator._decref(page)
        outs.append(eng.run(max_steps=100)[0].generated)
        assert eng.allocator.used_pages == 0
    assert list(outs[1]) == list(outs[0])
