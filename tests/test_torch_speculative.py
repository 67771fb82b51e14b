"""Speculative decoding in the port against the JAX package.

  * `verify_tokens` (models/api.py) against the JAX `verify_tokens` within
    the model parity tolerance 1e-4 (`tests/test_torch_model.py`), on
    gpt2_medium and qwen2_1_5b smoke, fp and int8 pools, three rows at
    different starts (one of them a parked all-trash row), and against the
    port's own sequential decode steps at the same positions (tolerance
    measured and stated below, argmaxes equal);
  * `NgramDrafter`, `DraftModelDrafter` (self-draft on the dense cache) and
    `greedy_accept` against the reference on the same contexts;
    `SpecConfig.validate` with the reference's messages;
  * greedy drains token for token with the JAX `ServingEngine`, with the
    same proposed/accepted/verify counts: `ngram` k=4 on and off, fp and
    int8 pools, self-draft (acceptance 1.0), an all-rejecting drafter
    (every round rewound), speculation with sharing and chunking, and
    requests that fill max_len (the verify pass's padded rows past the
    block table, and on a GPT-2 with a 32-row position table past
    max_seq), on gpt2_medium and qwen2_1_5b smoke; the rewound slot's
    device table and length after rejected rounds.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.salpim import SalPimConfig, SalPimEngine
from repro.models import api as jax_api
from repro.serving import speculative as jspec
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.config import GenConfig as JaxGenConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.salpim import SalPimEngine as TSalPimEngine
from repro_torch.models import api
from repro_torch.serving import kvcache as tkv
from repro_torch.serving import speculative as tspec
from repro_torch.serving.config import EngineConfig, GenConfig
from repro_torch.serving.engine import ServingEngine

TOL = 1e-4            # the model parity tolerance of tests/test_torch_model.py
# Verify logits against the port's own sequential decode logits (max abs
# difference over the smoke models' f32 logits, fp and int8 pools): the
# decode walk and the prefill walk sum in different orders (the prefill in
# fp64). Measured at most 2.15e-6 on the CPU (qwen2_1_5b, fp pools; the
# logits reach 3.9 in magnitude); held at 1e-5.
DECODE_TOL = 1e-5
PAGE, MAX_PAGES = 4, 8
MODELS = ["gpt2_medium", "qwen2_1_5b"]
JENGINE = SalPimEngine.create(SalPimConfig())
TENGINE = TSalPimEngine.create()


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    name = request.param
    jcfg = jax_get_config(name, smoke=True)
    jparams = jax_api.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return name, jcfg, jparams, get_config(name, smoke=True), tparams


# ---------------------------------------------------------------------------
# verify_tokens
# ---------------------------------------------------------------------------

def _resident(model, kv, seed=5):
    """Both packages' pools after two prompts of 6 and 9 tokens were
    prefilled into rows 0 and 1 (row 2 parked: an all-trash table)."""
    _, jcfg, jparams, cfg, tparams = model
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(2, jcfg.vocab, size=n) for n in (6, 9)]
    tables = np.zeros((3, MAX_PAGES), np.int32)
    tables[0, :3], tables[1, :3] = [1, 2, 3], [4, 5, 6]
    jc = jax_api.init_paged_cache(jcfg, 3, 12, PAGE, MAX_PAGES, kv_dtype=kv)
    tc = api.init_paged_cache(cfg, 3, 12, PAGE, MAX_PAGES, kv_dtype=kv, device="cpu")
    jpools = (jc.k_pages, jc.v_pages, jc.k_scale, jc.v_scale)
    logits = []
    for b, p in enumerate(prompts):
        res = jax_api.prefill_chunk(jparams, jnp.asarray(p[None]), jnp.asarray(tables[b:b + 1]),
                                    jnp.zeros((1,), jnp.int32), jpools[0], jpools[1], jcfg,
                                    JENGINE, jpools[2], jpools[3])
        jpools = tuple(res[1:]) + ((None, None) if kv == "model" else ())
        tres = api.prefill_chunk(tparams, torch.as_tensor(p[None]), torch.as_tensor(
            tables[b:b + 1]), torch.zeros(1, dtype=torch.int32), tc.k_pages, tc.v_pages,
            cfg, TENGINE, tc.k_scale, tc.v_scale)
        logits.append((res[0], tres[0]))
    starts = np.array([6, 9, 0], np.int32)
    return jpools, tc, tables, starts, logits


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_verify_tokens_matches_jax(model, kv):
    """Three rows of k+1 = 5 tokens at starts 6, 9 and 0 (the parked row
    writes the trash page): logits at every position and the pools."""
    _, jcfg, jparams, cfg, tparams = model
    jpools, tc, tables, starts, _ = _resident(model, kv)
    toks = np.random.RandomState(9).randint(2, jcfg.vocab, size=(3, 5))
    jres = jax_api.verify_tokens(jparams, jnp.asarray(toks), jnp.asarray(tables),
                                 jnp.asarray(starts), *jpools[:2], jcfg, JENGINE, *jpools[2:])
    tres = api.verify_tokens(tparams, torch.as_tensor(toks), torch.as_tensor(tables),
                             torch.as_tensor(starts), tc.k_pages, tc.v_pages, cfg, TENGINE,
                             tc.k_scale, tc.v_scale)
    assert tres[0].shape == (3, 5, cfg.vocab) and len(tres) == len(jres)
    np.testing.assert_allclose(tres[0].numpy(), np.asarray(jres[0]), rtol=TOL, atol=TOL)
    assert tres[1] is tc.k_pages
    if kv == "model":
        for got, want in zip(tres[1:], jres[1:]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_verify_matches_the_ports_sequential_decode(model, kv):
    """From one resident state: 3 greedy decode steps, and one verify pass
    over the same 3 tokens on a copy of the pools."""
    _, _, _, cfg, tparams = model
    _, tc, tables, starts, logits = _resident(model, kv)
    tc.block_tables.copy_(torch.as_tensor(tables))
    tc.lengths.copy_(torch.as_tensor(starts))
    pools = [t.clone() if t is not None else None
             for t in (tc.k_pages, tc.v_pages, tc.k_scale, tc.v_scale)]
    la = torch.stack([logits[0][1][0], logits[1][1][0], logits[1][1][0]])
    toks, seq = [], []
    cache = tc
    for _ in range(3):
        t = torch.argmax(la, -1).to(torch.int32)
        toks.append(t)
        la, cache = api.decode_step(tparams, t, cache, cfg, TENGINE)
        seq.append(la)
    vlog = api.verify_tokens(tparams, torch.stack(toks, 1), torch.as_tensor(tables),
                             torch.as_tensor(starts), pools[0], pools[1], cfg, TENGINE,
                             pools[2], pools[3])[0]
    for j in range(3):            # rows 0 and 1; row 2 is parked
        got, want = vlog[:2, j], seq[j][:2]
        assert float((got - want).abs().max()) <= DECODE_TOL, j
        assert torch.equal(got.argmax(-1), want.argmax(-1))
    for got, want in zip(pools, (cache.k_pages, cache.v_pages, cache.k_scale, cache.v_scale)):
        if got is not None:     # the same K/V written for rows 0 and 1's pages
            np.testing.assert_allclose(got[:, 1:7].float().numpy(),
                                       want[:, 1:7].float().numpy(), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# Drafters and acceptance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("nmax,nmin", [(3, 1), (2, 2), (4, 1)])
def test_ngram_drafter_matches_jax(seed, nmax, nmin):
    rng = np.random.RandomState(seed)
    jd, td = jspec.NgramDrafter(nmax, nmin), tspec.NgramDrafter(nmax, nmin)
    hits = 0
    for _ in range(40):
        ctx = rng.randint(0, 6, size=rng.randint(1, 30))
        k = int(rng.randint(1, 6))
        want, got = jd.propose(0, ctx, k), td.propose(0, ctx, k)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        hits += len(got) > 0
    assert hits > 0


def test_draft_model_drafter_matches_jax(model):
    """Self-draft on both packages: the same proposals over a growing
    context, a context change (re-prefill), released and fresh slots."""
    _, jcfg, jparams, cfg, tparams = model
    jd = jspec.DraftModelDrafter(jparams, jcfg, JENGINE, max_len=32, headroom=5)
    td = tspec.DraftModelDrafter(tparams, cfg, TENGINE, max_len=32, headroom=5)
    rng = np.random.RandomState(1)
    ctx = rng.randint(2, jcfg.vocab, size=6)
    other = rng.randint(2, jcfg.vocab, size=8)
    for slot, c, k in [(0, ctx, 4), (0, np.concatenate([ctx, [7, 9]]), 3),
                       (1, other, 4), (0, other, 2), (1, other[:5], 4)]:
        np.testing.assert_array_equal(td.propose(slot, c, k), jd.propose(slot, c, k))
    td.release(0)
    jd.release(0)
    assert 0 not in td._state and 1 in td._state
    np.testing.assert_array_equal(td.propose(0, ctx, 4), jd.propose(0, ctx, 4))
    # The rollback leaves the dense cache at the committed context.
    assert int(td._state[0][1].lengths[0]) == len(ctx)


def test_greedy_accept_matches_jax():
    rng = np.random.RandomState(3)
    for _ in range(200):
        drafts = rng.randint(0, 4, size=rng.randint(0, 6))
        greedy = rng.randint(0, 4, size=len(drafts) + 1)
        if rng.rand() < 0.5:
            greedy[:len(drafts)] = drafts
        for stop in (True, False):
            assert (tspec.greedy_accept(drafts, greedy, eos_id=0, stop_on_eos=stop)
                    == jspec.greedy_accept(drafts, greedy, eos_id=0, stop_on_eos=stop))


@pytest.mark.parametrize("kw", [dict(mode="oracle"), dict(k=0),
                                dict(ngram_min=3, ngram_max=2), dict(mode="draft-model")])
def test_spec_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as jerr:
        jspec.SpecConfig(**kw).validate()
    with pytest.raises(ValueError) as terr:
        tspec.SpecConfig(**kw).validate()
    assert str(terr.value) == str(jerr.value)
    tspec.SpecConfig().validate()


# ---------------------------------------------------------------------------
# Greedy drains against the JAX engine
# ---------------------------------------------------------------------------

class WrongDrafter:
    """Proposes vocab - 1 every time: rejected every round (the reference
    test's adversarial drafter)."""

    def __init__(self, vocab):
        self.vocab = vocab

    def propose(self, slot, context, k):
        return np.full((k,), -1, np.int64) % self.vocab

    def release(self, slot):
        pass


def _workload(vocab, seed=0):
    """Four random prompts of 4..10 tokens, two of them a repeated motif
    (which the ngram drafter can match), 6..13 new tokens each."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(2, vocab, size=rng.randint(4, 11)) for _ in range(4)]
    motif = rng.randint(2, vocab, size=3)
    prompts[1] = np.tile(motif, 3)
    prompts[3] = np.concatenate([motif, prompts[3][:4], motif])
    return prompts, [int(n) for n in rng.randint(6, 14, size=4)]


def _full_workload(vocab, seed=1):
    """Two requests whose prompt + max_new - 1 is max_len (32): their last
    verify rounds pad positions up to max_len + k - 1, past the block
    table's last page. One is a repeated motif the ngram drafter matches;
    the other, random, takes a round a token, so its last verify pass
    starts at position 31."""
    rng = np.random.RandomState(seed)
    prompts = [np.resize(rng.randint(2, vocab, size=3), 21),
               rng.randint(2, vocab, size=24)]
    return prompts, [33 - len(p) for p in prompts]


def _drain(eng, prompts, new, drafter=None):
    if drafter is not None:
        eng.drafter = drafter
    uids = [eng.submit(p.copy(), max_new_tokens=n) for p, n in zip(prompts, new)]
    done = eng.run(max_steps=600)
    assert sorted(r.uid for r in done) == sorted(uids)
    by = {r.uid: list(r.generated) for r in done}
    a = eng.allocator
    assert (a.used_pages, a._reserved, a.pinned_pages) == (0, 0, 0)
    return [by[u] for u in uids]


def _spec(pkg, model, mode):
    _, jcfg, jparams, cfg, tparams = model
    if mode is None:
        return None
    if mode == "self":
        return (jspec.SpecConfig(mode="draft-model", k=4, draft_cfg=jcfg, draft_params=jparams)
                if pkg == "jax" else
                tspec.SpecConfig(mode="draft-model", k=4, draft_cfg=cfg, draft_params=tparams))
    return (jspec if pkg == "jax" else tspec).SpecConfig(mode="ngram", k=4)


@pytest.fixture(scope="module")
def jax_drains():
    """Each JAX drain once per module, by (model, settings)."""
    memo = {}

    def get(model, spec=None, wrong=False, full=False, **kw):
        name, jcfg, jparams, _, _ = model
        key = (name, spec, wrong, full, tuple(sorted(kw.items())))
        if key not in memo:
            kw = dict(dict(prefix_sharing=False), **kw)
            eng = JaxServingEngine(jparams, jcfg, JENGINE, JaxEngineConfig(
                slots=2, max_len=32, paged=True, page_size=PAGE,
                gen=JaxGenConfig(stop_on_eos=False),
                speculative=_spec("jax", model, spec), **kw))
            out = _drain(eng, *(_full_workload if full else _workload)(jcfg.vocab),
                         drafter=WrongDrafter(jcfg.vocab) if wrong else None)
            memo[key] = out, eng.stats()
        return memo[key]
    return get


SPEC_KEYS = ("tokens", "proposed", "accepted", "verify_passes", "spec_rounds",
             "prefill_tokens", "prefill_tokens_saved", "peak_pages")


def _drain_both(model, jax_drains, spec=None, wrong=False, full=False, **kw):
    _, jcfg, _, cfg, tparams = model
    want, jst = jax_drains(model, spec, wrong, full, **kw)
    kw = dict(dict(prefix_sharing=False), **kw)
    eng = ServingEngine(tparams, cfg, TENGINE, EngineConfig(
        slots=2, max_len=32, paged=True, page_size=PAGE, gen=GenConfig(stop_on_eos=False),
        speculative=_spec("torch", model, spec), **kw), device="cpu")
    got = _drain(eng, *(_full_workload if full else _workload)(jcfg.vocab),
                 drafter=WrongDrafter(jcfg.vocab) if wrong else None)
    assert got == want
    st = eng.stats()
    assert {k: st[k] for k in SPEC_KEYS} == {k: jst[k] for k in SPEC_KEYS}
    for k in ("acceptance_rate", "verify_per_token", "tokens_per_pass"):
        assert st[k] == pytest.approx(jst[k])
    return st, want


@pytest.mark.parametrize("kv", ["model", "int8"])
@pytest.mark.parametrize("spec", [None, "ngram"])
def test_spec_drain_matches_jax_engine(model, jax_drains, kv, spec):
    st, want = _drain_both(model, jax_drains, spec, kv_cache_dtype=kv)
    if spec is not None:
        assert st["proposed"] > 0 and st["verify_passes"] > 0
        off, _ = jax_drains(model, None, kv_cache_dtype=kv)
        assert want == off           # speculation changes no token
    else:
        assert st["verify_passes"] == 0 and st["verify_per_token"] == 0.0


def test_self_draft_accepts_everything(model, jax_drains):
    st, want = _drain_both(model, jax_drains, "self")
    assert st["acceptance_rate"] == 1.0 and st["proposed"] > 0
    assert st["verify_per_token"] < 1.0
    assert want == jax_drains(model, None)[0]


def test_all_rejecting_drafter_rewinds_every_round(model, jax_drains):
    st, want = _drain_both(model, jax_drains, "ngram", wrong=True)
    assert st["accepted"] == 0 and st["proposed"] > 0
    # One token a round; a request's last token (its t0) needs no round.
    assert st["spec_rounds"] == st["tokens"] - len(want)
    assert want == jax_drains(model, None)[0]


def test_spec_with_sharing_and_chunks_matches_jax_engine(model, jax_drains):
    st, _ = _drain_both(model, jax_drains, "ngram", prefix_sharing=True,
                        prefill_chunk_tokens=3)
    assert st["proposed"] > 0


@pytest.mark.parametrize("kv,wrong", [("model", False), ("int8", True)])
def test_spec_drain_to_max_len_matches_jax_engine(model, jax_drains, kv, wrong):
    """Requests that fill max_len exactly: the verify pass's padded
    positions past the table's last page go to the trash page (the JAX
    engine drops them) and every token matches."""
    st, want = _drain_both(model, jax_drains, "ngram", wrong, full=True,
                           kv_cache_dtype=kv)
    assert st["proposed"] > 0
    assert want == jax_drains(model, None, full=True, kv_cache_dtype=kv)[0]


@pytest.fixture(scope="module")
def gpt2_max_seq_32():
    """gpt2_medium smoke with a 32-row position table: at max_len 32 the
    verify pass's padded rows run past max_seq as well as past the block
    table."""
    import dataclasses
    jcfg = dataclasses.replace(jax_get_config("gpt2_medium", smoke=True), max_seq=32)
    jparams = jax_api.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = dataclasses.replace(get_config("gpt2_medium", smoke=True), max_seq=32)
    return "gpt2_medium max_seq 32", jcfg, jparams, cfg, tparams


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_spec_drain_past_max_seq_matches_jax_engine(gpt2_max_seq_32, jax_drains, kv):
    st, want = _drain_both(gpt2_max_seq_32, jax_drains, "ngram", full=True,
                           kv_cache_dtype=kv)
    assert st["proposed"] > 0
    assert want == jax_drains(gpt2_max_seq_32, None, full=True, kv_cache_dtype=kv)[0]


def test_rejected_rounds_rewind_the_device_row(model):
    """After rounds whose drafts were all rejected the slot's table holds
    trash past its kept pages and its device length is the accepted
    frontier: one token a round past the prompt."""
    _, jcfg, _, cfg, tparams = model
    eng = ServingEngine(tparams, cfg, TENGINE, EngineConfig(
        slots=1, max_len=32, paged=True, page_size=2, gen=GenConfig(stop_on_eos=False),
        speculative=tspec.SpecConfig(mode="ngram", k=4)), device="cpu")
    eng.drafter = WrongDrafter(cfg.vocab)
    eng.submit(np.random.RandomState(13).randint(2, cfg.vocab, size=5), max_new_tokens=10)
    eng.step()
    eng.step()
    req = eng.active[0]
    n_mapped = len(eng.allocator.pages_of(req.uid))
    table = eng.cache.block_tables[0].numpy()
    assert (table[n_mapped:] == tkv.TRASH_PAGE).all() and (table[:n_mapped] != 0).all()
    assert int(eng.cache.lengths[0]) == int(eng._host_len[0]) == 5 + len(req.generated)
    assert n_mapped == eng.allocator.pages_for(int(eng._host_len[0]))
