"""The port's model on `gpt2_medium.smoke_config()` against the JAX model,
with the JAX weights carried across by `bridge.params_from_numpy`:
`prefill_chunk` logits and written pools (one chunk, and the split
{8, rest}), then four paged `decode_step`s, within 1e-4."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gpt2_medium as jax_gpt2
from repro.core.salpim import SalPimConfig, SalPimEngine
from repro.models import api as jax_api
from repro_torch import bridge
from repro_torch.configs import gpt2_medium
from repro_torch.core.salpim import SalPimConfig as TSalPimConfig
from repro_torch.core.salpim import SalPimEngine as TSalPimEngine
from repro_torch.models import api

TOL = 1e-4
PAGE, N_PAGES, MAX_PAGES = 4, 12, 5


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_gpt2.smoke_config()
    jparams = jax_api.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    return jcfg, jparams, tparams


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_init_params_mirrors_jax_tree(weights):
    jcfg, jparams, _ = weights
    mine = api.init_params(gpt2_medium.smoke_config(), seed=3, device="cpu")
    jflat = {jax.tree_util.keystr(k): v.shape
             for k, v in jax.tree_util.tree_leaves_with_path(jparams)}
    tflat = {jax.tree_util.keystr(k): tuple(v.shape)
             for k, v in jax.tree_util.tree_leaves_with_path(mine)}
    assert tflat == jflat
    d = jcfg.d_model
    assert abs(float(mine["blocks"]["attn"]["wq"].std()) - d ** -0.5) < 0.01
    assert float(mine["blocks"]["ln1"]["g"].min()) == 1.0
    again = api.init_params(gpt2_medium.smoke_config(), seed=3, device="cpu")
    assert torch.equal(again["embed"], mine["embed"])


@pytest.mark.parametrize("mode", ["exact", "lut"])
@pytest.mark.parametrize("splits", [[(0, 13)], [(0, 8), (8, 13)]])
def test_prefill_chunks_then_decode_match_jax(weights, mode, splits):
    jcfg, jparams, tparams = weights
    cfg = gpt2_medium.smoke_config()
    jeng = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))
    teng = TSalPimEngine.create(TSalPimConfig(nonlinear_mode=mode))
    rng = np.random.RandomState(11)
    B, S = 2, 13
    prompts = rng.randint(2, jcfg.vocab, size=(B, S)).astype(np.int32)
    rows = np.asarray([[3, 7, 1, 9, 0], [2, 11, 5, 4, 0]], np.int32)

    jcache = jax_api.init_paged_cache(jcfg, B, N_PAGES, PAGE, MAX_PAGES)
    tcache = api.init_paged_cache(cfg, B, N_PAGES, PAGE, MAX_PAGES, device="cpu")
    jkp, jvp = jcache.k_pages, jcache.v_pages
    for a, b in splits:
        st = np.full((B,), a, np.int32)
        jlog, jkp, jvp = jax_api.prefill_chunk(
            jparams, jnp.asarray(prompts[:, a:b]), jnp.asarray(rows),
            jnp.asarray(st), jkp, jvp, jcfg, jeng)
        tlog, tkp, tvp = api.prefill_chunk(
            tparams, torch.from_numpy(prompts[:, a:b]), torch.from_numpy(rows),
            torch.from_numpy(st), tcache.k_pages, tcache.v_pages, cfg, teng)
        assert tkp is tcache.k_pages           # pools written in place
        _close(tlog, jlog)
    _close(tcache.k_pages, jkp)
    _close(tcache.v_pages, jvp)

    # Decode 4 tokens from the prefilled state (slot lengths S).
    jcache = jcache.__class__(lengths=jnp.full((B,), S, jnp.int32),
                              block_tables=jnp.asarray(rows), k_pages=jkp,
                              v_pages=jvp)
    tcache = bridge.paged_cache_from_numpy(np.full((B,), S), rows,
                                           np.asarray(jkp), np.asarray(jvp),
                                           device="cpu")
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    for _ in range(4):
        jlog, jcache = jax_api.decode_step(jparams, jnp.asarray(tok), jcache,
                                           jcfg, jeng)
        tlog, tcache = api.decode_step(tparams, torch.from_numpy(tok), tcache,
                                       cfg, teng)
        _close(tlog, jlog)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    np.testing.assert_array_equal(tcache.lengths.numpy(), np.asarray(jcache.lengths))
    _close(tcache.k_pages, jcache.k_pages)
    _close(tcache.v_pages, jcache.v_pages)


def test_idle_slot_decode_parks_in_trash(weights):
    """A parked slot (length 0, all-trash row) appends into trash page 0,
    stays at length 0 and leaves every mapped page untouched."""
    _, _, tparams = weights
    cfg = gpt2_medium.smoke_config()
    cache = api.init_paged_cache(cfg, 2, N_PAGES, PAGE, MAX_PAGES, device="cpu")
    cache.lengths[0] = 3
    cache.block_tables[0, 0] = 5
    before = cache.k_pages.clone()
    _, cache = api.decode_step(tparams, torch.tensor([7, 9], dtype=torch.int32),
                               cache, cfg, TSalPimEngine.create())
    assert cache.lengths.tolist() == [4, 0]
    changed = (cache.k_pages != before).flatten(2).any(-1)   # (L, P)
    assert changed[:, 0].all() and changed[:, 5].all()
    assert not changed[:, 1:5].any() and not changed[:, 6:].any()
