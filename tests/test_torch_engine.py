"""The port's paged serving engine against the JAX `ServingEngine`: greedy
drains token-identical in exact and LUT mode at chunk sizes None and 8,
all pages returned; plus the port's guards (no JAX or `repro` imports in
the package, no silent CPU fallback, unsupported features raise)."""
from __future__ import annotations

import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import gpt2_medium as jax_gpt2
from repro.core.salpim import SalPimConfig, SalPimEngine
from repro.models import api as jax_api
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.config import GenConfig as JaxGenConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import bridge
from repro_torch.configs import gpt2_medium
from repro_torch.core.salpim import SalPimConfig as TSalPimConfig
from repro_torch.core.salpim import SalPimEngine as TSalPimEngine
from repro_torch.models import api
from repro_torch.serving.config import EngineConfig, GenConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import FifoScheduler

REPO = pathlib.Path(__file__).resolve().parents[1]
SLOTS, MAX_LEN, PAGE = 2, 32, 4


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_gpt2.smoke_config()
    jparams = jax_api.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    rng = np.random.RandomState(7)
    lens = [5, 11, 3, 17, 8]
    prompts = [rng.randint(2, jcfg.vocab, size=n) for n in lens]
    new = [6, 4, 8, 5, 7]
    return jcfg, jparams, tparams, prompts, new


def _drain(eng, prompts, new):
    uids = [eng.submit(p.copy(), max_new_tokens=n) for p, n in zip(prompts, new)]
    done = eng.run(max_steps=400)
    assert sorted(r.uid for r in done) == sorted(uids)
    by = {r.uid: list(r.generated) for r in done}
    return [by[u] for u in uids]


@pytest.mark.parametrize("mode", ["exact", "lut"])
@pytest.mark.parametrize("chunk", [None, 8])
def test_greedy_drain_matches_jax_engine(setup, mode, chunk):
    jcfg, jparams, tparams, prompts, new = setup
    kw = dict(slots=SLOTS, max_len=MAX_LEN, paged=True, page_size=PAGE,
              prefix_sharing=False, prefill_chunk_tokens=chunk)
    jeng = JaxServingEngine(
        jparams, jcfg, SalPimEngine.create(SalPimConfig(nonlinear_mode=mode)),
        JaxEngineConfig(gen=JaxGenConfig(stop_on_eos=False), **kw))
    want = _drain(jeng, prompts, new)

    teng = ServingEngine(
        tparams, gpt2_medium.smoke_config(),
        TSalPimEngine.create(TSalPimConfig(nonlinear_mode=mode)),
        EngineConfig(gen=GenConfig(stop_on_eos=False), **kw), device="cpu")
    got = _drain(teng, prompts, new)
    assert got == want
    assert teng.allocator.used_pages == 0
    st = teng.stats()
    assert st["tokens"] == sum(new)
    assert st["prefill_tokens"] == sum(len(p) for p in prompts)
    assert st["peak_pages"] == jeng.peak_pages


def test_import_guard():
    """No module of the port, and not chip_smoke.py, imports JAX or `repro`."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
           for f in files for m in pat.finditer(f.read_text())]
    assert not bad, bad


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch, setup):
    _, _, tparams, _, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gpt2_medium.smoke_config()
    eng_cfg = EngineConfig(slots=1, max_len=16, paged=True, prefix_sharing=False)
    engine = TSalPimEngine.create()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_paged_cache(cfg, 1, 4, 4, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tparams, cfg, engine, eng_cfg)
    params = api.init_params(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert api.init_paged_cache(cfg, 1, 4, 4, 2, device="cpu").k_pages.device.type == "cpu"
    ServingEngine(params, cfg, engine, eng_cfg, device="cpu")


@pytest.mark.parametrize("change", [
    {"paged": False}, {"prefix_sharing": True}, {"kv_cache_dtype": "int8"},
    {"kv_cache_dtype": "int4", "kv_scale_dtype": "bfloat16"},
    {"speculative": object()}, {"scheduler": object()},
    {"telemetry": object()}, {"mesh": object()}, {"kv_splits": 4},
    {"hardware": "h100"},
])
def test_unsupported_engine_features_raise(setup, change):
    _, _, tparams, _, _ = setup
    kw = dict(slots=1, max_len=16, paged=True, prefix_sharing=False)
    kw.update(change)
    with pytest.raises(NotImplementedError):
        ServingEngine(tparams, gpt2_medium.smoke_config(), TSalPimEngine.create(),
                      EngineConfig(**kw), device="cpu")


def test_fifo_scheduler_and_default_sharing():
    cfg = gpt2_medium.smoke_config()
    EngineConfig(slots=1, max_len=8, paged=True, prefix_sharing=False,
                 scheduler=FifoScheduler()).validate(cfg)
    with pytest.raises(NotImplementedError, match="prefix_sharing"):
        EngineConfig(slots=1, max_len=8, paged=True).validate(cfg)
    for quant_kw in ({"quant": "int8"}, {"kv_splits": 2}):
        with pytest.raises(NotImplementedError):
            TSalPimEngine.create(TSalPimConfig(**quant_kw))


def test_submit_rejects_oversized_requests(setup):
    _, _, tparams, _, _ = setup
    eng = ServingEngine(tparams, gpt2_medium.smoke_config(), TSalPimEngine.create(),
                        EngineConfig(slots=1, max_len=16, paged=True,
                                     prefix_sharing=False, num_pages=3,
                                     page_size=4), device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.arange(2, 14), max_new_tokens=8)
    with pytest.raises(ValueError, match="pages worst case"):
        eng.submit(np.arange(2, 12), max_new_tokens=4)
    assert not eng.queue and eng.allocator.used_pages == 0
