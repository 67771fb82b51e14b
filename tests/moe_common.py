"""Shared fixtures of the MoE tests (tests/test_torch_moe.py and
tests/test_torch_moe_drains.py): the JAX side, imported inside the `jx`
fixture only, and the four smoke models (olmoe-1B-7B and phi-3.5-MoE, at
their own cap factor 64 and the published 1.25) with the JAX parameters
carried across by `bridge.params_from_numpy`."""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.salpim import SalPimConfig as TSalPimConfig
from repro_torch.core.salpim import SalPimEngine as TSalPimEngine

MOE_MODELS = ["olmoe_1b_7b", "phi35_moe_42b"]
CAPS = [None, 1.25]                 # None: the smoke config's own (64.0)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.core.salpim import SalPimConfig, SalPimEngine
    from repro.models import api as jax_api
    from repro.models import moe as jmoe
    from repro.serving import engine as jengine
    from repro.serving import quantize as jquant
    from repro.serving import scheduler as jsched
    from repro.serving import telemetry as jtel
    from repro.serving.config import EngineConfig as JaxEngineConfig
    from repro.serving.config import GenConfig as JaxGenConfig
    from repro.serving.speculative import SpecConfig as JaxSpecConfig
    return SimpleNamespace(jax=jax, jnp=jnp, get_config=jax_get_config,
                           SalPimConfig=SalPimConfig, SalPimEngine=SalPimEngine,
                           api=jax_api, moe=jmoe, engine=jengine, quant=jquant,
                           sched=jsched, tel=jtel, EngineConfig=JaxEngineConfig,
                           GenConfig=JaxGenConfig, SpecConfig=JaxSpecConfig)


def smoke_configs(jx, name, cap=None, **over):
    """(JAX config, port config) of a smoke twin, at cap factor `cap`."""
    if cap is not None:
        over["router_cap_factor"] = cap
    return (dataclasses.replace(jx.get_config(name, smoke=True), **over),
            dataclasses.replace(get_config(name, smoke=True), **over))


_MODELS = {}


@pytest.fixture(scope="module", params=[(n, c) for n in MOE_MODELS for c in CAPS],
                ids=lambda p: f"{p[0]}-cap{p[1] or 'own'}")
def model(request, jx):
    """(name, JAX config, JAX params, port config, the same params)."""
    name, cap = request.param
    if request.param not in _MODELS:
        jcfg, cfg = smoke_configs(jx, name, cap)
        jparams = jx.api.init_params(jx.jax.random.PRNGKey(0), jcfg)
        tparams = bridge.params_from_numpy(jx.jax.tree.map(np.asarray, jparams), device="cpu")
        _MODELS[request.param] = (name, jcfg, jparams, cfg, tparams)
    return _MODELS[request.param]


def engine_pair(jx, mode="exact", **kw):
    return (jx.SalPimEngine.create(jx.SalPimConfig(nonlinear_mode=mode, **kw)),
            TSalPimEngine.create(TSalPimConfig(nonlinear_mode=mode, **kw)))


def assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
