"""Shared fixtures of the SSM and hybrid tests (tests/test_torch_mamba2.py
and tests/test_torch_ssm_drains.py): the JAX side, imported inside the
`jx` fixture only, and the two smoke models (mamba2-370m and zamba2-1.2B)
with the JAX parameters carried across by `bridge.params_from_numpy`."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.salpim import SalPimConfig as TSalPimConfig
from repro_torch.core.salpim import SalPimEngine as TSalPimEngine

SSM_MODELS = ["mamba2_370m", "zamba2_1_2b"]


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.core.salpim import SalPimConfig, SalPimEngine
    from repro.models import api as jax_api
    from repro.models import mamba2 as jm2
    from repro.models import transformer as jtf
    from repro.serving import engine as jengine
    from repro.serving import quantize as jquant
    from repro.serving import telemetry as jtel
    from repro.serving.config import EngineConfig as JaxEngineConfig
    from repro.serving.config import GenConfig as JaxGenConfig
    return SimpleNamespace(jax=jax, jnp=jnp, get_config=jax_get_config,
                           SalPimConfig=SalPimConfig, SalPimEngine=SalPimEngine,
                           api=jax_api, m2=jm2, tf=jtf, engine=jengine, quant=jquant,
                           tel=jtel, EngineConfig=JaxEngineConfig, GenConfig=JaxGenConfig)


_MODELS = {}


@pytest.fixture(scope="module", params=SSM_MODELS)
def model(request, jx):
    """(name, JAX config, JAX params, port config, the same params)."""
    name = request.param
    if name not in _MODELS:
        jcfg, cfg = jx.get_config(name, smoke=True), get_config(name, smoke=True)
        jparams = jx.api.init_params(jx.jax.random.PRNGKey(0), jcfg)
        tparams = bridge.params_from_numpy(jx.jax.tree.map(np.asarray, jparams), device="cpu")
        _MODELS[name] = (name, jcfg, jparams, cfg, tparams)
    return _MODELS[name]


def engine_pair(jx, mode="exact", **kw):
    return (jx.SalPimEngine.create(jx.SalPimConfig(nonlinear_mode=mode, **kw)),
            TSalPimEngine.create(TSalPimConfig(nonlinear_mode=mode, **kw)))


def assert_close(got, want, tol):
    """Within `tol` of `want` relative to its largest |value|."""
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1.0))
