"""The port's LUT tables and nonlinear policy against the JAX package:
identical tables, and the interpolation, range-reduced reciprocal and
rsqrt within 1e-6 on the same inputs."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut as jlut
from repro.core.nonlinear import Nonlinear as JaxNonlinear
from repro_torch.core import lut as tlut
from repro_torch.core.nonlinear import Nonlinear

JBANK = jlut.LutBank.create(64)
TBANK = tlut.LutBank.create(64)
NAMES = ["gelu", "silu", "exp", "tanh", "softplus", "sigmoid", "recip", "rsqrt"]


def _inputs(table, n=4096, seed=0):
    rng = np.random.RandomState(seed)
    span = table.hi - table.lo
    x = rng.uniform(table.lo - 0.5 * span, table.hi + 0.5 * span, size=n)
    # Section edges and the range ends exercise the floor and the guards.
    edges = np.linspace(table.lo, table.hi, table.sections + 1)
    return np.concatenate([x, edges, [-1e4, 1e4]]).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_tables_equal_jax(name):
    jt, tt = getattr(JBANK, name), getattr(TBANK, name)
    np.testing.assert_array_equal(tt.wb, np.asarray(jt.wb))
    assert (tt.lo, tt.hi, tt.sections) == (jt.lo, jt.hi, jt.sections)
    assert tt.inv_step == jt.inv_step


@pytest.mark.parametrize("name", NAMES)
def test_apply_table_matches_jax(name):
    jt, tt = getattr(JBANK, name), getattr(TBANK, name)
    x = _inputs(tt)
    want = np.asarray(jlut.apply_table(jnp.asarray(x), jt))
    got = tlut.apply_table(torch.from_numpy(x), tt).numpy()
    np.testing.assert_array_equal(tlut.section_index(torch.from_numpy(x), tt).numpy(),
                                  np.asarray(jlut.section_index(jnp.asarray(x), jt)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn", ["lut_reciprocal", "lut_rsqrt"])
def test_range_reduced_luts_match_jax(fn):
    rng = np.random.RandomState(1)
    # Softmax sums and variances: the range the model feeds these.
    x = np.exp(rng.uniform(-14, 14, size=4096)).astype(np.float32)
    x = np.concatenate([x, [1.0, 0.5, 0.25, 2.0, 3.0, 1e-6, 1e6]]).astype(np.float32)
    table = "recip" if fn == "lut_reciprocal" else "rsqrt"
    want = np.asarray(getattr(jlut, fn)(jnp.asarray(x), getattr(JBANK, table)))
    got = getattr(tlut, fn)(torch.from_numpy(x), getattr(TBANK, table)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["exact", "lut"])
def test_nonlinear_policy_matches_jax(mode):
    rng = np.random.RandomState(2)
    x = (rng.randn(6, 48) * 3).astype(np.float32)
    g = rng.randn(48).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    mask = rng.rand(6, 48) > 0.3
    jn, tn = JaxNonlinear.create(mode), Nonlinear.create(mode)
    tx = torch.from_numpy(x)
    pairs = [
        (jn.gelu(jnp.asarray(x)), tn.gelu(tx)),
        (jn.softmax(jnp.asarray(x), where=jnp.asarray(mask)),
         tn.softmax(tx, where=torch.from_numpy(mask))),
        (jn.layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)),
         tn.layernorm(tx, torch.from_numpy(g), torch.from_numpy(b))),
        (jn.rmsnorm(jnp.asarray(x), jnp.asarray(g)), tn.rmsnorm(tx, torch.from_numpy(g))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
