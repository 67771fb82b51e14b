"""The roofline cost model in the port (`repro_torch.serving.costmodel`),
the twin of `tests/test_costmodel.py`, and the port against the JAX
package.

  * the reference's tests on the port's module: the byte math against the
    kernels' `kv_vector_bytes` and the pool's `page_kv_bytes`, page
    rounding, each phase's shape, the memory/compute classification, the
    hardware name's validation, `per_device` (identity at tensor_parallel
    1, KV divided at 2), the engine's always-on accumulation (telemetry
    off: modeled bytes, an empty registry), the snapshot's roofline, and
    `kv_splits` moving no modeled byte;
  * cost-model parity: `step_costs` and `describe()` equal to the JAX
    cost model's to 1e-12 relative over seeded `StepShape`s, on every
    registry config (the SSM and hybrid ones too), smoke and full, fp,
    int8 and int4 pools, paged and dense, with a draft model;
  * the port's analytic parameter counts equal to the JAX package's;
  * the port's specs: `h100` at 989 TFLOP/s bf16 and 3.35 TB/s, no TPU
    spec (`hardware="tpu-v4"` raises the reference's `ValueError`),
    `detect_hardware(torch.device("cpu"))` giving `cpu`;
  * `launch/serve.py`'s `main()` on the CPU (`--device cpu --smoke`).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.serving import costmodel as jcost
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.speculative import SpecConfig as JaxSpecConfig
from repro_torch import bridge
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.salpim import SalPimEngine
from repro_torch.kernels.paged_attention import kv_vector_bytes
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.serving.config import EngineConfig, GenConfig
from repro_torch.serving.costmodel import (HARDWARE_SPECS, CostModel, HardwareSpec,
                                           PhaseCost, StepShape, detect_hardware)
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvcache import page_kv_bytes
from repro_torch.serving.speculative import SpecConfig
from repro_torch.serving.telemetry import Telemetry

ENGINE = SalPimEngine.create()
POOLS = [("model", "float32"), ("int8", "float32"), ("int4", "bfloat16")]
_PARAMS = {}


def _setup(arch="gpt2_medium"):
    cfg = get_config(arch, smoke=True)
    if arch not in _PARAMS:
        from repro.models import api as jax_api
        jparams = jax_api.init_params(jax.random.PRNGKey(0), jax_get_config(arch, smoke=True))
        _PARAMS[arch] = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                 device="cpu")
    return cfg, _PARAMS[arch]


def _model(cfg, **kw):
    kw.setdefault("hardware", HARDWARE_SPECS["hbm2"])
    return CostModel(cfg, **kw)


def _engine(params, cfg, **kw):
    return ServingEngine(params, cfg, ENGINE, EngineConfig(
        slots=2, max_len=32, gen=GenConfig(stop_on_eos=False), paged=True, page_size=8,
        **kw), device="cpu")


def _drain(eng, reqs):
    for p, n in reqs:
        eng.submit(p, max_new_tokens=n)
    eng.run(max_steps=500)
    assert not eng.queue and not any(eng.active)
    return {r.uid: list(r.generated) for r in eng.finished}


def _reqs(cfg, n=2, plen=6, new=4):
    rng = np.random.RandomState(0)
    return [(rng.randint(2, cfg.vocab, size=plen), new) for _ in range(n)]


# -- byte math: one source of truth ----------------------------------------

@pytest.mark.parametrize("kv_dtype,scale", POOLS)
def test_page_bytes_match_pool_contract(kv_dtype, scale):
    cfg, _ = _setup()
    for page_size in (1, 4, 16):
        cm = _model(cfg, page_size=page_size, kv_dtype=kv_dtype, kv_scale_dtype=scale)
        assert cm.page_bytes == page_kv_bytes(cfg, page_size, kv_dtype, scale)
        assert cm.kv_token_bytes == 2 * cfg.n_layers * cfg.n_kv_heads * cm.vec_bytes
        assert cm.vec_bytes == kv_vector_bytes(cfg.head_dim, kv_dtype, scale,
                                               payload_dtype=cfg.cdtype)


def test_kv_byte_ratios_quantized():
    cfg, _ = _setup()
    fp = _model(cfg, kv_dtype="model")
    q8 = _model(cfg, kv_dtype="int8")
    q4 = _model(cfg, kv_dtype="int4", kv_scale_dtype="bfloat16")
    # fp: Dh * 4 bytes; int8: Dh + 4; int4: Dh/2 + 2 per vector.
    d = cfg.head_dim
    assert fp.vec_bytes / q8.vec_bytes == pytest.approx(4 * d / (d + 4))
    assert fp.vec_bytes / q4.vec_bytes == pytest.approx(4 * d / (d / 2 + 2))
    assert fp.page_bytes > q8.page_bytes > q4.page_bytes


def test_kv_read_bytes_page_rounded():
    cfg, _ = _setup()
    cm = _model(cfg, page_size=16)
    assert cm.kv_read_bytes(0) == 0.0
    one_page = 16 * cm.kv_token_bytes
    assert cm.kv_read_bytes(1) == one_page
    assert cm.kv_read_bytes(16) == one_page
    assert cm.kv_read_bytes(17) == 2 * one_page


# -- phase shapes ----------------------------------------------------------

def test_decode_streams_weights_once_per_launch():
    cfg, _ = _setup()
    cm = _model(cfg, page_size=4)
    c1 = cm.decode([8])
    c2 = cm.decode([8, 8, 8])
    assert c1.weight_bytes == c2.weight_bytes == cm.weight_stream_bytes
    assert c2.kv_bytes == pytest.approx(3 * c1.kv_bytes)
    assert c2.linear_flops == pytest.approx(3 * c1.linear_flops)
    assert c1.intensity < 5.0          # the textbook memory-bound shape


def test_chunk_prefill_attention_grows_with_offset():
    cfg, _ = _setup()
    cm = _model(cfg, page_size=4)
    early = cm.chunk_prefill(0, 8)
    late = cm.chunk_prefill(64, 8)
    assert late.attn_flops > early.attn_flops      # reads back the prefix
    assert late.weight_bytes == early.weight_bytes
    assert early.attn_flops == cm._attn_flops(8 * 9 / 2)
    assert late.attn_flops == cm._attn_flops(8 * 64 + 8 * 9 / 2)


def test_verify_is_batched_chunk_rows():
    cfg, _ = _setup()
    cm = _model(cfg, page_size=4)
    v = cm.verify([(10, 3), (20, 3)])
    r1, r2 = cm.chunk_prefill(10, 3), cm.chunk_prefill(20, 3)
    assert v.weight_bytes == cm.weight_stream_bytes   # one launch
    assert v.kv_bytes == pytest.approx(r1.kv_bytes + r2.kv_bytes)
    assert v.attn_flops == pytest.approx(r1.attn_flops + r2.attn_flops)


def test_step_costs_keys_follow_shape():
    cfg, _ = _setup()
    cm = _model(cfg, page_size=4)
    assert cm.step_costs(StepShape()) == {}
    costs = cm.step_costs(StepShape(decode_lens=[4, 4], decode_ran=True, chunk=(0, 8)))
    assert set(costs) == {"decode", "chunk_prefill"}
    # A decode launch over all-dead rows still streams the weights.
    dead = cm.step_costs(StepShape(decode_ran=True))
    assert dead["decode"].weight_bytes == cm.weight_stream_bytes
    assert dead["decode"].kv_bytes == 0.0


# -- classification and the port's specs -----------------------------------

def test_hardware_classification_and_ridge():
    hw = HardwareSpec("x", peak_flops=100e12, peak_bytes_per_sec=1e12)
    assert hw.ridge == pytest.approx(100.0)
    assert hw.classify(1.0) == "memory"
    assert hw.classify(500.0) == "compute"
    for spec in HARDWARE_SPECS.values():
        assert spec.ridge > 0
    # SAL-PIM's point: internal bandwidth moves the ridge left.
    assert HARDWARE_SPECS["salpim-hbm2"].ridge < HARDWARE_SPECS["hbm2"].ridge
    assert detect_hardware(torch.device("cpu")).name == "cpu"
    assert detect_hardware("cpu") is HARDWARE_SPECS["cpu"]


def test_port_specs():
    """The paper's HBM2 and PIM rooflines and the CPU's as the reference
    states them, the H100's peaks, and no TPU spec."""
    assert sorted(HARDWARE_SPECS) == ["cpu", "h100", "hbm2", "salpim-hbm2"]
    for name in ("hbm2", "salpim-hbm2", "cpu"):
        assert HARDWARE_SPECS[name].to_dict() == jcost.HARDWARE_SPECS[name].to_dict()
    h100 = HARDWARE_SPECS["h100"]
    assert (h100.peak_flops, h100.peak_bytes_per_sec) == (989e12, 3.35e12)
    assert h100.classify(CostModel(get_config("gpt2_medium"), page_size=16,
                                   hardware=h100).decode([160] * 4).intensity) == "memory"


def test_detect_hardware_refuses_unknown_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert detect_hardware("cuda").name == "h100"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="hardware="):
        detect_hardware("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        detect_hardware("cuda")


@pytest.mark.parametrize("name", ["hbm9", "tpu-v4", "tpu-v5e"])
def test_engine_config_hardware_validation(name):
    cfg, _ = _setup()
    with pytest.raises(ValueError, match="unknown hardware") as err:
        EngineConfig(slots=2, max_len=32, hardware=name).validate(cfg)
    assert str(err.value) == (f"unknown hardware {name!r}; known roofline specs: "
                              f"{sorted(HARDWARE_SPECS)}")
    for ok in HARDWARE_SPECS:
        EngineConfig(slots=2, max_len=32, hardware=ok).validate(cfg)


def test_from_configs_resolves_hardware_and_dtype():
    cfg, _ = _setup()
    ec = EngineConfig(slots=2, max_len=32, paged=True, page_size=8,
                      kv_cache_dtype="int8", hardware="salpim-hbm2")
    cm = CostModel.from_configs(cfg, ec)
    assert cm.hardware.name == "salpim-hbm2"
    assert cm.kv_dtype == "int8"
    assert cm.page_size == 8
    assert ec.tensor_parallel() == cm.tp == 1
    # Dense engines model un-paged (page_size 1 = exact-length) reads; with
    # no hardware named, the device decides.
    cm_dense = CostModel.from_configs(cfg, EngineConfig(slots=2, max_len=32), device="cpu")
    assert cm_dense.page_size == 1 and cm_dense.hardware.name == "cpu"


# -- mesh ------------------------------------------------------------------

def test_per_device_shards_kv_not_weights():
    cfg, _ = _setup()
    assert cfg.n_kv_heads % 2 == 0, "test assumes tp=2 divides kv heads"
    cm1 = _model(cfg, page_size=4, tensor_parallel=1)
    cm2 = _model(cfg, page_size=4, tensor_parallel=2)
    shape = StepShape(decode_lens=[16, 16], decode_ran=True)
    dev = cm2.per_device(cm2.step_costs(shape))["decode"]
    full = cm1.step_costs(shape)["decode"]
    assert dev.kv_bytes == pytest.approx(full.kv_bytes / 2)
    assert dev.weight_bytes == full.weight_bytes          # replicated
    assert dev.attn_flops == pytest.approx(full.attn_flops / 2)
    assert dev.linear_flops == full.linear_flops
    n_tokens = full.act_bytes / cm2.logits_row_bytes
    assert dev.act_bytes == pytest.approx(full.act_bytes + cm2.gather_bytes_per_token * n_tokens)
    # tp=1 (no mesh, or a "model" extent of 1) is the identity.
    same = cm1.per_device(cm1.step_costs(StepShape(decode_lens=[4], decode_ran=True)))
    assert same["decode"].kv_bytes == cm1.decode([4]).kv_bytes


# -- engine integration ----------------------------------------------------

def test_engine_accumulates_costs_telemetry_off():
    cfg, params = _setup()
    eng = _engine(params, cfg)
    assert eng.cost_model.page_bytes == eng.page_bytes
    assert eng.cost_model.hardware.name == "cpu"
    _drain(eng, _reqs(cfg))
    roof = eng.stats()["roofline"]
    assert roof["decode"]["modeled_bytes"] > 0
    assert roof["decode"]["bound"] in ("memory", "compute")
    assert eng.telemetry.registry.empty


def test_engine_snapshot_roofline_phases():
    cfg, params = _setup()
    tel = Telemetry(enabled=True)
    eng = _engine(params, cfg, prefill_chunk_tokens=8, telemetry=tel, hardware="h100")
    _drain(eng, _reqs(cfg))
    roof = tel.snapshot()["roofline"]
    assert roof["hardware"] == HARDWARE_SPECS["h100"].to_dict()
    assert roof["model"]["page_bytes"] == eng.page_bytes
    dec = roof["phases"]["decode"]
    assert dec["bytes"] > 0 and dec["sec"] > 0
    assert dec["achieved_gbps"] > 0
    assert dec["bound"] == "memory"
    assert "chunk_prefill" in roof["phases"]
    assert eng.stats()["roofline"]["decode"]["modeled_bytes"] == pytest.approx(dec["bytes"])


def test_kv_splits_change_time_not_modeled_bytes():
    cfg, params = _setup()
    mods, outs = {}, {}
    for splits in (None, 4):
        eng = _engine(params, cfg, kv_splits=splits)
        outs[splits] = _drain(eng, _reqs(cfg))
        mods[splits] = {p: v["modeled_bytes"] for p, v in eng.stats()["roofline"].items()}
    assert outs[4] == outs[None]
    assert mods[4] == mods[None]


def test_phasecost_add_and_dict():
    a = PhaseCost(weight_bytes=10, kv_bytes=5, linear_flops=30)
    b = PhaseCost(kv_bytes=5, attn_flops=20)
    c = a.add(b)
    assert c.bytes == 20 and c.flops == 50
    assert c.intensity == pytest.approx(2.5)
    d = c.to_dict()
    assert d["bytes"] == 20 and d["arithmetic_intensity"] == 2.5
    assert PhaseCost().intensity == 0.0


# -- parity with the JAX package --------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(arch, smoke):
    cfg, jcfg = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def _shapes(rng, n=24):
    for _ in range(n):
        lens = [int(x) for x in rng.randint(1, 300, size=rng.randint(0, 5))]
        yield StepShape(
            decode_lens=lens, decode_ran=bool(lens) or bool(rng.rand() < 0.3),
            chunk=((int(rng.randint(0, 256)), int(rng.randint(1, 65)))
                   if rng.rand() < 0.5 else None),
            verify=[(int(rng.randint(0, 256)), int(rng.randint(1, 6)))
                    for _ in range(rng.randint(0, 4))],
            draft_forwards=int(rng.randint(0, 9)) if rng.rand() < 0.5 else 0,
            admit_prompt_tokens=int(rng.randint(1, 200)) if rng.rand() < 0.3 else 0)


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-12, abs=0.0), (a, b)
    else:
        assert a == b


@pytest.mark.parametrize("kv,scale", POOLS)
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_costs_match_jax(arch, smoke, kv, scale):
    """Paged at page 16 with a draft model (the smoke twin of gpt2_medium)
    and dense without one, each against the JAX cost model built from the
    same EngineConfig fields."""
    cfg, jcfg = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
    draft, jdraft = get_config("gpt2_medium", smoke=True), jax_get_config("gpt2_medium",
                                                                          smoke=True)
    rng = np.random.RandomState(len(arch) + 7 * smoke)
    for paged in (True, False):
        kw = dict(slots=4, max_len=256, hardware="hbm2")
        if paged:
            kw.update(paged=True, page_size=16, kv_cache_dtype=kv, kv_scale_dtype=scale)
        spec = SpecConfig(mode="draft-model", k=3, draft_cfg=draft) if paged else None
        jspec = JaxSpecConfig(mode="draft-model", k=3, draft_cfg=jdraft) if paged else None
        cm = CostModel.from_configs(cfg, EngineConfig(speculative=spec, **kw))
        jcm = jcost.CostModel.from_configs(jcfg, JaxEngineConfig(speculative=jspec, **kw))
        _close(cm.describe(), jcm.describe())
        for shape in _shapes(rng):
            got = cm.step_costs(shape)
            want = jcm.step_costs(jcost.StepShape(**vars(shape)))
            _close({p: c.to_dict() for p, c in got.items()},
                   {p: c.to_dict() for p, c in want.items()})
            _close({p: c.to_dict() for p, c in cm.per_device(got).items()},
                   {p: c.to_dict() for p, c in jcm.per_device(want).items()})


# -- launch/serve.py ---------------------------------------------------------

@pytest.mark.parametrize("argv,want", [
    (["--device", "cpu", "--smoke"],
     ["gpt2-medium-smoke: 164,544 params, nonlin=exact, weights=float32, kv=model",
      "8 requests through 4 slots: "]),
    (["--device", "cpu", "--smoke", "--arch", "qwen2-1.5b", "--lut", "--int8",
      "--requests", "5", "--slots", "2", "--max-new", "6"],
     ["qwen2-1.5b-smoke: 152,128 params, nonlin=lut, weights=int8, kv=int8",
      "5 requests through 2 slots: "]),
    (["--device", "cpu", "--mode", "batch", "--requests", "3", "--max-new", "4"],
     ["gpt2-medium-smoke: 164,544 params", "| 12 tokens"]),
])
def test_serve_main_on_the_cpu(capsys, argv, want):
    serve.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    for line, start in zip(lines, want):
        assert start in line, (line, start)
