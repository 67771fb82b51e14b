"""The port's paged serving engine against the JAX `ServingEngine`: greedy
drains token-identical in exact and LUT mode at chunk sizes None and 8, on
int8 (f32 and bf16 scale rows) and int4 pools, with the KV-split decode
engaged (`kv_splits=4`, a 1024-token block table), and on the quantized
linear datapaths (`quant="int8"` exact and LUT, `quant="fixed16"`, and
`quantize_params_int8` weights with int8 pools), all pages returned; the
default paged config (prefix sharing on) and speculative configs drained
against the JAX engine; plus the port's guards (no JAX or `repro` imports
in the package, no silent CPU fallback, bad
pool, split, speculative and mesh settings raise the JAX package's
`ValueError`s)."""
from __future__ import annotations

import dataclasses
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
from repro.serving.quantize import quantize_params_int8 as jax_quantize_params_int8
from repro.serving.scheduler import SloScheduler as JaxSloScheduler
from repro.serving.speculative import SpecConfig as JaxSpecConfig
from repro_torch import bridge
from repro_torch.configs import gpt2_medium
from repro_torch.core.salpim import SalPimConfig as TSalPimConfig
from repro_torch.core.salpim import SalPimEngine as TSalPimEngine
from repro_torch.models import api
from repro_torch.serving.config import EngineConfig, GenConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.quantize import QTensor
from repro_torch.serving.scheduler import FifoScheduler, SloScheduler
from repro_torch.serving.speculative import SpecConfig
from repro_torch.serving.telemetry import Telemetry

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


def _drain_both(setup, mode="exact", quant="none", transform=None, **kw):
    """Drain the same requests through both engines, on SAL-PIM datapath
    `quant` and with `transform` (e.g. `quantize_params_int8`) applied to
    the JAX parameters before they are bridged; check tokens, pages and
    counts; return the port's engine."""
    jcfg, jparams, tparams, prompts, new = setup
    if transform is not None:
        jparams = transform(jparams)
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           device="cpu")
    kw = dict(dict(slots=SLOTS, max_len=MAX_LEN, paged=True, page_size=PAGE,
                   prefix_sharing=False), **kw)
    jeng = JaxServingEngine(
        jparams, jcfg,
        SalPimEngine.create(SalPimConfig(nonlinear_mode=mode, quant=quant)),
        JaxEngineConfig(gen=JaxGenConfig(stop_on_eos=False), **kw))
    want = _drain(jeng, prompts, new)

    teng = ServingEngine(
        tparams, gpt2_medium.smoke_config(),
        TSalPimEngine.create(TSalPimConfig(nonlinear_mode=mode, quant=quant)),
        EngineConfig(gen=GenConfig(stop_on_eos=False), **kw), device="cpu")
    got = _drain(teng, prompts, new)
    assert got == want
    assert teng.allocator.used_pages == 0
    st = teng.stats()
    assert st["tokens"] == sum(new)
    assert st["prefill_tokens"] == sum(len(p) for p in prompts)
    assert st["peak_pages"] == jeng.peak_pages
    assert teng.allocator.num_pages == jeng.allocator.num_pages
    return teng


@pytest.mark.parametrize("mode", ["exact", "lut"])
@pytest.mark.parametrize("chunk", [None, 8])
def test_greedy_drain_matches_jax_engine(setup, mode, chunk):
    _drain_both(setup, mode, prefill_chunk_tokens=chunk)


@pytest.mark.parametrize("kv,scales", [("int8", "float32"), ("int8", "bfloat16"),
                                       ("int4", "bfloat16")])
@pytest.mark.parametrize("chunk", [None, 8])
def test_quantized_pool_drain_matches_jax_engine(setup, kv, scales, chunk):
    """Write-time quantized pools: same tokens, and the byte budget gives
    both engines the same (larger) page count."""
    teng = _drain_both(setup, kv_cache_dtype=kv, kv_scale_dtype=scales,
                       prefill_chunk_tokens=chunk)
    assert teng.cache.quantized and teng.cache.k_pages.dtype == torch.int8
    assert teng.cache.k_scale.dtype == getattr(torch, scales)
    assert teng.allocator.num_pages > SLOTS * (MAX_LEN // PAGE) + 1


def test_split_decode_drain_matches_jax_engine(setup):
    """kv_splits=4 at max_len=1024, page 16: the block table spans 1024
    tokens, so every decode step of both engines runs the KV-split path."""
    from repro_torch.kernels import paged_attention as paged_k
    calls = []
    split_plain = paged_k.paged_attention_split_plain

    def spy(*a, **k):
        calls.append(k["kv_splits"])
        return split_plain(*a, **k)

    paged_k.paged_attention_split_plain = spy
    try:
        teng = _drain_both(setup, max_len=1024, page_size=16, kv_splits=4,
                           prefill_chunk_tokens=8)
    finally:
        paged_k.paged_attention_split_plain = split_plain
    assert teng.engine.config.kv_splits == 4
    assert calls and set(calls) == {4}
    assert len(calls) == teng.decode_steps * gpt2_medium.smoke_config().n_layers


@pytest.mark.parametrize("quant,mode,chunk", [("int8", "exact", None),
                                               ("int8", "exact", 8),
                                               ("fixed16", "exact", None),
                                               ("int8", "lut", None)])
def test_quantized_linear_drain_matches_jax_engine(setup, quant, mode, chunk):
    """Weights and activations quantized on every linear call: the int8
    and fixed16 GEMVs' plain versions against the JAX engine's oracles."""
    teng = _drain_both(setup, mode, quant=quant, prefill_chunk_tokens=chunk)
    assert teng.engine.config.quant == quant


def test_int8_weights_and_pools_drain_matches_jax_engine(setup):
    """`quantize_params_int8` weights with int8 pools, the configuration
    of `repro.launch.serve --int8`: every matmul weight a QTensor."""
    teng = _drain_both(setup, transform=jax_quantize_params_int8,
                       kv_cache_dtype="int8", prefill_chunk_tokens=8)
    attn = teng.params["blocks"]["attn"]
    assert isinstance(teng.params["lm_head"], QTensor)
    assert isinstance(attn["wq"], QTensor) and attn["wq"].w_i8.dtype == torch.int8
    assert not isinstance(teng.params["embed"], QTensor)
    assert teng.cache.k_pages.dtype == torch.int8


def test_int8_weights_lut_drain_matches_jax_engine(setup):
    """`quantize_params_int8` weights with LUT nonlinearities: the LUT GELU
    rides the int8 linear layer's epilogue (`qtensor_linear(...,
    act_table=...)`), on the cast value, as the JAX engine applies it after
    `qtensor_linear`."""
    teng = _drain_both(setup, mode="lut", transform=jax_quantize_params_int8,
                       kv_cache_dtype="int8", prefill_chunk_tokens=8)
    assert isinstance(teng.params["blocks"]["ffn"]["w_up"], QTensor)


def test_import_guard():
    """No module of the port, not chip_smoke.py and not the mesh tests' rank
    functions (tests/mesh_common.py, tests/mesh_train_common.py,
    tests/mesh_decode_common.py) import JAX or `repro`."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tests" / "mesh_common.py",
              REPO / "tests" / "mesh_train_common.py", REPO / "tests" / "mesh_decode_common.py"]
    assert len(files) > 10
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"src/repro_torch/distributed/api.py", "src/repro_torch/distributed/sharding.py",
            "src/repro_torch/distributed/collectives.py",
            "src/repro_torch/distributed/pipeline.py",
            "src/repro_torch/launch/mesh.py"} <= names
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


def test_training_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch, tmp_path):
    """`run_training` and `launch.train` run on `cuda` unless the CPU is
    asked for, and refuse the reference's mesh and FSDP options."""
    from repro_torch.data import tokens as tdata
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime import optimizer as opt
    from repro_torch.runtime.train_loop import TrainConfig, run_training
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gpt2_medium.smoke_config()
    tc = TrainConfig(steps=1, ckpt_dir=str(tmp_path / "c"), log_every=1, async_ckpt=False)
    dcfg = tdata.data_config_for_model(cfg, 8, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training(cfg, tc, opt.AdamWConfig(), dcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path / "d")])
    out = run_training(cfg, tc, opt.AdamWConfig(), dcfg, device="cpu")
    assert out["params"]["embed"].device.type == "cpu"
    # mesh= takes a DeviceMesh; fsdp=True without a mesh trains on one device,
    # as the reference does
    with pytest.raises(ValueError, match="DeviceMesh"):
        run_training(cfg, tc, opt.AdamWConfig(), dcfg, device="cpu", mesh=object())
    tc_fsdp = TrainConfig(steps=1, ckpt_dir=str(tmp_path / "f"), log_every=1, async_ckpt=False)
    out = run_training(cfg, tc_fsdp, opt.AdamWConfig(), dcfg, device="cpu", fsdp=True)
    assert out["params"]["embed"].device.type == "cpu"


class ModelAxis:
    """What `EngineConfig.validate` reads of a mesh (`distributed.api.
    axis_size`): one "model" dimension of `n` ranks, no process group."""

    mesh_dim_names = ("model",)

    def __init__(self, n: int):
        self.n = n

    def size(self, dim: int = 0) -> int:
        return self.n


@pytest.mark.parametrize("change", [
    {"mesh": ModelAxis(2), "paged": False, "telemetry": Telemetry(enabled=True)},
    {"mesh": ModelAxis(3)},
    {"mesh": ModelAxis(2), "paged": False, "hardware": "h100"},
])
def test_unsupported_engine_features_raise(setup, change):
    """`mesh=` raises where the reference's validation does, word for word
    with its ValueErrors: on the dense engine (also beside the telemetry
    and roofline options), and for a "model" extent (3) that does not
    divide GPT-2's KV heads. (Mesh serving itself: tests/test_torch_mesh*.)"""
    jcfg, _, tparams, _, _ = setup
    kw = dict(slots=1, max_len=16, paged=True, prefix_sharing=False)
    kw.update(change)
    n = change["mesh"].n
    jkw = {k: v for k, v in kw.items() if k not in ("mesh", "telemetry", "hardware")}
    with pytest.raises(ValueError) as jerr:
        JaxEngineConfig(mesh=jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("model",)),
                        **jkw).validate(jcfg)
    with pytest.raises(ValueError) as terr:
        ServingEngine(tparams, gpt2_medium.smoke_config(), TSalPimEngine.create(),
                      EngineConfig(**kw), device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert ("requires paged=True" if not kw["paged"] else "must divide") in str(terr.value)


def test_preemptive_requires_paged(setup):
    """The SLO scheduler serves the paged engine; on the dense backend the
    port raises the JAX package's ValueError, word for word."""
    jcfg, _, tparams, _, _ = setup
    cfg = gpt2_medium.smoke_config()
    EngineConfig(slots=1, max_len=16, paged=True, scheduler=SloScheduler()).validate(cfg)
    ServingEngine(tparams, cfg, TSalPimEngine.create(),
                  EngineConfig(slots=1, max_len=16, paged=True, scheduler=SloScheduler(3)),
                  device="cpu")
    with pytest.raises(ValueError) as jerr:
        JaxEngineConfig(slots=1, max_len=16, scheduler=JaxSloScheduler()).validate(jcfg)
    with pytest.raises(ValueError) as terr:
        ServingEngine(tparams, cfg, TSalPimEngine.create(),
                      EngineConfig(slots=1, max_len=16, scheduler=SloScheduler()), device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert str(terr.value).startswith("preemptive scheduling requires paged=True")


@pytest.mark.parametrize("paged", [True, False])
def test_stats_keys_match_jax_engine(setup, paged):
    """stats() carries every key of the JAX engine's but the roofline (the
    cost model is not ported), model_sec_per_token among them: 0.0 on an
    empty drain, decode plus verify seconds a token after one."""
    jcfg, jparams, tparams, prompts, new = setup
    kw = dict(slots=SLOTS, max_len=MAX_LEN, paged=paged)
    jeng = JaxServingEngine(jparams, jcfg, SalPimEngine.create(SalPimConfig()),
                            JaxEngineConfig(gen=JaxGenConfig(stop_on_eos=False), **kw))
    teng = ServingEngine(tparams, gpt2_medium.smoke_config(), TSalPimEngine.create(),
                         EngineConfig(gen=GenConfig(stop_on_eos=False), **kw), device="cpu")
    st, jst = teng.stats(), jeng.stats()
    assert set(jst) - {"roofline"} <= set(st)
    assert st["model_sec_per_token"] == jst["model_sec_per_token"] == 0.0
    assert (st["scheduler"], st["swapped"], st["pinned_pages"]) == ("fifo", 0, 0)
    _drain(teng, prompts[:2], new[:2])
    st = teng.stats()
    assert st["model_sec_per_token"] == pytest.approx(
        (st["decode_sec"] + st["verify_sec"]) / st["tokens"])
    assert st["model_sec_per_token"] > 0


@pytest.mark.parametrize("change,head_dim", [
    ({"kv_cache_dtype": "int4", "kv_scale_dtype": "float32"}, None),
    ({"kv_scale_dtype": "bfloat16"}, None),
    ({"kv_splits": 0}, None),
    ({"kv_cache_dtype": "int4", "kv_scale_dtype": "bfloat16"}, 15),
])
def test_bad_pool_settings_raise_jax_value_errors(setup, change, head_dim):
    """The port refuses what the JAX engine refuses, with its message."""
    jcfg, _, tparams, _, _ = setup
    tcfg = gpt2_medium.smoke_config()
    if head_dim is not None:
        jcfg = dataclasses.replace(jcfg, head_dim=head_dim)
        tcfg = dataclasses.replace(tcfg, head_dim=head_dim)
    kw = dict(slots=1, max_len=16, paged=True, prefix_sharing=False, **change)
    with pytest.raises(ValueError) as jerr:
        JaxEngineConfig(**kw).validate(jcfg)
    with pytest.raises(ValueError) as terr:
        ServingEngine(tparams, tcfg, TSalPimEngine.create(), EngineConfig(**kw),
                      device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("change", [
    {}, {"speculative": SpecConfig(mode="ngram", k=4)},
    {"speculative": SpecConfig(mode="ngram", k=2), "prefill_chunk_tokens": 8,
     "kv_cache_dtype": "int8"},
])
def test_default_sharing_and_speculative_configs_drain(setup, change):
    """The paged engine's default (prefix sharing on) and speculative
    decoding, once refused, construct and drain token for token with the
    JAX engine; every page, reservation and cached page comes back."""
    jcfg, jparams, tparams, prompts, new = setup
    # The donor prompts[3] (17 tokens: 4 full pages) is followed by an exact
    # repeat (the fully covered path) and a sharer of its first 2 pages.
    prompts = prompts[:4] + [prompts[3].copy(), np.concatenate([prompts[3][:8], [5, 6]])] \
        + prompts[4:]
    new = new[:4] + [3, 4] + new[4:]
    jchange = dict(change)
    if "speculative" in change:
        spec = change["speculative"]
        jchange["speculative"] = JaxSpecConfig(mode=spec.mode, k=spec.k)
    jeng = JaxServingEngine(jparams, jcfg, SalPimEngine.create(SalPimConfig()),
                            JaxEngineConfig(slots=SLOTS, max_len=MAX_LEN, paged=True,
                                            page_size=PAGE,
                                            gen=JaxGenConfig(stop_on_eos=False),
                                            **jchange))
    teng = ServingEngine(tparams, gpt2_medium.smoke_config(), TSalPimEngine.create(),
                         EngineConfig(slots=SLOTS, max_len=MAX_LEN, paged=True,
                                      page_size=PAGE, gen=GenConfig(stop_on_eos=False),
                                      **change), device="cpu")
    assert teng.config.prefix_sharing
    assert _drain(teng, prompts, new) == _drain(jeng, prompts, new)
    a = teng.allocator
    assert (a.used_pages, a.reserved_pages, a.cached_pages) == (0, 0, 0)
    st = teng.stats()
    assert st["prefill_tokens_saved"] == jeng.prefill_tokens_saved > 0
    assert st["verify_passes"] == jeng.verify_passes
    assert (st["verify_passes"] > 0) == ("speculative" in change)


@pytest.mark.parametrize("change", [
    {"paged": False}, {"gen": "sampled"},
])
def test_speculative_refusals_raise_jax_value_errors(setup, change):
    """Speculation needs the paged pool and greedy decoding: the port
    raises the JAX package's ValueErrors, word for word."""
    jcfg, _, tparams, _, _ = setup
    kw = dict(slots=1, max_len=16, paged=True)
    kw.update(change)
    jkw, tkw = dict(kw), dict(kw)
    if change.get("gen") == "sampled":
        jkw["gen"], tkw["gen"] = JaxGenConfig(temperature=1.0), GenConfig(temperature=1.0)
    with pytest.raises(ValueError) as jerr:
        JaxEngineConfig(speculative=JaxSpecConfig(), **jkw).validate(jcfg)
    with pytest.raises(ValueError) as terr:
        ServingEngine(tparams, gpt2_medium.smoke_config(), TSalPimEngine.create(),
                      EngineConfig(speculative=SpecConfig(), **tkw), device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert ("paged=True" if change.get("paged") is False else "greedy-only") in str(terr.value)


def test_fifo_scheduler_and_default_sharing():
    cfg = gpt2_medium.smoke_config()
    EngineConfig(slots=1, max_len=8, paged=True, prefix_sharing=False,
                 scheduler=FifoScheduler()).validate(cfg)
    default = EngineConfig(slots=1, max_len=8, paged=True)
    assert default.prefix_sharing
    default.validate(cfg)
    assert FifoScheduler.pin_budget_pages == 0 and FifoScheduler.reserve
    assert not FifoScheduler.preemptive
    for quant in ("int8", "fixed16"):
        qcfg = TSalPimEngine.create(TSalPimConfig(quant=quant)).config
        assert (qcfg.quant, qcfg.fixed_frac_w, qcfg.fixed_frac_x) == (quant, 12, 10)
    assert TSalPimEngine.create(TSalPimConfig(kv_splits=2)).config.kv_splits == 2


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
