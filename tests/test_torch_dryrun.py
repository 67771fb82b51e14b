"""The dry run (`launch/dryrun.py`, `launch/roofline.py`, `launch/op_cost.py`
and the cells of `configs/__init__.py`) against the JAX package's on the
CPU.

  * `cells()` is the reference's list (40 with the skipped ones, 34 live)
    and `input_specs` its shapes and dtypes (int32 and float32 as torch's,
    the compute dtype for frames and patch embeddings) for the four
    architectures x three shapes of tests/test_roofline.py, every tensor
    on `meta`;
  * the reference's `roofline_terms` and `model_flops` cases on the H100's
    data-sheet constants (989 TFLOP/s, 3.35 TB/s, 450 GB/s);
  * `op_cost`'s dot FLOPs and bytes of a smoke decode step and a smoke
    train step (qwen2: GQA, RoPE, biases; one device) equal `repro.launch.hlo_cost.
    analyze` of the same jitted steps within 1e-9 relative. The port counts
    aten.mm / addmm / bmm / baddbmm as they are dispatched (every linear,
    the attention's einsums, their gradients); the reference every HLO
    `dot`, while bodies expanded by their trip counts: the same products;
  * `run_cell` at production size on the single (16, 16) mesh, rank 0 of a
    `fake` process group of 256: qwen2-1.5B decode_32k (the sequence on
    "model", the partials merged), mamba2-370m long_500k (B 1) and
    olmoe-1B-7B train_4k (the sharded step): nothing allocated (no tensor
    the step made off `meta`), a finite roofline, and the rank's argument
    bytes the sum of `spec_bytes` over its parameters, moments (train),
    batch and cache, below the whole trees' bytes.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.salpim import SalPimConfig as JSalPimConfig
from repro.core.salpim import SalPimEngine as JSalPimEngine
from repro.data import tokens as jdata
from repro.launch import hlo_cost
from repro.models import api as japi
from repro.runtime import optimizer as jopt
from repro.runtime.train_loop import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch import configs
from repro_torch.core.salpim import SalPimConfig, SalPimEngine
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch import roofline as R
from repro_torch.models import api
from repro_torch.runtime import optimizer as opt
from repro_torch.runtime.train_loop import make_train_step

# XLA's LLVM backend unoptimised: the same optimized HLO, a shorter compile.
_O0 = {"xla_backend_optimization_level": 0}
_DTYPES = {jnp.int32: torch.int32, jnp.float32: torch.float32,
           jnp.bfloat16: torch.bfloat16}


def test_cells_are_the_reference_cells():
    assert configs.cells() == jconfigs.cells()
    assert configs.cells(include_skipped=True) == jconfigs.cells(include_skipped=True)
    assert (len(configs.cells(include_skipped=True)), len(configs.cells())) == (40, 34)
    assert configs.LONG_CONTEXT_OK == jconfigs.LONG_CONTEXT_OK
    assert configs.LONG_CONTEXT_SKIP_REASON == jconfigs.LONG_CONTEXT_SKIP_REASON
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "whisper_large_v3", "qwen2_vl_2b",
                                  "mamba2_370m"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_match_the_reference_on_meta(arch, shape):
    got = configs.input_specs(configs.get_config(arch), configs.SHAPES[shape])
    want = jconfigs.input_specs(jconfigs.get_config(arch), jconfigs.SHAPES[shape])
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert v.dtype == _DTYPES[jnp.dtype(want[k].dtype).type], k
    small = configs.input_specs(configs.get_config(arch), configs.SHAPES[shape],
                                batch_override=3)
    assert all(v.shape[0] == 3 for v in small.values())


def test_roofline_terms_and_bottleneck_on_the_h100():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 450e9)
    r = R.roofline_terms({"flops": 989e12, "bytes accessed": 3.35e12 / 2}, coll_bytes=0)
    assert r["t_compute"] == pytest.approx(1.0)
    assert r["t_memory"] == pytest.approx(0.5)
    assert r["bottleneck"] == "compute"
    r2 = R.roofline_terms({"flops": 1e9, "bytes accessed": 1e9}, coll_bytes=450e9)
    assert r2["bottleneck"] == "collective"
    assert r2["t_collective"] == pytest.approx(1.0)


def test_collective_bytes_sum_the_records_by_kind():
    out = R.collective_bytes([("all-reduce", 8192), ("all-gather", 1024),
                              ("all-reduce", 8192)])
    assert out["per_kind_count"]["all-reduce"] == 2
    assert out["per_kind_bytes"] == {"all-gather": 1024, "all-reduce": 16384,
                                     "reduce-scatter": 0, "all-to-all": 0,
                                     "collective-permute": 0}
    assert out["total_bytes"] == 17408


def test_model_flops_train_vs_serve():
    cfg = configs.get_config("qwen2_1_5b")
    n = cfg.param_count()
    assert R.model_flops(cfg, "train", 1000) == pytest.approx(6 * n * 1000)
    assert R.model_flops(cfg, "decode", 128) == pytest.approx(2 * n * 128)
    moe = configs.get_config("olmoe_1b_7b")
    assert moe.active_param_count() < moe.param_count()


def test_op_cost_counts_the_dots_hlo_cost_counts():
    arch = "qwen2_1_5b"
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True), decode_uniform=True)
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True), decode_uniform=True)
    jeng, eng = JSalPimEngine.create(JSalPimConfig()), SalPimEngine.create(SalPimConfig())
    params = japi.init_params(jax.random.PRNGKey(0), jcfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 12), 0, jcfg.vocab)
    _, cache = japi.prefill(params, {"tokens": toks}, jcfg, jeng, max_len=16)
    tok = jnp.zeros((4,), jnp.int32)
    want = hlo_cost.analyze(jax.jit(lambda p, t, c: japi.decode_step(p, t, c, jcfg, jeng))
                            .lower(params, tok, cache).compile(_O0).as_text())
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    tcache = bridge.dense_cache_from_numpy(jax.tree.map(np.asarray, cache), device="cpu")
    _, got = op_cost.analyze(api.decode_step, tparams, torch.zeros(4, dtype=torch.int32),
                             tcache, cfg, eng)
    assert got.flops == pytest.approx(want.flops, rel=1e-9)
    assert got.dot_bytes == pytest.approx(want.dot_bytes, rel=1e-9)
    assert got.dots > 0 and got.host_outputs > 0      # CPU tensors: counted, not meta

    batch = jdata.batch_at(jdata.data_config_for_model(jcfg, 16, 4), 0)
    jstep = jax_make_train_step(jcfg, jeng, jopt.AdamWConfig())
    want = hlo_cost.analyze(jax.jit(jstep).lower(params, jopt.init_opt_state(params), batch)
                            .compile(_O0).as_text())
    step = make_train_step(cfg, eng, opt.AdamWConfig())
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    _, got = op_cost.analyze(step, tparams, opt.init_opt_state(tparams), tbatch)
    assert got.flops == pytest.approx(want.flops, rel=1e-9)


def _whole_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in opt.tree_leaves(tree))


@pytest.mark.parametrize("arch,shape", [("qwen2_1_5b", "decode_32k"),
                                        ("mamba2_370m", "long_500k"),
                                        ("olmoe_1b_7b", "train_4k")])
def test_run_cell_on_the_single_mesh_allocates_nothing(arch, shape):
    rec = dryrun.run_cell(arch, shape, "single")
    assert rec["devices"] == 256 and rec["mesh"] == "single"
    assert rec["host_outputs"] == {"count": 0, "bytes": 0}
    r = rec["roofline"]
    assert all(math.isfinite(r[k]) and r[k] >= 0 for k in ("t_compute", "t_memory",
                                                           "t_collective"))
    assert r["t_bound"] > 0 and rec["cost"]["flops"] > 0
    assert rec["memory"]["temp_bytes"] is None and "compile_sec" not in rec

    mesh = dryrun.production_mesh("single")
    cfg = configs.get_config(arch)
    sh_ = configs.SHAPES[shape]
    params = api.init_params(cfg, device="meta")
    pspecs = sh.param_pspecs(params, mesh, fsdp=rec["fsdp"])
    specs = configs.input_specs(cfg, sh_)
    want = (sh.spec_bytes(params, pspecs, mesh)
            + sh.spec_bytes(specs, sh.batch_pspecs(specs, mesh), mesh))
    whole = _whole_bytes(params) + _whole_bytes(specs)
    if sh_.kind == "train":
        moments = opt.tree_map(lambda p: p.new_empty(p.shape, dtype=torch.float32), params)
        want += 2 * sh.spec_bytes(moments, pspecs, mesh) + 4
        whole += 2 * _whole_bytes(moments) + 4
    else:
        cache = api.init_cache(cfg, sh_.global_batch, sh_.seq_len, device="meta")
        want += sh.spec_bytes(cache, sh.cache_pspecs(cache, mesh,
                                                     seq_shard=sh_.global_batch == 1), mesh)
        whole += _whole_bytes(cache)
    assert rec["memory"]["argument_bytes"] == want
    assert want < whole
    if shape == "decode_32k":      # 2 KV heads: the sequence on "model", merged
        assert rec["collectives"]["per_kind_count"]["all-reduce"] > 0
