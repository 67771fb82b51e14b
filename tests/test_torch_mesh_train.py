"""Training under a mesh (`distributed/sharding.py`'s rules and `TrainPlan`,
`distributed/collectives.py`, `distributed/pipeline.py`,
`runtime/train_loop.shard_train_step` and `run_training(mesh=, fsdp=)`,
the sharded checkpoints, `launch/train.py --mesh`) against the JAX package
on the CPU.

One gloo world of 4 CPU ranks (`repro_torch.launch.mesh.World`; the rank
functions in tests/mesh_train_common.py, which imports no JAX) runs every
rank-side case while the test process computes the JAX side on one device:

  * the specs: `param_pspecs` (fsdp off and on), `batch_pspecs` and
    `cache_pspecs` (seq_shard off and on) of all 11 archs at full size on
    (2, 4) ("data", "model") and (2, 2, 2) ("pod", "data", "model") equal
    the JAX functions' on the suite's fake devices (port side: `meta`
    tensors and a stand-in mesh), and every spec divides its dimension;
  * one sharded step (GPT-2 exact and LUT with fsdp on and off, GPT-2
    with an odd vocab, two microbatches and remat, qwen2 on (2, 2) and on
    (1, 4), olmoe, mamba2, whisper) equals the JAX unsharded
    `jax.jit(make_train_step)` on the same parameters and batch within the
    reference's own
    tolerances (tests/test_distributed.py): loss 1e-4, every parameter
    after the update rtol 1e-3 / atol 1e-4, the grad norm 1e-4 relative;
    each rank holds its spec's bytes of parameters and moments;
  * `compressed_psum` bit for bit a numpy emulation of the reference's
    algebra over two steps of error feedback, and within the reference's
    5e-2 / 2e-2 of the true mean; `merge_partial_softmax` within 1e-4 of
    softmax(scores) @ v; `hierarchical_psum` the flat sum;
  * `pipeline_forward` on (4,) within 1e-5 of the sequential stages;
  * a one-device and a JAX checkpoint restored onto (2, 2) with fsdp: each
    rank's leaves bit for bit its spec's cut; a (2, 2) save restored on
    one device bit for bit the gathered tree;
  * `run_training` on (2, 2): a resumed run bit for bit the straight one,
    and a SIGTERM to one rank stops every rank after the same step, saved;
  * `launch/train.py --mesh test` trains on 8 spawned ranks; `--mesh
    single` without a process group refuses, naming the 256 ranks it needs.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_train_common as common
from repro.configs import get_config as jax_get_config
from repro.core.salpim import SalPimConfig as JSalPimConfig
from repro.core.salpim import SalPimEngine as JSalPimEngine
from repro.data import tokens as jdata
from repro.distributed import sharding as jsh
from repro.models import api as japi
from repro.runtime import checkpoint as jckpt
from repro.runtime import optimizer as jopt
from repro.runtime.train_loop import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import World
from repro_torch.models import api
from repro_torch.runtime import checkpoint as ckpt_lib
from repro_torch.runtime import optimizer as opt
from repro_torch.serving.quantize import QTensor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["gpt2_medium", "qwen2_1_5b", "olmoe_1b_7b", "mamba2_370m", "zamba2_1_2b",
         "whisper_large_v3", "qwen2_vl_2b", "gemma2_2b", "h2o_danube3_4b",
         "nemotron_4_340b", "phi35_moe_42b"]
SPEC_MESHES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)

# name: (arch, config overrides, mode, n_micro, mesh shape, fsdp, tensor-parallel parts)
STEP_CASES = {
    "gpt2-exact-fsdp": ("gpt2_medium", {}, "exact", 1, (2, 2), True, {"attn", "ffn", "head"}),
    "gpt2-exact": ("gpt2_medium", {}, "exact", 1, (2, 2), False, {"attn", "ffn", "head"}),
    "gpt2-lut-fsdp": ("gpt2_medium", {}, "lut", 1, (2, 2), True, {"attn", "ffn", "head"}),
    "gpt2-lut": ("gpt2_medium", {}, "lut", 1, (2, 2), False, {"attn", "ffn", "head"}),
    # vocab 509 is odd, as GPT-2's 50257: the LM head is not split over "model"
    "gpt2-vocab509-micro2-remat": ("gpt2_medium", {"vocab": 509, "remat": "block"}, "exact",
                                   2, (2, 2), True, {"attn", "ffn"}),
    "qwen2-2x2": ("qwen2_1_5b", {}, "exact", 1, (2, 2), True, {"attn", "ffn", "head"}),
    "qwen2-1x4": ("qwen2_1_5b", {}, "exact", 1, (1, 4), True, {"ffn", "head"}),
    "olmoe": ("olmoe_1b_7b", {}, "exact", 1, (2, 2), True, {"attn", "experts", "head"}),
    "mamba2": ("mamba2_370m", {}, "exact", 1, (2, 2), True, set()),
    "whisper": ("whisper_large_v3", {}, "exact", 1, (2, 2), True, set()),
}


def _jax_ref_key(case):
    arch, over, mode, n_micro = case[:4]
    return (arch, tuple(sorted(over.items())), mode, n_micro)


def _setup(arch, over):
    """The JAX config, seeded parameters (the port's init, as numpy: the
    JAX step takes them as they are) and the batch of 4 x 16 tokens."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **over)
    params = opt.tree_map(lambda x: x.numpy(), api.init_params(
        dataclasses.replace(get_config(arch, smoke=True), **over), seed=0, device="cpu"))
    batch = jdata.batch_at(jdata.data_config_for_model(jcfg, 16, 4), 0)
    return jcfg, params, batch


def _rand_tree(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: rng.randn(*np.shape(x)).astype(np.float32), tree)


def _checkpoints(tmp):
    """A one-device checkpoint of the port and one of the JAX package (GPT-2
    smoke params with random moments), and the directory the ranks save to."""
    paths = {k: str(tmp / k) for k in ("torch_ckpt", "jax_ckpt", "mesh_ckpt")}
    cfg = get_config("gpt2_medium", smoke=True)
    tparams = api.init_params(cfg, seed=3, device="cpu")
    tmu, tnu = (opt.tree_map(lambda p, s=s: torch.from_numpy(
        np.random.RandomState(s).randn(*p.shape).astype(np.float32)), tparams) for s in (4, 5))
    ckpt_lib.save(paths["torch_ckpt"], 7, {"params": tparams, "opt": opt.OptState(
        torch.tensor(7, dtype=torch.int32), tmu, tnu)})
    jcfg = jax_get_config("gpt2_medium", smoke=True)
    jparams = japi.init_params(jax.random.PRNGKey(2), jcfg)
    jstate = jopt.OptState(step=jnp.int32(9), mu=_rand_tree(jparams, 6),
                           nu=_rand_tree(jparams, 7))
    jckpt.save(paths["jax_ckpt"], 9, {"params": jparams, "opt": jstate})
    return paths


def _collective_inputs():
    rng = np.random.RandomState(0)
    return {"grads": [rng.randn(4, 64).astype(np.float32) for _ in range(2)],
            "softmax": ((rng.randn(64) * 3).astype(np.float32),
                        rng.randn(64, 8).astype(np.float32)),
            "hier": rng.randint(-50, 50, size=(4, 6)).astype(np.float32)}


def _pipeline_inputs():
    rng = np.random.RandomState(1)
    return {"stage_params": (rng.randn(4, 16, 16) * 0.3).astype(np.float32),
            "x": rng.randn(8, 16).astype(np.float32)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The rank results of every job, the JAX steps, the inputs, and the
    launcher's `--mesh test` run (a subprocess started beside the world)."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    refs, jobs = {}, {}
    for name, case in STEP_CASES.items():
        arch, over, mode, n_micro, shape, fsdp, _ = case
        key = _jax_ref_key(case)
        if key not in refs:
            refs[key] = _setup(arch, over)
        _, params, batch = refs[key]
        jobs[f"step {name}"] = ("step", {
            "name": arch, "overrides": over, "mode": mode, "n_micro": n_micro,
            "shape": shape, "fsdp": fsdp, "params": params, "batch": batch, "ocfg": OCFG})
    paths = _checkpoints(tmp)
    coll, pipe = _collective_inputs(), _pipeline_inputs()
    jobs.update({"collectives": ("collectives", coll), "pipeline": ("pipeline", pipe),
                 "checkpoint": ("checkpoint", paths),
                 "loop": ("loop", {"dir": str(tmp / "loop")})})
    w = World(common.jobs_rank, 4, (jobs,), workdir=tmp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), TMPDIR=str(tmp))
    launcher = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gpt2-medium", "--smoke",
         "--steps", "2", "--device", "cpu", "--mesh", "test", "--fsdp", "--batch", "2",
         "--seq", "16", "--ckpt-dir", str(tmp / "launch_ckpt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ocfg = jopt.AdamWConfig(**OCFG)

        def jax_step(key):
            jcfg, params, batch = refs[key]
            eng = JSalPimEngine.create(JSalPimConfig(nonlinear_mode=key[2]))
            state = jopt.init_opt_state(params)
            # XLA's LLVM backend unoptimised: the same HLO, half the compile
            step = jax.jit(jax_make_train_step(jcfg, eng, ocfg, n_micro=key[3])).lower(
                params, state, batch).compile({"xla_backend_optimization_level": 0})
            p, s, m = step(params, state, batch)
            return (jax.tree.map(np.asarray, p), float(m["loss"]), float(m["grad_norm"]),
                    jax.tree.map(np.asarray, s.mu))
        # XLA compiles outside the GIL: two threads halve the wait
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            jax_steps = dict(zip(refs, pool.map(jax_step, refs)))
    finally:
        ranks = w.join()
        out, err = launcher.communicate(timeout=300)
    return {"ranks": ranks, "jax": jax_steps, "paths": paths, "coll": coll, "pipe": pipe,
            "launcher": (launcher.returncode, out, err, tmp / "launch_ckpt")}


# ---------------------------------------------------------------------------
# Specs at full size (no process group)
# ---------------------------------------------------------------------------

class StandIn:
    """What the rules read of a mesh: dimension names and sizes."""

    def __init__(self, shape, axes):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(axes)

    def size(self, i):
        return self.shape[i]


def _flat(tree):
    """{path: spec tuple} of the port's spec tree."""
    return {p: tuple(spec) for p, spec in opt.named_leaves(tree)}


@pytest.fixture(scope="module")
def jax_specs():
    """{(arch, mesh shape): {"params": {fsdp: specs}, "batch", "cache": {(B, seq_shard): specs}}}."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_get_config(arch)
        pshape = jax.eval_shape(lambda: japi.init_params(jax.random.PRNGKey(0), jcfg))
        batch = jdata.batch_at(jdata.data_config_for_model(jcfg, 16, 8), 0)
        caches = {B: jax.eval_shape(lambda B=B: japi.init_cache(jcfg, B, 64)) for B in (8, 1)}
        for shape, axes in SPEC_MESHES:
            mesh = jax.make_mesh(shape, axes)
            out[(arch, shape)] = {
                "params": {f: jsh.param_pspecs(pshape, mesh, fsdp=f) for f in (False, True)},
                "batch": jsh.batch_pspecs(batch, mesh),
                "cache": {(B, s): jsh.cache_pspecs(c, mesh, seq_shard=s)
                          for B, c in caches.items() for s in (False, True)}}
    return out


def _jax_flat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_jax_at_full_size(jax_specs, arch):
    cfg = get_config(arch)
    shapes = api.init_params(cfg, device="meta")
    assert all(x.device.type == "meta" for _, x in opt.named_leaves(shapes))
    for shape, axes in SPEC_MESHES:
        for fsdp in (False, True):
            got = _flat(sh.param_pspecs(shapes, StandIn(shape, axes), fsdp=fsdp))
            want = _jax_flat(jax_specs[(arch, shape)]["params"][fsdp])
            assert got == want, (shape, fsdp)
    assert sh.should_fsdp(cfg) == jsh.should_fsdp(jax_get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_pspecs_match_jax(jax_specs, arch):
    cfg = get_config(arch)
    batch = jdata.batch_at(jdata.data_config_for_model(jax_get_config(arch), 16, 8), 0)
    for shape, axes in SPEC_MESHES:
        mesh = StandIn(shape, axes)
        want = jax_specs[(arch, shape)]
        assert sh.batch_pspecs(batch, mesh) == {k: tuple(v) for k, v in want["batch"].items()}
        for (B, seq_shard), jspec in want["cache"].items():
            got = _flat(sh.cache_pspecs(api.init_cache(cfg, B, 64, device="meta"), mesh,
                                        seq_shard=seq_shard))
            assert got == _flat(jspec), (shape, B, seq_shard)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspec_divisibility(arch):
    """Every sharded dimension divides by its mesh extent (the twin of the
    reference's test_param_pspec_divisibility), and a quantized tree's
    int8 payload and scales follow their weight's rows."""
    cfg = get_config(arch)
    shapes = api.init_params(cfg, device="meta")
    for shape, axes in SPEC_MESHES:
        mesh = StandIn(shape, axes)
        sizes = dict(zip(axes, shape))
        for fsdp in (False, True):
            specs = dict(opt.named_leaves(sh.param_pspecs(shapes, mesh, fsdp=fsdp)))
            for path, x in opt.named_leaves(shapes):
                spec = specs[path]
                assert len(spec) == x.ndim, path
                for dim, entry in zip(x.shape, spec):
                    extent = int(np.prod([sizes[n] for n in sh.names_of(entry)]))
                    assert dim % extent == 0, (path, x.shape, spec)
    w = shapes["lm_head"]
    mesh = StandIn((2, 4), ("data", "model"))
    q = sh.param_pspecs({"lm_head": QTensor(w.to(dtype=torch.int8),
                                             torch.empty(w.shape[:-1], device="meta"))},
                        mesh, fsdp=True)["lm_head"]
    want = sh.param_pspecs({"lm_head": w}, mesh, fsdp=True)["lm_head"]
    assert q.w_i8 == want and q.scale == want[:-1]


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------

def _zero_in_exact_arithmetic(cfg, key):
    """A key bias's gradient where no rotation follows it (learned positions)."""
    return key.endswith("/bk") and cfg.learned_pos_emb


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_sharded_step_matches_jax_unsharded_step(world, name):
    case = STEP_CASES[name]
    want_p, want_loss, want_norm, want_mu = world["jax"][_jax_ref_key(case)]
    ranks = [r[f"step {name}"] for r in world["ranks"]]
    for r in ranks:
        assert {p for p, on in r["tp"].items() if on} == case[6]
        assert abs(r["loss"] - want_loss) < 1e-4, (r["loss"], want_loss)
        assert abs(r["grad_norm"] - want_norm) <= 1e-4 * want_norm, (r["grad_norm"], want_norm)
        # each rank holds its spec's slices of the parameters and both moments
        assert r["bytes"] == [r["spec_bytes"], r["spec_moment_bytes"], r["spec_moment_bytes"]]
        assert r["spec_moment_bytes"] < r["whole_moment_bytes"]
    want = dict(opt.named_leaves(want_p))
    got = dict(opt.named_leaves(ranks[0]["params"]))
    assert set(got) == set(want)
    for key, w in want.items():
        # A key bias's gradient is 0 in exact arithmetic under learned
        # positions and nearly so under RoPE: Adam turns its rounding noise
        # into a step of up to lr (tests/test_torch_train.py holds them so).
        tol = 3 * OCFG["lr"] if key.endswith("/bk") else 1e-4
        np.testing.assert_allclose(got[key], np.asarray(w, np.float32), rtol=1e-3, atol=tol,
                                   err_msg=f"{name} {key}")
    # The first moment after the step is (1 - b1) times the clipped
    # gradient: each leaf within 1e-4 of its largest element, as
    # tests/test_torch_train.py holds the gradients (a leaf's gradient
    # counted twice, or missing a rank's share, moves it by O(1)).
    cfg = dataclasses.replace(get_config(case[0], smoke=True), **case[1])
    want = {k: np.asarray(v, np.float32) for k, v in opt.named_leaves(want_mu)}
    got = dict(opt.named_leaves(ranks[0]["mu"]))
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, w in want.items():
        if _zero_in_exact_arithmetic(cfg, key):
            assert max(np.abs(got[key]).max(), np.abs(w).max()) < 1e-6 * top, key
            continue
        err, scale = float(np.abs(got[key] - w).max()), float(np.abs(w).max())
        assert err <= 1e-4 * scale, f"{name} {key}: first moment {err:.3e} against {scale:.3e}"


# ---------------------------------------------------------------------------
# Collectives and the pipeline
# ---------------------------------------------------------------------------

def _emulate_compressed_psum(grads, efs):
    """The reference's algebra in numpy f32: (mean, new feedback per rank)."""
    g = [x.astype(np.float32) + (0 if e is None else e) for x, e in zip(grads, efs)]
    scale = max(np.float32(max(np.max(np.abs(x)), np.float32(1e-12))) / np.float32(127.0)
                for x in g)
    q = [np.clip(np.round(x / scale), -127, 127).astype(np.int8) for x in g]
    new_ef = [x - qq.astype(np.float32) * scale for x, qq in zip(g, q)]
    total = np.sum([qq.astype(np.int32) for qq in q], axis=0)
    return total.astype(np.float32) * scale / np.float32(len(g)), new_ef


def test_compressed_psum_matches_the_reference_algebra(world):
    g1, g2 = world["coll"]["grads"]
    mean1, ef1 = _emulate_compressed_psum(list(g1), [None] * 4)
    mean2, ef2 = _emulate_compressed_psum(list(g2), ef1)
    for rank, r in enumerate(world["ranks"]):
        got = r["collectives"]["ef"]
        np.testing.assert_array_equal(got[0], mean1)
        np.testing.assert_array_equal(got[1], ef1[rank])
        np.testing.assert_array_equal(got[2], mean2)
        np.testing.assert_array_equal(got[3], ef2[rank])
        q, scale = r["collectives"]["quantized"]
        s = np.float32(np.max(np.abs(g1[rank]))) / np.float32(127.0)
        assert scale == s
        np.testing.assert_array_equal(q, np.clip(np.round(g1[rank] / s), -127, 127))
    np.testing.assert_allclose(mean1, g1.mean(0), rtol=0.05, atol=0.02)


def test_merge_partial_softmax_and_hierarchical_psum(world):
    scores, v = world["coll"]["softmax"]
    e = np.exp(scores.astype(np.float64) - scores.max())
    want = (e / e.sum()) @ v
    hier = world["coll"]["hier"].sum(0)
    for r in world["ranks"]:
        np.testing.assert_allclose(r["collectives"]["merged"][0], want, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(r["collectives"]["hier"], hier)


def test_pipeline_forward_equals_sequential(world):
    ref = world["pipe"]["x"]
    for w in world["pipe"]["stage_params"]:
        ref = np.tanh(ref @ w)
    for r in world["ranks"]:
        np.testing.assert_allclose(r["pipeline"]["out"], ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Checkpoints, the loop, the launcher
# ---------------------------------------------------------------------------

def _cut(arr, spec, coords, sizes):
    """The slice of a whole array by a spec at mesh coordinates (numpy)."""
    for d, entry in enumerate(spec):
        names = sh.names_of(entry)
        if not names:
            continue
        idx = 0
        for n in names:
            idx = idx * sizes[n] + coords[n]
        size = arr.shape[d] // int(np.prod([sizes[n] for n in names]))
        arr = np.take(arr, range(idx * size, (idx + 1) * size), axis=d)
    return arr


def _whole(path):
    data = np.load(os.path.join(path, "arrays.npz"))
    with open(os.path.join(path, "manifest.json")) as f:
        return {leaf["path"]: data[leaf["key"]] for leaf in json.load(f)["leaves"]}


@pytest.mark.parametrize("source", ["torch_ckpt", "jax_ckpt"])
def test_checkpoint_restores_onto_the_mesh_as_each_ranks_cut(world, source):
    step = {"torch_ckpt": 7, "jax_ckpt": 9}[source]
    whole = _whole(os.path.join(world["paths"][source], f"step_{step:08d}"))
    sizes = {"data": 2, "model": 2}
    seen = set()
    for r in world["ranks"]:
        got = r["checkpoint"][source]
        assert got["step"] == step
        specs = dict(opt.named_leaves(r["checkpoint"]["specs"]))
        for path, arr in got["leaves"].items():
            # params/<leaf>, opt/.mu/<leaf>, opt/.nu/<leaf>; opt/.step is replicated
            leaf = path.split("/", 2)[-1] if path.startswith("opt/") else path.split("/", 1)[1]
            spec = () if path == "opt/.step" else specs[leaf]
            want = _cut(whole[path], spec, r["checkpoint"]["coords"], sizes)
            np.testing.assert_array_equal(arr.view(want.dtype) if want.dtype.kind == "V"
                                          else arr, want, err_msg=path)
        seen.add(tuple(sorted(r["checkpoint"]["coords"].items())))
    assert len(seen) == 4
    # fsdp splits the token table's d over "data", wq over both dimensions
    specs = world["ranks"][0]["checkpoint"]["specs"]
    assert specs["embed"] == (None, "data")
    assert specs["blocks"]["attn"]["wq"] == (None, "model", "data")


def test_mesh_save_restores_on_one_device_as_the_gathered_tree(world):
    saved = world["ranks"][0]["checkpoint"]["saved_whole"]
    cfg = get_config("gpt2_medium", smoke=True)
    like = api.init_params(cfg, device="cpu")
    tree, manifest = ckpt_lib.restore(world["paths"]["mesh_ckpt"],
                                      {"params": like, "opt": opt.init_opt_state(like)})
    assert manifest["step"] == 1 and manifest["extra"]["next_step"] == 1
    got = {p: x.numpy() for p, x in opt.named_leaves(tree)}
    assert set(got) == set(saved)
    for path, arr in saved.items():
        np.testing.assert_array_equal(got[path], arr, err_msg=path)


def test_run_training_on_the_mesh_resumes_bit_for_bit_and_agrees_on_sigterm(world):
    for r in world["ranks"]:
        loop = r["loop"]
        assert all(loop["same"]) and len(loop["same"]) > 20
        assert loop["resumed_steps"] == [2]
        assert loop["sigterm_steps"] == [0] and loop["sigterm_latest"] == 1
        assert loop["losses"] == world["ranks"][0]["loop"]["losses"]
    # rank 0 alone writes the metrics JSONL
    assert [r["loop"]["metric_lines"] for r in world["ranks"]] == [3, None, None, None]
    assert all(np.isfinite(world["ranks"][0]["loop"]["losses"]))


def test_launch_train_mesh_test_and_the_production_mesh_refusal(world, capsys):
    rc, out, err, ckpt = world["launcher"]
    assert rc == 0, err
    assert out.count("step ") == 2 and "final loss:" in out
    assert (ckpt / "step_00000002" / "_COMMITTED").exists()
    assert not any(k in os.environ for k in ("RANK", "WORLD_SIZE"))
    with pytest.raises(SystemExit) as e:
        launch_train.main(["--smoke", "--mesh", "single", "--device", "cpu", "--steps", "1"])
    assert e.value.code == 2
    assert "256 ranks" in capsys.readouterr().err
