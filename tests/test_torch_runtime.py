"""The port's training runtime (`runtime/optimizer.py`, `checkpoint.py`,
`train_loop.py`) and data pipeline (`data/tokens.py`) on the CPU: twins
of tests/test_train.py, test_checkpoint.py (not its multi-device restore)
and test_data.py on the port's modules, and against the JAX package:
`batch_at` bit for bit, the schedule, clipping and AdamW update at 1e-6,
the checkpoint layout (leaf paths, dtypes) and a checkpoint the JAX
package wrote restoring into the port bit for bit; `run_training`'s
resume bit for bit, its save on SIGTERM and on a crash, its metrics
JSONL.
"""
from __future__ import annotations

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypcompat import hyp, st

from repro.configs import get_config as jax_get_config
from repro.data import tokens as jdata
from repro.models import api as japi
from repro.runtime import checkpoint as jck
from repro.runtime import optimizer as jopt
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.salpim import SalPimConfig, SalPimEngine
from repro_torch.data import tokens as D
from repro_torch.models import api
from repro_torch.runtime import checkpoint as ck
from repro_torch.runtime import optimizer as opt
from repro_torch.runtime.train_loop import (StragglerWatch, TrainConfig, make_train_step,
                                            run_training)

ENGINE = SalPimEngine.create(SalPimConfig())
CFG = D.DataConfig(vocab=1000, seq_len=32, global_batch=8)


def _tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _leaves(tree):
    return opt.tree_leaves(tree)


# ---------------------------------------------------------------------------
# Data (twins of test_data.py, and bit for bit the JAX package's batches)
# ---------------------------------------------------------------------------

def test_deterministic_and_seekable():
    a, b = D.batch_at(CFG, 5), D.batch_at(CFG, 5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], D.batch_at(CFG, 6)["tokens"])


def test_labels_are_shifted_tokens():
    b = D.batch_at(CFG, 0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_tokens_in_vocab():
    b = D.batch_at(CFG, 3)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < CFG.vocab


@hyp.given(st.integers(min_value=0, max_value=1000))
@hyp.settings(max_examples=20, deadline=None)
def test_shard_partition_property(step):
    shards = [D.batch_at(CFG, step, shard=i, n_shards=4)["tokens"] for i in range(4)]
    again = [D.batch_at(CFG, step, shard=i, n_shards=4)["tokens"] for i in range(4)]
    for a, b in zip(shards, again):
        np.testing.assert_array_equal(a, b)
    for i in range(4):
        for j in range(i + 1, 4):
            assert not np.array_equal(shards[i], shards[j])
    assert all(s.shape == (2, 32) for s in shards)


def test_iterator_advances_cursor():
    state = D.DataState()
    it = D.iterate(CFG, state)
    next(it)
    next(it)
    assert state.step == 2


def test_model_specific_inputs():
    wcfg = get_config("whisper_large_v3", smoke=True)
    b = D.batch_at(D.data_config_for_model(wcfg, 16, 4), 0)
    assert b["frames"].shape == (4, wcfg.enc_seq, wcfg.d_model)
    vcfg = get_config("qwen2_vl_2b", smoke=True)
    assert "patch_embeds" in D.batch_at(D.data_config_for_model(vcfg, 16, 4), 0)


@pytest.mark.parametrize("name", ["gpt2_medium", "whisper_large_v3", "qwen2_vl_2b",
                                  "mamba2_370m"])
@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (7, 1, 2), (123, 3, 4)])
def test_batch_at_bit_for_bit_with_jax(name, step, shard, n_shards):
    jcfg, cfg = jax_get_config(name, smoke=True), get_config(name, smoke=True)
    jd = jdata.data_config_for_model(jcfg, 24, 8, seed=99)
    td = D.data_config_for_model(cfg, 24, 8, seed=99)
    assert jd == jdata.DataConfig(**{f: getattr(td, f) for f in td.__dataclass_fields__})
    want = jdata.batch_at(jd, step, shard=shard, n_shards=n_shards)
    got = D.batch_at(td, step, shard=shard, n_shards=n_shards)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# Optimizer (twins of test_train.py, and against the JAX package)
# ---------------------------------------------------------------------------

def test_adamw_matches_naive_reference():
    cfg = opt.AdamWConfig(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                          clip_norm=None, warmup_steps=0, total_steps=10**9, min_lr_ratio=1.0)
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    newp, _, _ = opt.adamw_update(cfg, p, g, opt.init_opt_state(p))
    m = 0.1 * g["w"].numpy()
    v = 0.01 * g["w"].numpy() ** 2
    want = p["w"].numpy() - 1e-2 * (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.99)) + 1e-8)
    np.testing.assert_allclose(newp["w"].numpy(), want, rtol=1e-6)


def test_lr_schedule_shape():
    cfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(opt.lr_at(cfg, torch.tensor(s))) for s in range(0, 101, 5)]
    assert lrs[0] == 0.0
    assert abs(max(lrs) - 1.0) < 0.15
    assert abs(lrs[-1] - 0.1) < 0.02
    assert all(b <= a + 1e-6 for a, b in zip(lrs[2:], lrs[3:]))


def test_lr_schedule_matches_jax():
    for kw in (dict(lr=3e-4, warmup_steps=10, total_steps=100), dict(warmup_steps=0),
               dict(lr=1.0, warmup_steps=7, total_steps=7, min_lr_ratio=0.0)):
        jc, tc = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
        for s in range(0, 120, 3):
            np.testing.assert_allclose(float(opt.lr_at(tc, torch.tensor(s, dtype=torch.int32))),
                                       float(jopt.lr_at(jc, jnp.asarray(s, jnp.int32))),
                                       rtol=1e-6, atol=1e-12)


def test_clip_by_global_norm():
    g = {"a": torch.ones(4) * 3.0, "b": torch.ones(3) * 4.0}
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx((4 * 9 + 3 * 16) ** 0.5)
    assert float(opt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def _random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 7)).astype(np.float32),
            "nested": {"b": rng.standard_normal((7,)).astype(np.float32),
                       "s": np.float32(rng.standard_normal())}}


@pytest.mark.parametrize("clip", [None, 0.5, 100.0])
def test_adamw_update_matches_jax(clip):
    """Three updates of a tree with a scalar leaf (no weight decay there)."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, clip_norm=clip, weight_decay=0.1)
    jc, tc = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    p = _random_tree(0)
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(torch.from_numpy, jax.tree.map(np.array, p))
    js, ts = jopt.init_opt_state(jp), opt.init_opt_state(tp)
    for i in range(3):
        g = _random_tree(10 + i)
        jp, js, jm = jopt.adamw_update(jc, jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = opt.adamw_update(tc, tp, jax.tree.map(torch.from_numpy,
                                                           jax.tree.map(np.array, g)), ts)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    for a, b in zip(_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for a, b in zip(_leaves(ts.nu), jax.tree.leaves(js.nu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-12)
    assert int(ts.step) == 3 and ts.step.dtype == torch.int32


def test_bf16_params_keep_their_dtype_and_f32_moments():
    p = {"w": torch.randn(4, 4).to(torch.bfloat16)}
    g = {"w": torch.randn(4, 4).to(torch.bfloat16)}
    newp, state, _ = opt.adamw_update(opt.AdamWConfig(), p, g, opt.init_opt_state(p))
    assert newp["w"].dtype == torch.bfloat16
    assert state.mu["w"].dtype == state.nu["w"].dtype == torch.float32


def test_grad_accumulation_equivalence():
    cfg = get_config("gpt2_medium", smoke=True)
    params = api.init_params(cfg, device="cpu")
    batch = _tb(D.batch_at(D.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8), 0))

    def loss_fn(p, b):
        return api.loss_fn(p, b, cfg, ENGINE)

    l1, g1, _ = opt.accumulate_grads(loss_fn, params, batch, 1)
    l4, g4, _ = opt.accumulate_grads(loss_fn, params, batch, 4)
    assert float(l1) == pytest.approx(float(l4), rel=2e-3)
    for a, b in zip(_leaves(g1), _leaves(g4)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=2e-2, atol=2e-4)


def test_loss_decreases_on_tiny_model():
    cfg = get_config("gpt2_medium", smoke=True)
    params = api.init_params(cfg, device="cpu")
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=40, weight_decay=0.0)
    step = make_train_step(cfg, ENGINE, ocfg)
    state = opt.init_opt_state(params)
    batch = _tb(D.batch_at(D.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8,
                                        seed=7), 0))
    losses = []
    for _ in range(30):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_straggler_watch_flags_outlier():
    w = StragglerWatch(zscore=3.0, warmup=5)
    warn = None
    for _ in range(20):
        warn = w.observe(0.10 + np.random.RandomState(0).rand() * 0.001)
    assert warn is None
    assert w.observe(10.0) is not None


# ---------------------------------------------------------------------------
# Checkpoints (twins of test_checkpoint.py, and the JAX package's layout)
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.int32), "c": torch.tensor(3.5),
                       "h": torch.linspace(-3, 3, 7).to(torch.bfloat16)}}


def _equal(t, r):
    want, got = opt.named_leaves(t), opt.named_leaves(r)
    assert [k for k, _ in want] == [k for k, _ in got]
    for (k, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 3, t)
    restored, manifest = ck.restore(str(tmp_path), t)
    assert manifest["step"] == 3
    _equal(t, restored)


def test_keep_k_gc_and_latest(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), s, t, keep=2)
    assert len([d for d in os.listdir(tmp_path) if d.startswith("step_")]) == 2
    assert ck.latest_step(str(tmp_path)) == 5


def test_uncommitted_checkpoint_ignored(tmp_path):
    ck.save(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_00000009")
    assert ck.latest_step(str(tmp_path)) == 1


def test_async_save(tmp_path):
    th = ck.save_async(str(tmp_path), 7, _tree())
    th.join(timeout=30)
    assert ck.latest_step(str(tmp_path)) == 7


def test_concurrent_async_and_blocking_save_same_step(tmp_path):
    t = _tree()
    for _ in range(5):
        th = ck.save_async(str(tmp_path), 7, t)
        ck.save(str(tmp_path), 7, t)
        th.join(timeout=30)
    assert ck.latest_step(str(tmp_path)) == 7
    restored, manifest = ck.restore(str(tmp_path), t)
    assert manifest["step"] == 7
    _equal(t, restored)
    assert not [d for d in os.listdir(tmp_path) if ".tmp-" in d]


def _train_tree(name="gpt2_medium"):
    jcfg = jax_get_config(name, smoke=True)
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    jparams["extra_bf16"] = (jnp.arange(6, dtype=jnp.float32) / 7).astype(jnp.bfloat16)
    jstate = jopt.init_opt_state(jparams)
    jstate = jstate._replace(step=jnp.asarray(5, jnp.int32),
                             mu=jax.tree.map(lambda m: m + 0.25, jstate.mu))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tstate = opt.OptState(step=torch.tensor(5, dtype=torch.int32),
                          mu=opt.tree_map(lambda m: m + 0.25, opt.init_opt_state(tparams).mu),
                          nu=opt.init_opt_state(tparams).nu)
    return {"params": jparams, "opt": jstate}, {"params": tparams, "opt": tstate}


def test_checkpoint_layout_matches_jax(tmp_path):
    jtree, ttree = _train_tree()
    jck.save(str(tmp_path / "j"), 4, jtree, extra={"next_step": 4})
    ck.save(str(tmp_path / "t"), 4, ttree, extra={"next_step": 4})
    mans = []
    for d in ("j", "t"):
        with open(tmp_path / d / "step_00000004" / "manifest.json") as f:
            mans.append(json.load(f))
    strip = [[{k: v for k, v in leaf.items()} for leaf in m["leaves"]] for m in mans]
    assert strip[0] == strip[1]
    assert mans[0]["extra"] == mans[1]["extra"] and mans[0]["step"] == mans[1]["step"]
    assert sorted(os.listdir(tmp_path / "j" / "step_00000004")) == \
        sorted(os.listdir(tmp_path / "t" / "step_00000004"))


def test_jax_checkpoint_restores_bit_for_bit(tmp_path):
    jtree, ttree = _train_tree()
    jck.save(str(tmp_path), 4, jtree)
    like = {"params": opt.tree_map(torch.zeros_like, ttree["params"]),
            "opt": opt.init_opt_state(ttree["params"])}
    restored, manifest = ck.restore(str(tmp_path), like)
    assert manifest["step"] == 4
    _equal(ttree, restored)
    assert restored["params"]["extra_bf16"].dtype == torch.bfloat16


def _run(tmp_path, sub, steps, **kw):
    cfg = get_config("gpt2_medium", smoke=True)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=6)
    dcfg = D.data_config_for_model(cfg, 16, 4)
    tc = TrainConfig(steps=steps, ckpt_dir=str(tmp_path / sub), ckpt_every=3, log_every=1,
                     async_ckpt=False, **kw)
    return run_training(cfg, tc, ocfg, dcfg, engine=ENGINE, seed=0, device="cpu")


def test_train_resume_bitexact(tmp_path):
    """6 steps straight == 3 steps, stop, resume for 3 more — bit for bit."""
    straight = _run(tmp_path, "a", 6)
    _run(tmp_path, "b", 3)
    resumed = _run(tmp_path, "b", 6)
    assert resumed["history"][0]["step"] == 3
    _equal(straight["params"], resumed["params"])
    _equal(straight["opt_state"].mu, resumed["opt_state"].mu)
    assert resumed["data_state"].step == straight["data_state"].step == 6


def _loop(tmp_path, sub, steps, hooks, metrics_path=None):
    cfg = get_config("gpt2_medium", smoke=True)
    tc = TrainConfig(steps=steps, ckpt_dir=str(tmp_path / sub), ckpt_every=100, log_every=1,
                     async_ckpt=False, metrics_path=metrics_path)
    return run_training(cfg, tc, opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=6),
                        D.data_config_for_model(cfg, 16, 2), engine=ENGINE, device="cpu",
                        hooks=hooks)


def test_sigterm_saves_and_stops(tmp_path):
    def on_log(rec):
        if rec["step"] == 1:
            os.kill(os.getpid(), signal.SIGTERM)
    out = _loop(tmp_path, "s", 5, {"on_log": on_log})
    assert [r["step"] for r in out["history"]] == [0, 1]
    assert ck.latest_step(str(tmp_path / "s")) == 2
    _, manifest = ck.restore(str(tmp_path / "s"), {"params": out["params"],
                                                    "opt": out["opt_state"]})
    assert manifest["extra"] == {"next_step": 2, "data_step": 2}
    assert signal.getsignal(signal.SIGTERM) is not None


def test_crash_path_saves_the_last_good_step(tmp_path):
    def on_log(rec):
        if rec["step"] == 2:
            raise RuntimeError("boom")
    with pytest.raises(RuntimeError, match="boom"):
        _loop(tmp_path, "c", 5, {"on_log": on_log})
    assert ck.latest_step(str(tmp_path / "c")) == 3


def test_metrics_jsonl(tmp_path):
    path = tmp_path / "m.jsonl"
    out = _loop(tmp_path, "m", 3, {}, metrics_path=str(path))
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2] == [r["step"] for r in out["history"]]
    assert {"loss", "lr", "grad_norm", "accuracy", "ppl_proxy", "tokens",
            "sec_per_step"} <= set(recs[0])
    assert all(np.isfinite(r["loss"]) for r in recs)
