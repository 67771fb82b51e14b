"""Serving telemetry in the port (`repro_torch.serving.telemetry`), the twin
of `tests/test_telemetry.py`, and the port against the JAX package.

  * the reference's tests on the port's module: metric exactness, stable
    histogram buckets, lifecycle traces under a fake clock, windowed
    snapshots, Chrome traces that balance, the zero-cost disabled mode
    (tokens bit-identical with telemetry off and on, the disabled
    registry empty after a drain), `annotate` without `enabled` raising,
    `bench_metadata`'s keys (`torch_version` in place of `jax_version`),
    the snapshot's golden key set;
  * unit parity: one seeded stream of count / gauge / observe / request_* /
    chunk / tokens / spec_round / record_step / reset calls through both
    `Telemetry` classes under one fake clock each: equal `snapshot()` and
    `chrome_trace_events()`;
  * the allocator's counters over a seeded op stream, decision for
    decision with the JAX allocator's;
  * drain parity on gpt2_medium and qwen2_1_5b smoke: telemetry on both
    engines with a fake clock each, over a FIFO paged drain with chunks,
    sharing and a blocked head, `ngram` and self-draft speculation, an
    `SloScheduler` drain with preemptions, swaps, aborts and pins, and a
    dense drain. Equal exactly: greedy tokens, counters, gauges (but the
    achieved-bandwidth ones), the pool timeline's pages, the
    `prefix_cache`, `admission` and `scheduler` sections, the request
    summaries and fake-clock latency histograms (the port calls the clock
    as often and in the order the JAX engine does), and the modeled bytes
    and FLOPs per phase of `stats()["roofline"]` and of the snapshot. Equal
    in key sets only: what the host's perf_counter measures (phase and
    step seconds, achieved rates, the steps' Chrome-trace timestamps).
"""
from __future__ import annotations

import itertools
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.salpim import SalPimConfig, SalPimEngine
from repro.models import api as jax_api
from repro.serving import kvcache as jkv
from repro.serving import scheduler as jsched
from repro.serving import telemetry as jtel
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.config import GenConfig as JaxGenConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.speculative import SpecConfig as JaxSpecConfig
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.salpim import SalPimEngine as TSalPimEngine
from repro_torch.serving import kvcache as tkv
from repro_torch.serving.config import EngineConfig, GenConfig
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import SloScheduler
from repro_torch.serving.speculative import SpecConfig
from repro_torch.serving.telemetry import (
    NULL_TELEMETRY, SCHEMA_VERSION, Counter, Histogram, MetricsRegistry, Telemetry,
    bench_metadata, log_bucket_edges,
)

MODELS = ["gpt2_medium", "qwen2_1_5b"]
_MODELS = {}


def _model(name):
    if name not in _MODELS:
        jcfg = jax_get_config(name, smoke=True)
        jparams = jax_api.init_params(jax.random.PRNGKey(0), jcfg)
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
        _MODELS[name] = (jcfg, jparams, get_config(name, smoke=True), tparams)
    return _MODELS[name]


def _fake_clock(step=1.0):
    """Deterministic clock: 0, step, 2*step, ... per call."""
    c = itertools.count()
    return lambda: next(c) * step


# -- metrics ----------------------------------------------------------------

def test_counter_monotonic_and_exact():
    c = Counter()
    assert c.value == 0
    c.inc()
    c.inc(5)
    c.inc(0)
    assert c.value == 6
    with pytest.raises(AssertionError):
        c.inc(-1)


def test_log_bucket_edges_stable():
    # Bucket edges are a pure function of (lo, hi, buckets_per_decade):
    # cross-run (and cross-package) histogram comparability rests on them.
    edges = log_bucket_edges(1e-3, 1.0, buckets_per_decade=1)
    np.testing.assert_allclose(edges, [1e-3, 1e-2, 1e-1, 1.0], rtol=1e-12)
    edges = log_bucket_edges(1e-5, 100.0, buckets_per_decade=5)
    assert edges[0] == pytest.approx(1e-5) and edges[-1] >= 100.0
    assert len(edges) == 36                       # 7 decades x 5 + 1
    ratios = np.diff(np.log10(edges))
    np.testing.assert_allclose(ratios, ratios[0], rtol=1e-9)
    assert log_bucket_edges(1e-5, 100.0, 5) == edges
    assert edges == jtel.log_bucket_edges(1e-5, 100.0, 5)


def test_histogram_buckets_and_percentiles():
    h = Histogram(lo=1e-3, hi=1.0, buckets_per_decade=1)
    for v in [5e-4, 5e-3, 5e-2, 5e-2, 2.0]:       # under, mid, mid, mid, over
        h.observe(v)
    d = h.to_dict()
    assert d["total"] == 5
    assert sum(d["counts"]) == 5
    assert d["counts"][0] == 1                    # underflow
    assert d["counts"][-1] == 1                   # overflow
    assert d["sum"] == pytest.approx(2.1055)
    # p50 lands in the [1e-2, 1e-1) bucket: geometric midpoint.
    assert d["p50"] == pytest.approx(np.sqrt(1e-2 * 1e-1))


def test_registry_created_on_touch():
    reg = MetricsRegistry()
    assert reg.empty
    reg.counter("a").inc()
    reg.counter("a").inc()                        # same object, not a new one
    assert reg.counter("a").value == 2
    assert not reg.empty
    assert reg.snapshot()["counters"] == {"a": 2}
    reg.reset()
    assert reg.empty


# -- disabled mode ----------------------------------------------------------

def test_disabled_telemetry_is_noop():
    tel = Telemetry(enabled=False)
    tel.count("x")
    tel.gauge("y", 1.0)
    tel.observe("z", 0.5)
    tel.request_submitted(1, 4, 8)
    tel.request_admitted(1, 0)
    tel.chunk(1, 0.0, 1.0, 4)
    tel.tokens(1, 2.0)
    tel.spec_round(1, 0.0, 1.0, 4, 2)
    tel.request_finished(1)
    tel.attach_roofline({"hardware": {}})
    tel.record_step(0.0, 1.0, 0, 0, 0, 0, 1.0, 1, 2, 3, 0, 0, costs={"decode": (1, 1)})
    assert tel.registry.empty                     # nothing was ever created
    assert not tel.requests and not tel.steps
    assert tel.snapshot()["roofline"] == {"hardware": {}, "model": {}, "phases": {}}
    with tel.annotation("decode_step"), tel.step_annotation(1):
        pass                                      # no profiler scope, no torch import


def test_annotate_requires_enabled():
    with pytest.raises(ValueError, match="annotate=True requires enabled=True"):
        Telemetry(enabled=False, annotate=True)


def test_annotate_opens_profiler_scopes():
    """annotate=True: a step scope `serve_step` and a scope per model call,
    as torch.profiler records them."""
    tel = Telemetry(enabled=True, annotate=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tel.step_annotation(7):
            with tel.annotation("decode_step"):
                torch.ones(3).sum()
    names = [e.name for e in prof.events()]
    assert "serve_step" in names and "decode_step" in names


# -- lifecycle traces (scripted, fake clock) --------------------------------

def _scripted_telemetry(cls=Telemetry):
    """Clock ticks 1s per call: submit@1, 2, admit@3, 4, finish@5, 6."""
    tel = cls(enabled=True, clock=_fake_clock())
    tel.request_submitted(1, prompt_tokens=4, max_new_tokens=3)   # t=1
    tel.request_submitted(2, prompt_tokens=6, max_new_tokens=2)   # t=2
    tel.request_admitted(1, slot=0)                               # t=3
    tel.chunk(1, 3.0, 3.5, 4)
    for t in (4.0, 5.0, 7.0):
        tel.tokens(1, t)
    tel.request_admitted(2, slot=1, shared_tokens=2)              # t=4
    tel.tokens(2, 5.0, n=2)                       # burst: zero intra-delta
    tel.record_step(3.0, 1.0, 0.1, 0.2, 0.0, 0.0, 0.5, 5, 3, 2, 1, 1)
    tel.request_finished(1)                                       # t=5
    tel.request_finished(2)                                       # t=6
    return tel


def test_lifecycle_counters_exact():
    tel = _scripted_telemetry()
    snap = tel.snapshot()
    c = snap["counters"]
    assert c["requests.submitted"] == 2
    assert c["requests.admitted"] == 2
    assert c["requests.finished"] == 2
    assert c["tokens.generated"] == 5
    assert c["prefill.tokens"] == 4 and c["prefill.chunks"] == 1
    assert snap["steps"]["count"] == 1
    assert snap["steps"]["phase_sec"]["decode"] == pytest.approx(0.5)
    assert snap["pool"]["occupancy_timeline"] == [[3.0, 5, 3, 2]]
    assert snap["schema_version"] == SCHEMA_VERSION == jtel.SCHEMA_VERSION
    assert snap == _scripted_telemetry(jtel.Telemetry).snapshot()


def test_per_request_summaries():
    tel = _scripted_telemetry()
    per = {r["uid"]: r for r in tel.snapshot()["requests"]["per_request"]}
    r1 = per[1]
    assert r1["queued_sec"] == pytest.approx(2.0)     # submit@1, admit@3
    assert r1["ttft_sec"] == pytest.approx(3.0)       # first token @4
    assert r1["tokens"] == 3 and r1["finished"]
    # Deltas are [1, 2]: nearest-rank p50 = 1, p99 = 2, observed gaps.
    assert r1["inter_token_p50_sec"] == pytest.approx(1.0)
    assert r1["inter_token_p99_sec"] == pytest.approx(2.0)
    r2 = per[2]
    assert r2["shared_tokens"] == 2
    assert r2["tokens"] == 2
    assert r2["inter_token_p50_sec"] == pytest.approx(0.0)  # burst


def test_snapshot_reset_window():
    tel = _scripted_telemetry()
    tel.request_submitted(3, 4, 4)                # still live at reset
    tel.reset()
    snap = tel.snapshot()
    assert snap["counters"] == {} and snap["steps"]["count"] == 0
    # Live requests keep their traces across the window boundary.
    assert snap["requests"]["live"] == 1
    assert snap["requests"]["per_request"][0]["uid"] == 3
    tel.tokens(3, tel.now())
    assert tel.snapshot()["counters"]["tokens.generated"] == 1


# -- Chrome trace export ----------------------------------------------------

def _check_trace(events):
    """Per-tid span discipline: every B has a matching E on its tid, and in
    file order (the format's nesting order) spans are well-nested."""
    stacks = {}
    for e in events:
        if e["ph"] == "B":
            stacks.setdefault(e["tid"], []).append(e["name"])
        elif e["ph"] == "E":
            assert stacks.get(e["tid"]), f"E with no open B on tid {e['tid']}"
            stacks[e["tid"]].pop()
    assert all(not s for s in stacks.values()), f"unclosed spans: {stacks}"


def test_chrome_trace_balanced_and_nested(tmp_path):
    tel = _scripted_telemetry()
    events = tel.chrome_trace_events()
    _check_trace(events)
    assert {"request", "queued", "decode"} <= {e["name"] for e in events}
    assert any(e["ph"] == "C" and e["name"] == "pool" for e in events)
    path = tmp_path / "trace.json"
    n = tel.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    assert len(doc["traceEvents"]) == n
    assert doc["otherData"]["schema_version"] == SCHEMA_VERSION
    snap = tel.export_json(str(tmp_path / "snap.json"))
    assert json.loads((tmp_path / "snap.json").read_text()) == json.loads(json.dumps(snap))


# -- unit parity with the JAX package ---------------------------------------

_STATIC = {"hardware": {"name": "cpu", "peak_flops": 1e12, "peak_bytes_per_sec": 100e9,
                        "ridge_flops_per_byte": 10.0},
           "page_size": 4, "weight_stream_bytes": 123456}
_PHASES = ("admit", "chunk_prefill", "draft", "verify", "decode")


def _op_stream(seed, n_ops=300):
    """A seeded list of (method, args) calls on a Telemetry."""
    rng = np.random.RandomState(seed)
    ops, uid = [], 0
    for i in range(n_ops):
        r = rng.rand()
        t = float(rng.rand() * 10)
        if r < 0.12 or uid == 0:
            uid += 1
            ops.append(("request_submitted", (uid, int(rng.randint(1, 40)),
                                              int(rng.randint(1, 20))),
                        {"priority": int(rng.randint(0, 3))}))
        elif r < 0.2:
            ops.append(("request_admitted", (int(rng.randint(1, uid + 2)),
                                             int(rng.randint(0, 4)), int(rng.randint(0, 9))), {}))
        elif r < 0.3:
            ops.append(("chunk", (int(rng.randint(1, uid + 2)), t, t + float(rng.rand()),
                                  int(rng.randint(1, 64))), {}))
        elif r < 0.45:
            ops.append(("tokens", (int(rng.randint(1, uid + 2)), t,
                                   int(rng.randint(0, 4))), {}))
        elif r < 0.52:
            ops.append(("spec_round", (int(rng.randint(1, uid + 2)), t, t + 0.5,
                                       int(rng.randint(0, 5)), int(rng.randint(0, 3))), {}))
        elif r < 0.58:
            ops.append(("request_finished", (int(rng.randint(1, uid + 2)),), {}))
        elif r < 0.65:
            ops.append(("count", (f"c.{rng.randint(5)}", int(rng.randint(0, 4))), {}))
        elif r < 0.7:
            ops.append(("gauge", (f"g.{rng.randint(3)}", float(rng.randn())), {}))
        elif r < 0.75:
            ops.append(("observe", (f"h.{rng.randint(3)}", float(rng.rand() * 1e-2),
                                    int(rng.randint(1, 3))), {}))
        elif r < 0.78:
            ops.append(("now", (), {}))
        elif r < 0.785:
            ops.append(("reset", (), {}))
        else:
            secs = [float(x) if rng.rand() < 0.5 else 0.0 for x in rng.rand(5)]
            costs = {p: (float(rng.randint(1, 10 ** 9)), float(rng.randint(1, 10 ** 10)))
                     for p, s in zip(_PHASES, secs) if s > 0 or rng.rand() < 0.2}
            ops.append(("record_step", (t, float(sum(secs)) + 0.1, *secs,
                                        *(int(x) for x in rng.randint(0, 50, size=5))),
                        {"costs": costs or None}))
    return ops


@pytest.mark.parametrize("seed", range(3))
def test_unit_stream_matches_jax(seed):
    tels = [cls(enabled=True, clock=_fake_clock(0.25)) for cls in (jtel.Telemetry, Telemetry)]
    for tel in tels:
        tel.attach_roofline(_STATIC)
        for name, args, kw in _op_stream(seed):
            getattr(tel, name)(*args, **kw)
    want, got = tels
    assert got.snapshot() == want.snapshot()
    assert got.chrome_trace_events() == want.chrome_trace_events()
    _check_trace(got.chrome_trace_events())


# -- the allocator's counters against the JAX allocator's --------------------

def _alloc_ops(rng, n_ops, ref):
    """Seeded admissions (sharing page-aligned prefixes), extends, forks of
    shared pages, rewinds, pin reclaims and releases."""
    bases = [rng.randint(2, 50, size=12) for _ in range(3)]
    uid, live = 0, []
    for _ in range(n_ops):
        r = rng.rand()
        if r < 0.35 or not live:
            base = bases[rng.randint(len(bases))]
            toks = np.concatenate([base[:int(rng.choice([0, 4, 8, 12]))],
                                   rng.randint(2, 50, size=rng.randint(1, 6))])
            uid += 1
            reserve = bool(rng.rand() < 0.7)
            if rng.rand() < 0.2:
                n = int(rng.randint(1, 4))
                yield "admit_restored", (uid, n, n + int(rng.randint(0, 3)), reserve)
            else:
                yield "admit_tokens", (uid, toks, int(rng.randint(1, 10)), reserve)
            live.append(uid)
        elif r < 0.55:
            if ref._free:
                yield "extend", (int(rng.choice(live)),)
        elif r < 0.65:
            shared = [(u, i) for u, pages in ref._pages.items()
                      for i, p in enumerate(pages) if ref._ref[p] > 1]
            if shared and ref._free:
                yield "fork_page", shared[rng.randint(len(shared))]
        elif r < 0.72:
            # Rewind only decode-frontier pages (private, not cached), as
            # the engine does.
            u = int(rng.choice(live))
            pages = ref._pages.get(u, [])
            keep = len(pages)
            while keep and ref._ref[pages[keep - 1]] == 1 and pages[keep - 1] not in ref._page_key:
                keep -= 1
            if pages:
                ps = ref.page_size
                yield "rewind", (u, int(rng.randint(max(keep - 1, 0) * ps + 1,
                                                    len(pages) * ps + 1)))
        elif r < 0.77:
            yield "reclaim_pinned", (int(rng.randint(0, 3)),)
        else:
            u = int(rng.choice(live))
            live.remove(u)
            yield "release", (u,)
    # A drained pool, then a prompt's cached pages pinned at release and
    # revived by the next admission of the same prompt.
    for u in live:
        yield "release", (u,)
    yield "reclaim_pinned", (3,)
    for u in (uid + 1, uid + 2):
        yield "admit_tokens", (u, bases[0], 4, True)
        yield "release", (u,)


@pytest.mark.parametrize("seed", range(3))
def test_allocator_counters_match_jax(seed):
    tels = [jtel.Telemetry(enabled=True), Telemetry(enabled=True)]
    ja = jkv.BlockAllocator(20, 4, prefix_sharing=True, telemetry=tels[0], pin_budget_pages=3)
    ta = tkv.BlockAllocator(20, 4, prefix_sharing=True, telemetry=tels[1], pin_budget_pages=3)
    for op, args in _alloc_ops(np.random.RandomState(seed), 300, ja):
        outs = []
        for a in (ja, ta):
            try:
                outs.append((getattr(a, op)(*args), None))
            except (AssertionError, RuntimeError, ValueError, KeyError) as e:
                outs.append((None, type(e).__name__))
        assert (outs[0][1] is None) == (outs[1][1] is None), (op, args, outs)
        assert outs[1][0] == outs[0][0], (op, args)
        assert tels[1].registry.snapshot() == tels[0].registry.snapshot(), (op, args)
    counters = tels[1].snapshot()["counters"]
    for name in ("pool.pages_allocated", "pool.pages_freed", "prefix_cache.page_hits",
                 "prefix_cache.page_misses", "pool.pages_rewound", "sched.pin",
                 "sched.pin_hits"):
        assert name in counters, name


# -- engine integration -----------------------------------------------------

def _port_engine(tel=None, **kw):
    _, _, cfg, tparams = _model("gpt2_medium")
    return ServingEngine(tparams, cfg, TSalPimEngine.create(), EngineConfig(
        slots=2, max_len=24, gen=GenConfig(temperature=0.0, stop_on_eos=False),
        paged=True, page_size=8, prefill_chunk_tokens=4, telemetry=tel, **kw),
        device="cpu")


def _drain_port(eng, reqs):
    uids = [eng.submit(p.copy(), max_new_tokens=n) for p, n in reqs]
    eng.run(max_steps=500)
    by = {r.uid: list(r.generated) for r in eng.finished}
    return [by[u] for u in uids]


def test_engine_telemetry_zero_cost_and_exact(tmp_path):
    cfg = _model("gpt2_medium")[2]
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(2, cfg.vocab, size=rng.randint(4, 10)), int(rng.randint(3, 7)))
            for _ in range(4)]
    tel = Telemetry(enabled=True)
    outs = {}
    for label, t in [("off", None), ("on", tel)]:
        eng = _port_engine(t)
        outs[label] = _drain_port(eng, reqs)
        if label == "off":
            # Zero-cost contract: the disabled default never touches the
            # registry, so it is provably empty after a full drain.
            assert eng.telemetry is NULL_TELEMETRY and not eng.telemetry.enabled
            assert eng.telemetry.registry.empty and not eng.telemetry.requests
        else:
            st = eng.stats()
    assert outs["on"] == outs["off"], "telemetry changed greedy outputs"

    n_new = sum(n for _, n in reqs)
    c = tel.snapshot()["counters"]
    assert c["tokens.generated"] == n_new
    assert c["requests.submitted"] == c["requests.finished"] == len(reqs)
    assert c["prefill.tokens"] == sum(len(p) for p, _ in reqs)
    for k in ("step_sec", "admit_sec", "chunk_prefill_sec", "draft_sec", "verify_sec",
              "decode_sec", "model_sec_per_token", "sec_per_token", "tokens", "roofline"):
        assert k in st, k
    phase_sum = (st["admit_sec"] + st["chunk_prefill_sec"] + st["draft_sec"]
                 + st["verify_sec"] + st["decode_sec"])
    assert phase_sum <= st["step_sec"] + 1e-6
    assert st["decode_sec"] > 0 and st["chunk_prefill_sec"] > 0

    events = tel.chrome_trace_events()
    _check_trace(events)
    req_tids = {e["tid"] for e in events if e["ph"] == "B" and e["name"] == "request"}
    assert len(req_tids) == len(reqs)
    tel.export_chrome_trace(str(tmp_path / "engine_trace.json"))
    json.loads((tmp_path / "engine_trace.json").read_text())
    snap = tel.snapshot()
    assert len(snap["pool"]["occupancy_timeline"]) == snap["steps"]["count"]
    assert snap["pool"]["occupancy_timeline"][-1][1] == 0
    assert max(t[1] for t in snap["pool"]["occupancy_timeline"]) > 0


def test_engine_annotated_drain_scopes():
    """annotate=True under torch.profiler: one serve_step scope a step, the
    chunk and decode calls in theirs; the tokens are those of a drain with
    telemetry off."""
    cfg = _model("gpt2_medium")[2]
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(2, cfg.vocab, size=6), 3) for _ in range(2)]
    want = _drain_port(_port_engine(), reqs)
    eng = _port_engine(Telemetry(enabled=True, annotate=True))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = _drain_port(eng, reqs)
    assert got == want
    names = [e.name for e in prof.events()]
    assert names.count("serve_step") == eng.telemetry.snapshot()["steps"]["count"]
    assert names.count("decode_step") == eng.decode_steps
    assert names.count("prefill_chunk") == eng.prefill_chunks


def test_bench_metadata_keys():
    meta = bench_metadata()
    for k in ("schema_version", "git_sha", "torch_version", "device_kind",
              "platform", "generated_utc"):
        assert k in meta, k
    assert meta["schema_version"] == SCHEMA_VERSION
    assert meta["torch_version"] == torch.__version__
    assert (meta["platform"], meta["device_kind"]) == ("cpu", "cpu")


def test_snapshot_golden_keys():
    """The snapshot's schema is the reference's, locked to SCHEMA_VERSION."""
    assert SCHEMA_VERSION == 2
    cfg = _model("gpt2_medium")[2]
    tel = Telemetry(enabled=True, clock=_fake_clock(0.01))
    eng = _port_engine(tel)
    rng = np.random.RandomState(0)
    _drain_port(eng, [(rng.randint(2, cfg.vocab, size=6), 4) for _ in range(2)])
    snap = tel.snapshot()
    assert set(snap) == {
        "schema_version", "counters", "gauges", "histograms", "steps",
        "pool", "requests", "prefix_cache", "admission", "scheduler",
        "roofline",
    }
    roof = snap["roofline"]
    assert set(roof) == {"hardware", "model", "phases"}
    assert set(roof["hardware"]) == {
        "name", "peak_flops", "peak_bytes_per_sec", "ridge_flops_per_byte"}
    for k in ("kv_dtype", "kv_scale_dtype", "kv_bytes_per_vector",
              "kv_bytes_per_token", "page_size", "page_bytes",
              "weight_stream_bytes", "draft_stream_bytes",
              "tensor_parallel", "gather_bytes_per_token", "model"):
        assert k in roof["model"], k
    assert roof["phases"], "no phase ran costs"
    for phase, row in roof["phases"].items():
        assert set(row) == {
            "bytes", "flops", "sec", "achieved_gbps", "achieved_gflops",
            "arithmetic_intensity", "bw_utilization", "bound",
        }, phase
    assert any(k.startswith("roofline.") and k.endswith(".achieved_gbps")
               for k in snap["gauges"])


# -- drain parity with the JAX engine ---------------------------------------

DRAINS = ["fifo", "ngram", "self-draft", "slo", "dense"]


def _workload(vocab, kind):
    """(requests [(prompt, new, priority)], late requests, the step before
    which they arrive)."""
    rng = np.random.RandomState(5)
    if kind == "slo":
        # The reference's burst: three background requests, then three
        # urgent ones (two on one 8-token prefix) at step 5.
        bg = [(rng.randint(2, vocab, size=int(n)), 10, 1) for n in (10, 9, 11)]
        prefix = rng.randint(2, vocab, size=8)
        urgent = [(np.concatenate([prefix, rng.randint(2, vocab, size=3)]), 5, 0),
                  (np.concatenate([prefix, rng.randint(2, vocab, size=2)]), 4, 0),
                  (rng.randint(2, vocab, size=7), 6, 0)]
        return bg, urgent, 5
    prefix = rng.randint(2, vocab, size=8)
    reqs = [(np.concatenate([prefix, rng.randint(2, vocab, size=int(n))]), int(m), 0)
            for n, m in ((3, 6), (5, 7), (0, 5))]
    reqs += [(rng.randint(2, vocab, size=int(n)), int(m), 0) for n, m in ((6, 8), (4, 6))]
    if kind == "fifo":
        # Six of the seven pages' worth: it waits at the watermark.
        reqs.insert(2, (rng.randint(2, vocab, size=14), 10, 0))
    if kind == "ngram":
        # Repeats inside the prompts give the n-gram drafter matches.
        reqs = [(np.concatenate([p, p[:6]]), n, pr) for p, n, pr in reqs]
    return reqs, [], None


def _settings(kind):
    kw = dict(slots=2, max_len=32, paged=True, page_size=4, prefill_chunk_tokens=4)
    if kind == "fifo":
        kw["num_pages"] = 8           # a head that waits at the watermark
    elif kind == "slo":
        kw.update(slots=3, num_pages=11)
    elif kind == "dense":
        kw = dict(slots=2, max_len=32)
    return kw


def _engines(name, kind):
    jcfg, jparams, cfg, tparams = _model(name)
    kw = _settings(kind)
    jspec = tspec = None
    if kind == "ngram":
        jspec, tspec = JaxSpecConfig(mode="ngram", k=4), SpecConfig(mode="ngram", k=4)
    elif kind == "self-draft":
        jspec = JaxSpecConfig(mode="draft-model", k=2, draft_cfg=jcfg, draft_params=jparams)
        tspec = SpecConfig(mode="draft-model", k=2, draft_cfg=cfg, draft_params=tparams)
    slo = kind == "slo"
    jtele = jtel.Telemetry(enabled=True, clock=_fake_clock(1e-3))
    ttele = Telemetry(enabled=True, clock=_fake_clock(1e-3))
    jeng = JaxServingEngine(jparams, jcfg, SalPimEngine.create(SalPimConfig()), JaxEngineConfig(
        gen=JaxGenConfig(temperature=0.0, stop_on_eos=False), speculative=jspec,
        scheduler=jsched.SloScheduler(pin_budget_pages=2) if slo else None,
        telemetry=jtele, **kw))
    teng = ServingEngine(tparams, cfg, TSalPimEngine.create(), EngineConfig(
        gen=GenConfig(stop_on_eos=False), speculative=tspec,
        scheduler=SloScheduler(pin_budget_pages=2) if slo else None,
        telemetry=ttele, **kw), device="cpu")
    return jeng, teng


def _drain(eng, requests, late, at_step):
    uids = [eng.submit(p.copy(), max_new_tokens=n, priority=pr) for p, n, pr in requests]
    steps = 0
    while late and steps < at_step:
        eng.step()
        steps += 1
    uids += [eng.submit(p.copy(), max_new_tokens=n, priority=pr) for p, n, pr in late]
    eng.run(max_steps=800)
    by = {r.uid: list(r.generated) for r in eng.finished}
    assert set(uids) <= set(by) and not eng.queue and not any(eng.active)
    return [by[u] for u in uids]


def _untimed(hist_name):
    """Histograms of the host's perf_counter (the fake clock does not feed
    them)."""
    return hist_name == "latency.step_sec"


def _same_snapshots(got, want):
    assert set(got) == set(want)
    assert got["schema_version"] == want["schema_version"]
    assert got["counters"] == want["counters"]
    assert set(got["gauges"]) == set(want["gauges"])
    assert ({k: v for k, v in got["gauges"].items() if not k.startswith("roofline.")}
            == {k: v for k, v in want["gauges"].items() if not k.startswith("roofline.")})
    assert set(got["histograms"]) == set(want["histograms"])
    for k, h in got["histograms"].items():
        if _untimed(k):
            assert h["total"] == want["histograms"][k]["total"], k
        else:
            assert h == want["histograms"][k], k
    assert got["steps"]["count"] == want["steps"]["count"]
    assert set(got["steps"]["phase_sec"]) == set(want["steps"]["phase_sec"])
    assert ([r[1:] for r in got["pool"]["occupancy_timeline"]]
            == [r[1:] for r in want["pool"]["occupancy_timeline"]])
    assert got["requests"] == want["requests"]
    for section in ("prefix_cache", "admission", "scheduler"):
        assert got[section] == want[section], section
    groof, wroof = got["roofline"], want["roofline"]
    assert (groof["hardware"], groof["model"]) == (wroof["hardware"], wroof["model"])
    assert set(groof["phases"]) == set(wroof["phases"])
    for phase, row in groof["phases"].items():
        ref = wroof["phases"][phase]
        assert set(row) == set(ref)
        assert (row["bytes"], row["flops"], row["arithmetic_intensity"], row["bound"]) == (
            ref["bytes"], ref["flops"], ref["arithmetic_intensity"], ref["bound"]), phase


def _same_traces(got, want):
    """Request tids exactly (the fake clock's times); the engine timeline
    (tid 0, perf_counter times) event for event by kind, name and pages."""
    assert [(e["ph"], e["name"], e["tid"]) for e in got] == \
        [(e["ph"], e["name"], e["tid"]) for e in want]
    for g, w in zip(got, want):
        if g["tid"] != 0 or g["ph"] == "M" or g["name"] in ("pool", "queue"):
            if g["tid"] == 0 and g["ph"] == "C":
                assert g["args"] == w["args"]
            else:
                assert g == w
        elif g["name"] == "roofline_gbps":
            assert set(g["args"]) == set(w["args"])


@pytest.mark.parametrize("kind", DRAINS)
@pytest.mark.parametrize("name", MODELS)
def test_drain_telemetry_matches_jax(name, kind):
    jeng, teng = _engines(name, kind)
    requests, late, at_step = _workload(_model(name)[0].vocab, kind)
    if kind == "fifo":
        for eng in (jeng, teng):
            with pytest.raises(ValueError, match="max_len is 32"):
                eng.submit(np.arange(2, 32), max_new_tokens=10)
            with pytest.raises(ValueError, match="pages worst case"):
                eng.submit(np.arange(2, 27), max_new_tokens=8)
    want = _drain(jeng, requests, late, at_step)
    got = _drain(teng, requests, late, at_step)
    assert got == want
    jsnap, tsnap = jeng.telemetry.snapshot(), teng.telemetry.snapshot()
    _same_snapshots(tsnap, jsnap)
    _same_traces(teng.telemetry.chrome_trace_events(), jeng.telemetry.chrome_trace_events())
    _check_trace(teng.telemetry.chrome_trace_events())
    jroof, troof = jeng.stats()["roofline"], teng.stats()["roofline"]
    assert set(troof) == set(jroof)
    for phase, row in troof.items():
        ref = jroof[phase]
        assert set(row) == set(ref)
        assert ((row["modeled_bytes"], row["modeled_flops"], row["bound"])
                == (ref["modeled_bytes"], ref["modeled_flops"], ref["bound"])), phase
        assert row["modeled_bytes"] == pytest.approx(tsnap["roofline"]["phases"][phase]["bytes"])
    c = tsnap["counters"]
    sched = tsnap["scheduler"]
    if kind == "fifo":
        assert tsnap["admission"]["blocked_steps"] > 0 and c["prefix_cache.page_hits"] > 0
        assert tsnap["admission"]["rejected"] == {"over_max_len": 1, "over_pool_capacity": 1}
        assert set(troof) == {"chunk_prefill", "decode"}
    elif kind == "ngram":
        assert c["spec.rounds"] > 0 and c["spec.proposed"] > 0 and "verify" in troof
    elif kind == "self-draft":
        assert c["spec.draft_prefills"] > 0 and c["spec.draft_decode_steps"] > 0
        assert {"draft", "verify"} <= set(troof)
    elif kind == "slo":
        assert sched["preempt"] > 0 and sched["swap_out"] > 0 and sched["swap_in"] > 0
        assert sched["readmit"] > 0, "no mid-prefill victim was aborted and readmitted"
        assert sched["pin"] > 0, sched
    else:
        assert set(troof) == {"admit", "decode"} and not tsnap["prefix_cache"]["page_misses"]
