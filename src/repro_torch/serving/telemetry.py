"""Serving telemetry (the port of `repro.serving.telemetry`): metrics
registry, request lifecycle traces, and Chrome-trace step timelines.

SAL-PIM's argument is that generation-stage decode is memory-bound and
must be *measured* end-to-end: a cumulative stats() dict cannot say where
a step's milliseconds go (draft vs verify vs decode vs chunk prefill), how
pool occupancy and watermark headroom evolve, or where head-of-line
blocking bites. This module is the engine's observability layer, three
pieces behind one `Telemetry` facade:

  * `MetricsRegistry` — counters (monotonic), gauges (last value), and
    histograms with *fixed log-spaced buckets* (edges are a pure
    function of (lo, hi, buckets_per_decade), so exported histograms
    from different runs are bucket-compatible and machine-comparable).
    The engine, `BlockAllocator`, the scheduler and the speculative path
    publish here: pool pages used/free, watermark headroom, prefix-cache
    page hits/misses, COW forks, admission rejections by reason and
    blocked steps, preemptions and swaps, tokens generated, drafts
    proposed/accepted, inter-token and time-to-first-token latency
    histograms.

  * Request lifecycle tracing — every request gets a `RequestTrace`
    recording span timestamps through its whole life: submit -> admit
    (queued time) -> prefill chunks -> first token -> decode / spec
    rounds -> finish. Exportable two ways: `snapshot()` (structured
    dict, JSON-ready, with per-request inter-token p50/p99 computed
    exactly from token timestamps) and `export_chrome_trace()` (a
    Chrome `trace_event` file: one tid per request with well-nested
    B/E spans, a tid for engine step phases, and `ph:"C"` counter
    tracks for pool occupancy/queue depth; load it at
    https://ui.perfetto.dev or chrome://tracing).

  * A zero-cost disabled mode — `Telemetry(enabled=False)` (the
    engine's default) makes every record method return on a single
    attribute check: no dict allocation, no event objects, no device
    sync. Instrumentation happens at step boundaries only and reads host
    state (the engine's host lengths, the allocator), never a device
    tensor, so the kernels launched and the serving outputs are
    bit-identical with telemetry on or off.

With `annotate=True` (requires `enabled=True`) the engine additionally
wraps each engine step in a `torch.profiler.record_function` scope named
`serve_step` (carrying the step number) and each model call in one named
after it (`prefill_chunk`, `dense_admit_prefill`, `decode_step`,
`verify_tokens`), so a trace captured with `torch.profiler.profile` lines
up with the engine phases recorded here and puts each kernel under the
phase that launched it.

`snapshot()` / `reset()` give long-running servers a windowed view:
snapshot returns everything observed since the last reset; reset zeroes
the registry and drops finished-request traces and step records while
keeping live requests' traces intact (their spans continue across the
window boundary).

`bench_metadata()` is the shared stamp for benchmark JSON exports
(schema version, git SHA, torch version, device kind).

The module imports no framework: torch is imported only by `annotation`,
`step_annotation` (with `annotate=True`) and `bench_metadata`.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import math
import subprocess
import time
from typing import Optional

# Version stamp for every exported artifact (bench JSON, snapshot,
# Chrome trace metadata), the JAX package's: the snapshot's key set is
# the reference's (tests/test_torch_telemetry.py locks it). Bump when a
# field changes meaning or the key set changes. v2: the snapshot's
# "roofline" section (costmodel.py).
SCHEMA_VERSION = 2

_NULL_CTX = contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        assert n >= 0, f"counter decrement ({n})"
        self.value += n


class Gauge:
    """Last-observed value (pool occupancy, queue depth, ...)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


def log_bucket_edges(lo: float, hi: float,
                     buckets_per_decade: int = 5) -> tuple[float, ...]:
    """Fixed log-spaced bucket edges: lo * 10**(i / bpd) up through hi.

    Pure function of its arguments — two runs (or two machines) with the
    same parameters always produce identical edges, so their histograms
    can be merged or diffed bucket by bucket.
    """
    assert 0 < lo < hi and buckets_per_decade >= 1
    n = math.ceil(round(math.log10(hi / lo) * buckets_per_decade, 9))
    return tuple(lo * 10.0 ** (i / buckets_per_decade)
                 for i in range(n + 1))


class Histogram:
    """Histogram over fixed log-spaced buckets plus under/overflow.

    counts[0] holds observations < edges[0] (including exact zeros from
    burst-emitted speculative tokens); counts[-1] holds >= edges[-1].
    Percentile estimates interpolate inside the hit bucket; exact
    per-request percentiles come from the tracer's raw timestamps.
    """

    __slots__ = ("edges", "counts", "total", "sum")

    def __init__(self, lo: float = 1e-5, hi: float = 100.0,
                 buckets_per_decade: int = 5):
        self.edges = log_bucket_edges(lo, hi, buckets_per_decade)
        self.counts = [0] * (len(self.edges) + 1)
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float, n: int = 1) -> None:
        self.counts[bisect.bisect_right(self.edges, v)] += n
        self.total += n
        self.sum += v * n

    def percentile(self, q: float) -> float:
        """Bucket-resolution quantile estimate, q in [0, 100]."""
        if self.total == 0:
            return 0.0
        rank = q / 100.0 * self.total
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank and c > 0:
                if i == 0:
                    return self.edges[0]
                if i == len(self.edges):
                    return self.edges[-1]
                return math.sqrt(self.edges[i - 1] * self.edges[i])
        return self.edges[-1]

    def to_dict(self) -> dict:
        return {"edges": list(self.edges), "counts": list(self.counts),
                "total": self.total, "sum": self.sum,
                "p50": self.percentile(50), "p99": self.percentile(99)}


class MetricsRegistry:
    """Name -> metric. Metrics are created on first touch, so a disabled
    telemetry (which never touches them) leaves the registry empty."""

    def __init__(self):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str, **kwargs) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(**kwargs)
        return h

    @property
    def empty(self) -> bool:
        return not (self.counters or self.gauges or self.histograms)

    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.to_dict()
                           for k, h in sorted(self.histograms.items())},
        }

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()


# ---------------------------------------------------------------------------
# Lifecycle traces
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RequestTrace:
    """One request's lifecycle timestamps (engine clock seconds)."""

    uid: int
    prompt_tokens: int
    max_new_tokens: int
    submit_t: float
    admit_t: Optional[float] = None
    slot: Optional[int] = None
    shared_tokens: int = 0
    finish_t: Optional[float] = None
    # Scheduling class (serving/scheduler.py; 0 = most urgent). Keys the
    # per-class latency histograms.
    priority: int = 0
    # One entry per emitted token (speculative rounds emit bursts that
    # legitimately share a timestamp).
    token_times: list[float] = dataclasses.field(default_factory=list)
    # (t0, t1, n_tokens) per prefill chunk (dense admission records its
    # whole-prompt prefill as one chunk).
    chunks: list[tuple[float, float, int]] = dataclasses.field(
        default_factory=list)
    # (t0, t1, proposed, accepted) per draft-verify round.
    spec_rounds: list[tuple[float, float, int, int]] = dataclasses.field(
        default_factory=list)

    @property
    def first_token_t(self) -> Optional[float]:
        return self.token_times[0] if self.token_times else None

    def inter_token_deltas(self) -> list[float]:
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]

    def summary(self) -> dict:
        deltas = sorted(self.inter_token_deltas())

        def pct(q):
            if not deltas:
                return None
            # Nearest-rank on the raw timestamps: exact, an observed gap.
            return deltas[min(len(deltas) - 1,
                              math.ceil(q / 100.0 * len(deltas)) - 1)]

        return {
            "uid": self.uid,
            "slot": self.slot,
            "priority": self.priority,
            "prompt_tokens": self.prompt_tokens,
            "shared_tokens": self.shared_tokens,
            "max_new_tokens": self.max_new_tokens,
            "tokens": len(self.token_times),
            "queued_sec": (None if self.admit_t is None
                           else self.admit_t - self.submit_t),
            "ttft_sec": (None if self.first_token_t is None
                         else self.first_token_t - self.submit_t),
            "prefill_chunks": len(self.chunks),
            "spec_rounds": len(self.spec_rounds),
            "proposed": sum(r[2] for r in self.spec_rounds),
            "accepted": sum(r[3] for r in self.spec_rounds),
            "inter_token_p50_sec": pct(50),
            "inter_token_p99_sec": pct(99),
            "finished": self.finish_t is not None,
            "total_sec": (None if self.finish_t is None
                          else self.finish_t - self.submit_t),
        }


# Per-step record field order (kept a plain tuple — one allocation per
# step): (t_start, dur, admit, chunk, draft, verify, decode,
#         pages_used, pages_free, headroom, queue_depth, prefilling,
#         phase_costs)
# phase_costs is None or {phase: (modeled_bytes, modeled_flops)} from
# the engine's cost model (serving/costmodel.py).
_STEP_FIELDS = ("t_start", "dur_sec", "admit_sec", "chunk_prefill_sec",
                "draft_sec", "verify_sec", "decode_sec", "pages_used",
                "pages_free", "watermark_headroom", "queue_depth",
                "slots_prefilling", "phase_costs")
_PHASES = ("admit", "chunk_prefill", "draft", "verify", "decode")


class Telemetry:
    """Facade the serving stack publishes into.

    Disabled (the default) every record method is a no-op behind one
    `self.enabled` check — the hot path allocates nothing. Enabled, it
    feeds the registry, per-request traces, and per-step records that
    `snapshot()` and `export_chrome_trace()` serialize.
    """

    def __init__(self, enabled: bool = False, annotate: bool = False,
                 clock=time.perf_counter):
        if annotate and not enabled:
            raise ValueError("annotate=True requires enabled=True")
        self.enabled = enabled
        self.annotate = annotate
        self.clock = clock
        self.registry = MetricsRegistry()
        self.requests: dict[int, RequestTrace] = {}
        self.steps: list[tuple] = []
        # Roofline state: static facts from the engine's cost model
        # (attach_roofline) and per-phase [bytes, flops, sec] running
        # sums over the window (record_step's `costs`).
        self._roofline_static: Optional[dict] = None
        self._roofline_acc: dict[str, list] = {}
        self._t0 = clock()

    def now(self) -> float:
        return self.clock()

    # -- generic metric helpers (allocator / drafter publishing) ------------
    def count(self, name: str, n: int = 1) -> None:
        if not self.enabled:
            return
        self.registry.counter(name).inc(n)

    def gauge(self, name: str, v: float) -> None:
        if not self.enabled:
            return
        self.registry.gauge(name).set(v)

    def observe(self, name: str, v: float, n: int = 1) -> None:
        if not self.enabled:
            return
        self.registry.histogram(name).observe(v, n)

    # -- request lifecycle --------------------------------------------------
    def request_submitted(self, uid: int, prompt_tokens: int,
                          max_new_tokens: int, priority: int = 0) -> None:
        if not self.enabled:
            return
        self.requests[uid] = RequestTrace(uid, prompt_tokens,
                                          max_new_tokens, self.now(),
                                          priority=priority)
        self.registry.counter("requests.submitted").inc()

    def request_admitted(self, uid: int, slot: int,
                         shared_tokens: int = 0) -> None:
        if not self.enabled:
            return
        tr = self.requests.get(uid)
        if tr is None:        # submitted before telemetry was attached
            return
        tr.admit_t = self.now()
        tr.slot = slot
        tr.shared_tokens = shared_tokens
        self.registry.counter("requests.admitted").inc()
        self.registry.histogram("latency.queued_sec").observe(
            tr.admit_t - tr.submit_t)

    def chunk(self, uid: int, t0: float, t1: float, n_tokens: int) -> None:
        if not self.enabled:
            return
        tr = self.requests.get(uid)
        if tr is not None:
            tr.chunks.append((t0, t1, n_tokens))
        self.registry.counter("prefill.chunks").inc()
        self.registry.counter("prefill.tokens").inc(n_tokens)

    def tokens(self, uid: int, t: float, n: int = 1) -> None:
        """n tokens emitted for `uid` at engine time t (a speculative
        round's accepted burst arrives together — n > 1, zero deltas).

        Latency observations land twice: in the aggregate histogram and
        in a per-scheduling-class one (`...class{p}`), so SLO runs can
        read p50/p99 per priority class straight off the snapshot."""
        if not self.enabled or n < 1:
            return
        tr = self.requests.get(uid)
        reg = self.registry
        reg.counter("tokens.generated").inc(n)
        if tr is None:
            return
        cls = f".class{tr.priority}"
        if tr.token_times:
            gap = t - tr.token_times[-1]
            reg.histogram("latency.inter_token_sec").observe(gap)
            reg.histogram("latency.inter_token_sec" + cls).observe(gap)
            if n > 1:
                reg.histogram("latency.inter_token_sec").observe(0.0, n - 1)
                reg.histogram("latency.inter_token_sec" + cls).observe(
                    0.0, n - 1)
        else:
            ttft = t - tr.submit_t
            reg.histogram("latency.ttft_sec").observe(ttft)
            reg.histogram("latency.ttft_sec" + cls).observe(ttft)
            if n > 1:
                reg.histogram("latency.inter_token_sec").observe(0.0, n - 1)
                reg.histogram("latency.inter_token_sec" + cls).observe(
                    0.0, n - 1)
        tr.token_times.extend([t] * n)

    def spec_round(self, uid: int, t0: float, t1: float, proposed: int,
                   accepted: int) -> None:
        if not self.enabled:
            return
        tr = self.requests.get(uid)
        if tr is not None:
            tr.spec_rounds.append((t0, t1, proposed, accepted))
        self.registry.counter("spec.rounds").inc()
        self.registry.counter("spec.proposed").inc(proposed)
        self.registry.counter("spec.accepted").inc(accepted)

    def request_finished(self, uid: int) -> None:
        if not self.enabled:
            return
        tr = self.requests.get(uid)
        if tr is not None:
            tr.finish_t = self.now()
        self.registry.counter("requests.finished").inc()

    # -- roofline (serving/costmodel.py feeds this) ---------------------------
    def attach_roofline(self, static: dict) -> None:
        """Attach the cost model's static description (hardware spec,
        bytes/vector table, weight stream, mesh division) — the engine
        calls this once at construction so `snapshot()["roofline"]` can
        report the model alongside the measured rates."""
        if not self.enabled:
            return
        self._roofline_static = static

    # -- step records --------------------------------------------------------
    def record_step(self, t_start: float, dur: float, admit: float,
                    chunk: float, draft: float, verify: float,
                    decode: float, pages_used: int, pages_free: int,
                    headroom: int, queue_depth: int, prefilling: int,
                    costs: Optional[dict] = None) -> None:
        """One engine step's boundary record. `costs` (optional) is the
        cost model's {phase: (modeled_bytes, modeled_flops)} for the
        phases that ran this step; combined with the measured phase
        wall-times it becomes the achieved-GB/s gauges and the windowed
        roofline aggregates snapshot() reports."""
        if not self.enabled:
            return
        self.steps.append((t_start, dur, admit, chunk, draft, verify,
                           decode, pages_used, pages_free, headroom,
                           queue_depth, prefilling, costs))
        reg = self.registry
        reg.counter("engine.steps").inc()
        reg.gauge("pool.pages_used").set(pages_used)
        reg.gauge("pool.pages_free").set(pages_free)
        reg.gauge("pool.watermark_headroom").set(headroom)
        reg.gauge("queue.depth").set(queue_depth)
        reg.gauge("slots.prefilling").set(prefilling)
        reg.histogram("latency.step_sec").observe(dur)
        if costs:
            phase_sec = {"admit": admit, "chunk_prefill": chunk,
                         "draft": draft, "verify": verify,
                         "decode": decode}
            for phase, (nbytes, nflops) in costs.items():
                sec = phase_sec.get(phase, 0.0)
                acc = self._roofline_acc.get(phase)
                if acc is None:
                    acc = self._roofline_acc[phase] = [0.0, 0.0, 0.0]
                acc[0] += nbytes
                acc[1] += nflops
                acc[2] += sec
                if sec > 0.0:
                    reg.gauge(f"roofline.{phase}.achieved_gbps").set(
                        nbytes / sec / 1e9)

    # -- torch.profiler integration -------------------------------------------
    def annotation(self, name: str):
        """Profiler scope for one model call (no-op unless annotate=True):
        the kernels it launches land under `name` in a torch.profiler
        trace."""
        if not self.annotate:
            return _NULL_CTX
        import torch.profiler
        return torch.profiler.record_function(name)

    def step_annotation(self, step_num: int):
        """Profiler scope for a whole engine step, named `serve_step` and
        carrying the step number, so device traces group kernels under the
        same step numbers as `self.steps`."""
        if not self.annotate:
            return _NULL_CTX
        import torch.profiler
        return torch.profiler.record_function("serve_step", str(step_num))

    # -- windowed views -------------------------------------------------------
    def snapshot(self) -> dict:
        """Everything observed since the last reset(), JSON-ready."""
        live = [tr for tr in self.requests.values() if tr.finish_t is None]
        done = [tr for tr in self.requests.values()
                if tr.finish_t is not None]
        per_request = [tr.summary() for tr in done + live]
        snap = {
            "schema_version": SCHEMA_VERSION,
            **self.registry.snapshot(),
            "steps": {
                "count": len(self.steps),
                "phase_sec": {
                    p: sum(s[2 + i] for s in self.steps)
                    for i, p in enumerate(_PHASES)
                },
                "total_sec": sum(s[1] for s in self.steps),
            },
            "pool": {
                # [t_rel, used, free, headroom] per step — the occupancy
                # timeline the SLO scheduler work regresses against.
                "occupancy_timeline": [
                    [round(s[0] - self._t0, 6), s[7], s[8], s[9]]
                    for s in self.steps
                ],
            },
            "requests": {
                "finished": len(done),
                "live": len(live),
                "per_request": per_request,
            },
        }
        counters = snap["counters"]
        hits = counters.get("prefix_cache.page_hits", 0)
        misses = counters.get("prefix_cache.page_misses", 0)
        snap["prefix_cache"] = {
            "page_hits": hits,
            "page_misses": misses,
            "hit_rate": hits / max(hits + misses, 1),
        }
        snap["admission"] = {
            "rejected": {k.split("admission.rejected.", 1)[1]: v
                         for k, v in counters.items()
                         if k.startswith("admission.rejected.")},
            "blocked_steps": counters.get("admission.blocked_steps", 0),
        }
        # Scheduler decisions (serving/scheduler.py publishes sched.*):
        # preempt / swap_out / swap_in / readmit / pin / pin_evict /
        # pin_hits plus their page counts — the counters the part-7
        # oversubscription bench uploads as a CI artifact.
        snap["scheduler"] = {k.split("sched.", 1)[1]: v
                             for k, v in counters.items()
                             if k.startswith("sched.")}
        snap["roofline"] = self._roofline_snapshot()
        return snap

    def _roofline_snapshot(self) -> dict:
        """The roofline section: the cost model's static facts plus
        windowed per-phase aggregates — modeled bytes/FLOPs against
        measured phase seconds gives achieved GB/s, achieved GFLOP/s,
        arithmetic intensity, bandwidth utilization against the
        hardware roof, and the memory/compute-bound classification
        (intensity vs the ridge point)."""
        static = self._roofline_static or {}
        hw = static.get("hardware") or {}
        ridge = hw.get("ridge_flops_per_byte")
        peak_bw = hw.get("peak_bytes_per_sec")
        phases = {}
        for phase in _PHASES:
            acc = self._roofline_acc.get(phase)
            if acc is None:
                continue
            nbytes, nflops, sec = acc
            intensity = nflops / nbytes if nbytes else 0.0
            phases[phase] = {
                "bytes": nbytes,
                "flops": nflops,
                "sec": sec,
                "achieved_gbps": nbytes / sec / 1e9 if sec else 0.0,
                "achieved_gflops": nflops / sec / 1e9 if sec else 0.0,
                "arithmetic_intensity": intensity,
                "bw_utilization": (nbytes / sec / peak_bw
                                   if sec and peak_bw else 0.0),
                "bound": (None if ridge is None
                          else "memory" if intensity < ridge
                          else "compute"),
            }
        return {
            "hardware": hw,
            "model": {k: v for k, v in static.items() if k != "hardware"},
            "phases": phases,
        }

    def reset(self) -> None:
        """Start a new window: zero the registry, drop step records and
        finished-request traces. Live requests keep their traces so
        spans that straddle the boundary stay well-formed."""
        self.registry.reset()
        self.steps.clear()
        self._roofline_acc.clear()   # static description survives resets
        self.requests = {uid: tr for uid, tr in self.requests.items()
                         if tr.finish_t is None}

    # -- exports ---------------------------------------------------------------
    def export_json(self, path: str) -> dict:
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
            f.write("\n")
        return snap

    def chrome_trace_events(self) -> list[dict]:
        """Chrome `trace_event` list: engine phases on tid 0 (B/E pairs
        laid out back-to-back from each step's start — step-boundary
        attribution, the resolution we measure at), one tid per request
        with well-nested lifecycle spans, and `ph:"C"` counter tracks.
        Event order in the list is nesting order; every B has a
        matching E on its tid."""
        us = 1e6
        t0 = self._t0

        def ts(t):
            return (t - t0) * us

        ev: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "args": {"name": "serving-engine"}},
            {"ph": "M", "name": "thread_name", "pid": 0, "tid": 0,
             "args": {"name": "engine steps"}},
        ]
        for s in self.steps:
            cursor = s[0]
            for i, phase in enumerate(_PHASES):
                dur = s[2 + i]
                if dur <= 0.0:
                    continue
                ev.append({"ph": "B", "name": phase, "pid": 0, "tid": 0,
                           "ts": ts(cursor)})
                ev.append({"ph": "E", "name": phase, "pid": 0, "tid": 0,
                           "ts": ts(cursor + dur)})
                cursor += dur
            ev.append({"ph": "C", "name": "pool", "pid": 0, "tid": 0,
                       "ts": ts(s[0]),
                       "args": {"pages_used": s[7], "pages_free": s[8],
                                "watermark_headroom": s[9]}})
            ev.append({"ph": "C", "name": "queue", "pid": 0, "tid": 0,
                       "ts": ts(s[0]),
                       "args": {"depth": s[10], "prefilling": s[11]}})
            costs = s[12] if len(s) > 12 else None
            if costs:
                # Achieved-bandwidth counter track: one series per phase
                # that ran this step (modeled bytes over measured phase
                # seconds), rendered as stacked counters in Perfetto.
                phase_sec = dict(zip(_PHASES, s[2:7]))
                args = {
                    f"{phase}_gbps": round(nbytes / sec / 1e9, 3)
                    for phase, (nbytes, _f) in sorted(costs.items())
                    if (sec := phase_sec.get(phase, 0.0)) > 0.0}
                if args:
                    ev.append({"ph": "C", "name": "roofline_gbps",
                               "pid": 0, "tid": 0, "ts": ts(s[0]),
                               "args": args})
        for uid, tr in sorted(self.requests.items()):
            tid = uid  # uids start at 1; tid 0 is the engine timeline
            ev.append({"ph": "M", "name": "thread_name", "pid": 0,
                       "tid": tid, "args": {"name": f"request {uid}"}})
            end_t = tr.finish_t
            if end_t is None:
                end_t = max([tr.submit_t, tr.admit_t or tr.submit_t]
                            + [c[1] for c in tr.chunks]
                            + [r[1] for r in tr.spec_rounds]
                            + tr.token_times[-1:])
            ev.append({"ph": "B", "name": "request", "pid": 0, "tid": tid,
                       "ts": ts(tr.submit_t),
                       "args": {"prompt_tokens": tr.prompt_tokens,
                                "max_new_tokens": tr.max_new_tokens,
                                "shared_tokens": tr.shared_tokens,
                                "slot": tr.slot}})
            if tr.admit_t is not None:
                ev.append({"ph": "B", "name": "queued", "pid": 0,
                           "tid": tid, "ts": ts(tr.submit_t)})
                ev.append({"ph": "E", "name": "queued", "pid": 0,
                           "tid": tid, "ts": ts(tr.admit_t)})
            for c0, c1, n in tr.chunks:
                ev.append({"ph": "B", "name": "prefill_chunk", "pid": 0,
                           "tid": tid, "ts": ts(c0),
                           "args": {"tokens": n}})
                ev.append({"ph": "E", "name": "prefill_chunk", "pid": 0,
                           "tid": tid, "ts": ts(c1)})
            for r0, r1, proposed, accepted in tr.spec_rounds:
                ev.append({"ph": "B", "name": "spec_round", "pid": 0,
                           "tid": tid, "ts": ts(r0),
                           "args": {"proposed": proposed,
                                    "accepted": accepted}})
                ev.append({"ph": "E", "name": "spec_round", "pid": 0,
                           "tid": tid, "ts": ts(r1)})
            if tr.token_times:
                ev.append({"ph": "i", "name": "first_token", "pid": 0,
                           "tid": tid, "ts": ts(tr.token_times[0]),
                           "s": "t"})
            ev.append({"ph": "E", "name": "request", "pid": 0, "tid": tid,
                       "ts": ts(end_t)})
        return ev

    def export_chrome_trace(self, path: str) -> int:
        """Write the Perfetto/chrome://tracing file; returns event count."""
        events = self.chrome_trace_events()
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"schema_version": SCHEMA_VERSION},
        }
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        return len(events)


# A shared always-off instance for components (BlockAllocator, drafters)
# whose owner did not attach telemetry.
NULL_TELEMETRY = Telemetry(enabled=False)


# ---------------------------------------------------------------------------
# Benchmark export stamping
# ---------------------------------------------------------------------------

def bench_metadata() -> dict:
    """Provenance stamp for benchmark JSON exports: schema version, git
    SHA, torch version, and device kind (the CUDA device's name), so
    `BENCH_*.json` files from different PRs/machines are
    machine-comparable."""
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        sha = "unknown"
    import torch
    if torch.cuda.is_available():
        device_kind = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:
        device_kind = platform = "cpu"
    return {
        "schema_version": SCHEMA_VERSION,
        "git_sha": sha,
        "torch_version": torch.__version__,
        "device_kind": device_kind,
        "platform": platform,
        "generated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
