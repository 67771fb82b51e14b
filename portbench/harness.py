"""One run of one cell: build the served model from the seed, warm up,
drive the window through `ServingEngine.submit` / `step`, judge the
tokens it served, and read the metrics.

A cell (`cells/<cell>.json`) names its configuration (`configs/<config>
.json`), its traffic mix (`traffic/<mix>.json`) and its engine settings.
Every metric is read by `metrics/<metric>.py`'s `read(run)` from the
`Run` below; `BENCHMARK.json` says which metrics a cell reports. The
program is imported inside `run_cell`, never at import.

The loop is the harness's own, one process and one thread:
  closed  a client sends its next request when its last one finishes
          (no think time); the first cohort opens the run;
  open    requests are submitted when due on the mix's Poisson schedule;
          between steps with nothing to do the loop sleeps until the next.
A request's times are the host clock's: due, submitted, admitted (the
step that placed it in a slot), first and last token (the end of the
step that emitted it, when `step()` hands the token back).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import pathlib
import sys
import time
from typing import Optional

from portbench import check, trace, weights, work
from portbench.traffic import Traffic, max_tokens

BENCH = pathlib.Path(__file__).resolve().parent
BENCHMARK = BENCH.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SLICES = 3


@dataclasses.dataclass
class Req:
    uid: int
    prompt_len: int
    budget: int
    due: float
    submit: float
    admit: Optional[float] = None
    first: Optional[float] = None
    last: Optional[float] = None
    done_at: Optional[float] = None
    n: int = 0
    cursor: int = 0                # prompt tokens in the cache, as last seen
    failed: bool = False


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    rows: int                      # live decode rows of the forward
    keys: int                      # their valid keys, summed
    chunk: Optional[tuple]         # (start, tokens) of the step's prompt chunk
    tokens: int                    # tokens emitted
    book_s: float = 0.0            # the loop's own bookkeeping after the step


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: dict
    mix: dict
    config: dict
    dims: work.Dims
    slots: int
    setup_s: float
    t_start: float
    t_stop: float
    steps: list                    # the window's steps
    reqs: list
    stats0: dict                   # engine.stats() as the window opened
    stats1: dict                   # ... and as it closed
    trace: Optional[trace.Summary] = None
    traced: Optional[list] = None  # the steps inside the traced slice

    @property
    def window_s(self) -> float:
        return self.t_stop - self.t_start

    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.t_start <= t <= self.t_stop

    def step_work(self, s: Step) -> dict:
        return work.step(self.dims, s.rows, s.keys, s.chunk)


def load(kind: str, name: str, bench_dir: pathlib.Path = BENCH) -> dict:
    path = bench_dir / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    return json.loads(path.read_text())


def metric_reader(name: str, bench_dir: pathlib.Path = BENCH):
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """The metrics `BENCHMARK.json` has a cell report: its end-to-end
    metrics untraced, its per-layer metrics traced. A metric without a
    `workloads` list is every cell's (a per-layer one: every cell that
    reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in names]


def model_config(config: dict):
    """The program's ModelConfig for a configuration file: the registry's
    model with the file's overrides, checked against the file's widths."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(config["registry"], smoke=config.get("smoke", False)),
                              **config.get("overrides", {}),
                              param_dtype=config["dtype"], compute_dtype=config["dtype"])
    wrong = {k: (getattr(cfg, k), v) for k, v in config["model"].items()
             if getattr(cfg, k) != v}
    if wrong:
        raise ValueError(f"the program's {config['registry']} differs from "
                         f"{config['name']}: {wrong} (program, file)")
    return cfg


class Loop:
    """Drives the engine and keeps the requests' and steps' records.

    The records follow the engine's events, not its slots: after a step
    the loop looks only at the requests that were queued or mid-prefill
    and at those the step finished, so its cost does not grow with the
    slots. Each decoding request, and each whose prompt the step
    completed, emits one token a step (FIFO, no speculation);
    `generated()` counts the tokens again from the requests themselves,
    and the run checks the two counts agree over the window."""

    def __init__(self, eng, traffic: Traffic, mix: dict, clock=time.perf_counter):
        self.eng, self.traffic, self.mix, self.clock = eng, traffic, mix, clock
        self.reqs: dict = {}            # uid -> Req
        self.objs: dict = {}            # uid -> the engine's Request
        self.failed: list = []
        self.steps: list = []
        self.finished_seen = 0
        self.queued: list = []          # uids not yet admitted, in order
        self.prefilling: list = []      # uids admitted, prompt not yet cached
        self.live: set = set()          # uids decoding
        self.keys = 0                   # the live rows' cache lengths, summed
        self.t0 = None                  # the open loop's schedule origin
        self.next_open = None

    def submit(self, spec, due: float) -> None:
        t = self.clock()
        try:
            uid = self.eng.submit(spec.prompt, spec.max_new)
        except ValueError:
            self.failed.append(Req(-1, len(spec.prompt), spec.max_new, due, t, failed=True))
            return
        self.reqs[uid] = Req(uid, len(spec.prompt), spec.max_new, due, t)
        self.objs[uid] = next(r for r in reversed(self.eng.queue) if r.uid == uid)
        self.queued.append(uid)

    def generated(self) -> int:
        """Tokens generated so far, over every request submitted."""
        return sum(len(r.generated) for r in self.objs.values())

    def step(self) -> Step:
        """One engine step, and what it did as the host sees it after:
        the tokens emitted, the live decode rows and their keys, the prompt
        chunk (FIFO runs at most one a step; a prefix-cache hit would move
        a cursor without one, so the chunk is the move of the tokens the
        engine counted)."""
        eng, reqs = self.eng, self.reqs
        ptoks0 = eng.prefill_tokens
        t0 = self.clock()
        eng.step()
        t1 = self.clock()
        if len(eng.queue) < len(self.queued):
            inq = {r.uid for r in eng.queue}
            for u in self.queued:
                if u not in inq:
                    reqs[u].admit = t0
                    self.prefilling.append(u)
            self.queued = [u for u in self.queued if u in inq]
        s = eng.prefill_tokens - ptoks0
        chunk, ready, still = None, [], []
        for u in self.prefilling:
            rec, cur = reqs[u], self.objs[u].prefill_cursor
            if cur != rec.cursor:
                if cur - rec.cursor == s:
                    chunk = (rec.cursor, s)
                rec.cursor = cur
            (ready if cur >= rec.prompt_len else still).append(u)
        self.prefilling = still
        tokens = len(self.live) + len(ready)
        self.keys += len(self.live)
        for u in ready:
            rec = reqs[u]
            rec.first, rec.n = t1, 1
            self.live.add(u)
            self.keys += rec.prompt_len + 1
        for r in eng.finished[self.finished_seen:]:
            rec = reqs[r.uid]
            self.live.discard(r.uid)
            self.keys -= rec.prompt_len + len(r.generated)
            rec.n, rec.last, rec.done_at = len(r.generated), t1, t1
        self.finished_seen = len(eng.finished)
        st = Step(t0, t1, len(self.live), self.keys, chunk, tokens)
        self.steps.append(st)
        st.book_s = self.clock() - t1
        return st

    def busy(self) -> bool:
        return bool(self.queued or self.prefilling or self.live)

    def pending(self) -> set:
        """Requests not yet decoding: queued or mid-prefill."""
        return set(self.queued) | set(self.prefilling)

    def turn(self) -> None:
        """One pass of the loop: the open loop's due submissions, a step
        (or, idle, a sleep until the next arrival), the closed loop's
        resubmissions."""
        if self.mix["loop"] == "open":
            now = self.clock()
            while self.t0 + self.next_open.due <= now:
                self.submit(self.next_open, self.t0 + self.next_open.due)
                self.next_open = self.traffic.next_open()
            if not self.busy():
                wait = self.t0 + self.next_open.due - self.clock()
                if wait > 0:
                    time.sleep(min(wait, 0.005))
                return
            self.step()
            return
        before = self.finished_seen
        st = self.step()
        for _ in range(self.finished_seen - before):
            self.submit(self.traffic.next_closed(), st.t1)

    def start(self) -> None:
        """Open the loop: the closed loop's first cohort, or the open
        loop's schedule from now."""
        if self.mix["loop"] == "closed":
            t = self.clock()
            for spec in self.traffic.first_cohort():
                self.submit(spec, t)
        else:
            self.t0 = self.clock()
            self.next_open = self.traffic.next_open()


def _profiler_warmup(torch_mod, device) -> None:
    """Start and stop the profiler once in set-up: its first start loads
    CUPTI, which must not land in the window."""
    acts = [torch_mod.profiler.ProfilerActivity.CPU, torch_mod.profiler.ProfilerActivity.CUDA]
    with torch_mod.profiler.profile(activities=acts):
        torch_mod.ones(8, device=device).sum().item()


def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             data_dir: pathlib.Path = BENCH, benchmark: pathlib.Path = BENCHMARK,
             device: str = "cuda",
             t_proc: Optional[float] = None, quant: str = "none",
             rate: Optional[float] = None) -> tuple[dict, list, list]:
    """One run; returns (the result line's object, the compared numbers as
    lines for standard error, the forbidden modules loaded). `quant`
    switches the program's own int8 datapath on (the control); `rate`
    replaces an open mix's arrival rate (the knee sweep). Cells,
    configurations and mixes are read from `data_dir`, the metrics a cell
    reports from `benchmark`."""
    t_proc = time.perf_counter() if t_proc is None else t_proc
    import torch

    from repro_torch.core.salpim import SalPimConfig, SalPimEngine
    from repro_torch.models import api as model_api
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.config import EngineConfig, GenConfig
    from repro_torch.serving.telemetry import Telemetry

    bench = json.loads(benchmark.read_text())
    cell = load("cells", name, data_dir)
    config = load("configs", cell["config"], data_dir)
    mix = load("traffic", cell["traffic"], data_dir)
    if rate is not None:
        mix["arrivals"] = dict(mix["arrivals"], rate_per_s=rate)
    es = cell["engine"]
    if max_tokens(mix) > es["max_len"]:
        raise ValueError(f"{name}: the mix reaches {max_tokens(mix)} positions, "
                         f"max_len is {es['max_len']}")
    dev = torch.device(device)
    cfg = model_config(config)
    params = weights.draw(model_api.init_params(cfg, device="meta"), seed, dev)
    engine = SalPimEngine.create(SalPimConfig(nonlinear_mode=config["nonlinear_mode"],
                                              lut_sections=config["lut_sections"],
                                              quant=quant))
    tel = Telemetry(enabled=True, annotate=True) if traced else None
    eng = ServingEngine(params, cfg, engine, EngineConfig(
        slots=es["slots"], max_len=es["max_len"], paged=True, page_size=es["page_size"],
        prefill_chunk_tokens=es.get("prefill_chunk_tokens"), telemetry=tel,
        seed=int(seed) % (1 << 63),
        gen=GenConfig(temperature=0.0, stop_on_eos=False)), device=dev)
    warm = cell["warmup"]
    loop = Loop(eng, Traffic(mix, cfg.vocab, seed, seconds=warm["seconds"] + seconds), mix)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        # A checkout's first run builds the kernels here, before any clock
        # of the loop starts (an open loop's schedule would run on meanwhile).
        from repro_torch.kernels import _build
        _build.build_all()
        if traced:
            _profiler_warmup(torch, dev)

    # Set-up: the cell's own traffic. A closed loop runs until its first
    # cohort is prefilled and the prompts queued behind it have drained
    # (one chunk a step fills the slots one by one, and clients whose first
    # requests finish meanwhile queue again): nothing queued, at most one
    # slot mid-prefill. An open loop runs for the cell's warm-up seconds.
    # Then the cell's warm-up steps.
    loop.start()
    if mix["loop"] == "closed":
        cohort = set(loop.reqs)
        while cohort & loop.pending():
            loop.turn()
        for _ in range(warm["max_drain_steps"]):
            if not loop.queued and len(loop.prefilling) <= 1:
                break
            loop.turn()
    else:
        t_w = loop.clock() + warm["seconds"]
        while loop.clock() < t_w:
            loop.turn()
    for _ in range(warm["steps"]):
        loop.turn()
    sync()
    t_start = time.perf_counter()
    setup_s = t_start - t_proc
    stats0 = eng.stats()
    first_step = len(loop.steps)
    generated0 = loop.generated()

    # The traced run profiles up to SLICES slices of the window, one after
    # another from skip_s, each `seconds` long and a second apart; after the
    # window the first whole one is read (CUPTI can drop a slice's device
    # records, which leaves launches without their kernels).
    tr = cell["trace"]
    t_end = t_start + seconds
    starts = ([t_start + tr["skip_s"] + i * (tr["seconds"] + 1.0) for i in range(SLICES)]
              if traced else [])
    slices, open_slice = [], None

    def close(sl):
        sync()
        sl["scope"].__exit__(None, None, None)
        sl["prof"].stop()
        sl["steps"] = loop.steps[sl["k0"]:]

    while True:
        now = loop.clock()
        if now >= t_end:
            break
        if open_slice is None and starts and now >= starts[0]:
            starts.pop(0)
            sync()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            scope = torch.profiler.record_function(trace.SLICE)
            scope.__enter__()
            open_slice = {"prof": prof, "scope": scope, "k0": len(loop.steps),
                          "until": loop.clock() + tr["seconds"]}
        loop.turn()
        if open_slice is not None and loop.clock() >= open_slice["until"]:
            close(open_slice)
            slices.append(open_slice)
            open_slice = None
    if open_slice is not None:
        close(open_slice)
        slices.append(open_slice)
    sync()
    # The closed loop's window ends with its last step; the open loop's
    # when the loop stops offering load.
    t_stop = (loop.steps[-1].t1 if mix["loop"] == "closed" and len(loop.steps) > first_step
              else loop.clock())
    stats1 = eng.stats()
    generated1 = loop.generated()
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))

    run = Run(cell=cell, mix=mix, config=config, dims=work.Dims.of(config["model"]),
              slots=es["slots"], setup_s=setup_s, t_start=t_start, t_stop=t_stop,
              steps=loop.steps[first_step:], reqs=list(loop.reqs.values()) + loop.failed,
              stats0=stats0, stats1=stats1)
    counted = sum(s.tokens for s in run.steps)
    if counted != generated1 - generated0:
        raise RuntimeError(f"the loop counted {counted} tokens in the window, the "
                           f"requests hold {generated1 - generated0} more than at its start")
    attempted = sum(1 for r in run.reqs if run.in_window(r.submit))
    failed = sum(1 for r in run.reqs if r.failed and run.in_window(r.submit))

    # Correctness, once the program's state is freed.
    finished = [r for r in eng.finished if run.in_window(loop.reqs[r.uid].done_at)]
    load_info = {"window_s": run.window_s, "finished": len(finished),
                 "finished_per_s": len(finished) / run.window_s if run.window_s > 0 else 0.0,
                 "queued_at_end": len(eng.queue),
                 "active_at_end": sum(1 for r in eng.active if r is not None),
                 "prefilling_at_end": sum(1 for r in eng.active
                                          if r is not None and r.prefilling),
                 "steps": len(run.steps),
                 "bookkeeping_share": (sum(s.book_s for s in run.steps) / run.window_s
                                       if run.window_s > 0 else 0.0)}
    picked = [(r.prompt, list(r.generated)) for r in
              check.sample(finished, cell["check"]["sample"], seed)]
    del eng, loop
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reqs_checked = [dataclasses.make_dataclass("R", ["prompt", "generated"])(p, g)
                    for p, g in picked]
    read = check.readings(reqs_checked, params, config["model"], config,
                          es["page_size"], dev)
    correct, shown = check.verdict(read, cell["check"]["limits"])

    classes = trace.load_classes(BENCH / "kernel_classes")
    read_slice, seen = None, []
    for i, sl in enumerate(slices):
        run.trace, run.traced = trace.summarize(sl["prof"], classes), sl["steps"]
        seen.append([run.trace.matched, run.trace.launched])
        if run.trace.whole:
            read_slice = i
            break
    if run.trace is not None:
        if read_slice is None:
            raise RuntimeError(f"no traced slice holds every kernel it launched "
                               f"(matched, launched by slice: {seen})")
        load_info["trace_slices"] = seen
    metrics = {}
    for m in cell_metrics(bench, name, traced):
        v = metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(mem_peak),
    }
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": [[n, s] for n, s in run.trace.by_name()[:10]],
                               "idle_gaps": [[n, s] for n, s in run.trace.gaps[:10]]}
    result["load"] = load_info
    result["checked"] = shown
    lines = [f"{k} {v['value']} limit {v['limit']}" if "limit" in v
             else f"{k} {v['value']} min {v['min']}" for k, v in shown.items()]
    if run.trace is not None:
        # Device seconds of the traced slice by kernel class ("other": no
        # kernel_classes file matched), before the compared numbers.
        lines.insert(0, f"device seconds by class {json.dumps(run.trace.by_class())}; "
                        f"slice {read_slice + 1} of {len(slices)} read, its "
                        f"{run.trace.matched} of {run.trace.launched} launches traced")
    return result, lines, found
