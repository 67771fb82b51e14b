"""Reading a `torch.profiler` trace of a slice of the window: device
kernels by operation class, the engine's scopes, busy and idle time.

The port launches its CUDA kernels through ctypes, so torch.profiler ties
them to no PyTorch operation: a kernel is matched to its launch call by
CUPTI correlation id, and the launch to the engine scope around it
(`serve_step`, `prefill_chunk`, `decode_step`, which the engine's
telemetry opens with `annotate=True`) by time. The slice itself is the
harness's own scope `portbench_slice`, which ends after a synchronize, so
every kernel launched in it has ended inside it.

A kernel's class comes from `kernel_classes/<class>-<impl>.json`: the
first file, in name order, one of whose regular expressions matches the
kernel's name. A kernel that none matches is "other".
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import pathlib
import re

SLICE = "portbench_slice"
SCOPES = ("serve_step", "prefill_chunk", "decode_step")


@dataclasses.dataclass
class Kernel:
    name: str
    start: int          # ns, the profiler's clock
    end: int
    cls: str
    scope: str = ""     # innermost engine scope around its launch


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: list
    scopes: dict        # name -> [(start, end)]
    gaps: list          # [(host label, seconds)]
    launched: int = 0   # kernel launches the slice's host made
    matched: int = 0    # ... whose kernel the trace holds

    @property
    def whole(self) -> bool:
        """The trace holds the kernels of the slice's launches (98% of
        them: a launch call that starts no kernel, such as a host
        function's, has no device record)."""
        return self.matched >= 0.98 * self.launched

    def class_seconds(self, cls: str) -> float:
        return sum(k.end - k.start for k in self.kernels if k.cls == cls) / 1e9

    def scope_seconds(self, scope: str) -> float:
        return sum(k.end - k.start for k in self.kernels if k.scope == scope) / 1e9

    def by_name(self) -> list:
        tot = collections.Counter()
        for k in self.kernels:
            tot[short_name(k.name)] += (k.end - k.start) / 1e9
        return tot.most_common()

    def by_class(self) -> dict:
        tot = collections.Counter()
        for k in self.kernels:
            tot[k.cls] += (k.end - k.start) / 1e9
        return dict(tot)


def load_classes(directory: pathlib.Path) -> list:
    """[(class, compiled pattern)] from every kernel_classes file, in name
    order of the files."""
    out = []
    for f in sorted(directory.glob("*.json")):
        spec = json.loads(f.read_text())
        for pat in spec["patterns"]:
            out.append((spec["class"], re.compile(pat)))
    return out


def classify(name: str, classes: list) -> str:
    for cls, pat in classes:
        if pat.search(name):
            return cls
    return "other"


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments or
    parameters: `void walk::(anonymous namespace)::decode_walk_kernel<...>(...)`
    -> `walk::decode_walk_kernel`."""
    n = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth, out = 0, []
    for ch in n:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or n[:120]


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, classes: list, n_gaps: int = 10) -> Summary:
    """The traced slice's device time by kernel, class and engine scope,
    its busy time (kernels and copies, overlaps counted once) and its
    idle gaps, each labelled by the host's innermost engine scope and
    innermost operation at the gap's middle."""
    from torch.autograd import DeviceType
    dev, launches, cpu = [], [], []
    scopes = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        name, t0 = e.name(), e.start_ns()
        t1 = t0 + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if name in SCOPES or name == SLICE or name.startswith("ProfilerStep#") \
                    or e.is_user_annotation():
                continue
            dev.append((name, t0, t1, e.correlation_id()))
        elif name in SCOPES or name == SLICE:
            scopes[name].append((t0, t1))
        elif "aunch" in name:     # cudaLaunchKernel(ExC), cuLaunchKernel(Ex)
            launches.append((t0, e.correlation_id()))
        else:
            cpu.append((t0, t1, name))
    if not scopes.get(SLICE):
        raise RuntimeError(f"the trace holds no {SLICE} scope")
    lo, hi = scopes[SLICE][0]
    launch_at = {c: t for t, c in launches}
    in_slice = {c for t, c in launches if lo <= t <= hi}
    scope_list = sorted((s, e, n) for n in ("prefill_chunk", "decode_step")
                        for s, e in scopes.get(n, []))
    starts = [s for s, _, _ in scope_list]
    kernels = []
    for name, t0, t1, corr in dev:
        if t1 <= lo or t0 >= hi:
            continue
        k = Kernel(name, max(t0, lo), min(t1, hi), classify(name, classes))
        t = launch_at.get(corr)
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and scope_list[i][1] >= t:
                k.scope = scope_list[i][2]
        kernels.append(k)
    busy = _union((k.start, k.end) for k in kernels)
    busy_ns = sum(e - s for s, e in busy)
    gaps, prev = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    cpu.sort()
    label = _Labeller(scopes, cpu)
    labelled = collections.Counter()
    for g0, g1 in gaps:
        labelled[label((g0 + g1) // 2)] += (g1 - g0) / 1e9
    have = {corr for _, _, _, corr in dev}
    return Summary(window_s=(hi - lo) / 1e9, busy_s=busy_ns / 1e9, kernels=kernels,
                   scopes=dict(scopes), gaps=labelled.most_common(n_gaps),
                   launched=len(in_slice), matched=len(in_slice & have))


class _Labeller:
    """What the host was doing at a time: the innermost engine scope
    ("harness" outside any) and the innermost traced host operation."""

    def __init__(self, scopes: dict, cpu: list):
        self.scopes = {n: sorted(scopes.get(n, [])) for n in SCOPES}
        self.starts = {n: [s for s, _ in v] for n, v in self.scopes.items()}
        self.cpu = cpu
        self.cpu_starts = [s for s, _, _ in cpu]

    def _inside(self, name: str, t: int) -> bool:
        i = bisect.bisect_right(self.starts[name], t) - 1
        return i >= 0 and self.scopes[name][i][1] >= t

    def __call__(self, t: int) -> str:
        scope = "harness"
        for name in SCOPES:           # outermost first
            if self._inside(name, t):
                scope = name
        i = bisect.bisect_right(self.cpu_starts, t) - 1
        # The innermost operation covering t starts last; look back a little.
        for j in range(i, max(i - 256, -1), -1):
            s, e, name = self.cpu[j]
            if e >= t:
                return f"{scope}:{name}"
        return scope
