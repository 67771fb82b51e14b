"""Formulas that several per-layer metrics share. Each metric keeps its
own file under `metrics/`, which calls one of these with its class or
scope, so a fix lands in one place."""
from __future__ import annotations

from portbench.trace import SLICE


def roofline(run, cls: str):
    """The least time the traced slice's `cls` work could take at the
    card's peaks (`work.py`: the larger of FLOPs at 989 TFLOP/s and bytes
    at 3.35 TB/s, a step at a time), over the device time of the kernels
    `kernel_classes/` puts in class `cls`; in percent. Nothing when the
    slice ran no such kernel."""
    if run.trace is None:
        return None
    t = run.trace.class_seconds(cls)
    if t <= 0:
        return None
    least = sum(run.step_work(s)[cls].least_s for s in run.traced)
    return 100.0 * least / t if least > 0 else None


def scope_device_ms(run, scope: str):
    """Device time of the kernels launched under the engine's `scope`
    scopes, per such scope that opened in the traced slice; in ms."""
    if run.trace is None:
        return None
    lo, hi = run.trace.scopes.get(SLICE, [(0, 0)])[0]
    n = sum(1 for s, _ in run.trace.scopes.get(scope, []) if lo <= s <= hi)
    t = run.trace.scope_seconds(scope)
    return t * 1e3 / n if n and t > 0 else None


def idle_pct(run):
    """The share of the traced slice in which no kernel or copy ran on
    the device; in percent."""
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
