"""mfu.closed: the whole step's share of the card's peak in roofline
form: over the traced slice's steps, the sum of each step's least time
(`work.total`: the larger of its FLOPs at 989 TFLOP/s and its bytes at
3.35 TB/s), over the slice's length; in percent."""
from portbench import work


def read(run):
    if run.trace is None or not run.traced:
        return None
    least = sum(work.total(run.step_work(s)).least_s for s in run.traced)
    return 100.0 * least / run.trace.window_s
