"""mfu.open: as mfu.closed over the traced slice's steps that ran a
prompt chunk, over their wall time (from one step's start to the next
step's start); in percent."""
from portbench import work


def read(run):
    if run.trace is None or not run.traced:
        return None
    steps = run.traced
    least = wall = 0.0
    for i, s in enumerate(steps):
        if s.chunk is None or i + 1 >= len(steps):
            continue
        least += work.total(run.step_work(s)).least_s
        wall += steps[i + 1].t0 - s.t0
    return 100.0 * least / wall if wall > 0 else None
