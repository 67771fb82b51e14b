"""occupancy_pct.closed: the slots that emitted a token per decode step,
as a share of the slots, over the window's steps that decoded."""


def read(run):
    dec = [s for s in run.steps if s.tokens]
    if not dec:
        return None
    return 100.0 * sum(s.tokens for s in dec) / (len(dec) * run.slots)
