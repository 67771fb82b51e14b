"""tok_s: every token the window's steps emitted, over the window's
seconds (host clock, from the window's first step to the end of its
last)."""


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    return sum(s.tokens for s in run.steps) / run.window_s
