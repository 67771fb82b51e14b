"""decode_host_ms.closed: the engine's own decode phase time (host clock,
`stats()["decode_sec"]`, which ends when the sampled tokens reach the
host) per decode step over the window."""


def read(run):
    n = run.stats1["decode_steps"] - run.stats0["decode_steps"]
    if n <= 0:
        return None
    return (run.stats1["decode_sec"] - run.stats0["decode_sec"]) * 1e3 / n
