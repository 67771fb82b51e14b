"""tpot_p90_ms: (last token - first token) / (tokens - 1) of each request
finished in the window with two tokens or more; the 90th percentile."""
import numpy as np


def read(run):
    vals = [(r.last - r.first) * 1e3 / (r.n - 1) for r in run.reqs
            if not r.failed and run.in_window(r.done_at) and r.n > 1]
    return float(np.percentile(np.asarray(vals), 90)) if vals else None
