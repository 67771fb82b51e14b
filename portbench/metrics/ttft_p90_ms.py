"""ttft_p90_ms: from a request's due time to its first token (the end of
the step that emitted it), host clock; the 90th percentile over every
request whose first token lands in the window, a request that failed
counting as never served."""
import math

import numpy as np


def read(run):
    vals = [(r.first - r.due) * 1e3 for r in run.reqs
            if not r.failed and run.in_window(r.first)]
    vals += [math.inf for r in run.reqs if r.failed and run.in_window(r.submit)]
    if not vals:
        return None
    v = float(np.percentile(np.asarray(vals), 90))
    return v if math.isfinite(v) else None
