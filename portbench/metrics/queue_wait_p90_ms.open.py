"""queue_wait_p90_ms.open: from a request's due time to the step that
placed it in a slot (`ServingEngine.active`), over the requests admitted
in the window; the 90th percentile."""
import numpy as np


def read(run):
    vals = [(r.admit - r.due) * 1e3 for r in run.reqs if run.in_window(r.admit)]
    return float(np.percentile(np.asarray(vals), 90)) if vals else None
