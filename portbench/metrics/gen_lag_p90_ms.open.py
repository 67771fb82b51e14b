"""gen_lag_p90_ms.open: how late the load generator submitted, submit -
due, over the requests submitted in the window; the 90th percentile."""
import numpy as np


def read(run):
    vals = [(r.submit - r.due) * 1e3 for r in run.reqs if run.in_window(r.submit)]
    return float(np.percentile(np.asarray(vals), 90)) if vals else None
