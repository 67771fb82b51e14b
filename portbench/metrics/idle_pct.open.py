"""idle_pct.open: the share of the traced slice with no kernel or copy
running on the device (`readers.idle_pct`); in percent."""
from portbench import readers


def read(run):
    return readers.idle_pct(run)
