"""prefill_attn_roofline: the prefill_attn class's work at the card's peaks over its
kernels' device time in the traced slice (`readers.roofline`); in percent."""
from portbench import readers


def read(run):
    return readers.roofline(run, "prefill_attn")
