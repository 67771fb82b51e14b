"""decode_attn_roofline: the decode_attn class's work at the card's peaks over its
kernels' device time in the traced slice (`readers.roofline`); in percent."""
from portbench import readers


def read(run):
    return readers.roofline(run, "decode_attn")
