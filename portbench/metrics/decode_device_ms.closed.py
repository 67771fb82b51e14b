"""decode_device_ms.closed: device time of the kernels launched under the
engine's `decode_step` scopes, per such scope, in the traced slice
(`readers.scope_device_ms`)."""
from portbench import readers


def read(run):
    return readers.scope_device_ms(run, "decode_step")
