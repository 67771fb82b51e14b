"""chunk_device_ms.open: device time of the kernels launched under the
engine's `prefill_chunk` scopes, per such scope, in the traced slice
(`readers.scope_device_ms`)."""
from portbench import readers


def read(run):
    return readers.scope_device_ms(run, "prefill_chunk")
