"""The device's idle share: 100 x (1 - the union of its kernel and copy
intervals over the traced stretch's wall time), in %."""

SPANS = {}


def read(trace, ctx):
    if not trace.device_ops or trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us)
