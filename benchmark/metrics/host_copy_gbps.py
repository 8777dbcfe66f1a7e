"""The adapter's host copies, in GB/s: the bytes the program counted
(``host_copy_bytes``) inside its ``rcw.gym.to_host`` spans, per step of the
host stretch, over the device time, per profiled step, of the
device-to-host copies launched inside those spans.  Silent where the
program has no tracer or no such copy ran."""

from benchmark import program_spans

SPANS = {}


def read(trace, ctx):
    rec = program_spans.recorded()
    if rec is None or not ctx.host.steps or not trace.steps:
        return None
    nbytes = rec.counted("host_copy_bytes", within="rcw.gym.to_host",
                         window=ctx.host.window)
    copies = [o for o in trace.device_ops if o.cat == "gpu_memcpy" and "DtoH" in o.name]
    us = sum(o.dur for o in trace.launched_within("rcw.gym.to_host", copies))
    if not nbytes or us <= 0:
        return None
    return (nbytes / ctx.host.steps) / (us / trace.steps * 1e-6) / 1e9
