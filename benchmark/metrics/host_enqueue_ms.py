"""``Env.step``'s host time: the mean host-clock duration of the span
around each ``Env.step`` call of the host stretch (no profiler running),
in ms."""

SPANS = {"env.Env.step": "raycastworlds_tpu_torch.env:Env.step"}


def read(trace, ctx):
    durs = ctx.host.span_durations("env.Env.step")
    return sum(durs) / len(durs) / 1e3 if durs else None
