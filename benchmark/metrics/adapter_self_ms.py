"""``GymVectorAdapter.step``'s own host time: per step, the host-clock
duration of the span around the adapter's step minus the part the
``Env.step`` span inside it covers, mean over the host stretch's steps (no
profiler running), in ms."""

SPANS = {
    "gym_compat.GymVectorAdapter.step": "adapter.step",
    "env.Env.step": "raycastworlds_tpu_torch.env:Env.step",
}


def read(trace, ctx):
    outer = ctx.host.span_durations("gym_compat.GymVectorAdapter.step")
    if not outer:
        return None
    inner = ctx.host.spans_within("env.Env.step", "gym_compat.GymVectorAdapter.step")
    return sum(o - i for o, i in zip(outer, inner)) / len(outer) / 1e3
