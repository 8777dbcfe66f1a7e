"""The players' cast's device time: the kernels launched inside the
program's ``rcw.game.cast_players`` spans (``models/multi_player.py``'s
``MultiPlayerRoom._cast_players``: the crossing cast of every player's
pose and the sprites' ray-circle distances), summed over the profiled
stretch, per step, in ms.  Silent where the trace holds no such span or no
kernel launched in one."""

from benchmark import program_spans  # noqa: F401  (turns the program's tracer on)

SPANS = {}


def read(trace, ctx):
    ops = trace.launched_within("rcw.game.cast_players")
    if not ops or not trace.steps:
        return None
    return sum(o.dur for o in ops) / trace.steps / 1e3
