"""The players' cast's host time: per step of the host stretch (no profiler
running), the ms the program spent inside its ``rcw.game.cast_players``
spans (``models/multi_player.py``'s ``MultiPlayerRoom._cast_players``: the
per-player map words, one batch cast of every env's P poses, and the
sprites' ray-circle distances), from the program's own record.  Silent
where the program has no tracer or no such span."""

from benchmark import program_spans

SPANS = {}


def read(trace, ctx):
    return program_spans.per_host_step_ms(ctx, "rcw.game.cast_players")
