"""The maze generator's host time: per step of the host stretch (no
profiler running), the ms the program spent inside its
``rcw.game.maze_reset`` spans (``models/maze.py``'s ``Maze.reset_batch``:
the budgeted reset's fresh mazes, goals, spawns and headings), from the
program's own record.  Silent where the program has no tracer or no such
span."""

from benchmark import program_spans

SPANS = {}


def read(trace, ctx):
    return program_spans.per_host_step_ms(ctx, "rcw.game.maze_reset")
