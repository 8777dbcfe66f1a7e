"""The maze generator's kernels: those launched inside the program's
``rcw.game.maze_reset`` spans (``models/maze.py``'s ``Maze.reset_batch``)
over the profiled stretch, per step (a count).  Silent where the trace
holds no such span or no kernel launched in one."""

from benchmark import program_spans  # noqa: F401  (turns the program's tracer on)

SPANS = {}


def read(trace, ctx):
    ops = trace.launched_within("rcw.game.maze_reset")
    if not ops or not trace.steps:
        return None
    return len(ops) / trace.steps
