"""Mean wall of a decode iteration (the engine's ``iter_times``: staging,
the graphed step, the host copy of its tokens) over the window up to
the profiled sub-window."""
from portbench.readers import Ctx


def read(ctx: Ctx):
    steps = ctx.untraced_decode()
    return sum(d[3] for d in steps) / len(steps) * 1e3 if steps else None
