"""Share of the profiled sub-window in which no operation ran on the
device (1 - the union of the device activities' intervals over the
sub-window)."""
from portbench.readers import Ctx


def read(ctx: Ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return (1.0 - ctx.trace.busy_s() / ctx.trace.window_s) * 100.0
