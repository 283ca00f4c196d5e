"""Preemptions (the engine's ``preempt`` events in the window) per request
due in the window."""
from portbench.readers import Ctx


def read(ctx: Ctx):
    due = ctx.due()
    if not due:
        return None
    return sum(1 for e in ctx.kind("preempt") if ctx.in_window(e.t)) \
        / len(due)
