"""Prefill wall per thousand prompt tokens (the engine's ``prefill_times``:
each chunk's call, synchronized) over the window up to the profiled
sub-window."""
from portbench.readers import Ctx


def read(ctx: Ctx):
    chunks = ctx.untraced_prefill()
    toks = sum(p[1] for p in chunks)
    return sum(p[2] for p in chunks) / toks * 1e6 if toks else None
