"""Median wait of a request due in the window from its due time to the
wall start of its first prefill chunk (the ``prefill_chunk`` event at
position 0 on the engine's wall-clock bus): the scheduler's queue."""
from portbench.readers import Ctx, median


def read(ctx: Ctx):
    first = {}
    for e in ctx.kind("prefill_chunk"):
        if e.data.get("start") == 0 and e.req_id not in first \
                and ctx.in_window(e.t):
            first[e.req_id] = e.t
    return median([t - ctx.recs[i].due for i, t in first.items()
                   if i in ctx.recs])
