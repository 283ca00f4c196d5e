"""Mean absolute error, in tokens, of the length predictor's p50 at
submission (the scheduler's ``predict`` event) against the request's true
output length, over the requests due in the window before the profiled
sub-window."""
import numpy as np

from portbench.readers import Ctx


def read(ctx: Ctx):
    err = [abs(float(e.data["p50"]) - ctx.recs[e.req_id].out_len)
           for e in ctx.kind("predict")
           if e.req_id in ctx.recs
           and ctx.recs[e.req_id].due < ctx.host_end]
    return float(np.mean(err)) if err else None
