"""The paged decode-attention kernel's share of its roofline in the
profiled sub-window: the bound of the decode steps run there
(``roofline/paged_attention.py``, from each step's lanes and attended
positions) over the device time of the kernel's launches by name."""
from portbench.readers import Ctx
from portbench.roofline import paged_attention as k


def read(ctx: Ctx):
    if ctx.trace is None:
        return None
    dev = ctx.trace.kernel_s(k.KERNELS)
    steps = [d for d in ctx.decode if ctx.in_traced(d[0], d[0] + d[3])]
    if not dev or not steps:
        return None
    return sum(k.step_bound_s(ctx.arch, d[2], d[1]) for d in steps) \
        / dev * 100.0
