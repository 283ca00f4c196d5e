"""The decode steps' model operations over their wall, as a share of the
card's bf16 peak: 2 per active parameter per token and 4 per attended
position, head and head dim (``roofline/model_step.py``), over the
window's decode steps up to the profiled sub-window."""
from portbench.readers import Ctx
from portbench.roofline import model_step, peaks


def read(ctx: Ctx):
    steps = ctx.untraced_decode()
    wall = sum(d[3] for d in steps)
    if not wall:
        return None
    flops = sum(model_step.decode_flops(ctx.arch, d[2], d[1]) for d in steps)
    return flops / wall / peaks.BF16_FLOPS * 100.0
