"""The prefix flash-attention kernel's share of its roofline in the
profiled sub-window: the bound of the chunks run there (each chunk's
start and end from its ``prefill_chunk`` event,
``roofline/flash_prefill_prefix.py``) over the device time of the
kernel's launches by name."""
from portbench.readers import Ctx
from portbench.roofline import flash_prefill_prefix as k


def read(ctx: Ctx):
    if ctx.trace is None:
        return None
    dev = ctx.trace.kernel_s(k.KERNELS)
    chunks = [e for e in ctx.kind("prefill_chunk")
              if ctx.in_traced(e.t, e.t + e.dur)]
    if not dev or not chunks:
        return None
    return sum(k.chunk_bound_s(ctx.arch, e.data["start"], e.data["end"])
               for e in chunks) / dev * 100.0
