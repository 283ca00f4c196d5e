"""Mean wall of an INT8 offload in the window: the harness's span around
the backend's ``offload`` call (quantize on the device, one pinned copy,
one sync), the device synchronized before it starts and after it
returns.  Measured, not the bus's modelled transfer time."""
from portbench.readers import Ctx


def read(ctx: Ctx):
    ms = ctx.offload_ms
    return sum(ms) / len(ms) if ms else None
