"""Kernel launches a step in the trace, once the port's own kernels among
them agree with its launch counters."""
from cudabench.layers import counters_agree


def read(ctx):
    if not counters_agree(ctx):
        ctx.log("dispatch.launches_per_step: the trace and the port's "
                "launch counters disagree; not reported")
        return None
    return ctx.trace["launches"] / ctx.trace_steps
