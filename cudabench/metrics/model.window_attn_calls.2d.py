"""The port's ``swin.window_attn`` counter a traced 2D step (one count a
window attention's forward), where it equals the trace's launches of the
fused attention's forward kernel; else None, both logged.  None where the
program has no such counter."""
import sys

from cudabench.spans import COUNTERS

COUNTER = "swin.window_attn"
# the forward kernel of F.scaled_dot_product_attention's memory-efficient
# backend in float32, one launch a call
KERNEL = "fmha_cutlassF"


def read(ctx):
    traced = getattr(sys.modules.get(COUNTERS), "TRACED_COUNTS", None)
    if traced is None or COUNTER not in traced:
        ctx.log(f"window attention calls: the program has no {COUNTER} "
                f"count")
        return None
    program = traced[COUNTER]
    launches = sum(n for name, (_, n) in ctx.trace["kernels"].items()
                   if KERNEL in name)
    ctx.log(f"window attention calls over {ctx.trace_steps} traced steps: "
            f"program {program}, trace {launches}")
    if program != launches:
        return None
    return program / ctx.trace_steps
