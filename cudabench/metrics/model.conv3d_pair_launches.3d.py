"""The port's ``conv3d_wgrad.pair`` counter a traced 3D step (the
hand-written Conv3d weight-gradient pair's calls), where it equals the
trace's ``conv3d_wgrad_partial_kernel`` launches; else None, both
logged."""
import sys

from cudabench.spans import COUNTERS
from cudabench.trace import matching

COUNTER = "conv3d_wgrad.pair"
KERNEL = "conv3d_wgrad_partial_kernel"


def read(ctx):
    traced = getattr(sys.modules.get(COUNTERS), "TRACED_COUNTS", None)
    if traced is None or COUNTER not in traced:
        ctx.log(f"conv3d pair launches: the program has no {COUNTER} count")
        return None
    program = traced[COUNTER]
    launches = matching(ctx.trace["kernels"], KERNEL)[1]
    ctx.log(f"conv3d pair launches over {ctx.trace_steps} traced steps: "
            f"program {program}, trace {launches}")
    if program != launches:
        return None
    return program / ctx.trace_steps
