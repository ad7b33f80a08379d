"""The port's ``batchnorm.pair`` counter a traced 2D step (the calls of the
hand-written training BatchNorm backward pair), where it equals the trace's
``batch_norm_grad_reduce_kernel`` launches; else None, both logged.  None
where the program has no such counter."""
import sys

from cudabench.spans import COUNTERS
from cudabench.trace import matching

COUNTER = "batchnorm.pair"
KERNEL = "batch_norm_grad_reduce_kernel"


def read(ctx):
    traced = getattr(sys.modules.get(COUNTERS), "TRACED_COUNTS", None)
    if traced is None or COUNTER not in traced:
        ctx.log(f"batchnorm pair launches: the program has no {COUNTER} "
                f"count")
        return None
    program = traced[COUNTER]
    launches = matching(ctx.trace["kernels"], KERNEL)[1]
    ctx.log(f"batchnorm pair launches over {ctx.trace_steps} traced steps: "
            f"program {program}, trace {launches}")
    if program != launches:
        return None
    return program / ctx.trace_steps
