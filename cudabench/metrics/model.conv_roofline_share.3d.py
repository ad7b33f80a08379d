"""The model FLOPs of the traced 3D steps (``costs.step_model_flops``, the
same work whatever algorithm computes it) over the device time of the
convolution kernel class in those steps, as a percentage of the f32 peak;
None where no convolution kernel ran."""
from cudabench.layers import kernel_class


def read(ctx):
    took = sum(t for name, (t, _) in ctx.trace["kernels"].items()
               if kernel_class(name) == "convolution")
    flops = ctx.costs.step_model_flops(ctx.config, ctx.step) * ctx.batch \
        * ctx.trace_steps
    peak = ctx.costs.PEAKS["f32_flops_per_s"]
    ctx.log(f"conv roofline {flops!r} FLOP over {ctx.trace_steps} steps in "
            f"{took!r} s of convolution kernels at {peak!r} FLOP/s (card, "
            f"power limit: {ctx.card})")
    if took <= 0:
        return None
    return 100.0 * flops / took / peak
