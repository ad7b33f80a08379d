"""Device ms a traced 2D step in the window attention's fused kernels,
forward and backward (PyTorch's memory-efficient attention, picked out by
name); None where none ran."""

# the kernels of F.scaled_dot_product_attention's memory-efficient backend
# in float32, forward and backward
KERNELS = ("fmha_cutlassF", "fmha_cutlassB")


def read(ctx):
    took = {name: t for name, (t, _) in ctx.trace["kernels"].items()
            if any(k in name for k in KERNELS)}
    ctx.log(f"window attention kernels over {ctx.trace_steps} traced steps "
            f"(s): {took}")
    if not took:
        return None
    return 1e3 * sum(took.values()) / ctx.trace_steps
