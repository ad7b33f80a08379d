"""Readings shared by the per-layer metrics' readers (``metrics/*.py``):
the kernel classes of the model layer, the roofline share of the warps'
and compositions' kernels, the whole step's share of the f32 peak, and the
check of the port's launch counters against the trace."""

from __future__ import annotations

from cudabench.trace import matching

# kernel-name substrings of the model layer's classes (cuDNN's and
# PyTorch's native kernels; the FFT convolution's transforms and complex
# products count as convolution); a frozen copy of the repository's
# profile classifier
KERNEL_CLASSES = {
    "batchnorm": ("batch_norm", "batchnorm", "bn_fw", "bn_bw"),
    "upsample": ("upsample",),
    "convolution": ("conv", "implicit_gemm", "xmma", "fft", "cf32",
                    "dgrad", "wgrad", "fprop", "implicit_convolve",
                    "nchwtonhwc", "nhwctonchw"),
}


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in KERNEL_CLASSES.items():
        if any(k in low for k in keys):
            return cls
    return "other"


def model_device_ms(ctx):
    """Device milliseconds a step in the model layer's kernel classes."""
    sec = sum(t for name, (t, _) in ctx.trace["kernels"].items()
              if kernel_class(name) != "other")
    return 1e3 * sec / ctx.trace_steps if sec > 0 else None


def step_mfu(ctx):
    """The model FLOPs the steps of the measured window required, over the
    window, as a percentage of the f32 peak outside the tensor cores."""
    flops = ctx.costs.step_model_flops(ctx.config, ctx.step)
    peak = ctx.costs.PEAKS["f32_flops_per_s"]
    ctx.log(f"step_mfu {flops!r} FLOP an item at {ctx.rate!r} items/s over "
            f"{peak!r} FLOP/s (card, power limit: {ctx.card})")
    return 100.0 * flops * ctx.rate / peak


def roofline_share(ctx):
    """The least time the warps' and compositions' bytes need at the HBM
    peak, over the device time of the kernels ``rooflines/*.json`` name, in
    the traced steps, as a percentage; None where those kernels did not
    run."""
    work = ctx.costs.warp_bytes(ctx.config, ctx.batch, ctx.step)
    need = sum(work.values()) * ctx.trace_steps \
        / ctx.costs.PEAKS["hbm_bytes_per_s"]
    took = sum(matching(ctx.trace["kernels"], r["pattern"])[0]
               for r in ctx.rooflines)
    ctx.log(f"roofline {work} bytes a step, {need!r} s needed, {took!r} s "
            f"taken over {ctx.trace_steps} steps (card, power limit: "
            f"{ctx.card})")
    if took <= 0 or need <= 0:
        return None
    return 100.0 * need / took


def counters_agree(ctx) -> bool:
    """Whether every roofline kernel's launches in the trace equal the
    port's counter of it over the traced steps (logged either way)."""
    per = {}
    for r in ctx.rooflines:
        if r.get("counter"):
            n = matching(ctx.trace["kernels"], r["pattern"])[1]
            per[r["pattern"]] = (n, ctx.launches.get(r["counter"], 0))
    ctx.log(f"launches (trace, counter) {per}")
    return all(a == b for a, b in per.values())
