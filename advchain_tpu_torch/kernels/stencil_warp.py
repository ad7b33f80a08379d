"""Near-identity 2D warp (bilinear, border padding, align_corners=True at a
channel-first grid): the CUDA kernel pair, their plain twins, and the
autograd wrapper; and the flow compositions' dispatch predicate.

Replaces advchain_tpu/kernels/stencil.py::_stencil_fwd_2d_pallas (:132) and
::_stencil_bwd_2d_pallas (:172), wired there by
ops/grid_sample.py::stencil_warp_2d's custom VJP.  The kernels live in
``csrc/stencil_warp.cu`` (which carries the design and bound note) and are
built by ``_build`` on first use.

Contract: ``img`` (N, C, H, W), ``flow`` (N, 2, H, W) in [-1, 1] with
channel 0 indexing W.  Each output pixel reads four taps at clamped rows
``min(max(y0, 0), H-1)``, ``min(max(y0 + 1, 0), H-1)`` (columns alike) of
the unclipped coordinate ``ypix = (gy + 1) * 0.5 * (H - 1)``,
``y0 = floor(ypix)``, with hat weights of ``fy = ypix - y0``.  Within R
pixels that is the JAX package's edge-padded (2R+1)^2 stencil exactly, and
past R it is still exact bilinear sampling with border padding.  At an exact
bound the grid gradient is the stencil's one-sided slope (the whole
``v1 - v0`` at -1, 0 at +1) times ``lower_slope`` at -1 (None: 1).

The backward gathers: each source pixel sums the weighted cotangent of the
output pixels within ``WINDOW`` (2) pixels whose tap it is, with no float
atomics, so ``d_img`` comes out the same bit for bit from run to run; a
second kernel adds the taps farther than ``WINDOW`` from their own pixel
with atomics, and their count is left in ``LAST_OUT_OF_WINDOW`` (a
one-element int32 tensor on the device).

The dispatch predicate (:func:`dispatch_slope`) is the JAX package's
``lax.cond`` in ``compose_flow`` (advchain_tpu/ops/integrate.py:103-116,
134-141): the largest displacement of a flow from the base grid, in pixels,
against ``R - 1e-3``; below it JAX takes its stencil (the whole slope at an
exact lower bound), otherwise its sampler (``jnp.clip``'s half).  It stays
on the device: the slope is a tensor the backward kernels read.  Each call
zeroes its own two work words, so calls on different streams do not mix.

Dispatch: a CPU tensor takes the plain twin; a CUDA tensor launches the
kernel or raises.  ``FWD_LAUNCHES`` / ``BWD_LAUNCHES`` / ``SLOPE_LAUNCHES``
count calls that launch the forward, the backward (its two kernels and the
zeroing of their counter) and the predicate (its kernel and the zeroing of
its words), and nothing else, so a run can show it went through the
kernels.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from advchain_tpu_torch._consts import device_const
from advchain_tpu_torch._trace import to_device
from advchain_tpu_torch.kernels import _build

__all__ = ["StencilWarp", "stencil_warp_fwd", "stencil_warp_bwd",
           "stencil_warp_fwd_plain", "stencil_warp_bwd_plain",
           "dispatch_slope", "dispatch_slope_plain", "out_of_window_plain",
           "reset_launch_counts"]

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
SLOPE_LAUNCHES = 0
# the backward gather's window in pixels: kWindow in csrc/stencil_warp.cu
WINDOW = 2
# the count of out-of-window taps of the latest CUDA backward
LAST_OUT_OF_WINDOW = None


def reset_launch_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES, SLOPE_LAUNCHES
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0
    SLOPE_LAUNCHES = 0


# ------------------------------------------------------------ plain twins
def _axis(g, size: int):
    """Clamped taps (int64), fraction and the exact-lower-bound mask of one
    axis, as the kernel's ``axis_taps``: ``fmax`` / ``fmin`` map NaN to the
    low bound as the kernel's ``fmaxf`` does."""
    pix = (g + 1.0) * 0.5 * (size - 1)
    fl = torch.floor(pix)
    frac = pix - fl
    lo = torch.fmin(torch.fmax(fl, torch.tensor(-1.0, dtype=fl.dtype,
                                                device=fl.device)),
                    torch.tensor(float(size - 1), dtype=fl.dtype,
                                 device=fl.device)).long()
    return lo.clamp(min=0), (lo + 1).clamp(max=size - 1), frac, pix == 0


def _taps(img, flow):
    """The four tap values (each (N, C, H*W)), the flat tap indices (each
    (N, H*W)), the weights wx0, wx1, wy0, wy1 (each (N, 1, H*W)) and the
    exact-lower-bound masks of x and y (each (N, H*W))."""
    n, c, h, w = img.shape
    x0, x1, fx, x_lo = _axis(flow[:, 0].reshape(n, -1), w)
    y0, y1, fy, y_lo = _axis(flow[:, 1].reshape(n, -1), h)
    flat = img.reshape(n, c, h * w)
    offs = (y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1)
    vals = [torch.gather(flat, 2, o[:, None].expand(n, c, o.shape[1]))
            for o in offs]
    fx, fy = fx[:, None], fy[:, None]
    return vals, offs, (1.0 - fx, fx, 1.0 - fy, fy), (x_lo, y_lo)


def stencil_warp_fwd_plain(img, flow):
    """Plain PyTorch forward (any device, any float dtype), in the kernel's
    order: ``wy0 * (wx0 v00 + wx1 v01) + wy1 * (wx0 v10 + wx1 v11)``."""
    n, c, h, w = img.shape
    (v00, v01, v10, v11), _, (wx0, wx1, wy0, wy1), _ = _taps(img, flow)
    out = wy0 * (wx0 * v00 + wx1 * v01) + wy1 * (wx0 * v10 + wx1 * v11)
    return out.reshape(n, c, h, w)


def stencil_warp_bwd_plain(g, img, flow, lower_slope=None):
    """Plain PyTorch backward: ``(d_img, d_flow)``; ``d_img`` by a
    deterministic scatter-add of ``wy * wx * g`` into the clamped taps (the
    definition the gather kernel computes), ``d_flow`` times the first
    value of ``lower_slope`` where its coordinate lies exactly on the lower
    bound (None: 1, the stencil's whole slope)."""
    n, c, h, w = img.shape
    (v00, v01, v10, v11), offs, (wx0, wx1, wy0, wy1), (x_lo, y_lo) = \
        _taps(img, flow)
    gf = g.reshape(n, c, h * w)
    gx0 = (gf * (v01 - v00)).sum(1)
    gx1 = (gf * (v11 - v10)).sum(1)
    gy0 = (gf * (wx0 * v00 + wx1 * v01)).sum(1)
    gy1 = (gf * (wx0 * v10 + wx1 * v11)).sum(1)
    d_fx = wy0[:, 0] * gx0 + wy1[:, 0] * gx1
    d_fy = gy1 - gy0
    if lower_slope is not None:
        slope = lower_slope.reshape(-1)[0]
        d_fx = torch.where(x_lo, d_fx * slope, d_fx)
        d_fy = torch.where(y_lo, d_fy * slope, d_fy)
    d_flow = torch.stack([d_fx * (0.5 * (w - 1)), d_fy * (0.5 * (h - 1))],
                         dim=1).reshape(n, 2, h, w)
    d_img = torch.zeros(n, c, h * w, dtype=img.dtype, device=img.device)
    for o, wgt in zip(offs, (wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1)):
        d_img.scatter_add_(2, o[:, None].expand(n, c, o.shape[1]), wgt * gf)
    return d_img.reshape(n, c, h, w), d_flow


def out_of_window_plain(flow):
    """The plain version of the backward's counter: the taps of weight
    != 0 lying farther than ``WINDOW`` pixels from their own pixel along
    either axis, which the CUDA backward adds with atomics after its
    gather."""
    n, _, h, w = flow.shape
    x0, x1, fx, _ = _axis(flow[:, 0].reshape(n, -1), w)
    y0, y1, fy, _ = _axis(flow[:, 1].reshape(n, -1), h)
    px = torch.arange(w, device=flow.device).repeat(h)
    py = torch.arange(h, device=flow.device).repeat_interleave(w)
    total = 0
    for ty, wy in ((y0, 1.0 - fy), (y1, fy)):
        for tx, wx in ((x0, 1.0 - fx), (x1, fx)):
            far = ((ty - py).abs() > WINDOW) | ((tx - px).abs() > WINDOW)
            total += int((far & (wy * wx != 0)).sum())
    return total


@device_const
def _base(sizes: tuple, device: str):
    """The base grid's coordinates along each axis, the last spatial axis
    first, concatenated (f32 on ``device``): ``linspace(-1, 1, S)`` computed
    in float64 and rounded once, as the port's ``base_grid``."""
    return to_device(np.concatenate(
        [np.linspace(-1.0, 1.0, s) for s in reversed(sizes)]),
        torch.float32, device)


def dispatch_slope_plain(flow, radius: int):
    """``[slope, dpx]`` (f32, on ``flow``'s device) for a flow (N, d, *S),
    d = 2 or 3: ``dpx`` the largest ``|flow_i - base_i| (S_i - 1) / 2`` over
    the batch and the axes (axis i indexing ``S[d - 1 - i]``), ``slope`` 1
    where ``dpx < radius - 1e-3`` (the JAX package's stencil) and 0.5
    otherwise (its sampler), in f32 as JAX computes it."""
    sizes = tuple(flow.shape[2:])
    base = _base(sizes, str(flow.device)).to(flow.dtype)
    dpx, start = None, 0
    for i, size in enumerate(reversed(sizes)):
        coords = base[start:start + size].reshape((size,) + (1,) * i)
        start += size
        m = torch.amax(torch.abs(flow[:, i] - coords)) * (0.5 * (size - 1))
        dpx = m if dpx is None else torch.maximum(dpx, m)
    slope = torch.where(dpx < radius - 1e-3, 1.0, 0.5).to(dpx.dtype)
    return torch.stack([slope, dpx]).float()


# ---------------------------------------------------------------- kernels
@functools.cache
def _lib():
    lib = _build.load("stencil_warp")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.advchain_stencil_warp_fwd.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
    lib.advchain_stencil_warp_fwd.restype = i32
    lib.advchain_stencil_warp_bwd.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
    lib.advchain_stencil_warp_bwd.restype = i32
    lib.advchain_dispatch_slope.argtypes = ([ptr] * 4 + [i32] * 5
                                            + [ctypes.c_float, ptr])
    lib.advchain_dispatch_slope.restype = i32
    return lib


def dispatch_slope(flow, radius: int):
    """The dispatch predicate of a composition sampling at ``flow``
    (N, d, *S): ``[slope, dpx]`` as :func:`dispatch_slope_plain`, without
    a host read, in two launches: the zeroing of this call's four words
    (the result and the kernel's two work words), then the kernel.  CPU
    tensors take the plain twin."""
    global SLOPE_LAUNCHES
    dims = flow.dim() - 2
    if dims not in (2, 3) or flow.shape[1] != dims:
        raise ValueError(f"dispatch_slope takes a flow (N, d, *S) with d = "
                         f"2 or 3 spatial axes, got {tuple(flow.shape)}")
    if flow.device.type == "cpu":
        return dispatch_slope_plain(flow, radius)
    if flow.device.type != "cuda":
        raise ValueError(f"dispatch_slope runs on cuda or cpu, not "
                         f"{flow.device.type}")
    if flow.dtype != torch.float32 or not flow.is_contiguous():
        raise TypeError("the CUDA dispatch_slope takes a contiguous f32 flow")
    if flow.numel() == 0 or flow.numel() >= 2 ** 31:
        raise ValueError("dispatch_slope takes a non-empty flow of fewer "
                         "than 2^31 elements")
    n, _, *sizes = flow.shape
    d, h, w = ([1] + sizes)[-3:]
    base = _base(tuple(sizes), str(flow.device))
    words = torch.zeros(4, dtype=torch.int32, device=flow.device)
    out = words[:2].view(torch.float32)
    _build.launch(_lib().advchain_dispatch_slope, flow.device,
                  "dispatch_slope", flow.data_ptr(), base.data_ptr(),
                  out.data_ptr(), words[2:].data_ptr(), n, dims, d, h, w,
                  radius - 1e-3)
    SLOPE_LAUNCHES += 1
    return out


def _check(img, flow, g=None, lower_slope=None) -> bool:
    """Validate a call.  False: CPU tensors, which take the plain twin;
    True: CUDA tensors the kernel takes; anything else raises."""
    if img.dim() != 4 or flow.dim() != 4:
        raise ValueError(f"stencil_warp takes img (N, C, H, W) and flow "
                         f"(N, 2, H, W), got {tuple(img.shape)} and "
                         f"{tuple(flow.shape)}")
    n, _, h, w = img.shape
    if tuple(flow.shape) != (n, 2, h, w):
        raise ValueError(f"stencil_warp: flow must be {(n, 2, h, w)}, got "
                         f"{tuple(flow.shape)}")
    if g is not None and g.shape != img.shape:
        raise ValueError(f"stencil_warp: g must be {tuple(img.shape)}, got "
                         f"{tuple(g.shape)}")
    if lower_slope is not None and lower_slope.numel() < 1:
        raise ValueError("stencil_warp: lower_slope must hold one value")
    tensors = [t for t in (img, flow, g, lower_slope) if t is not None]
    if any(t.device != img.device for t in tensors):
        raise ValueError("stencil_warp tensors must share one device")
    if img.device.type == "cpu":
        return False
    if img.device.type != "cuda":
        raise ValueError(f"stencil_warp runs on cuda or cpu, not "
                         f"{img.device.type}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the CUDA stencil_warp takes f32 tensors")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA stencil_warp takes contiguous tensors")
    if img.numel() >= 2 ** 31 or flow.numel() >= 2 ** 31:
        raise ValueError("stencil_warp sizes must stay below 2^31 elements")
    return True


def stencil_warp_fwd(img, flow):
    """Forward: ``out`` (N, C, H, W).  CPU tensors take the plain twin."""
    global FWD_LAUNCHES
    if not _check(img, flow):
        return stencil_warp_fwd_plain(img, flow)
    n, c, h, w = img.shape
    out = torch.empty_like(img)
    _build.launch(_lib().advchain_stencil_warp_fwd, img.device,
                  "stencil_warp_fwd", img.data_ptr(), flow.data_ptr(),
                  out.data_ptr(), n, c, h, w)
    FWD_LAUNCHES += 1
    return out


def stencil_warp_bwd(g, img, flow, lower_slope=None):
    """Backward: ``(d_img (N, C, H, W), d_flow (N, 2, H, W))`` in three
    launches: the zeroing of a one-int counter, the gather of ``d_img``
    over a ``WINDOW``-pixel window with ``d_flow``, then the taps outside
    the window, added to ``d_img`` with atomics (their count is left in
    ``LAST_OUT_OF_WINDOW``).
    ``lower_slope``: a one-element f32 tensor (the dispatch slope) that
    scales ``d_flow`` at an exact lower bound, or None for 1.  CPU tensors
    take the plain twin."""
    global BWD_LAUNCHES, LAST_OUT_OF_WINDOW
    if not _check(img, flow, g, lower_slope):
        return stencil_warp_bwd_plain(g, img, flow, lower_slope)
    n, c, h, w = img.shape
    d_img = torch.empty_like(img)
    d_flow = torch.empty_like(flow)
    outside = torch.zeros(1, dtype=torch.int32, device=img.device)
    _build.launch(_lib().advchain_stencil_warp_bwd, img.device,
                  "stencil_warp_bwd", g.data_ptr(), img.data_ptr(),
                  flow.data_ptr(),
                  None if lower_slope is None else lower_slope.data_ptr(),
                  d_img.data_ptr(), d_flow.data_ptr(), outside.data_ptr(), n,
                  c, h, w)
    BWD_LAUNCHES += 1
    LAST_OUT_OF_WINDOW = outside
    return d_img, d_flow


class StencilWarp(torch.autograd.Function):
    """``out = stencil_warp_fwd(img, flow)`` with gradients to ``img`` and
    ``flow`` from ``stencil_warp_bwd`` (the JAX ``stencil_warp_2d`` custom
    VJP; ``lower_slope`` as there).  Saves only ``(img, flow)`` and the
    slope."""

    @staticmethod
    def forward(ctx, img, flow, lower_slope=None):
        ctx.save_for_backward(img, flow)
        ctx.lower_slope = lower_slope
        return stencil_warp_fwd(img, flow)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        img, flow = ctx.saved_tensors
        d_img, d_flow = stencil_warp_bwd(g.contiguous(), img, flow,
                                         ctx.lower_slope)
        return d_img, d_flow, None
