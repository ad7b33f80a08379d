"""Near-identity 2D warp (bilinear, border padding, align_corners=True at a
channel-first grid): the CUDA kernel pair, their plain twins, and the
autograd wrapper.

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
``v1 - v0`` at -1, 0 at +1), not a clip's half.

Dispatch: a CPU tensor takes the plain twin; a CUDA tensor launches the
kernel or raises.  ``FWD_LAUNCHES`` / ``BWD_LAUNCHES`` count kernel launches
(and nothing else), so a run can show it went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from advchain_tpu_torch.kernels import _build

__all__ = ["StencilWarp", "stencil_warp_fwd", "stencil_warp_bwd",
           "stencil_warp_fwd_plain", "stencil_warp_bwd_plain",
           "reset_launch_counts"]

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


def reset_launch_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0


# ------------------------------------------------------------ plain twins
def _axis(g, size: int):
    """Clamped taps (int64) and fraction of one axis, as the kernel's
    ``axis_taps``: ``fmax`` / ``fmin`` map NaN to the low bound as the
    kernel's ``fmaxf`` does."""
    pix = (g + 1.0) * 0.5 * (size - 1)
    fl = torch.floor(pix)
    frac = pix - fl
    lo = torch.fmin(torch.fmax(fl, torch.tensor(-1.0, dtype=fl.dtype,
                                                device=fl.device)),
                    torch.tensor(float(size - 1), dtype=fl.dtype,
                                 device=fl.device)).long()
    return lo.clamp(min=0), (lo + 1).clamp(max=size - 1), frac


def _taps(img, flow):
    """The four tap values (each (N, C, H*W)), the flat tap indices (each
    (N, H*W)) and the weights wx0, wx1, wy0, wy1 (each (N, 1, H*W))."""
    n, c, h, w = img.shape
    x0, x1, fx = _axis(flow[:, 0].reshape(n, -1), w)
    y0, y1, fy = _axis(flow[:, 1].reshape(n, -1), h)
    flat = img.reshape(n, c, h * w)
    offs = (y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1)
    vals = [torch.gather(flat, 2, o[:, None].expand(n, c, o.shape[1]))
            for o in offs]
    fx, fy = fx[:, None], fy[:, None]
    return vals, offs, (1.0 - fx, fx, 1.0 - fy, fy)


def stencil_warp_fwd_plain(img, flow):
    """Plain PyTorch forward (any device, any float dtype), in the kernel's
    order: ``wy0 * (wx0 v00 + wx1 v01) + wy1 * (wx0 v10 + wx1 v11)``."""
    n, c, h, w = img.shape
    (v00, v01, v10, v11), _, (wx0, wx1, wy0, wy1) = _taps(img, flow)
    out = wy0 * (wx0 * v00 + wx1 * v01) + wy1 * (wx0 * v10 + wx1 * v11)
    return out.reshape(n, c, h, w)


def stencil_warp_bwd_plain(g, img, flow):
    """Plain PyTorch backward: ``(d_img, d_flow)``; ``d_img`` by a
    deterministic scatter-add of ``wy * wx * g`` into the clamped taps."""
    n, c, h, w = img.shape
    (v00, v01, v10, v11), offs, (wx0, wx1, wy0, wy1) = _taps(img, flow)
    gf = g.reshape(n, c, h * w)
    gx0 = (gf * (v01 - v00)).sum(1)
    gx1 = (gf * (v11 - v10)).sum(1)
    gy0 = (gf * (wx0 * v00 + wx1 * v01)).sum(1)
    gy1 = (gf * (wx0 * v10 + wx1 * v11)).sum(1)
    d_fx = wy0[:, 0] * gx0 + wy1[:, 0] * gx1
    d_fy = gy1 - gy0
    d_flow = torch.stack([d_fx * (0.5 * (w - 1)), d_fy * (0.5 * (h - 1))],
                         dim=1).reshape(n, 2, h, w)
    d_img = torch.zeros(n, c, h * w, dtype=img.dtype, device=img.device)
    for o, wgt in zip(offs, (wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1)):
        d_img.scatter_add_(2, o[:, None].expand(n, c, o.shape[1]), wgt * gf)
    return d_img.reshape(n, c, h, w), d_flow


# ---------------------------------------------------------------- kernels
@functools.cache
def _lib():
    lib = _build.load("stencil_warp")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.advchain_stencil_warp_fwd.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
    lib.advchain_stencil_warp_fwd.restype = i32
    lib.advchain_stencil_warp_bwd.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.advchain_stencil_warp_bwd.restype = i32
    return lib


def _check(img, flow, g=None) -> bool:
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
    tensors = [img, flow] + ([g] if g is not None else [])
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
    with torch.cuda.device(img.device):
        err = _lib().advchain_stencil_warp_fwd(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(), n, c, h, w,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"stencil_warp_fwd launch failed: CUDA error {err}")
    FWD_LAUNCHES += 1
    return out


def stencil_warp_bwd(g, img, flow):
    """Backward: ``(d_img (N, C, H, W), d_flow (N, 2, H, W))`` in one
    launch.  CPU tensors take the plain twin."""
    global BWD_LAUNCHES
    if not _check(img, flow, g):
        return stencil_warp_bwd_plain(g, img, flow)
    n, c, h, w = img.shape
    d_img = torch.zeros_like(img)
    d_flow = torch.empty_like(flow)
    with torch.cuda.device(img.device):
        err = _lib().advchain_stencil_warp_bwd(
            g.data_ptr(), img.data_ptr(), flow.data_ptr(), d_img.data_ptr(),
            d_flow.data_ptr(), n, c, h, w,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"stencil_warp_bwd launch failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    return d_img, d_flow


class StencilWarp(torch.autograd.Function):
    """``out = stencil_warp_fwd(img, flow)`` with gradients to ``img`` and
    ``flow`` from one ``stencil_warp_bwd`` launch (the JAX
    ``stencil_warp_2d`` custom VJP).  Saves only ``(img, flow)``."""

    @staticmethod
    def forward(ctx, img, flow):
        ctx.save_for_backward(img, flow)
        return stencil_warp_fwd(img, flow)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        img, flow = ctx.saved_tensors
        return stencil_warp_bwd(g.contiguous(), img, flow)
