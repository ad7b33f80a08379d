"""Bilinear corner sampler: the CUDA kernel pair, their plain twins, and the
autograd wrapper.

Replaces advchain_tpu/kernels/gather_matmul.py::band_gather (:839) and
::band_scatter (:923), wired there by ``_weighted_band_sample`` (:1407) with
``_wbs_fwd`` / ``_wbs_bwd``.  The kernels live in ``csrc/band_sample.cu``
(which carries the design and bound note) and are built by ``_build`` on
first use.

Contract: ``img`` (N, C, H, W), ``yidx``/``xidx`` (N, P) int32 base corners,
``w`` (N, 4, P) in corner order (0,0) (0,1) (1,0) (1,1);
``out[n,c,p] = sum_k w[n,k,p] * img[n, c, y+dy_k, x+dx_k]``, where a tap
outside the image reads zero and receives no gradient.

Dispatch: a CPU tensor takes the plain twin; a CUDA tensor launches the
kernel or raises.  ``FWD_LAUNCHES`` / ``BWD_LAUNCHES`` count kernel launches
(and nothing else), so a run can show it went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from advchain_tpu_torch.kernels import _build, _corners

__all__ = ["BandSample", "band_sample_fwd",
           "band_sample_bwd", "band_sample_fwd_plain",
           "band_sample_bwd_plain", "reset_launch_counts"]

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


def reset_launch_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0


# ------------------------------------------------------------ plain twins
def band_sample_fwd_plain(img, yidx, xidx, w):
    """Plain PyTorch forward (any device, any float dtype): gather the four
    corners, then sum k = 0..3 in order, as the kernel does."""
    return _corners.fwd_plain(img, (yidx, xidx), w)


def band_sample_bwd_plain(g, img, yidx, xidx, w):
    """Plain PyTorch backward: ``d_w[n,k,p] = sum_c g * v_k`` and
    ``d_img`` += ``w_k * g`` at each valid tap (deterministic scatter)."""
    return _corners.bwd_plain(g, img, (yidx, xidx), w)


# ---------------------------------------------------------------- kernels
@functools.cache
def _lib():
    lib = _build.load("band_sample")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.advchain_band_sample_fwd.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.advchain_band_sample_fwd.restype = i32
    lib.advchain_band_sample_bwd.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
    lib.advchain_band_sample_bwd.restype = i32
    return lib


def band_sample_fwd(img, yidx, xidx, w):
    """Forward: ``out`` (N, C, P).  CPU tensors take the plain twin."""
    global FWD_LAUNCHES
    if not _corners.check("band_sample", img, (yidx, xidx), w):
        return band_sample_fwd_plain(img, yidx, xidx, w)
    (n, c, h, wd), p = img.shape, yidx.shape[1]
    out = torch.empty(n, c, p, dtype=img.dtype, device=img.device)
    with torch.cuda.device(img.device):
        err = _lib().advchain_band_sample_fwd(
            img.data_ptr(), yidx.data_ptr(), xidx.data_ptr(), w.data_ptr(),
            out.data_ptr(), n, c, h, wd, p,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"band_sample_fwd launch failed: CUDA error {err}")
    FWD_LAUNCHES += 1
    return out


def band_sample_bwd(g, img, yidx, xidx, w):
    """Backward: ``(d_img (N, C, H, W), d_w (N, 4, P))`` in one launch.
    CPU tensors take the plain twin."""
    global BWD_LAUNCHES
    if not _corners.check("band_sample", img, (yidx, xidx), w, g):
        return band_sample_bwd_plain(g, img, yidx, xidx, w)
    (n, c, h, wd), p = img.shape, yidx.shape[1]
    d_img = torch.zeros_like(img)
    d_w = torch.empty_like(w)
    with torch.cuda.device(img.device):
        err = _lib().advchain_band_sample_bwd(
            g.data_ptr(), img.data_ptr(), yidx.data_ptr(), xidx.data_ptr(),
            w.data_ptr(), d_img.data_ptr(), d_w.data_ptr(), n, c, h, wd, p,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"band_sample_bwd launch failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    return d_img, d_w


class BandSample(torch.autograd.Function):
    """``out = band_sample_fwd(img, yidx, xidx, w)`` with gradients to
    ``img`` and ``w`` from one ``band_sample_bwd`` launch (the JAX
    ``_weighted_band_sample`` custom VJP).  The indices get no gradient."""

    @staticmethod
    def forward(ctx, img, yidx, xidx, w):
        ctx.save_for_backward(img, yidx, xidx, w)
        return band_sample_fwd(img, yidx, xidx, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        img, yidx, xidx, w = ctx.saved_tensors
        d_img, d_w = band_sample_bwd(g.contiguous(), img, yidx, xidx, w)
        return d_img, None, None, d_w
