"""Trilinear corner sampler: the CUDA kernel pair, their plain twins, and
the autograd wrapper.

Replaces advchain_tpu/kernels/gather_matmul.py::zband_gather (:1081) and
::zband_scatter (:1230), wired there by ``_weighted_zband_sample`` (:1379)
with ``_wzs_fwd`` / ``_wzs_bwd``.  The kernels live in
``csrc/zband_sample.cu`` (which carries the design and bound note) and are
built by ``_build`` on first use.

Contract: ``img`` (N, C, D, H, W), ``zidx``/``yidx``/``xidx`` (N, P) int32
base corners, ``w`` (N, 8, P) in (dz, dy, dx) binary corner order
(k = 4*dz + 2*dy + dx);
``out[n,c,p] = sum_k w[n,k,p] * img[n, c, z+dz_k, y+dy_k, x+dx_k]``, where
a tap outside the volume reads zero and receives no gradient.

Dispatch: a CPU tensor takes the plain twin; a CUDA tensor launches the
kernel or raises.  ``FWD_LAUNCHES`` / ``BWD_LAUNCHES`` count kernel launches
(and nothing else), so a run can show it went through the kernels.  The JAX
package's ``tile_order`` and channel groups are TPU tiling choices with no
counterpart here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from advchain_tpu_torch.kernels import _build, _corners

__all__ = ["ZBandSample", "zband_sample_fwd", "zband_sample_bwd",
           "zband_sample_fwd_plain", "zband_sample_bwd_plain",
           "reset_launch_counts"]

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


def reset_launch_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0


# ------------------------------------------------------------ plain twins
def zband_sample_fwd_plain(img, zidx, yidx, xidx, w):
    """Plain PyTorch forward (any device, any float dtype): gather the
    eight corners, then sum k = 0..7 in order, as the kernel does."""
    return _corners.fwd_plain(img, (zidx, yidx, xidx), w)


def zband_sample_bwd_plain(g, img, zidx, yidx, xidx, w):
    """Plain PyTorch backward: ``d_w[n,k,p] = sum_c g * v_k`` and
    ``d_img`` += ``w_k * g`` at each valid tap (deterministic scatter)."""
    return _corners.bwd_plain(g, img, (zidx, yidx, xidx), w)


# ---------------------------------------------------------------- kernels
@functools.cache
def _lib():
    lib = _build.load("zband_sample")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.advchain_zband_sample_fwd.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.advchain_zband_sample_fwd.restype = i32
    lib.advchain_zband_sample_bwd.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
    lib.advchain_zband_sample_bwd.restype = i32
    return lib


def zband_sample_fwd(img, zidx, yidx, xidx, w):
    """Forward: ``out`` (N, C, P).  CPU tensors take the plain twin."""
    global FWD_LAUNCHES
    if not _corners.check("zband_sample", img, (zidx, yidx, xidx), w):
        return zband_sample_fwd_plain(img, zidx, yidx, xidx, w)
    (n, c, d, h, wd), p = img.shape, zidx.shape[1]
    out = torch.empty(n, c, p, dtype=img.dtype, device=img.device)
    with torch.cuda.device(img.device):
        err = _lib().advchain_zband_sample_fwd(
            img.data_ptr(), zidx.data_ptr(), yidx.data_ptr(),
            xidx.data_ptr(), w.data_ptr(), out.data_ptr(), n, c, d, h, wd,
            p, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"zband_sample_fwd launch failed: CUDA error "
                           f"{err}")
    FWD_LAUNCHES += 1
    return out


def zband_sample_bwd(g, img, zidx, yidx, xidx, w):
    """Backward: ``(d_img (N, C, D, H, W), d_w (N, 8, P))`` in one launch.
    CPU tensors take the plain twin."""
    global BWD_LAUNCHES
    if not _corners.check("zband_sample", img, (zidx, yidx, xidx), w, g):
        return zband_sample_bwd_plain(g, img, zidx, yidx, xidx, w)
    (n, c, d, h, wd), p = img.shape, zidx.shape[1]
    d_img = torch.zeros_like(img)
    d_w = torch.empty_like(w)
    with torch.cuda.device(img.device):
        err = _lib().advchain_zband_sample_bwd(
            g.data_ptr(), img.data_ptr(), zidx.data_ptr(), yidx.data_ptr(),
            xidx.data_ptr(), w.data_ptr(), d_img.data_ptr(), d_w.data_ptr(),
            n, c, d, h, wd, p, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"zband_sample_bwd launch failed: CUDA error "
                           f"{err}")
    BWD_LAUNCHES += 1
    return d_img, d_w


class ZBandSample(torch.autograd.Function):
    """``out = zband_sample_fwd(img, zidx, yidx, xidx, w)`` with gradients
    to ``img`` and ``w`` from one ``zband_sample_bwd`` launch (the JAX
    ``_weighted_zband_sample`` custom VJP).  The indices get no gradient."""

    @staticmethod
    def forward(ctx, img, zidx, yidx, xidx, w):
        ctx.save_for_backward(img, zidx, yidx, xidx, w)
        return zband_sample_fwd(img, zidx, yidx, xidx, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        img, zidx, yidx, xidx, w = ctx.saved_tensors
        d_img, d_w = zband_sample_bwd(g.contiguous(), img, zidx, yidx, xidx,
                                      w)
        return d_img, None, None, None, d_w
