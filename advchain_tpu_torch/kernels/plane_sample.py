"""Flat-index corner and plane samplers: the CUDA kernel pair, their plain
twins, and the autograd wrappers.

Replaces advchain_tpu/kernels/gather_matmul.py::corner_gather (:134, with
``_corner_gather_streamed`` :208), ::corner_scatter (:283, with
``_corner_scatter_resident`` :323 and ``_corner_scatter_chunk_major``
:373), ::plane_gather (:466) and ::plane_scatter (:603, with
``_plane_scatter_streamed`` :690), wired there by
``_weighted_corner_sample`` (:1466) and ``_weighted_plane_sample``
(:1435).  The corner pair is the plane pair with one plane, so one kernel
pair (``csrc/plane_sample.cu``, which carries the design and bound note)
serves both; it is built by ``_build`` on first use.

Contract: ``img`` (N, C, S) for the corner pair or (N, C, D, HW) for the
plane pair, ``idx`` / ``yxidx`` and ``zidx`` (N, P) int32, ``w`` (N, K, P)
and ``offsets`` K <= 4 non-negative ints;
``out[n,c,p] = sum_k w[n,k,p] * img[n, c, (z,) idx + offsets[k]]``, where
a tap at or past the flat end (S, or HW within its plane) or on a plane
outside [0, D) reads zero and receives no gradient.  Unlike the band
contract this does not zero a tap that leaves its row: at the last column
the +1 tap is the next row's first pixel (the samplers give it weight 0,
so only the kernel-level ``d_w`` shows it).

Dispatch: a CPU tensor takes the plain twin; a CUDA tensor launches the
kernel or raises.  ``LAUNCHES["corner"|"plane"]["fwd"|"bwd"]`` count
kernel launches (and nothing else) per route, so a run can show which
route it went through.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from advchain_tpu_torch.kernels import _build, _corners

__all__ = ["CornerSample", "PlaneSample", "corner_sample_fwd",
           "corner_sample_bwd", "corner_sample_fwd_plain",
           "corner_sample_bwd_plain", "plane_sample_fwd", "plane_sample_bwd",
           "plane_sample_fwd_plain", "plane_sample_bwd_plain",
           "reset_launch_counts"]

MAX_TAPS = 4
LAUNCHES = {"corner": {"fwd": 0, "bwd": 0}, "plane": {"fwd": 0, "bwd": 0}}


def reset_launch_counts() -> None:
    for counts in LAUNCHES.values():
        counts["fwd"] = counts["bwd"] = 0


def _check_offsets(name: str, offsets, w):
    if not 1 <= len(offsets) <= MAX_TAPS or w.shape[1:2] != (len(offsets),):
        raise ValueError(f"{name}: 1-{MAX_TAPS} offsets, one per weight row; "
                         f"got {tuple(offsets)} for w {tuple(w.shape)}")
    if any(int(o) != o or not 0 <= o < 2 ** 31 for o in offsets):
        raise ValueError(f"{name}: offsets must be non-negative ints below "
                         f"2^31, got {tuple(offsets)}")


def _taps(zidx, yxidx, offsets, d: int, hw: int):
    """Flat tap index into each sample's (D*HW) block, (N, K, P) int64,
    and validity: ``0 <= yx + offsets[k] < HW`` and ``0 <= z < D``."""
    off = torch.tensor(offsets, dtype=torch.int64, device=yxidx.device)
    yx = yxidx.long()[:, None, :] + off[None, :, None]
    valid = (yx >= 0) & (yx < hw)
    flat = yx
    if zidx is not None:
        z = zidx.long()[:, None, :]
        valid = valid & (z >= 0) & (z < d)
        flat = z * hw + yx
    return torch.where(valid, flat, torch.zeros_like(flat)), valid


# ------------------------------------------------------------ plain twins
def corner_sample_fwd_plain(img, idx, w, offsets):
    """Plain PyTorch forward (any device, any float dtype): gather the K
    taps, then sum k = 0..K-1 in order, as the kernel does."""
    return _corners.fwd_taps(img, *_taps(None, idx, offsets, 1,
                                         img.shape[2]), w)


def corner_sample_bwd_plain(g, img, idx, w, offsets):
    """Plain PyTorch backward: ``d_w[n,k,p] = sum_c g * v_k`` and
    ``d_img`` += ``w_k * g`` at each valid tap (deterministic scatter)."""
    return _corners.bwd_taps(g, img, *_taps(None, idx, offsets, 1,
                                            img.shape[2]), w)


def plane_sample_fwd_plain(img, zidx, yxidx, w, offsets):
    """Plain PyTorch forward of the plane contract (see the module)."""
    return _corners.fwd_taps(img, *_taps(zidx, yxidx, offsets,
                                         *img.shape[2:]), w)


def plane_sample_bwd_plain(g, img, zidx, yxidx, w, offsets):
    """Plain PyTorch backward of the plane contract."""
    return _corners.bwd_taps(g, img, *_taps(zidx, yxidx, offsets,
                                            *img.shape[2:]), w)


# ---------------------------------------------------------------- kernels
@functools.cache
def _lib():
    lib = _build.load("plane_sample")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.advchain_plane_sample_fwd.argtypes = ([ptr] * 5 + [i32] * 10
                                              + [ptr])
    lib.advchain_plane_sample_fwd.restype = i32
    lib.advchain_plane_sample_bwd.argtypes = ([ptr] * 7 + [i32] * 10
                                              + [ptr])
    lib.advchain_plane_sample_bwd.restype = i32
    return lib


def _shape(img, yxidx, offsets):
    """(n, c, d, hw, p, k, four offsets) for the C entry points."""
    n, c = img.shape[:2]
    d, hw = (1, img.shape[2]) if img.dim() == 3 else img.shape[2:]
    offs = list(offsets) + [0] * (MAX_TAPS - len(offsets))
    return [n, c, d, hw, yxidx.shape[1], len(offsets), *offs]


def _fwd(route, img, zidx, yxidx, w, offsets):
    out = torch.empty(img.shape[0], img.shape[1], yxidx.shape[1],
                      dtype=img.dtype, device=img.device)
    with torch.cuda.device(img.device):
        err = _lib().advchain_plane_sample_fwd(
            img.data_ptr(), None if zidx is None else zidx.data_ptr(),
            yxidx.data_ptr(), w.data_ptr(), out.data_ptr(),
            *_shape(img, yxidx, offsets),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{route}_sample_fwd launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[route]["fwd"] += 1
    return out


def _bwd(route, g, img, zidx, yxidx, w, offsets):
    d_img = torch.zeros_like(img)
    d_w = torch.empty_like(w)
    with torch.cuda.device(img.device):
        err = _lib().advchain_plane_sample_bwd(
            g.data_ptr(), img.data_ptr(),
            None if zidx is None else zidx.data_ptr(), yxidx.data_ptr(),
            w.data_ptr(), d_img.data_ptr(), d_w.data_ptr(),
            *_shape(img, yxidx, offsets),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{route}_sample_bwd launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[route]["bwd"] += 1
    return d_img, d_w


def corner_sample_fwd(img, idx, w, offsets):
    """Forward: ``out`` (N, C, P).  CPU tensors take the plain twin."""
    _check_offsets("corner_sample", offsets, w)
    if not _corners.check("corner_sample", img, (idx,), w,
                          taps=len(offsets)):
        return corner_sample_fwd_plain(img, idx, w, offsets)
    return _fwd("corner", img, None, idx, w, offsets)


def corner_sample_bwd(g, img, idx, w, offsets):
    """Backward: ``(d_img (N, C, S), d_w (N, K, P))`` in one launch.  CPU
    tensors take the plain twin."""
    _check_offsets("corner_sample", offsets, w)
    if not _corners.check("corner_sample", img, (idx,), w, g,
                          taps=len(offsets)):
        return corner_sample_bwd_plain(g, img, idx, w, offsets)
    return _bwd("corner", g, img, None, idx, w, offsets)


def plane_sample_fwd(img, zidx, yxidx, w, offsets):
    """Forward: ``out`` (N, C, P).  CPU tensors take the plain twin."""
    _check_offsets("plane_sample", offsets, w)
    if not _corners.check("plane_sample", img, (zidx, yxidx), w,
                          taps=len(offsets)):
        return plane_sample_fwd_plain(img, zidx, yxidx, w, offsets)
    return _fwd("plane", img, zidx, yxidx, w, offsets)


def plane_sample_bwd(g, img, zidx, yxidx, w, offsets):
    """Backward: ``(d_img (N, C, D, HW), d_w (N, K, P))`` in one launch.
    CPU tensors take the plain twin."""
    _check_offsets("plane_sample", offsets, w)
    if not _corners.check("plane_sample", img, (zidx, yxidx), w, g,
                          taps=len(offsets)):
        return plane_sample_bwd_plain(g, img, zidx, yxidx, w, offsets)
    return _bwd("plane", g, img, zidx, yxidx, w, offsets)


class CornerSample(torch.autograd.Function):
    """``out = corner_sample_fwd(img, idx, w, offsets)`` with gradients to
    ``img`` and ``w`` from one ``corner_sample_bwd`` launch (the JAX
    ``_weighted_corner_sample`` custom VJP).  The indices get no
    gradient."""

    @staticmethod
    def forward(ctx, img, idx, w, offsets):
        ctx.save_for_backward(img, idx, w)
        ctx.offsets = tuple(offsets)
        return corner_sample_fwd(img, idx, w, ctx.offsets)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        img, idx, w = ctx.saved_tensors
        d_img, d_w = corner_sample_bwd(g.contiguous(), img, idx, w,
                                       ctx.offsets)
        return d_img, None, d_w, None


class PlaneSample(torch.autograd.Function):
    """``out = plane_sample_fwd(img, zidx, yxidx, w, offsets)`` with
    gradients to ``img`` and ``w`` from one ``plane_sample_bwd`` launch
    (the JAX ``_weighted_plane_sample`` custom VJP)."""

    @staticmethod
    def forward(ctx, img, zidx, yxidx, w, offsets):
        ctx.save_for_backward(img, zidx, yxidx, w)
        ctx.offsets = tuple(offsets)
        return plane_sample_fwd(img, zidx, yxidx, w, ctx.offsets)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        img, zidx, yxidx, w = ctx.saved_tensors
        d_img, d_w = plane_sample_bwd(g.contiguous(), img, zidx, yxidx, w,
                                      ctx.offsets)
        return d_img, None, None, d_w, None
