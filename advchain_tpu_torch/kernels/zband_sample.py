"""Trilinear sampler: the CUDA kernels, their plain twins and the autograd
wrappers, on two contracts.

Replaces advchain_tpu/kernels/gather_matmul.py::zband_gather (:1081) and
::zband_scatter (:1230), wired there by ``_weighted_zband_sample`` (:1379)
with ``_wzs_fwd`` / ``_wzs_bwd``, and the coordinate prep and corner fold
of ``_grid_sample_3d_zband`` (:1866-1952) and
``grid_sample_3d_pallas_nearest`` (:1713).  The kernels live in
``csrc/zband_sample.cu`` (which carries the design and bound note) and are
built by ``_build`` on first use.

Grid contract (``zband_grid_sample_*``, ``ZBandGridSample``, the default 3D
route): ``img`` (N, C, D, H, W), ``grid`` (N, P, 3) normalised (x, y, z);
``padding_mode`` in {zeros, border, reflection, edge}, ``align_corners``,
``mode`` in {bilinear, nearest}; ``out`` (N, C, P), and from a cotangent
``g`` (N, C, P) the gradients ``d_img`` and ``d_grid`` (zero in nearest
mode).  ``edge`` is border padding whose grid slope at an exact lower bound
is ``lower_slope`` (a one-element f32 tensor on the image's device, the
flow compositions' dispatch slope; None for 1), read by the backward.
The kernels fold the corner weights in registers; the plain forward is
``_coords.corner_weights_3d`` (or ``nearest_weights``) followed by the
corner contract's plain forward, and the plain backward is the closed form
the backward kernel computes, on ``_coords``' coordinate prep.

Corner contract (``zband_sample_*``, ``ZBandSample``): ``img``
(N, C, D, H, W), ``zidx``/``yidx``/``xidx`` (N, P) int32 base corners,
``w`` (N, 8, P) in (dz, dy, dx) binary corner order (k = 4*dz + 2*dy + dx);
``out[n,c,p] = sum_k w[n,k,p] * img[n, c, z+dz_k, y+dy_k, x+dx_k]``, where
a tap outside the volume reads zero and receives no gradient.

Dispatch: a CPU tensor takes the plain twin; a CUDA tensor launches the
kernel or raises.  ``FWD_LAUNCHES`` / ``BWD_LAUNCHES`` (corner contract) and
``GRID_FWD_LAUNCHES`` / ``GRID_BWD_LAUNCHES`` (grid contract) count kernel
launches and nothing else, so a run can show it went through the kernels.
The JAX package's ``tile_order`` and channel groups are TPU tiling choices
with no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
import torch

from advchain_tpu_torch.kernels import _build, _coords, _corners

__all__ = ["ZBandSample", "zband_sample_fwd", "zband_sample_bwd",
           "zband_sample_fwd_plain", "zband_sample_bwd_plain",
           "ZBandGridSample", "zband_grid_sample_fwd",
           "zband_grid_sample_bwd", "zband_grid_sample_fwd_plain",
           "zband_grid_sample_bwd_plain", "reset_launch_counts"]

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0
GRID_FWD_LAUNCHES = 0
GRID_BWD_LAUNCHES = 0
PADDING_MODES = _corners.PADDING_MODES
MODES = _corners.MODES


def reset_launch_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES, GRID_FWD_LAUNCHES, GRID_BWD_LAUNCHES
    FWD_LAUNCHES = BWD_LAUNCHES = 0
    GRID_FWD_LAUNCHES = GRID_BWD_LAUNCHES = 0


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
    lib.advchain_zband_grid_sample_fwd.argtypes = [ptr] * 3 + [i32] * 9 + [ptr]
    lib.advchain_zband_grid_sample_fwd.restype = i32
    lib.advchain_zband_grid_sample_bwd.argtypes = [ptr] * 6 + [i32] * 9 + [ptr]
    lib.advchain_zband_grid_sample_bwd.restype = i32
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


# ------------------------------------------------- grid contract: twins
def _corner_inputs(img, grid, padding_mode, align_corners, mode):
    """The corner contract's ``(zidx, yidx, xidx, w)`` for ``grid``
    (N, P, 3): ``corner_weights_3d`` or ``nearest_weights``."""
    d, h, w = img.shape[2:]
    vol = grid.reshape(grid.shape[0], grid.shape[1], 1, 1, 3)
    if mode == "nearest":
        idx, weights = _coords.nearest_weights(vol, (d, h, w), padding_mode,
                                               align_corners)
        return (*idx, weights)
    return _coords.corner_weights_3d(vol, d, h, w, padding_mode,
                                     align_corners)


def zband_grid_sample_fwd_plain(img, grid, padding_mode="zeros",
                                align_corners=True, mode="bilinear"):
    """Plain PyTorch forward (any device, any float dtype): the fold of
    ``_coords.corner_weights_3d`` (or ``nearest_weights``), then
    the corner contract's plain forward.  ``out`` (N, C, P)."""
    return zband_sample_fwd_plain(
        img, *_corner_inputs(img, grid, padding_mode, align_corners, mode))


def zband_grid_sample_bwd_plain(g, img, grid, padding_mode="zeros",
                                align_corners=True, mode="bilinear",
                                lower_slope=None):
    """Plain PyTorch backward: ``(d_img (N, C, D, H, W), d_grid (N, P,
    3))``.  ``d_img`` and the folded weights' gradient ``d_w`` come from the
    corner contract's plain backward; ``d_grid`` is the closed form of the
    backward kernel's ``grid_grad``, in its order: each raw tap takes the
    ``d_w`` of the corner it folds onto (zero where zeros padding masks
    it), ``d_f = d_w1 - d_w0`` per axis through ``raw = ((wz * wy) * wx)``,
    then the axis slope and ``scale / 2``.  Zero in nearest mode.
    ``lower_slope``: the ``edge`` padding's slope at an exact lower bound
    (None: 1)."""
    zidx, yidx, xidx, w = _corner_inputs(img, grid, padding_mode,
                                         align_corners, mode)
    d_img, d_w = zband_sample_bwd_plain(g, img, zidx, yidx, xidx, w)
    if mode == "nearest":
        return d_img, torch.zeros_like(grid)
    d, h, wd = img.shape[2:]
    ax, ay, az = (_coords.axis_terms(grid[..., i], size, align_corners,
                                     padding_mode, lower_slope)
                  for i, size in enumerate((wd, h, d)))
    mask = (az.m << 2) | (ay.m << 1) | ax.m
    dwx, dwy, dwz = [0, 0], [0, 0], [0, 0]
    for j in range(8):
        dz, dy, dx = j >> 2, (j >> 1) & 1, j & 1
        dr = torch.gather(d_w, 1, (j & mask)[:, None])[:, 0]
        dr = torch.where(az.ins[dz] & ay.ins[dy] & ax.ins[dx], dr, 0.0)
        dwx[dx] = dwx[dx] + dr * (az.w[dz] * ay.w[dy])
        drx = dr * ax.w[dx]
        dwy[dy] = dwy[dy] + drx * az.w[dz]
        dwz[dz] = dwz[dz] + drx * ay.w[dy]
    d_grid = torch.stack([(dw[1] - dw[0]) * a.slope * a.scale * 0.5
                          for dw, a in ((dwx, ax), (dwy, ay), (dwz, az))],
                         dim=-1)
    return d_img, d_grid.to(grid.dtype)


# ----------------------------------------------- grid contract: kernels
def zband_grid_sample_fwd(img, grid, padding_mode="zeros",
                          align_corners=True, mode="bilinear"):
    """Forward: ``out`` (N, C, P) in one launch.  CPU tensors take the plain
    twin."""
    global GRID_FWD_LAUNCHES
    if not _corners.check_grid("zband_grid_sample", img, grid, padding_mode,
                               mode):
        return zband_grid_sample_fwd_plain(img, grid, padding_mode,
                                           align_corners, mode)
    (n, c, d, h, w), p = img.shape, grid.shape[1]
    out = torch.empty(n, c, p, dtype=img.dtype, device=img.device)
    with torch.cuda.device(img.device):
        err = _lib().advchain_zband_grid_sample_fwd(
            img.data_ptr(), grid.data_ptr(), out.data_ptr(), n, c, d, h, w,
            p, *_corners.grid_flags(padding_mode, align_corners, mode),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"zband_grid_sample_fwd launch failed: CUDA error "
                           f"{err}")
    GRID_FWD_LAUNCHES += 1
    return out


def zband_grid_sample_bwd(g, img, grid, padding_mode="zeros",
                          align_corners=True, mode="bilinear",
                          lower_slope=None):
    """Backward: ``(d_img (N, C, D, H, W), d_grid (N, P, 3))`` in one
    launch.  CPU tensors take the plain twin."""
    global GRID_BWD_LAUNCHES
    if not _corners.check_grid("zband_grid_sample", img, grid, padding_mode,
                               mode, g, lower_slope):
        return zband_grid_sample_bwd_plain(g, img, grid, padding_mode,
                                           align_corners, mode, lower_slope)
    (n, c, d, h, w), p = img.shape, grid.shape[1]
    d_img = torch.zeros_like(img)
    d_grid = torch.empty_like(grid)
    with torch.cuda.device(img.device):
        err = _lib().advchain_zband_grid_sample_bwd(
            g.data_ptr(), img.data_ptr(), grid.data_ptr(), d_img.data_ptr(),
            d_grid.data_ptr(),
            None if lower_slope is None else lower_slope.data_ptr(),
            n, c, d, h, w, p,
            *_corners.grid_flags(padding_mode, align_corners, mode),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"zband_grid_sample_bwd launch failed: CUDA error "
                           f"{err}")
    GRID_BWD_LAUNCHES += 1
    return d_img, d_grid


class ZBandGridSample(torch.autograd.Function):
    """``out = zband_grid_sample_fwd(img, grid, padding_mode, align_corners,
    mode)`` with gradients to ``img`` and ``grid`` from one
    ``zband_grid_sample_bwd`` launch (``lower_slope``: the ``edge``
    padding's slope at an exact lower bound, None for 1).  Saves only
    ``(img, grid)`` and the slope: no folded weights or their
    intermediates."""

    @staticmethod
    def forward(ctx, img, grid, padding_mode, align_corners, mode,
                lower_slope=None):
        ctx.save_for_backward(img, grid)
        ctx.opts = (padding_mode, align_corners, mode)
        ctx.lower_slope = lower_slope
        return zband_grid_sample_fwd(img, grid, *ctx.opts)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        img, grid = ctx.saved_tensors
        d_img, d_grid = zband_grid_sample_bwd(g.contiguous(), img, grid,
                                              *ctx.opts, ctx.lower_slope)
        return d_img, d_grid, None, None, None, None
