"""Bilinear sampler: the grid-level CUDA pair, its plain versions and the
autograd wrapper.

Replaces advchain_tpu/kernels/gather_matmul.py::band_gather (:839) and
::band_scatter (:923), wired there by ``_weighted_band_sample`` (:1407) with
``_wbs_fwd`` / ``_wbs_bwd``, and the coordinate prep and corner fold of
``grid_sample_2d_pallas`` (:1584-1648) and
``grid_sample_2d_pallas_nearest`` (:1653).  The kernels live in
``csrc/band_sample.cu`` (which carries the design and bound note) and are
built by ``_build`` on first use.

Contract (``band_grid_sample_*``, ``BandGridSample``, the default 2D
route): ``img`` (N, C, H, W), ``grid`` (N, P, 2) normalised (x, y);
``padding_mode`` in {zeros, border, reflection}, ``align_corners``, ``mode``
in {bilinear, nearest}; ``out`` (N, C, P), and from a cotangent ``g``
(N, C, P) the gradients ``d_img`` and ``d_grid`` (zero in nearest mode).
The kernels fold the corner weights in registers.  The plain forward is
``_coords.corner_weights`` (or ``nearest_weights``) followed by the corner
sum ``band_sample_fwd_plain``, and the plain backward is the closed form
the backward kernel computes, on ``_coords``' coordinate prep and
``band_sample_bwd_plain``.  Those two twins take the folded corners:
``yidx``/``xidx`` (N, P) int32 base corners, ``w`` (N, 4, P) in corner
order (0,0) (0,1) (1,0) (1,1);
``out[n,c,p] = sum_k w[n,k,p] * img[n, c, y+dy_k, x+dx_k]``, where a tap
outside the image reads zero and receives no gradient.  They are the body
of the plain versions, not a route of their own.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  ``GRID_FWD_LAUNCHES`` / ``GRID_BWD_LAUNCHES`` count
kernel launches and nothing else, so a run can show it went through the
kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from advchain_tpu_torch.kernels import _build, _coords, _corners

__all__ = ["band_sample_fwd_plain", "band_sample_bwd_plain",
           "BandGridSample", "band_grid_sample_fwd",
           "band_grid_sample_bwd", "band_grid_sample_fwd_plain",
           "band_grid_sample_bwd_plain", "reset_launch_counts"]

# no kernel counts FWD_LAUNCHES / BWD_LAUNCHES: they stay at 0 for
# cudabench/sut.py::launch_counts, which reads them
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


# ------------------------------------------------------ plain versions
def band_sample_fwd_plain(img, yidx, xidx, w):
    """The plain forward's corner sum (any device, any float dtype): gather
    the four corners, then sum k = 0..3 in order, as the forward kernel
    does."""
    return _corners.fwd_plain(img, (yidx, xidx), w)


def band_sample_bwd_plain(g, img, yidx, xidx, w):
    """The plain backward's corner scatter: ``d_w[n,k,p] = sum_c g * v_k``
    and ``d_img`` += ``w_k * g`` at each valid tap (deterministic)."""
    return _corners.bwd_plain(g, img, (yidx, xidx), w)


def _corner_inputs(img, grid, padding_mode, align_corners, mode):
    """The folded corners ``(yidx, xidx, w)`` for ``grid`` (N, P, 2):
    ``corner_weights`` or ``nearest_weights``."""
    h, w = img.shape[2:]
    plane = grid.reshape(grid.shape[0], grid.shape[1], 1, 2)
    if mode == "nearest":
        idx, weights = _coords.nearest_weights(plane, (h, w), padding_mode,
                                               align_corners)
        return (*idx, weights)
    return _coords.corner_weights(plane, h, w, padding_mode, align_corners)


def band_grid_sample_fwd_plain(img, grid, padding_mode="zeros",
                               align_corners=True, mode="bilinear"):
    """Plain PyTorch forward (any device, any float dtype): the fold of
    ``_coords.corner_weights`` (or ``nearest_weights``), then the corner
    sum :func:`band_sample_fwd_plain`.  ``out`` (N, C, P)."""
    return band_sample_fwd_plain(
        img, *_corner_inputs(img, grid, padding_mode, align_corners, mode))


def band_grid_sample_bwd_plain(g, img, grid, padding_mode="zeros",
                               align_corners=True, mode="bilinear"):
    """Plain PyTorch backward: ``(d_img (N, C, H, W), d_grid (N, P, 2))``.
    ``d_img`` and the folded weights' gradient ``d_w`` come from
    :func:`band_sample_bwd_plain`; ``d_grid`` is the closed form of the
    backward kernel's ``grid_grad``, in its order: each raw tap takes the
    ``d_w`` of the corner it folds onto (zero where zeros padding masks
    it), ``d_f = d_w1 - d_w0`` per axis through ``raw = (wx * wy)``, then
    the axis slope and ``scale / 2``.  Zero in nearest mode."""
    yidx, xidx, w = _corner_inputs(img, grid, padding_mode, align_corners,
                                   mode)
    d_img, d_w = band_sample_bwd_plain(g, img, yidx, xidx, w)
    if mode == "nearest":
        return d_img, torch.zeros_like(grid)
    h, wd = img.shape[2:]
    ax, ay = (_coords.axis_terms(grid[..., i], size, align_corners,
                                 padding_mode)
              for i, size in enumerate((wd, h)))
    mask = (ay.m << 1) | ax.m
    dwx, dwy = [0, 0], [0, 0]
    for j in range(4):
        dy, dx = j >> 1, j & 1
        dr = torch.gather(d_w, 1, (j & mask)[:, None])[:, 0]
        dr = torch.where(ay.ins[dy] & ax.ins[dx], dr, 0.0)
        dwx[dx] = dwx[dx] + dr * ay.w[dy]
        dwy[dy] = dwy[dy] + dr * ax.w[dx]
    d_grid = torch.stack([(dw[1] - dw[0]) * a.slope * a.scale * 0.5
                          for dw, a in ((dwx, ax), (dwy, ay))], dim=-1)
    return d_img, d_grid.to(grid.dtype)


# ---------------------------------------------------------------- kernels
@functools.cache
def _lib():
    lib = _build.load("band_sample")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.advchain_band_grid_sample_fwd.argtypes = [ptr] * 3 + [i32] * 8 + [ptr]
    lib.advchain_band_grid_sample_fwd.restype = i32
    lib.advchain_band_grid_sample_bwd.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
    lib.advchain_band_grid_sample_bwd.restype = i32
    return lib


def band_grid_sample_fwd(img, grid, padding_mode="zeros", align_corners=True,
                         mode="bilinear"):
    """Forward: ``out`` (N, C, P) in one launch.  CPU tensors take the plain
    twin."""
    global GRID_FWD_LAUNCHES
    if not _corners.check_grid("band_grid_sample", img, grid, padding_mode,
                               mode):
        return band_grid_sample_fwd_plain(img, grid, padding_mode,
                                          align_corners, mode)
    (n, c, h, w), p = img.shape, grid.shape[1]
    _check_batch(n)
    out = torch.empty(n, c, p, dtype=img.dtype, device=img.device)
    _build.launch(_lib().advchain_band_grid_sample_fwd, img.device,
                  "band_grid_sample_fwd", img.data_ptr(), grid.data_ptr(),
                  out.data_ptr(), n, c, h, w, p,
                  *_corners.grid_flags(padding_mode, align_corners, mode))
    GRID_FWD_LAUNCHES += 1
    return out


def band_grid_sample_bwd(g, img, grid, padding_mode="zeros",
                         align_corners=True, mode="bilinear"):
    """Backward: ``(d_img (N, C, H, W), d_grid (N, P, 2))`` in one launch.
    CPU tensors take the plain twin."""
    global GRID_BWD_LAUNCHES
    if not _corners.check_grid("band_grid_sample", img, grid, padding_mode,
                               mode, g):
        return band_grid_sample_bwd_plain(g, img, grid, padding_mode,
                                          align_corners, mode)
    (n, c, h, w), p = img.shape, grid.shape[1]
    _check_batch(n)
    d_img = torch.zeros_like(img)
    d_grid = torch.empty_like(grid)
    _build.launch(_lib().advchain_band_grid_sample_bwd, img.device,
                  "band_grid_sample_bwd", g.data_ptr(), img.data_ptr(),
                  grid.data_ptr(), d_img.data_ptr(), d_grid.data_ptr(), n, c,
                  h, w, p,
                  *_corners.grid_flags(padding_mode, align_corners, mode))
    GRID_BWD_LAUNCHES += 1
    return d_img, d_grid


def _check_batch(n):
    # the kernels put the batch on the launch grid's y dimension
    if n > 65535:
        raise ValueError(f"band_grid_sample takes at most 65535 images a "
                         f"call, got {n}")


class BandGridSample(torch.autograd.Function):
    """``out = band_grid_sample_fwd(img, grid, padding_mode, align_corners,
    mode)`` with gradients to ``img`` and ``grid`` from one
    ``band_grid_sample_bwd`` launch.  Saves only ``(img, grid)``: no
    folded weights or their intermediates."""

    @staticmethod
    def forward(ctx, img, grid, padding_mode, align_corners, mode):
        ctx.save_for_backward(img, grid)
        ctx.opts = (padding_mode, align_corners, mode)
        return band_grid_sample_fwd(img, grid, *ctx.opts)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        img, grid = ctx.saved_tensors
        d_img, d_grid = band_grid_sample_bwd(g.contiguous(), img, grid,
                                             *ctx.opts)
        return d_img, d_grid, None, None, None
