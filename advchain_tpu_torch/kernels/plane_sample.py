"""Plane samplers: the CUDA kernels, their plain versions and the autograd
wrappers, one contract per route.

Replaces advchain_tpu/kernels/gather_matmul.py::corner_gather (:134, with
``_corner_gather_streamed`` :208), ::corner_scatter (:283, with
``_corner_scatter_resident`` :323 and ``_corner_scatter_chunk_major``
:373), ::plane_gather (:466) and ::plane_scatter (:603, with
``_plane_scatter_streamed`` :690), wired there by
``_weighted_corner_sample`` (:1466) and ``_weighted_plane_sample``
(:1435), and the coordinate prep and in-plane fold of
``_grid_sample_3d_pallas_packed`` (:1790-1863).  The kernels live in
``csrc/plane_sample.cu`` (which carries the design and bound note) and are
built by ``_build`` on first use.

Grid contract (``plane_grid_sample_*``, ``PlaneGridSample``, the 3D
trilinear route under ``ADVCHAIN_ZBAND=0``): ``img`` (N, C, D, H, W),
``grid`` (N, P, 3) normalised (x, y, z); ``padding_mode`` in {zeros,
border, reflection, edge}, ``align_corners``; ``out`` (N, C, P), and from
a cotangent ``g`` (N, C, P) the gradients ``d_img`` and ``d_grid``.  The
packed formulation: two clipped z planes, each with four folded in-plane
weights on offsets (0, 1, w, w+1), summed dz = 0 then 1.  ``edge`` is
border padding whose grid slope at an exact lower bound is ``lower_slope``
(a one-element f32 tensor on the image's device; None for 1), read by the
backward.  The kernels build the planes and fold the weights in registers,
one launch each way; the plain forward is ``_coords.plane_weights``
followed by the flat plane sum ``plane_sample_fwd_plain`` per z tap, and
the plain backward is the closed form the backward kernel computes, on
``plane_sample_bwd_plain``.  Those two twins are the body of the plain
versions, not a route of their own.

Flat contract (``corner_sample_*``, ``CornerSample``, the 2D route under
``ADVCHAIN_BAND_KERNEL=0``; and the plane twins): ``img`` (N, C, S) for
the corner pair or (N, C, D, HW) for the plane twins, ``idx`` / ``yxidx``
and ``zidx`` (N, P) int32, ``w`` (N, K, P) and ``offsets`` K <= 4
non-negative ints;
``out[n,c,p] = sum_k w[n,k,p] * img[n, c, (z,) idx + offsets[k]]``, where
a tap at or past the flat end (S, or HW within its plane) or on a plane
outside [0, D) reads zero and receives no gradient.  Unlike the band
contract this does not zero a tap that leaves its row: at the last column
the +1 tap is the next row's first pixel (the samplers give it weight 0,
so only the kernel-level ``d_w`` shows it).  The corner pair launches the
flat plane kernels with one plane and no z index.

The corner backward takes the raster width of its P points (``width``,
which must divide P; None: one row of P).  Its CUDA launch is chosen by
contract: K = 4 at the tap square ``(0, 1, o, o + 1)``, the 2D route's
bilinear calls, takes the corner tile kernel, which sums the taps of a
tile's points in shared memory before its global atomics; K < 4 (nearest's
one tap) and other offsets take the flat kernel.  Both are hand-written;
the width changes the tiling, not the result.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  ``LAUNCHES["corner"|"plane_grid"]["fwd"|"bwd"]`` count
kernel launches (and nothing else) per route, and
``LAUNCHES["corner_tile"]["bwd"]`` the corner tile kernel's, so a run can
show which route and kernel it went through.  ``LAUNCHES["plane"]`` stays
at 0: no route launches the flat kernels with a z index.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from advchain_tpu_torch._trace import to_device
from advchain_tpu_torch.kernels import _build, _coords, _corners

__all__ = ["CornerSample", "corner_sample_fwd", "corner_sample_bwd",
           "corner_sample_fwd_plain", "corner_sample_bwd_plain",
           "plane_sample_fwd_plain", "plane_sample_bwd_plain",
           "PlaneGridSample", "plane_grid_sample_fwd",
           "plane_grid_sample_bwd", "plane_grid_sample_fwd_plain",
           "plane_grid_sample_bwd_plain", "reset_launch_counts",
           "tile_offsets"]

MAX_TAPS = 4
# no route launches the flat kernels with a z index: "plane" stays at 0
# for cudabench/sut.py::launch_counts, which reads it
LAUNCHES = {"corner": {"fwd": 0, "bwd": 0}, "plane": {"fwd": 0, "bwd": 0},
            "plane_grid": {"fwd": 0, "bwd": 0}, "corner_tile": {"bwd": 0}}


def reset_launch_counts() -> None:
    for counts in LAUNCHES.values():
        for kind in counts:
            counts[kind] = 0


def _check_offsets(name: str, offsets, w):
    if not 1 <= len(offsets) <= MAX_TAPS or w.shape[1:2] != (len(offsets),):
        raise ValueError(f"{name}: 1-{MAX_TAPS} offsets, one per weight row; "
                         f"got {tuple(offsets)} for w {tuple(w.shape)}")
    if any(int(o) != o or not 0 <= o < 2 ** 31 for o in offsets):
        raise ValueError(f"{name}: offsets must be non-negative ints below "
                         f"2^31, got {tuple(offsets)}")


def _check_width(width, p: int):
    if width is not None and (int(width) != width or width < 1
                              or p % width):
        raise ValueError(f"corner_sample: width must be a positive int that "
                         f"divides P={p}, got {width!r}")


def tile_offsets(offsets) -> bool:
    """True for the bilinear tap square ``(0, 1, o, o + 1)``, o >= 1, which
    the corner tile backward takes."""
    return (len(offsets) == 4 and tuple(offsets[:2]) == (0, 1)
            and offsets[2] >= 1 and offsets[3] == offsets[2] + 1)


def _taps(zidx, yxidx, offsets, d: int, hw: int):
    """Flat tap index into each sample's (D*HW) block, (N, K, P) int64,
    and validity: ``0 <= yx + offsets[k] < HW`` and ``0 <= z < D``."""
    off = to_device(offsets, torch.int64, yxidx.device)
    yx = yxidx.long()[:, None, :] + off[None, :, None]
    valid = (yx >= 0) & (yx < hw)
    flat = yx
    if zidx is not None:
        z = zidx.long()[:, None, :]
        valid = valid & (z >= 0) & (z < d)
        flat = z * hw + yx
    return torch.where(valid, flat, torch.zeros_like(flat)), valid


# ------------------------------------------------------ plain versions
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
    """The plain grid forward's flat plane sum (see the module)."""
    return _corners.fwd_taps(img, *_taps(zidx, yxidx, offsets,
                                         *img.shape[2:]), w)


def plane_sample_bwd_plain(g, img, zidx, yxidx, w, offsets):
    """The plain grid backward's flat plane scatter."""
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
    lib.advchain_plane_grid_sample_fwd.argtypes = [ptr] * 3 + [i32] * 8 + [ptr]
    lib.advchain_plane_grid_sample_fwd.restype = i32
    lib.advchain_plane_grid_sample_bwd.argtypes = ([ptr] * 6 + [i32] * 8
                                                   + [ptr])
    lib.advchain_plane_grid_sample_bwd.restype = i32
    lib.advchain_corner_tile_sample_bwd.argtypes = ([ptr] * 6 + [i32] * 6
                                                    + [ptr])
    lib.advchain_corner_tile_sample_bwd.restype = i32
    return lib


def _shape(img, idx, offsets):
    """(n, c, d = 1, hw = S, p, k, four offsets) for the flat entry
    points: the corner pair is one plane with no z index."""
    n, c, s = img.shape
    offs = list(offsets) + [0] * (MAX_TAPS - len(offsets))
    return [n, c, 1, s, idx.shape[1], len(offsets), *offs]


def _fwd(img, idx, w, offsets):
    out = torch.empty(img.shape[0], img.shape[1], idx.shape[1],
                      dtype=img.dtype, device=img.device)
    _build.launch(_lib().advchain_plane_sample_fwd, img.device,
                  "corner_sample_fwd", img.data_ptr(), None, idx.data_ptr(),
                  w.data_ptr(), out.data_ptr(), *_shape(img, idx, offsets))
    LAUNCHES["corner"]["fwd"] += 1
    return out


def _bwd(g, img, idx, w, offsets):
    d_img = torch.zeros_like(img)
    d_w = torch.empty_like(w)
    _build.launch(_lib().advchain_plane_sample_bwd, img.device,
                  "corner_sample_bwd", g.data_ptr(), img.data_ptr(), None,
                  idx.data_ptr(), w.data_ptr(), d_img.data_ptr(),
                  d_w.data_ptr(), *_shape(img, idx, offsets))
    LAUNCHES["corner"]["bwd"] += 1
    return d_img, d_w


def _tile_bwd(g, img, idx, w, offsets, width):
    d_img = torch.zeros_like(img)
    d_w = torch.empty_like(w)
    n, c, s = img.shape
    p = idx.shape[1]
    _build.launch(_lib().advchain_corner_tile_sample_bwd, img.device,
                  "corner_tile_sample_bwd", g.data_ptr(), img.data_ptr(),
                  idx.data_ptr(), w.data_ptr(), d_img.data_ptr(),
                  d_w.data_ptr(), n, c, s, p,
                  max(p, 1) if width is None else int(width),
                  int(offsets[2]))
    LAUNCHES["corner_tile"]["bwd"] += 1
    return d_img, d_w


def corner_sample_fwd(img, idx, w, offsets):
    """Forward: ``out`` (N, C, P).  CPU tensors take the plain twin."""
    _check_offsets("corner_sample", offsets, w)
    if not _corners.check("corner_sample", img, (idx,), w,
                          taps=len(offsets)):
        return corner_sample_fwd_plain(img, idx, w, offsets)
    return _fwd(img, idx, w, offsets)


def corner_sample_bwd(g, img, idx, w, offsets, width=None):
    """Backward: ``(d_img (N, C, S), d_w (N, K, P))`` in one launch, after
    one zero fill: the corner tile kernel at the tap square (see
    :func:`tile_offsets`), else the flat kernel.  ``width``: the raster
    width of the P points (None: one row).  CPU tensors take the plain
    twin."""
    _check_offsets("corner_sample", offsets, w)
    _check_width(width, idx.shape[-1])
    if not _corners.check("corner_sample", img, (idx,), w, g,
                          taps=len(offsets)):
        return corner_sample_bwd_plain(g, img, idx, w, offsets)
    if tile_offsets(offsets):
        return _tile_bwd(g, img, idx, w, offsets, width)
    return _bwd(g, img, idx, w, offsets)


class CornerSample(torch.autograd.Function):
    """``out = corner_sample_fwd(img, idx, w, offsets)`` with gradients to
    ``img`` and ``w`` from one ``corner_sample_bwd`` launch (the JAX
    ``_weighted_corner_sample`` custom VJP); ``width``: the raster width of
    the P points, handed to the backward (None: one row).  The indices get
    no gradient."""

    @staticmethod
    def forward(ctx, img, idx, w, offsets, width=None):
        _check_width(width, idx.shape[-1])
        ctx.save_for_backward(img, idx, w)
        ctx.offsets = tuple(offsets)
        ctx.width = width
        return corner_sample_fwd(img, idx, w, ctx.offsets)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        img, idx, w = ctx.saved_tensors
        d_img, d_w = corner_sample_bwd(g.contiguous(), img, idx, w,
                                       ctx.offsets, ctx.width)
        return d_img, None, d_w, None, None


# ------------------------------------------------- grid contract: twins
def _plane_inputs(img, grid, padding_mode, align_corners):
    """The flat plane twins' ``(zidx, yxidx, weights, offsets)`` for
    ``grid`` (N, P, 3), and ``img`` viewed (N, C, D, HW)."""
    n, c, d, h, w = img.shape
    zidx, yxidx, weights = _coords.plane_weights(
        grid.reshape(n, grid.shape[1], 1, 1, 3), d, h, w, padding_mode,
        align_corners)
    return (img.reshape(n, c, d, h * w), zidx, yxidx, weights,
            (0, 1, w, w + 1))


def plane_grid_sample_fwd_plain(img, grid, padding_mode="zeros",
                                align_corners=True):
    """Plain PyTorch forward (any device, any float dtype):
    ``_coords.plane_weights``, then the flat plane sum of each z tap,
    summed dz = 0 then 1.  ``out`` (N, C, P)."""
    flat, zidx, yxidx, weights, offsets = _plane_inputs(
        img, grid, padding_mode, align_corners)
    return (plane_sample_fwd_plain(flat, zidx[0], yxidx, weights[0], offsets)
            + plane_sample_fwd_plain(flat, zidx[1], yxidx, weights[1],
                                     offsets))


def plane_grid_sample_bwd_plain(g, img, grid, padding_mode="zeros",
                                align_corners=True, lower_slope=None):
    """Plain PyTorch backward: ``(d_img (N, C, D, H, W), d_grid (N, P,
    3))``.  ``d_img`` and the folded weights' gradient ``d_w`` of each z tap
    come from the flat plane scatter; ``d_grid`` is the closed form of the
    backward kernel's ``plane_grid_grad``, in its order: each raw in-plane
    tap takes the ``d_w`` of the tap it folds onto (zero where zeros
    padding masks it), ``d_f = d_w1 - d_w0`` per axis through
    ``raw = ((wx * wy) * wz)``, then the axis slope and ``scale / 2``.
    ``lower_slope``: the ``edge`` padding's slope at an exact lower bound
    (None: 1)."""
    flat, zidx, yxidx, weights, offsets = _plane_inputs(
        img, grid, padding_mode, align_corners)
    d_img, d_w = 0, []
    for dz in (0, 1):
        d_img_dz, d_w_dz = plane_sample_bwd_plain(g, flat, zidx[dz], yxidx,
                                                  weights[dz], offsets)
        d_img = d_img + d_img_dz
        d_w.append(d_w_dz)
    d, h, w = img.shape[2:]
    ax, ay, az = (_coords.axis_terms(grid[..., i], size, align_corners,
                                     padding_mode, lower_slope)
                  for i, size in enumerate((w, h, d)))
    mask = (ay.m << 1) | ax.m
    dwx, dwy, dwz = [0, 0], [0, 0], [0, 0]
    for dz in (0, 1):
        for j in range(4):
            dy, dx = j >> 1, j & 1
            dr = torch.gather(d_w[dz], 1, (j & mask)[:, None])[:, 0]
            dr = torch.where(az.ins[dz] & ay.ins[dy] & ax.ins[dx], dr, 0.0)
            dwz[dz] = dwz[dz] + dr * (ax.w[dx] * ay.w[dy])
            drz = dr * az.w[dz]
            dwx[dx] = dwx[dx] + drz * ay.w[dy]
            dwy[dy] = dwy[dy] + drz * ax.w[dx]
    d_grid = torch.stack([(dw[1] - dw[0]) * a.slope * a.scale * 0.5
                          for dw, a in ((dwx, ax), (dwy, ay), (dwz, az))],
                         dim=-1)
    return d_img.reshape(img.shape), d_grid.to(grid.dtype)


# ----------------------------------------------- grid contract: kernels
def plane_grid_sample_fwd(img, grid, padding_mode="zeros",
                          align_corners=True):
    """Forward: ``out`` (N, C, P) in one launch.  CPU tensors take the plain
    twin."""
    if not _corners.check_grid("plane_grid_sample", img, grid, padding_mode,
                               "bilinear"):
        return plane_grid_sample_fwd_plain(img, grid, padding_mode,
                                           align_corners)
    (n, c, d, h, w), p = img.shape, grid.shape[1]
    out = torch.empty(n, c, p, dtype=img.dtype, device=img.device)
    padding, align, _ = _corners.grid_flags(padding_mode, align_corners,
                                            "bilinear")
    _build.launch(_lib().advchain_plane_grid_sample_fwd, img.device,
                  "plane_grid_sample_fwd", img.data_ptr(), grid.data_ptr(),
                  out.data_ptr(), n, c, d, h, w, p, padding, align)
    LAUNCHES["plane_grid"]["fwd"] += 1
    return out


def plane_grid_sample_bwd(g, img, grid, padding_mode="zeros",
                          align_corners=True, lower_slope=None):
    """Backward: ``(d_img (N, C, D, H, W), d_grid (N, P, 3))`` in one
    launch, after one zero fill.  CPU tensors take the plain twin."""
    if not _corners.check_grid("plane_grid_sample", img, grid, padding_mode,
                               "bilinear", g, lower_slope):
        return plane_grid_sample_bwd_plain(g, img, grid, padding_mode,
                                           align_corners, lower_slope)
    (n, c, d, h, w), p = img.shape, grid.shape[1]
    d_img = torch.zeros_like(img)
    d_grid = torch.empty_like(grid)
    padding, align, _ = _corners.grid_flags(padding_mode, align_corners,
                                            "bilinear")
    _build.launch(_lib().advchain_plane_grid_sample_bwd, img.device,
                  "plane_grid_sample_bwd", g.data_ptr(), img.data_ptr(),
                  grid.data_ptr(), d_img.data_ptr(), d_grid.data_ptr(),
                  None if lower_slope is None else lower_slope.data_ptr(),
                  n, c, d, h, w, p, padding, align)
    LAUNCHES["plane_grid"]["bwd"] += 1
    return d_img, d_grid


class PlaneGridSample(torch.autograd.Function):
    """``out = plane_grid_sample_fwd(img, grid, padding_mode,
    align_corners)`` with gradients to ``img`` and ``grid`` from one
    ``plane_grid_sample_bwd`` launch (``lower_slope``: the ``edge``
    padding's slope at an exact lower bound, None for 1).  Saves only
    ``(img, grid)`` and the slope: no planes, weights or their
    intermediates."""

    @staticmethod
    def forward(ctx, img, grid, padding_mode, align_corners,
                lower_slope=None):
        ctx.save_for_backward(img, grid)
        ctx.opts = (padding_mode, align_corners)
        ctx.lower_slope = lower_slope
        return plane_grid_sample_fwd(img, grid, *ctx.opts)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        img, grid = ctx.saved_tensors
        d_img, d_grid = plane_grid_sample_bwd(g.contiguous(), img, grid,
                                              *ctx.opts, ctx.lower_slope)
        return d_img, d_grid, None, None, None
