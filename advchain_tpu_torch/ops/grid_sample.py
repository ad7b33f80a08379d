"""Differentiable grid sampling with torch ``grid_sample`` semantics:
2D bilinear on the band grid kernel pair, 3D trilinear on the z-band grid
kernel pair, and nearest in both on the same kernels; and the 2D stencil
warp (bilinear, border padding, channel-first grid) on its own kernel pair.
The JAX package's switches select its legacy kernels, read here at call
time: ``ADVCHAIN_BAND_KERNEL=0`` sends 2D sampling (bilinear and nearest)
to the flat-index corner kernels, ``ADVCHAIN_ZBAND=0`` sends 3D trilinear
sampling to the plane grid kernels, JAX's packed formulation (3D nearest
stays on the z-band kernels, as in JAX).

Port of advchain_tpu/ops/grid_sample.py and of the coordinate and weight
preparation in kernels/gather_matmul.py: ``grid_sample_2d_pallas``
(:1584-1648), ``_grid_sample_3d_pallas_packed`` (:1790-1863),
``_grid_sample_3d_zband`` (:1866-1952) and the nearest wrappers
(:1653-1754).  2D and 3D sampling (bilinear or trilinear, and nearest)
hand the grid to the band and z-band grid kernels, which unnormalize, pad
and fold the corner weights in registers and return the grid's gradient
from their backward; the coordinate prep and the folds
(``corner_weights``, ``corner_weights_3d``, ``plane_weights``,
``nearest_weights``) live beside those kernels in ``kernels._coords``, the
body of their plain versions, and are re-exported here.  The 3D plane route
hands the grid to the plane grid kernels alike.  The legacy corner route
(2D) still unnormalizes and pads in PyTorch, folds the corner weights onto
the clipped base corner, and runs the gather and its transpose in
``kernels``, with the grid's gradient from autograd over the weight math,
as XLA differentiates it in JAX.  Nearest sampling gives the grid a zero
gradient.

Clips are written ``minimum(maximum(x, lo), hi)`` (``kernels._coords.clip``):
at an exact bound that passes half the gradient, as ``jnp.clip`` does,
where ``torch.clamp`` passes all of it (base grid corners sit exactly on
+-1).
"""

from __future__ import annotations

import os

import torch

from advchain_tpu_torch.kernels._coords import (clip, corner_weights,
                                                corner_weights_3d,
                                                nearest_weights,
                                                plane_weights)
from advchain_tpu_torch.kernels.band_sample import BandGridSample
from advchain_tpu_torch.kernels.plane_sample import (CornerSample,
                                                     PlaneGridSample)
from advchain_tpu_torch.kernels.stencil_warp import StencilWarp
from advchain_tpu_torch.kernels.zband_sample import ZBandGridSample

__all__ = ["grid_sample", "grid_sample_2d", "grid_sample_3d",
           "stencil_warp_2d", "corner_weights", "corner_weights_3d",
           "plane_weights", "nearest_weights", "clip"]


def _band_enabled() -> bool:
    """False when ``ADVCHAIN_BAND_KERNEL=0``: 2D sampling then takes the
    flat-index corner kernels (the JAX package's switch,
    gather_matmul.py:117-120, read here at call time)."""
    return os.environ.get("ADVCHAIN_BAND_KERNEL", "1") != "0"


def _zband_enabled() -> bool:
    """False when ``ADVCHAIN_ZBAND=0``: 3D trilinear sampling then takes
    the plane grid kernels (gather_matmul.py:1992-1996, read at call
    time)."""
    return os.environ.get("ADVCHAIN_ZBAND") != "0"


def _f32(t):
    """The kernels take contiguous f32 tensors.  A CUDA tensor goes to the
    kernel wrapper as it is, which refuses another dtype (a bf16 network
    output must be cast back before it is warped); on the CPU the plain
    version computes in f32."""
    return t.contiguous() if t.is_cuda else t.float().contiguous()


def grid_sample_2d(x, grid, mode: str = "bilinear",
                   padding_mode: str = "zeros", align_corners: bool = True,
                   tile_order: str = "rows"):
    """Sample ``x`` (N, C, H, W) at ``grid`` (N, Ho, Wo, 2);
    ``grid[..., 0]`` indexes W.  ``tile_order`` is a TPU tiling hint of the
    JAX package, accepted and ignored."""
    del tile_order
    n, c, h, w = x.shape
    if grid.shape[0] != n:
        raise ValueError(f"grid batch {grid.shape[0]} != image batch {n}")
    if mode not in ("bilinear", "nearest"):
        raise NotImplementedError(f"mode={mode!r}")
    xf = _f32(x)
    # JAX also sends an image whose band stack exceeds its 5 MiB VMEM
    # budget to the corner kernels (gather_matmul.py:1621-1627); the band
    # kernels here have no size limit, so only the switch selects them
    if _band_enabled():
        # one launch each way: the kernels read the grid and fold in
        # registers
        out = BandGridSample.apply(
            xf, _f32(grid.reshape(n, -1, 2)), padding_mode,
            align_corners, mode)
        return out.reshape(n, c, grid.shape[1], grid.shape[2]).to(x.dtype)
    if mode == "bilinear":
        yidx, xidx, weights = corner_weights(grid, h, w, padding_mode,
                                             align_corners)
        offsets = (0, 1, w, w + 1)
    else:
        (yidx, xidx), weights = nearest_weights(grid, (h, w), padding_mode,
                                                align_corners)
        offsets = (0,)  # one unit-weight tap (gather_matmul.py:1697-1704)
    # int32 index arithmetic, as JAX's (:1607); the wrapper rejects images
    # of 2^31 elements or more
    # the raster width lets the backward tile the points in 2D
    out = CornerSample.apply(xf.reshape(n, c, h * w), yidx * w + xidx,
                             _f32(weights[:, :len(offsets)]),
                             offsets, grid.shape[2])
    return out.reshape(n, c, grid.shape[1], grid.shape[2]).to(x.dtype)


def grid_sample_3d(x, grid, mode: str = "bilinear",
                   padding_mode: str = "zeros", align_corners: bool = True,
                   tile_order: str = "rows", lower_slope=None):
    """Sample ``x`` (N, C, D, H, W) at ``grid`` (N, Do, Ho, Wo, 3);
    ``grid[..., 0]`` indexes W, ``[..., 1]`` H and ``[..., 2]`` D
    (``mode="bilinear"`` is trilinear, as in torch).  ``tile_order`` is
    accepted and ignored.  ``padding_mode="edge"`` is border padding whose
    grid gradient at an exact lower bound is ``lower_slope`` (a one-element
    tensor on ``x``'s device; None for 1): the flow compositions'."""
    del tile_order
    n, c, d, h, w = x.shape
    if grid.shape[0] != n:
        raise ValueError(f"grid batch {grid.shape[0]} != image batch {n}")
    if mode == "bilinear" and not _zband_enabled():
        # JAX's packed formulation for every C: both z taps' planes, summed
        # dz = 0 then 1, one launch each way.  Its 4-base formulation, taken
        # when all channels' K=2 stack fits the TPU's VMEM budget, differs
        # from it only by f32 reassociation (:1997-2012).
        out = PlaneGridSample.apply(
            _f32(x), _f32(grid.reshape(n, -1, 3)), padding_mode,
            align_corners, lower_slope)
        return out.reshape((n, c) + tuple(grid.shape[1:4])).to(x.dtype)
    if mode not in ("bilinear", "nearest"):
        raise NotImplementedError(f"mode={mode!r}")
    # one launch each way: the kernels read the grid and fold in registers
    out = ZBandGridSample.apply(_f32(x), _f32(grid.reshape(n, -1, 3)),
                                padding_mode, align_corners, mode,
                                lower_slope)
    return out.reshape((n, c) + tuple(grid.shape[1:4])).to(x.dtype)


def stencil_warp_2d(img, grid, radius: int = 2, grid_layout: str = "last",
                    lower_slope=None):
    """Bilinear warp of ``img`` (N, C, H, W) with border padding and
    align_corners=True at a grid on the image's own H x W raster (port of
    advchain_tpu/ops/grid_sample.py::stencil_warp_2d, :197-392).

    ``grid_layout``: 'last' = (N, H, W, 2), the torch convention; 'first' =
    (N, 2, H, W), the channel-first flow that ``compose_flow`` passes
    without a transpose.  ``radius`` is accepted so the API matches and is
    ignored: the JAX stencil sums (2R+1)^2 taps of an R-pixel edge-padded
    frame, so its caller must keep every sample within R pixels, whereas
    the kernel reads clamped taps and is exact for any displacement.
    Gradients reach the image and the grid through the backward kernel
    (the JAX analytic VJP); autograd saves only ``(img, grid)``.  The grid
    gradient at an exact lower bound (an entry on -1) is the stencil's
    whole one-sided slope, as JAX's; ``lower_slope`` (a one-element tensor
    on the image's device, what ``compose_flow`` passes) scales it."""
    del radius
    if grid_layout == "last":
        grid = torch.movedim(grid, -1, 1)
    elif grid_layout != "first":
        raise ValueError(f"grid_layout must be 'last' or 'first', got "
                         f"{grid_layout!r}")
    out = StencilWarp.apply(_f32(img), _f32(grid), lower_slope)
    return out.to(img.dtype)


def grid_sample(x, grid, mode: str = "bilinear", padding_mode: str = "zeros",
                align_corners: bool = True, tile_order: str = "rows"):
    """Dispatch on rank: 4-D input -> 2D sampler, 5-D input -> 3D."""
    if x.dim() == 4:
        return grid_sample_2d(x, grid, mode, padding_mode, align_corners,
                              tile_order=tile_order)
    if x.dim() == 5:
        return grid_sample_3d(x, grid, mode, padding_mode, align_corners,
                              tile_order=tile_order)
    raise ValueError(f"grid_sample expects 4-D or 5-D input, got "
                     f"{x.dim()}-D")
