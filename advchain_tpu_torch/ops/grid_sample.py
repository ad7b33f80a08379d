"""Differentiable 2D bilinear grid sampling with torch ``grid_sample``
semantics, on the band-sample kernel pair.

Port of advchain_tpu/ops/grid_sample.py (2D) and of the coordinate and
weight preparation in kernels/gather_matmul.py::grid_sample_2d_pallas
(:1584-1619): coordinates are unnormalized and padded in PyTorch, the
corner weights are folded onto the clipped base corner, and the gather and
its transpose run in ``kernels.band_sample``.  Gradients flow to the image
(the scatter kernel) and to the grid (autograd over the weight math here,
as XLA differentiates it in JAX).

Clips are written ``minimum(maximum(x, lo), hi)``: at an exact bound that
passes half the gradient, as ``jnp.clip`` does, where ``torch.clamp``
passes all of it (base grid corners sit exactly on +-1).
"""

from __future__ import annotations

import torch

from advchain_tpu_torch.kernels.band_sample import BandSample

__all__ = ["grid_sample", "grid_sample_2d", "corner_weights", "clip"]


def clip(x, lo, hi):
    """``jnp.clip`` with its subgradient: 0.5 at an exact bound."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def _unnormalize(coord, size: int, align_corners: bool):
    """[-1, 1] -> pixel coordinate, torch grid_sampler convention."""
    size = float(size)
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1.0)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(coord, size: int, align_corners: bool):
    """Reflect out-of-range pixel coordinates (torch reflect_coordinates)."""
    if align_corners:
        low, high = 0.0, float(size - 1)
    else:
        low, high = -0.5, float(size) - 0.5
    span = high - low
    if span <= 0:
        return torch.zeros_like(coord)
    # |.| written as a select: its gradient at 0 is 1, as jnp.abs's is
    # (torch.abs gives 0 there, and a grid on the border lands exactly on 0)
    x = coord - low
    x = torch.where(x >= 0, x, -x)
    x = torch.remainder(x, 2.0 * span)
    x = torch.where(x > span, 2.0 * span - x, x)
    return x + low


def _prep_coord(g, size: int, align_corners: bool, padding_mode: str):
    """Pixel-space coordinate, transformed per padding mode."""
    ix = _unnormalize(g, size, align_corners)
    if padding_mode == "reflection":
        ix = clip(_reflect(ix, size, align_corners), 0.0, float(size - 1))
    elif padding_mode == "border":
        ix = clip(ix, 0.0, float(size - 1))
    elif padding_mode != "zeros":
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    return ix


def corner_weights(grid, h: int, w: int, padding_mode: str = "zeros",
                   align_corners: bool = True):
    """The band-sample inputs for ``grid`` (N, Ho, Wo, 2) over an H x W
    image: base corners ``yidx``/``xidx`` (N, P) int32 and folded weights
    (N, 4, P) f32, differentiable with respect to the grid."""
    n, ho, wo, two = grid.shape
    if two != 2:
        raise ValueError(f"grid must be (N, Ho, Wo, 2), got "
                         f"{tuple(grid.shape)}")
    gx = grid[..., 0].reshape(n, ho * wo)
    gy = grid[..., 1].reshape(n, ho * wo)
    ix = _prep_coord(gx, w, align_corners, padding_mode)
    iy = _prep_coord(gy, h, align_corners, padding_mode)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    fx = ix - x0
    fy = iy - y0

    def inb(xi, yi):
        if padding_mode == "zeros":
            return ((xi >= 0) & (xi <= w - 1) & (yi >= 0)
                    & (yi <= h - 1)).to(fx.dtype)
        return torch.ones_like(fx)

    # corner taps use CLIPPED coordinates; offsets from the clipped base are
    # 0/1 per axis, so a tap whose clipped coordinate collapses onto the base
    # folds its weight into the base tap's
    x0c = clip(x0, 0, w - 1)
    y0c = clip(y0, 0, h - 1)
    dxf = clip(x0 + 1, 0, w - 1) - x0c  # 0.0 or 1.0
    dyf = clip(y0 + 1, 0, h - 1) - y0c

    w00 = (1 - fx) * (1 - fy) * inb(x0, y0)
    w01 = fx * (1 - fy) * inb(x0 + 1, y0)
    w10 = (1 - fx) * fy * inb(x0, y0 + 1)
    w11 = fx * fy * inb(x0 + 1, y0 + 1)
    cw00 = w00 + w01 * (1 - dxf) + w10 * (1 - dyf) \
        + w11 * (1 - dxf) * (1 - dyf)
    cw01 = w01 * dxf + w11 * dxf * (1 - dyf)
    cw10 = w10 * dyf + w11 * (1 - dxf) * dyf
    cw11 = w11 * dxf * dyf
    weights = torch.stack([cw00, cw01, cw10, cw11], dim=1).float()
    return (y0c.to(torch.int32).contiguous(), x0c.to(torch.int32).contiguous(),
            weights.contiguous())


def grid_sample_2d(x, grid, mode: str = "bilinear",
                   padding_mode: str = "zeros", align_corners: bool = True,
                   tile_order: str = "rows"):
    """Sample ``x`` (N, C, H, W) at ``grid`` (N, Ho, Wo, 2);
    ``grid[..., 0]`` indexes W.  ``tile_order`` is a TPU tiling hint of the
    JAX package, accepted and ignored."""
    del tile_order
    if mode == "nearest":
        raise NotImplementedError("nearest sampling is not ported yet")
    if mode != "bilinear":
        raise NotImplementedError(f"mode={mode!r}")
    n, c, h, w = x.shape
    if grid.shape[0] != n:
        raise ValueError(f"grid batch {grid.shape[0]} != image batch {n}")
    yidx, xidx, weights = corner_weights(grid, h, w, padding_mode,
                                         align_corners)
    out = BandSample.apply(x.float().contiguous(), yidx, xidx, weights)
    return out.reshape(n, c, grid.shape[1], grid.shape[2]).to(x.dtype)


def grid_sample(x, grid, mode: str = "bilinear", padding_mode: str = "zeros",
                align_corners: bool = True, tile_order: str = "rows"):
    """Rank dispatch; only 4-D (2D) inputs are ported so far."""
    if x.dim() == 4:
        return grid_sample_2d(x, grid, mode, padding_mode, align_corners,
                              tile_order=tile_order)
    if x.dim() == 5:
        raise NotImplementedError("3D grid sampling is not ported yet")
    raise ValueError(f"grid_sample expects 4-D or 5-D input, got "
                     f"{x.dim()}-D")
