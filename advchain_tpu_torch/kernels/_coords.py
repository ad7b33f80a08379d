"""The sampling grid's coordinate prep and the 3D corner folds, in PyTorch:
the arithmetic that the z-band grid kernels (``csrc/zband_sample.cu``,
``axis_prep`` / ``point_prep``) do in registers, and the body of their
plain versions in ``zband_sample``.  The ops routes that still fold on
the host (2D, the legacy 3D plane route) share the same coordinate prep.

Port of the coordinate and weight preparation in
advchain_tpu/kernels/gather_matmul.py: ``_grid_sample_3d_zband``
(:1866-1952) and the nearest wrappers (:1653-1754).

Clips are written ``minimum(maximum(x, lo), hi)``: at an exact bound that
passes half the gradient, as ``jnp.clip`` does, where ``torch.clamp``
passes all of it (base grid corners sit exactly on +-1).
"""

from __future__ import annotations

import torch

__all__ = ["clip", "prep_coord", "corner_weights_3d", "nearest_weights"]


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


def _reflect(coord, size: int, align_corners: bool, slope=None):
    """Reflect out-of-range pixel coordinates (torch reflect_coordinates).
    Returns the coordinate and, when ``slope`` is given, ``slope`` times
    d reflected / d coordinate (the sign of each mirror; 0 for one voxel
    with align_corners)."""
    if align_corners:
        low, high = 0.0, float(size - 1)
    else:
        low, high = -0.5, float(size) - 0.5
    span = high - low
    if span <= 0:
        zero = torch.zeros_like(coord)
        return zero, (None if slope is None else zero)
    # |.| written as a select: its gradient at 0 is 1, as jnp.abs's is
    # (torch.abs gives 0 there, and a grid on the border lands exactly on 0)
    x = coord - low
    if slope is not None:
        slope = torch.where(x >= 0, slope, -slope)
    x = torch.where(x >= 0, x, -x)
    x = torch.remainder(x, 2.0 * span)
    if slope is not None:
        slope = torch.where(x > span, -slope, slope)
    x = torch.where(x > span, 2.0 * span - x, x)
    return x + low, slope


def _clip_slope(v, lo: float, hi: float):
    """The factor ``clip(v, lo, hi)`` passes: 0.5 at each exact bound, as
    ``jnp.clip``'s subgradient."""
    a = torch.where(v > lo, 1.0, torch.where(v == lo, 0.5, 0.0))
    m = torch.clamp(v, min=lo)
    return a * torch.where(m < hi, 1.0, torch.where(m == hi, 0.5, 0.0))


def prep_coord(g, size: int, align_corners: bool, padding_mode: str,
                with_slope: bool = False):
    """Pixel-space coordinate, transformed per padding mode.  With
    ``with_slope``, also d coordinate / d unnormalised coordinate: the
    reflection's signs times the clip's factor (a power of two or 0), as
    the z-band backward kernel carries it."""
    hi = float(size - 1)
    ix = _unnormalize(g, size, align_corners)
    slope = torch.ones_like(ix) if with_slope else None
    if padding_mode == "reflection":
        ix, slope = _reflect(ix, size, align_corners, slope)
    elif padding_mode not in ("border", "zeros"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    if padding_mode != "zeros":
        if with_slope:
            slope = slope * _clip_slope(ix, 0.0, hi)
        ix = clip(ix, 0.0, hi)
    return (ix, slope) if with_slope else ix


def corner_weights_3d(grid, d: int, h: int, w: int,
                      padding_mode: str = "zeros",
                      align_corners: bool = True):
    """The z-band inputs for ``grid`` (N, Do, Ho, Wo, 3) over a D x H x W
    volume: base corners ``zidx``/``yidx``/``xidx`` (N, P) int32 and folded
    weights (N, 8, P) f32 in (dz, dy, dx) order, differentiable with
    respect to the grid (``_grid_sample_3d_zband``, :1866-1952)."""
    n = grid.shape[0]
    if grid.dim() != 5 or grid.shape[-1] != 3:
        raise ValueError(f"grid must be (N, Do, Ho, Wo, 3), got "
                         f"{tuple(grid.shape)}")
    p = grid[0, ..., 0].numel()
    gx = grid[..., 0].reshape(n, p)
    gy = grid[..., 1].reshape(n, p)
    gz = grid[..., 2].reshape(n, p)
    ix = prep_coord(gx, w, align_corners, padding_mode)
    iy = prep_coord(gy, h, align_corners, padding_mode)
    iz = prep_coord(gz, d, align_corners, padding_mode)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    z0 = torch.floor(iz)
    fx, fy, fz = ix - x0, iy - y0, iz - z0

    def inb(xi, yi, zi):
        if padding_mode == "zeros":
            return ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
                    & (zi >= 0) & (zi <= d - 1)).to(fx.dtype)
        return torch.ones_like(fx)

    x0c = clip(x0, 0, w - 1)
    y0c = clip(y0, 0, h - 1)
    z0c = clip(z0, 0, d - 1)
    # collapse indicators: does the clipped +1 tap differ from the base?
    dxf = clip(x0 + 1, 0, w - 1) - x0c
    dyf = clip(y0 + 1, 0, h - 1) - y0c
    dzf = clip(z0 + 1, 0, d - 1) - z0c

    wxs = (1 - fx, fx)
    wys = (1 - fy, fy)
    wzs = (1 - fz, fz)
    raw = {}
    for pz in (0, 1):
        for py in (0, 1):
            for px in (0, 1):
                raw[(pz, py, px)] = (wzs[pz] * wys[py] * wxs[px]
                                     * inb(x0 + px, y0 + py, z0 + pz))

    def fold(tap, corner, m):
        # tap-0 weight stays on corner 0; a collapsed +1 tap (m == 0)
        # folds onto the base corner
        if tap == 0:
            return 1.0 if corner == 0 else None
        return m if corner == 1 else (1 - m)

    corners = []
    for a in (0, 1):
        for b in (0, 1):
            for cc in (0, 1):
                acc = None
                for (pz, py, px), wv in raw.items():
                    factors = (fold(pz, a, dzf), fold(py, b, dyf),
                               fold(px, cc, dxf))
                    if any(f is None for f in factors):
                        continue
                    term = wv
                    for f in factors:
                        if not (isinstance(f, float) and f == 1.0):
                            term = term * f
                    acc = term if acc is None else acc + term
                corners.append(acc)
    # f32, as JAX's; a float64 grid keeps float64 (the plain twins' gradcheck)
    weights = torch.stack(corners, dim=1).to(
        torch.promote_types(grid.dtype, torch.float32))
    return (z0c.to(torch.int32).contiguous(),
            y0c.to(torch.int32).contiguous(),
            x0c.to(torch.int32).contiguous(), weights.contiguous())


def nearest_weights(grid, sizes, padding_mode: str = "zeros",
                    align_corners: bool = True):
    """Nearest-neighbour inputs for the corner kernels
    (``grid_sample_{2d,3d}_pallas_nearest``, :1653-1754): rounded
    (half-to-even, as ``jnp.round``) and clipped base corners (N, P) int32
    in (z,) y, x order, and weights (N, 2^d, P) with the zero-padding mask
    on corner 0 and 0 elsewhere.  Piecewise constant: no grid gradient."""
    n = grid.shape[0]
    dims = len(sizes)
    p = grid[0, ..., 0].numel()
    bases, w0 = [], None
    for axis, size in enumerate(sizes):
        g = grid[..., dims - 1 - axis].reshape(n, p)
        i_n = torch.round(prep_coord(g, size, align_corners, padding_mode))
        ok = (i_n >= 0) & (i_n <= size - 1)
        w0 = ok if w0 is None else w0 & ok
        bases.append(clip(i_n, 0, size - 1).to(torch.int32).contiguous())
    if padding_mode != "zeros":
        w0 = torch.ones_like(w0)
    w0 = w0.to(torch.float32)
    zero = torch.zeros_like(w0)
    weights = torch.stack([w0] + [zero] * (2 ** dims - 1), dim=1)
    return bases, weights.contiguous()
