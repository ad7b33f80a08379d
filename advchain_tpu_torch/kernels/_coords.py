"""The sampling grid's coordinate prep and the 2D and 3D corner folds, in
PyTorch: the arithmetic that the grid-level kernels
(``csrc/grid_coords.cuh``'s ``axis_prep``, ``point_prep`` in
``csrc/band_sample.cu`` and ``csrc/zband_sample.cu``) do in registers, the
body of their plain versions in ``band_sample`` and ``zband_sample``, and
the per-axis terms of their closed-form backward.  The legacy routes that
still fold on the host (the 2D corner route, the 3D plane route) share the
same coordinate prep and folds.

Port of the coordinate and weight preparation in
advchain_tpu/kernels/gather_matmul.py: ``grid_sample_2d_pallas``
(:1584-1648), ``_grid_sample_3d_zband`` (:1866-1952) and the nearest
wrappers (:1653-1754).

Clips are written ``minimum(maximum(x, lo), hi)``: at an exact bound that
passes half the gradient, as ``jnp.clip`` does, where ``torch.clamp``
passes all of it (base grid corners sit exactly on +-1).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["clip", "prep_coord", "axis_terms", "corner_weights", "fold_2d",
           "corner_weights_3d", "nearest_weights"]


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


def _lower(lower_slope):
    """The ``edge`` padding's slope at an exact lower bound: 1 (the
    edge-padded stencil's one-sided difference) for None, else the first
    value of the tensor (the flow compositions' dispatch slope)."""
    return 1.0 if lower_slope is None else lower_slope.reshape(-1)[0]


def _clip_slope(v, lo: float, hi: float, lo_tie=0.5):
    """The factor ``clip(v, lo, hi)`` passes: ``lo_tie`` at an exact lower
    bound (``jnp.clip``'s subgradient, 0.5, unless given) and 0.5 at the
    upper."""
    a = torch.where(v > lo, 1.0, torch.where(v == lo, lo_tie, 0.0))
    m = torch.clamp(v, min=lo)
    return a * torch.where(m < hi, 1.0, torch.where(m == hi, 0.5, 0.0))


def prep_coord(g, size: int, align_corners: bool, padding_mode: str,
                with_slope: bool = False, lower_slope=None):
    """Pixel-space coordinate, transformed per padding mode.  With
    ``with_slope``, also d coordinate / d unnormalised coordinate: the
    reflection's signs times the clip's factor (a power of two or 0), as
    the grid kernels carry it.  ``padding_mode="edge"`` is border padding
    whose slope at an exact lower bound is ``lower_slope`` (a one-element
    tensor; None for 1, the edge-padded stencil's one-sided difference):
    the 3D flow compositions pass the JAX package's dispatch slope, 1 where
    it takes its stencil and 0.5 where it takes its sampler.  Its
    coordinate is border padding's; autograd passes the same slope."""
    hi = float(size - 1)
    ix = _unnormalize(g, size, align_corners)
    slope = torch.ones_like(ix) if with_slope else None
    if padding_mode == "reflection":
        ix, slope = _reflect(ix, size, align_corners, slope)
    elif padding_mode not in ("border", "zeros", "edge"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    if padding_mode != "zeros":
        lo_tie = _lower(lower_slope) if padding_mode == "edge" else 0.5
        if with_slope:
            slope = slope * _clip_slope(ix, 0.0, hi, lo_tie)
        if padding_mode == "edge":
            # the clip's value; autograd passes lo_tie at 0 (lo_tie * 0 is
            # the value there)
            ix = torch.where(ix > 0, torch.minimum(
                ix, torch.as_tensor(hi, dtype=ix.dtype, device=ix.device)),
                torch.where(ix == 0, ix * lo_tie, torch.zeros_like(ix)))
        else:
            ix = clip(ix, 0.0, hi)
    return (ix, slope) if with_slope else ix


class AxisTerms(NamedTuple):
    """One axis of a grid kernel's coordinate prep (:func:`axis_terms`)."""
    w: tuple        # hat weights (1 - f, f)
    m: torch.Tensor  # int64 1 where the clipped +1 tap differs from the base
    ins: tuple      # zeros padding: unclipped taps x0, x0 + 1 in [0, S-1]
    slope: torch.Tensor  # d coord / d unnormalised coord
    scale: float    # S - 1 (align_corners) or S


def axis_terms(g, size: int, align_corners: bool, padding_mode: str,
               lower_slope=None):
    """One axis of the grid kernels' ``axis_prep``, elementwise, for the
    plain closed-form backwards: the padded coordinate and its slope from
    :func:`prep_coord` (the forward's operations, so the same floor), then
    the hat weights, the collapse indicator and the zeros-padding masks."""
    hi = float(size - 1)
    c, slope = prep_coord(g, size, align_corners, padding_mode,
                          with_slope=True, lower_slope=lower_slope)
    x0 = torch.floor(c)
    x1 = x0 + 1
    f = c - x0
    m = (clip(x1, 0.0, hi) != clip(x0, 0.0, hi)).long()
    if padding_mode == "zeros":
        ins = ((x0 >= 0) & (x0 <= hi), (x1 >= 0) & (x1 <= hi))
    else:
        ins = (torch.ones_like(m, dtype=torch.bool),) * 2
    return AxisTerms((1 - f, f), m, ins, slope,
                     hi if align_corners else float(size))


def corner_weights(grid, h: int, w: int, padding_mode: str = "zeros",
                   align_corners: bool = True):
    """The band-sample inputs for ``grid`` (N, Ho, Wo, 2) over an H x W
    image: base corners ``yidx``/``xidx`` (N, P) int32 and folded weights
    (N, 4, P) f32 (float64 for a float64 grid), differentiable with respect
    to the grid."""
    n, ho, wo, two = grid.shape
    if two != 2:
        raise ValueError(f"grid must be (N, Ho, Wo, 2), got "
                         f"{tuple(grid.shape)}")
    gx = grid[..., 0].reshape(n, ho * wo)
    gy = grid[..., 1].reshape(n, ho * wo)
    ix = prep_coord(gx, w, align_corners, padding_mode)
    iy = prep_coord(gy, h, align_corners, padding_mode)
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
    weights = fold_2d(w00, w01, w10, w11, dxf, dyf)
    return (y0c.to(torch.int32).contiguous(), x0c.to(torch.int32).contiguous(),
            weights)


def fold_2d(w00, w01, w10, w11, dxf, dyf):
    """Fold the four raw bilinear weights onto the taps of the clipped base
    corner: a +1 tap whose clipped coordinate collapses onto the base
    (``dxf`` / ``dyf`` 0) adds its weight to the base's.  (N, 4, P) f32, or
    float64 from float64 weights."""
    cw00 = w00 + w01 * (1 - dxf) + w10 * (1 - dyf) \
        + w11 * (1 - dxf) * (1 - dyf)
    cw01 = w01 * dxf + w11 * dxf * (1 - dyf)
    cw10 = w10 * dyf + w11 * (1 - dxf) * dyf
    cw11 = w11 * dxf * dyf
    # f32, as JAX's; a float64 grid keeps float64 (the plain twins' gradcheck)
    weights = torch.stack([cw00, cw01, cw10, cw11], dim=1)
    return weights.to(torch.promote_types(weights.dtype,
                                          torch.float32)).contiguous()


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
