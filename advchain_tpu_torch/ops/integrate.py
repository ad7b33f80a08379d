"""Diffeomorphic flow integration (scaling and squaring) and flow
composition, 2D (port of advchain_tpu/ops/integrate.py).

The JAX package chooses, per composition, between a near-identity stencil
and the sampler with a ``lax.cond``; both compute exact bilinear sampling
with border padding, so the choice is only about TPU speed.  Here every
composition goes through ``grid_sample_2d``: no branch, and no host sync on
a device scalar.
"""

from __future__ import annotations

import torch

from .affine import linspace
from .grid_sample import grid_sample_2d

__all__ = ["base_grid", "compose_flow", "exponentiate_flow"]


def base_grid(batch_size: int, spatial_shape, dtype=torch.float32,
              device=None):
    """Identity grid (N, d, *spatial) in [-1, 1]; channel 0 ('x') varies
    along the last spatial axis."""
    spatial_shape = tuple(int(s) for s in spatial_shape)
    d = len(spatial_shape)
    axes = [linspace(-1.0, 1.0, s, dtype, device) for s in spatial_shape]
    mesh = torch.meshgrid(*axes, indexing="ij")
    grid = torch.stack([mesh[d - 1 - i] for i in range(d)], dim=0)[None]
    return grid.expand((batch_size, d) + spatial_shape)


def compose_flow(flow1, flow2):
    """h = f(g(x)): sample ``flow1`` at the positions given by ``flow2``
    (both (N, 2, H, W) grids in [-1, 1]), border padding,
    align_corners=True."""
    if flow1.shape[1] != 2:
        raise NotImplementedError("3D flow composition is not ported yet")
    grid = flow2.permute(0, 2, 3, 1)
    return grid_sample_2d(flow1, grid, mode="bilinear",
                          padding_mode="border", align_corners=True)


def exponentiate_flow(duv, nb_steps: int = 8, method: str = "ss",
                      adaptive: bool = False):
    """Scaling-and-squaring exponentiation of a velocity field (N, 2, H, W);
    returns the integrated offset field.

    Reference quirk kept: the base grid is mutated in place to
    ``grid + duv / 2^n`` before the squarings, so the returned offset is
    ``phi - phi0`` rather than ``phi - grid``.
    """
    if method != "ss" or adaptive:
        raise NotImplementedError(
            "only non-adaptive scaling and squaring is ported yet")
    grid = base_grid(duv.shape[0], duv.shape[2:], duv.dtype, duv.device)
    phi0 = grid + duv / (2.0 ** nb_steps)
    phi = phi0
    for _ in range(nb_steps):
        phi = compose_flow(phi, phi)
    return phi - phi0
