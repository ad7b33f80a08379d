"""Diffeomorphic flow integration (scaling and squaring) and flow
composition, 2D and 3D (port of advchain_tpu/ops/integrate.py).

Every 2D composition of two same-shape flows goes through
``stencil_warp_2d``, which reads the channel-first flow directly.  The JAX
package picks, per composition, between its stencil (displacement under 2
px) and the sampler with a ``lax.cond``, because its TPU stencil holds only
R pixels of halo; the port's stencil kernel reads clamped taps and is exact
for any displacement, so there is no predicate and no host read.  Both
agree with the sampler except at an exact border (a grid entry on +-1),
where the stencil's one-sided slope is what JAX's default dispatch takes.
3D compositions (and 2D ones of differing shapes) go through
``grid_sample_3d`` / ``grid_sample_2d``; a same-shape 3D composition takes
the stencil's slope at an exact lower border too (``padding_mode="edge"``),
so 2D and 3D share one convention.

The adaptive 3D step count depends on the whole batch's velocity norm.  It
is read to the host once per exponentiation (one sync), and the squarings
then run as a plain loop; a per-step ``if`` on a device scalar would sync
8-16 times, and ``torch.where`` over all ``nb_steps + 8`` steps would run
every composition whether it is needed or not.
"""

from __future__ import annotations

import collections
import math

import torch

from .affine import linspace
from .grid_sample import grid_sample_2d, grid_sample_3d, stencil_warp_2d

__all__ = ["base_grid", "compose_flow", "exponentiate_flow",
           "adaptive_step_count", "ADAPTIVE_STEPS"]

# the JAX package's static bound on extra squarings (integrate.py:32)
_MAX_EXTRA_STEPS = 8

# step counts of the latest adaptive exponentiations, newest last
ADAPTIVE_STEPS: collections.deque = collections.deque(maxlen=64)


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
    (both (N, d, *spatial) grids in [-1, 1], d = 2 or 3), border padding,
    align_corners=True."""
    if flow1.shape[1] == 2 and flow1.shape == flow2.shape:
        return stencil_warp_2d(flow1, flow2, grid_layout="first")
    grid = torch.movedim(flow2, 1, -1)
    if flow1.shape[1] == 3:
        # a same-shape composition takes the edge-padded stencil's slope at
        # the lower bound, as the 2D stencil kernel does (JAX's sub-voxel
        # dispatch, integrate.py:126-153); its values are border padding's
        padding = "edge" if flow1.shape == flow2.shape else "border"
        return grid_sample_3d(flow1, grid, mode="bilinear",
                              padding_mode=padding, align_corners=True)
    return grid_sample_2d(flow1, grid, mode="bilinear", padding_mode="border",
                          align_corners=True)


def adaptive_step_count(duv, nb_steps: int) -> int:
    """``clamp(max(nb_steps, ceil(log2(||duv||_F / 0.5))), <= nb_steps + 8)``
    with the Frobenius norm over the whole batch (integrate.py:229-232).
    Reads one scalar from the device."""
    norm = torch.linalg.vector_norm(duv.detach().reshape(-1))
    needed = torch.ceil(torch.log2(torch.clamp(norm, min=1e-30) / 0.5))
    return int(min(max(nb_steps, int(needed)),
                   nb_steps + _MAX_EXTRA_STEPS))


def exponentiate_flow(duv, nb_steps: int = 8, method: str = "ss",
                      adaptive: bool = False):
    """Scaling-and-squaring exponentiation of a velocity field
    (N, d, *spatial); returns the integrated offset field.  With
    ``adaptive=True`` (the 3D path) the step count grows until
    ``||duv / 2^n||_F <= 0.5`` (:func:`adaptive_step_count`).

    Reference quirk kept: the base grid is mutated in place to
    ``grid + duv / 2^n`` before the squarings, so the returned offset is
    ``phi - phi0`` rather than ``phi - grid``.
    """
    if method != "ss":
        raise NotImplementedError(f"integration method {method!r} is not "
                                  f"ported yet")
    steps = nb_steps
    if adaptive:
        steps = adaptive_step_count(duv, nb_steps)
        ADAPTIVE_STEPS.append(steps)
    grid = base_grid(duv.shape[0], duv.shape[2:], duv.dtype, duv.device)
    phi0 = grid + duv * math.ldexp(1.0, -steps)
    phi = phi0
    for _ in range(steps):
        phi = compose_flow(phi, phi)
    return phi - phi0
