"""Diffeomorphic flow integration (scaling and squaring) and flow
composition, 2D and 3D (port of advchain_tpu/ops/integrate.py).

Every 2D composition of two same-shape flows goes through
``stencil_warp_2d``, which reads the channel-first flow directly; 3D ones
(and 2D ones of differing shapes) go through ``grid_sample_3d`` /
``grid_sample_2d``.  The JAX package picks, per composition, between its
stencil (largest displacement under R = 2 px in 2D, 1 voxel in 3D) and the
sampler with a ``lax.cond``, because its TPU stencil holds only R pixels of
halo.  The port's kernels are exact for any displacement, so the two
branches agree in value and in the image gradient; they differ only in the
grid gradient at an entry exactly on -1, where the stencil passes the whole
one-sided slope and the sampler's ``jnp.clip`` half of it.  So each
same-shape composition whose sampling grid carries a gradient computes
JAX's predicate on the device (``kernels.stencil_warp.dispatch_slope``, no
host read) and hands the slope to the backward kernels: the 2D stencil's,
and in 3D the z-band pair's with ``padding_mode="edge"`` (border padding
with that slope at the lower bound).  A composition whose grid takes no
gradient skips the predicate, which nothing else reads.

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

from advchain_tpu_torch.kernels.stencil_warp import dispatch_slope

from .affine import linspace
from .grid_sample import grid_sample_2d, grid_sample_3d, stencil_warp_2d

__all__ = ["base_grid", "compose_flow", "exponentiate_flow",
           "adaptive_step_count", "ADAPTIVE_STEPS"]

# the JAX package's static bound on extra squarings (integrate.py:32)
_MAX_EXTRA_STEPS = 8
# the JAX package's stencil radius per dimension: its compositions take the
# stencil below R - 1e-3 px of displacement (integrate.py:101, 133)
_STENCIL_RADIUS = {2: 2, 3: 1}

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
    align_corners=True, with the grid gradient of JAX's default dispatch at
    an exact lower bound."""
    dims = flow1.shape[1]
    if flow1.shape != flow2.shape:
        grid = torch.movedim(flow2, 1, -1)
        sample = grid_sample_3d if dims == 3 else grid_sample_2d
        return sample(flow1, grid, mode="bilinear", padding_mode="border",
                      align_corners=True)
    slope = None  # read only by the grid's gradient
    if torch.is_grad_enabled() and flow2.requires_grad:
        slope = dispatch_slope(flow2.detach().float().contiguous(),
                               _STENCIL_RADIUS[dims])
    if dims == 2:
        return stencil_warp_2d(flow1, flow2, grid_layout="first",
                               lower_slope=slope)
    return grid_sample_3d(flow1, torch.movedim(flow2, 1, -1),
                          mode="bilinear", padding_mode="edge",
                          align_corners=True, lower_slope=slope)


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
