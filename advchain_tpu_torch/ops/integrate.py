"""Diffeomorphic flow integration (scaling and squaring) and flow
composition, 2D and 3D (port of advchain_tpu/ops/integrate.py).

The JAX package chooses, per composition, between a near-identity stencil
and the sampler with a ``lax.cond``; both compute exact bi/trilinear
sampling with border padding, so the choice is only about TPU speed.  Here
every composition goes through ``grid_sample_2d`` / ``grid_sample_3d``:
no branch, and no host sync on a device scalar per composition.

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
from .grid_sample import grid_sample_2d, grid_sample_3d

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
    grid = torch.movedim(flow2, 1, -1)
    sample = {2: grid_sample_2d, 3: grid_sample_3d}[flow1.shape[1]]
    return sample(flow1, grid, mode="bilinear", padding_mode="border",
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
