"""Affine grid generation and homogeneous matrix inversion, 2D and 3D
(port of advchain_tpu/ops/affine.py).  Inside a spatially partitioned
step's space group the grid is this rank's rows of the global grid: the
leading spatial axis of ``size`` is the slab's, and its coordinates are the
slab's of the global ``linspace``."""

from __future__ import annotations

import numpy as np
import torch

from advchain_tpu_torch._consts import device_const
from advchain_tpu_torch._trace import to_device

from . import collectives

__all__ = ["linspace", "affine_grid_2d", "affine_grid_3d", "affine_grid",
           "make_batch_eye", "invert_affine_matrix"]


@device_const
def linspace(start: float, stop: float, num: int, dtype=torch.float32,
             device=None):
    """``linspace`` computed in float64 and rounded once, so every device
    gives the same values; cached on the device (``_consts``), so shared:
    write into it nothing in place."""
    return to_device(np.linspace(start, stop, num), dtype, device)


def _base_coords(size: int, align_corners: bool, dtype, device,
                 leading: bool = False):
    """The coordinates of an axis of ``size``; ``leading``: the leading
    spatial axis, this slab's coordinates inside a space group."""
    sg = collectives.current_space() if leading else None
    if sg is not None:
        size *= sg.n
    xs = linspace(-1.0, 1.0, size, dtype, device)
    if not (align_corners or size == 1):
        xs = xs * (size - 1) / size
    return xs if sg is None else sg.slab(xs, 0)


def affine_grid_2d(theta, size, align_corners: bool = True):
    """theta: (N, 2, 3); size: (N, C, H, W) -> grid (N, H, W, 2) with
    ``grid[..., 0] = theta[0,0]*x + theta[0,1]*y + theta[0,2]``."""
    _, _, h, w = size
    xs = _base_coords(w, align_corners, theta.dtype, theta.device)
    ys = _base_coords(h, align_corners, theta.dtype, theta.device, True)
    by, bx = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)
    base = torch.stack([bx, by, torch.ones_like(bx)], dim=-1)  # (H, W, 3)
    return torch.einsum("hwk,njk->nhwj", base, theta)


def affine_grid_3d(theta, size, align_corners: bool = True):
    """theta: (N, 3, 4); size: (N, C, D, H, W) -> grid (N, D, H, W, 3)
    with ``grid[..., 0]`` (x, over W) first."""
    _, _, d, h, w = size
    xs = _base_coords(w, align_corners, theta.dtype, theta.device)
    ys = _base_coords(h, align_corners, theta.dtype, theta.device)
    zs = _base_coords(d, align_corners, theta.dtype, theta.device, True)
    bz, by, bx = torch.meshgrid(zs, ys, xs, indexing="ij")  # (D, H, W)
    base = torch.stack([bx, by, bz, torch.ones_like(bx)], dim=-1)
    return torch.einsum("dhwk,njk->ndhwj", base, theta)


def affine_grid(theta, size, align_corners: bool = True):
    if len(size) == 4:
        return affine_grid_2d(theta, size, align_corners)
    if len(size) == 5:
        return affine_grid_3d(theta, size, align_corners)
    raise ValueError(f"size must have 4 or 5 entries, got {len(size)}")


def make_batch_eye(batch_size: int, ndim: int, dtype=torch.float32,
                   device=None):
    """Batched (ndim+1)x(ndim+1) identity matrices."""
    eye = torch.eye(ndim + 1, dtype=dtype, device=device)
    return eye.expand(batch_size, ndim + 1, ndim + 1)


def invert_affine_matrix(affine_matrix):
    """Exact inverse of (N, d, d+1) affine matrices via homogeneous
    augmentation. Returns (N, d, d+1)."""
    n, d, _ = affine_matrix.shape
    last = make_batch_eye(n, d, affine_matrix.dtype,
                          affine_matrix.device)[:, d:, :]
    homo = torch.cat([affine_matrix, last], dim=1)
    # linalg.inv's factorisation without its error check, which reads the
    # device from the host: the same values, no sync
    return torch.linalg.inv_ex(homo).inverse[:, :d, :]
