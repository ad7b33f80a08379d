"""Spatial sharding of the leading spatial axis (D of NCDHW, H of NCHW)
across a mesh's ``space`` axis (port of advchain_tpu/parallel/spatial.py).

The JAX package writes these ops as ``jax.shard_map`` bodies over a 2-D
``('data', 'space')`` mesh.  Here each rank is one such body: every
function takes and returns this rank's local shard (its rows of the batch
over ``data``, its block of planes over ``space``), and the collectives
run over the mesh's ``space`` group (``ops.collectives``; a gloo group
stages CUDA tensors through host memory):

* :func:`halo_exchange`: ``halo`` planes from each neighbour, zeros at the
  volume's two ends (a non-cyclic exchange), differentiable: the backward
  sends each halo slab's gradient back to its owner, which adds it.
* :func:`sharded_gaussian_smooth`: the morph's Gaussian with one halo
  exchange per pass on the sharded axis; equal to the dense
  ``ops.conv.gaussian_smooth`` bit for bit (the same taps in the same
  order, the edge shards' zero halos are SAME padding's zeros).
* :func:`sharded_grid_sample`: a global warp gathers the source along
  ``space`` and samples this rank's output rows with the port's
  ``grid_sample`` (the band grid kernel pair in 2D, the z-band pair in 3D);
  with a static displacement bound (:func:`chain_displacement_bound`) it
  exchanges neighbour bands only and samples the local slab.

The spatially partitioned train step (``parallel.train`` on a mesh whose
``space`` axis is larger than 1) runs inside a space group
(``ops.collectives.SpaceGroup``): there ``ops.grid_sample.grid_sample``
samples through :func:`slab_grid_sample` (this module's sampler on the
group, with the chain's bound and without the extent check), and the
convolutions, the Gaussian and the UNet's upsampling exchange halos with
``ops.collectives.exchange_halo``, as :func:`halo_exchange` does here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Shard

from advchain_tpu_torch.kernels._coords import prep_coord
from advchain_tpu_torch.ops import collectives
from advchain_tpu_torch.ops.conv import (effective_gaussian_ks,
                                         gaussian_smooth,
                                         slab_gaussian_smooth)
from advchain_tpu_torch.ops.grid_sample import local_grid_sample
from advchain_tpu_torch.parallel.mesh import (_axis, _mesh, _world_size,
                                              mesh_device)

__all__ = [
    "make_spatial_mesh", "volume_sharding", "grid_sharding",
    "shard_volume", "shard_batch_spatial", "halo_exchange",
    "sharded_gaussian_smooth", "sharded_grid_sample",
    "chain_displacement_bound",
]

_DATA, _SPACE = "data", "space"


def make_spatial_mesh(n_data: int, n_space: int,
                      device_type: str = "cuda") -> DeviceMesh:
    """2-D ``(data, space)`` mesh over the first ``n_data * n_space``
    ranks: batch x leading-spatial-axis sharding."""
    need = n_data * n_space
    have = _world_size()
    assert have >= need, (f"need {need} devices for a {n_data}x{n_space} "
                          f"mesh, have {have}")
    return _mesh(device_type, (n_data, n_space), (_DATA, _SPACE))


def volume_sharding(mesh: DeviceMesh):
    """DTensor placements over ``(data, space)``: N over 'data', the
    leading spatial axis (dim 2 of NC*S) over 'space'."""
    del mesh
    return (Shard(0), Shard(2))


def grid_sharding(mesh: DeviceMesh):
    """Placements of a sampling grid (N, Do[, Ho], Wo, dim): N over 'data',
    its leading output axis (dim 1) over 'space'."""
    del mesh
    return (Shard(0), Shard(1))


def _local_block(x, mesh: DeviceMesh, placements):
    """This rank's block of a global tensor under ``placements``, one per
    mesh axis, on its device."""
    x = torch.as_tensor(x)
    for name, place in zip((_DATA, _SPACE), placements):
        _, n, idx = _axis(mesh, name)
        size = x.shape[place.dim]
        assert size % n == 0, (f"axis {place.dim} of size {size} not "
                               f"divisible by {name}={n}")
        x = x.narrow(place.dim, idx * (size // n), size // n)
    return x.to(mesh_device(mesh))


def shard_volume(x, mesh: DeviceMesh):
    """This rank's block of (N, C, D, H, W) or (N, C, H, W): N over
    'data', the leading spatial axis over 'space'."""
    return _local_block(x, mesh, volume_sharding(mesh))


def shard_batch_spatial(batch, mesh: DeviceMesh):
    """This rank's block of an {'image', 'label'} batch: image (N, C, *S)
    as :func:`shard_volume`, a hard label (N, *S) with its leading spatial
    axis over 'space'."""
    out = dict(batch)
    out["image"] = shard_volume(batch["image"], mesh)
    out["label"] = _local_block(batch["label"], mesh, grid_sharding(mesh))
    return out


def halo_exchange(x_local, halo: int, axis: int, mesh: DeviceMesh,
                  axis_name: str = _SPACE):
    """Concatenate ``halo`` planes from each neighbour along ``axis``
    (this rank's shard of a tensor sharded over ``axis_name`` on that
    axis).  Non-cyclic: the two edge shards get zeros in the missing halo,
    the dense ops' zero padding.  ``halo == 0`` or a single shard pads
    locally.  Differentiable."""
    group, n, _ = _axis(mesh, axis_name)
    if halo == 0 or n == 1:
        if not halo:
            return x_local
        pads = [0, 0] * x_local.dim()
        pads[2 * (x_local.dim() - 1 - axis)] = halo
        pads[2 * (x_local.dim() - 1 - axis) + 1] = halo
        return F.pad(x_local, pads)
    assert x_local.shape[axis] >= halo, (
        f"local extent {x_local.shape[axis]} < halo {halo}")
    return collectives.exchange_halo(x_local, halo, axis, group)


def _shard_extent(x_local, group, n: int) -> int:
    """The global extent of a sharded dim 2, every shard of one size."""
    d_loc = x_local.shape[2]
    if n > 1:
        sizes = collectives.all_gather(
            torch.tensor([d_loc], device=x_local.device), group=group)
        assert bool((sizes == d_loc).all()), (
            f"leading spatial axis {int(sizes.sum())} not divisible by "
            f"space={n}: shards {sizes.tolist()}")
    return d_loc * n


def sharded_gaussian_smooth(x_local, mesh: DeviceMesh, sigma: float = 1.0,
                            kernel_size: int = 5, iters: int = 1):
    """``ops.conv.gaussian_smooth`` on this rank's shard of a tensor whose
    leading spatial axis is sharded over 'space'.  Separable per-axis
    passes; only the sharded axis exchanges a halo, of ``(k_eff - 1) // 2``
    planes, every iteration.  Equal to the dense op: interior seams see
    true neighbour planes, the global ends the zeros SAME padding gives."""
    ndim = x_local.dim() - 2
    assert ndim in (2, 3), f"expected NCHW or NCDHW, got {x_local.dim()}-D"
    ks = effective_gaussian_ks(kernel_size, sigma, ndim)
    halo = (ks - 1) // 2
    group, n_space, _ = _axis(mesh, _SPACE)
    _shard_extent(x_local, group, n_space)
    d_loc = x_local.shape[2]
    assert d_loc >= halo, (
        f"local extent {d_loc} < halo {halo}: use fewer 'space' shards")
    if n_space == 1:
        return gaussian_smooth(x_local, sigma, kernel_size, iters)
    return slab_gaussian_smooth(x_local, group, sigma, kernel_size, iters)


def _sin_cap(frac_of_pi: float) -> float:
    """sin of ``frac_of_pi``*pi, capped at 1 (angles past 90 deg)."""
    return float(np.sin(min(abs(frac_of_pi), 0.5) * np.pi))


def chain_displacement_bound(transforms) -> Optional[float]:
    """A static per-warp displacement bound (normalised grid units, where
    the full axis extent is 2.0) over a chain's geometric warps, from the
    transforms' configs alone: what lets :func:`sharded_grid_sample`
    exchange halo bands instead of gathering the whole source.

    Every warp the chain traces (forward, inverse, prediction, mask
    roundtrips, and the morph's scaling-and-squaring compositions, whose
    intermediate displacement never exceeds the final one) samples within
    its own transform's bound, so the chain's bound is the max:

    * AdvMorph: ``min(epsilon, 2)`` (the latent is unit-l2-normalised, so
      each element is at most 1; smoothing and upsampling cannot raise the
      max; grids clamp to [-1, 1]).
    * AdvAffine: ``|R C x + t - x|`` bounded by ``|RCx - Cx|_2 + |Cx - x|
      + |t|``, with the scale factor the larger of the forward ``1 + s``
      and the inverse ``1 / (1 - s)``.

    Returns None when a geometric transform is not recognised, or an
    affine scale reaches 1 (the caller then gathers the source)."""
    bound = 0.0
    for t in transforms:
        if not getattr(t, "is_geometric", lambda: 0)():
            continue
        name = getattr(t, "get_name", lambda: "")()
        if name == "morph":
            bound = max(bound, min(float(t.epsilon), 2.0))
        elif name == "affine":
            if t.spatial_dims == 2:
                rots = [getattr(t, "rot_ratio", 0.0)]
                scales = [getattr(t, "scale_x", 0.0),
                          getattr(t, "scale_y", 0.0)]
                shifts = [getattr(t, "translation_x", 0.0),
                          getattr(t, "translation_y", 0.0)]
                sdim = np.sqrt(2.0)
            else:
                rots = [getattr(t, "rot_x", 0.0), getattr(t, "rot_y", 0.0),
                        getattr(t, "rot_z", 0.0)]
                scales = [getattr(t, "scale_x", 0.0),
                          getattr(t, "scale_y", 0.0),
                          getattr(t, "scale_z", 0.0)]
                shifts = [getattr(t, "translation_x", 0.0),
                          getattr(t, "translation_y", 0.0),
                          getattr(t, "translation_z", 0.0)]
                sdim = np.sqrt(3.0)
            s = max(abs(float(v)) for v in scales)
            if s >= 1.0:
                return None  # inverse scale unbounded
            shift = max(abs(float(v)) for v in shifts)
            # |Rx - x|_2 <= sum_i 2 sin(theta_i / 2) * |x|_2
            rot_l2 = sum(2.0 * _sin_cap(abs(float(r)) / 2.0) for r in rots)
            f = max(1.0 + s, 1.0 / (1.0 - s))  # fwd vs inverse scaling
            bound = max(bound, sdim * f * rot_l2 + f * (s + shift))
        else:
            return None  # unknown geometric transform: no static bound
    return bound


def _halo_planes(max_disp: float, size: int) -> int:
    """Halo width (planes) for a normalised displacement bound on an
    align_corners=True axis of ``size`` planes: the farthest sample is
    ``max_disp * (size-1)/2`` planes away and its +1 bilinear tap one
    more."""
    return int(np.ceil(max_disp * 0.5 * (size - 1))) + 1


def _slab_coordinate(pix, off: int, planes: int):
    """The normalised coordinate (align_corners) over ``planes`` planes of
    the global coordinate ``pix`` on a slab starting at plane ``off``,
    nudged by an ulp where the samplers' own unnormalisation would land on
    the other side of an integer than ``pix`` does: there bilinear's
    derivative jumps to the next pair of planes (a coordinate on a plane,
    as identity and clipped grids give, or an ulp under one on the first
    shard, whose slab coordinate ``pix + halo`` rounds up), so the grid
    gradient would not be the dense sampler's.  A nudge moves ``g + 1``,
    the sum the samplers form first, by its own ulp (at least 2^-24, so
    ``g`` stays exact)."""
    # divided by a tensor: CUDA divides by a Python scalar as a product
    # with its reciprocal
    half = torch.full((), 0.5 * (planes - 1), dtype=pix.dtype,
                      device=pix.device)
    g = (pix - float(off)) / half - 1.0
    lo = torch.floor(pix.detach()) - float(off)
    for _ in range(3):
        with torch.no_grad():
            got = torch.floor(prep_coord(g, planes, True, "zeros"))
            t = g + 1.0
            step = torch.clamp(torch.nextafter(t, torch.full_like(t, 4.0))
                               - t, min=2.0 ** -24)
            step = torch.where(got < lo, step,
                               torch.where(got > lo, -step, 0.0))
        g = (g + 1.0 + step) - 1.0
    return g


def sharded_grid_sample(x_local, grid_local, mesh: DeviceMesh,
                        mode: str = "bilinear", padding_mode: str = "zeros",
                        align_corners: bool = True, tile_order: str = "rows",
                        max_disp: Optional[float] = None):
    """``ops.grid_sample`` with the source's leading spatial axis and the
    grid's leading output axis sharded over 'space' (and the batch over
    'data'): samples this rank's output rows.

    * ``max_disp`` given (a static normalised displacement bound, e.g. from
      :func:`chain_displacement_bound`), ``align_corners``, an output whose
      sharded axis matches the source's, and a halo under the local
      extent: exchange ``halo`` neighbour planes (:func:`halo_exchange`,
      zeros at the volume's ends; with border or reflection padding the
      last plane repeated past the end, as the dense sampler clamps its
      taps) and sample the local slab.  The sharded
      coordinate goes through the global padding transform
      (``prep_coord``), then shifts by ``idx * d_loc - halo`` and is
      normalised over the slab (nearest: the plane the global coordinate
      rounds to, so ties go where the dense sampler sends them).
    * otherwise: gather the whole source along 'space' (a global warp may
      move any output plane anywhere) and sample this rank's rows.

    Each shard's sample runs the port's kernels (``tile_order`` is a TPU
    hint, accepted and ignored)."""
    del tile_order
    group, n_space, idx = _axis(mesh, _SPACE)
    size0 = _shard_extent(x_local, group, n_space)
    return _sample_slab(x_local, grid_local, group, n_space, idx, size0,
                        mode, padding_mode, align_corners, max_disp)


def slab_grid_sample(x_local, grid_local, space, mode: str = "bilinear",
                     padding_mode: str = "zeros",
                     align_corners: bool = True):
    """:func:`sharded_grid_sample` inside a spatially partitioned step's
    space group (``ops.collectives.SpaceGroup``), with its displacement
    bound: what ``ops.grid_sample.grid_sample`` routes to there.  The step
    checked once that every rank's slab has one extent, so no call
    gathers the extents again."""
    return _sample_slab(x_local, grid_local, space.group, space.n,
                        space.index, x_local.shape[2] * space.n, mode,
                        padding_mode, align_corners, space.max_disp)


def _sample_slab(x_local, grid_local, group, n_space, idx, size0, mode,
                 padding_mode, align_corners, max_disp):
    ndim = x_local.dim() - 2
    assert ndim in (2, 3)
    d_loc = x_local.shape[2]
    halo = None
    if (max_disp is not None and align_corners
            and grid_local.shape[1] == d_loc and n_space > 1):
        hp = _halo_planes(float(max_disp), size0)
        if hp < d_loc:  # the exchange reaches immediate neighbours only
            halo = hp
    if halo is None:
        xf = (x_local if n_space == 1
              else collectives.gather_slabs(x_local, group))
        return local_grid_sample(xf, grid_local, mode=mode,
                                 padding_mode=padding_mode,
                                 align_corners=align_corners)
    zch = ndim - 1  # the grid channel indexing the sharded axis (y or z)
    slab = d_loc + 2 * halo
    xh = collectives.exchange_halo(x_local, halo, 2, group)  # zeros at ends
    if padding_mode != "zeros" and idx == n_space - 1:
        # border and reflection clamp the dense sampler's taps past the end
        # to the last plane, which a coordinate exactly on it reads as the
        # +1 tap (weight 0, but the slope of its derivative)
        xh = torch.cat([xh.narrow(2, 0, d_loc + halo),
                        x_local.narrow(2, d_loc - 1, 1).expand(
                            (-1, -1, halo) + tuple(x_local.shape[3:]))],
                       dim=2)
    gz = grid_local[..., zch]
    # the global pixel coordinate with the padding transform applied
    # globally (border clip, reflection fold); on in-slab coordinates the
    # local sampler's own transform is the identity.  zeros: samples past
    # the volume land on the zero halos or past the slab, both zero.
    pix = prep_coord(gz, size0, True, padding_mode)
    if mode == "nearest":
        # the dense sampler's plane, rounded half to even on the global
        # coordinate: the remap below moves a coordinate by an ulp, which
        # would send a half-integer to the other plane, but not an integer
        pix = torch.round(pix)
    gz_l = _slab_coordinate(pix, idx * d_loc - halo, slab)
    grid_l = torch.cat([grid_local[..., :zch], gz_l[..., None],
                        grid_local[..., zch + 1:]], dim=-1)
    return local_grid_sample(xh, grid_l, mode=mode,
                             padding_mode=padding_mode, align_corners=True)
