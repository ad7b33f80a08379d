#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (advchain_tpu_torch) once on one GPU.

    python3 chip_smoke.py [--profile PATH] [--profile3d PATH]
                          [--profile-train PATH]

Phases (any failure raises and the script exits non-zero):
  1. print the card's name and power limit, build the CUDA kernels from
     ``advchain_tpu_torch/kernels/csrc`` (one nvcc per source, started
     together) and print the build time;
  2. hold each 2D kernel against its plain PyTorch twin on the card at the
     main path's shapes (N=128, 192x192): the corner-level band pair at C
     in {1, 2, 5} on a 30-degree rotation with zeros padding and a
     near-identity warp with border padding; the band grid pair (the
     default 2D route, bilinear and nearest) at C in {1, 2, 4, 5} with
     three paddings and both align_corners on the near-identity grid, that
     grid with 5% exact +-1 entries, and the rotation;
  3. check the 2D episode on a small input against the same episode on the
     CPU (plain twins), with identical weights and transform parameters;
  4. run the headline adversarial episode (noise -> bias -> affine -> morph,
     batch 128 at 192x192, UNet_16 with 4 classes and seeded random
     weights, mse + contour, n_iter=1, smart power iteration), count the
     kernel launches of one episode (12 / 6 on the band grid pair, none on
     the corner-level pair, no call of a host-side fold; 32 / 16 on the
     stencil pair and 16 dispatch predicates, one per composition whose
     grid takes a gradient) and time 5 episodes after 2 warm-ups;
  5. time each 2D kernel, its twin and ``F.grid_sample`` (the library
     yardstick, never used by the port; a backward row times the library's
     backward alone, its graph built before the timed window, and its
     forward and backward together), and a whole 2D sample three ways
     in turns: the pre-fusion route (the host-side fold and the
     corner-level pair), the band grid pair, and ``F.grid_sample``;
  6. hold the corner-level z-band kernels against their twins at the 3D
     episode's shapes (N=2, 12x192x192, C in {1, 3, 5}; a 10-degree
     rotation about each axis with zeros padding and a near-identity warp
     of up to 1 voxel with border padding), the fused grid-level pair
     (trilinear and nearest) against its plain versions at the same shapes
     with three paddings and both align_corners on the near-identity grid,
     that grid with 5% exact +-1 entries, and the rotation (samples past
     the volume); and 2D and 3D nearest sampling on the card against the
     CPU;
  7. check a small 3D episode (batch 2, 1x8x32x32, dropout 0) against the
     same episode on the CPU;
  8. run the 3D volume episode of bench.py:349-404 (noise -> bias ->
     affine -> morph in 3D, batch 2 at 1x12x192x192, PseudoConv3dModel
     with 4 classes, dropout 0.1 and seeded random weights, mse,
     n_iter=1), count its kernel launches (44 / 22 on the fused pair, none
     on the corner-level pair, no call of the host-side fold, one dispatch
     predicate per squaring of the PGD step's two exponentiations), print
     its adaptive step counts and time 5 episodes after 2 warm-ups;
  9. time the corner-level and fused z-band kernels, their twins and
     ``F.grid_sample`` on 5-D input, nearest sampling on both pairs, and a
     whole 3D sample three ways in turns: the pre-fusion route (the
     host-side fold and the corner-level pair), the fused pair, and
     ``F.grid_sample``;
 10. hold the stencil-warp kernels (every 2D flow composition) against
     their twins at the compositions' shapes (N=128, 192x192, C in
     {1, 2, 5}; near-identity flows under 2 px, the same with its border
     exactly on +-1, flows of up to 20 px that run past the border with
     entries on exactly +-1, and the 8 squaring inputs of a seeded headline
     morph) and at an odd shape (N=3, 17x23), the backward with both
     dispatch slopes; show that two backward runs on the near-identity flow
     give the same d_img bit for bit; hold the dispatch predicate's kernel
     against its twin in 2D and 3D;
 11. check a small adversarial train step (batch 2, 32x32, UNet_16, the
     same weights and transform draws, 2 steps) against the CPU;
 12. run the headline fused adversarial train step of bench.py:408-447
     (batch 128 at 192x192, UNet_16, Adam 1e-4, n_iter=1, smart power
     iteration, mse + contour, seeded random weights and labels), count
     the kernel launches of one step (12 / 8 on the band grid pair, none on
     the corner-level pair, no call of a host-side fold; 32 / 16 on the
     stencil pair and 16 dispatch predicates) and time 5 steps after 2
     warm-ups; then time the supervised step the same way;
 13. time the stencil kernels, their twins and ``F.grid_sample`` (the
     backward alone) at the composition shape (N=128, C=2, 192x192), the
     backward summed over the 8 squaring inputs of a seeded headline morph
     with each one's share of taps outside the gather's window, and the
     dispatch predicate;
 14. hold the flat-index corner kernels (the 2D route under
     ADVCHAIN_BAND_KERNEL=0) against their twins at the 2D episode's
     shapes (N=128, 192x192, C in {1, 2, 5}, K in {1, 4}) and the plane
     kernels (the 3D route under ADVCHAIN_ZBAND=0) at the 3D episode's
     (N=2, 12x192x192, C in {1, 3, 5}, K in {2, 4}), on phase 2's and 6's
     grids with 5% of the near-identity entries on exactly +-1 (bases on
     the last column, row and plane: the 2D wrap and the plane edge);
 15. run the headline episode with ADVCHAIN_BAND_KERNEL=0 (set inside a
     try/finally that restores the environment): its loss against the
     band route's with the same weights and injected transform
     parameters (within 1e-4 relative), its launches (corner as many as
     the band grid pair on the default route, the band pairs 0, stencil
     unchanged) and 3 timed episodes after 2 warm-ups;
 16. the same for the 3D volume episode with ADVCHAIN_ZBAND=0 (plane
     launches, z-band 0);
 17. time the corner and plane kernels, their twins and ``F.grid_sample``,
     then print the ``kernels`` line for all fifteen kernels.
The last line of standard output is the device record.  ``--profile PATH``
/ ``--profile3d PATH`` / ``--profile-train PATH`` additionally write a
torch.profiler summary of one 2D episode / 3D episode / train step to PATH.

Convolutions and matmuls run in full f32 (TF32 off): morph's 8 or more
self-compositions amplify rounding.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

BATCH = 128
SHAPE = (192, 192)
BATCH3D = 2
SHAPE3D = (12, 192, 192)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
SM_CLOCK_HZ = 1.98e9         # H100 SXM peak SM clock
TOL_FWD = 1e-5
TOL_GRID_FWD = 1e-6          # the fused forward repeats its plain fold
TOL_DW = 1e-5
TOL_DIMG_REL = 1e-5          # of max|d_img|: sums reassociate (atomics)
TOL_DFLOW_REL = 1e-5         # of max|d_flow|
TOL_ROUTES = 1e-4            # episode loss, legacy route vs default route
LR = 1e-4                    # the headline train step's Adam rate
_CSRC = "advchain_tpu_torch/kernels/csrc/"
KERNEL_SOURCES = {"band": _CSRC + "band_sample.cu",
                  "band_grid": _CSRC + "band_sample.cu",
                  "zband": _CSRC + "zband_sample.cu",
                  "zband_grid": _CSRC + "zband_sample.cu",
                  "stencil": _CSRC + "stencil_warp.cu",
                  "slope": _CSRC + "stencil_warp.cu",
                  # one kernel pair serves the corner (2D) and plane (3D)
                  # routes
                  "corner": _CSRC + "plane_sample.cu",
                  "plane": _CSRC + "plane_sample.cu"}
KERNEL_NAMES = {"band": "band_sample", "band_grid": "band_grid_sample",
                "zband": "zband_sample",
                "zband_grid": "zband_grid_sample",
                "stencil": "stencil_warp", "slope": "dispatch_slope",
                "corner": "corner_sample", "plane": "plane_sample"}
# the sources to build, one nvcc each
BUILD = sorted({src.rsplit("/", 1)[1][:-3] for src in KERNEL_SOURCES.values()})
# the TPU kernels each pair replaces
_GM = "advchain_tpu/kernels/gather_matmul.py"
REPLACES = {"band": {"fwd": f"{_GM}:839", "bwd": f"{_GM}:923"},
            "band_grid": {"fwd": f"{_GM}:839", "bwd": f"{_GM}:923"},
            "zband": {"fwd": f"{_GM}:1081", "bwd": f"{_GM}:1230"},
            "zband_grid": {"fwd": f"{_GM}:1081", "bwd": f"{_GM}:1230"},
            "stencil": {"fwd": "advchain_tpu/kernels/stencil.py:132",
                        "bwd": "advchain_tpu/kernels/stencil.py:172"},
            # not a Pallas kernel: the lax.cond predicate of compose_flow
            "slope": {"fwd": "advchain_tpu/ops/integrate.py:103"},
            "corner": {"fwd": f"{_GM}:134", "bwd": f"{_GM}:283"},
            "plane": {"fwd": f"{_GM}:466", "bwd": f"{_GM}:603"}}
# substrings of the port's CUDA kernel names (the profiler's rows)
PORT_KERNEL_NAMES = ("band_sample", "band_grid", "zband_grid",
                     "stencil_warp", "dispatch_slope", "plane_sample")
# the switches that send 2D / 3D sampling to the corner / plane kernels
LEGACY_SWITCH = {2: "ADVCHAIN_BAND_KERNEL", 3: "ADVCHAIN_ZBAND"}
# the family the default route sends bilinear sampling to
DEFAULT_FAMILY = {2: "band_grid", 3: "zband_grid"}
# the corner-level pairs no default route takes since the grid-level pairs
CORNER_LEVEL = {2: "band", 3: "zband"}
# the grid-level pair's launches (fwd, bwd) in one 2D episode, one 2D train
# step and one 3D episode
GRID_LAUNCHES = {"episode2d": {"fwd": 12, "bwd": 6},
                 "train": {"fwd": 12, "bwd": 8},
                 "episode3d": {"fwd": 44, "bwd": 22}}
# the stencil pair's launches (fwd, bwd) in one 2D episode and one train
# step: 4 exponentiations of 8 squarings, 2 of them differentiated
STENCIL_LAUNCHES = {"fwd": 32, "bwd": 16}
# the host-side folds that no default route calls
FOLDS = ("corner_weights", "corner_weights_3d", "nearest_weights")


def chain_configs(batch, shape):
    """The headline transform configs (bench.py:156-168), or the 3D volume
    episode's (bench.py:363-382) for a 3-D shape."""
    size = [batch, 1, *shape]
    if len(shape) == 3:
        return {
            "noise": {"epsilon": 1.0, "xi": 1e-6, "data_size": size},
            "bias": {"epsilon": 0.3,
                     "control_point_spacing": [max(s // 2, 2)
                                               for s in shape],
                     "downscale": 4, "data_size": size,
                     "interpolation_order": 3, "init_mode": "random",
                     "space": "log"},
            "affine": {"rot_x": 10.0 / 180, "rot_y": 10.0 / 180,
                       "rot_z": 10.0 / 180, "scale_x": 0.1, "scale_y": 0.1,
                       "scale_z": 0.1, "shift_x": 0.1, "shift_y": 0.1,
                       "shift_z": 0.1, "data_size": size},
            "morph": {"epsilon": 1.5, "data_size": size,
                      "vector_size": [max(shape[0] // 2, 2),
                                      shape[1] // 16, shape[2] // 16]},
        }
    return {
        "noise": {"epsilon": 1.0, "xi": 1e-6, "data_size": size},
        "bias": {"epsilon": 0.3, "control_point_spacing": [48, 48],
                 "downscale": 2, "data_size": size,
                 "interpolation_order": 3, "init_mode": "random",
                 "space": "log"},
        "affine": {"rot": 30.0 / 180.0, "scale_x": 0.2, "scale_y": 0.2,
                   "shift_x": 0.1, "shift_y": 0.1, "data_size": size},
        "morph": {"epsilon": 1.5, "data_size": size,
                  "vector_size": [shape[0] // 16, shape[1] // 16]},
    }


def make_image(batch, shape):
    """The headline's synthetic image (bench.py make_image)."""
    ii, jj = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                         indexing="ij")
    cy, cx = shape[0] / 2, shape[1] / 2
    img = (np.exp(-(((ii - cy) / 30.0) ** 2 + ((jj - cx) / 24.0) ** 2))
           + 0.3 * np.exp(-(((ii - 0.3125 * shape[0]) / 15.0) ** 2
                            + ((jj - 0.625 * shape[1]) / 12.0) ** 2)))
    r = np.random.RandomState(0)
    x = np.broadcast_to(img, (batch, 1) + tuple(shape)).copy()
    return (x + 0.05 * r.rand(batch, 1, *shape)).astype(np.float32)


def make_volume(batch, shape):
    """The 3D episode's synthetic volume (bench.py make_volume)."""
    d, h, w = shape
    ii, jj, kk = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    img = np.exp(-(((ii - d / 2) / (d / 3)) ** 2
                   + ((jj - h / 2) / (h / 4)) ** 2
                   + ((kk - w / 2) / (w / 4)) ** 2))
    r = np.random.RandomState(0)
    x = np.broadcast_to(img, (batch, 1) + tuple(shape)).copy()
    return (x + 0.05 * r.rand(batch, 1, *shape)).astype(np.float32)


def make_input(batch, shape):
    return (make_image if len(shape) == 2 else make_volume)(batch, shape)


def build_solver(batch, shape, names=("noise", "bias", "affine", "morph")):
    """The headline solver (mse + contour), or the 3D episode's (mse) for a
    3-D shape."""
    from advchain_tpu_torch.augmentor import (
        AdvAffine, AdvBias, AdvMorph, AdvNoise,
        ComposeAdversarialTransformSolver)
    cls = {"noise": AdvNoise, "bias": AdvBias, "affine": AdvAffine,
           "morph": AdvMorph}
    cfg = chain_configs(batch, shape)
    dims = len(shape)
    chain = [cls[n](spatial_dims=dims, config_dict=cfg[n], seed=i)
             for i, n in enumerate(names)]
    if dims == 3:
        return ComposeAdversarialTransformSolver(
            chain_of_transforms=chain, divergence_types=["mse"],
            divergence_weights=[1.0])
    return ComposeAdversarialTransformSolver(
        chain_of_transforms=chain, divergence_types=["mse", "contour"],
        divergence_weights=[1.0, 0.5])


def build_model(device, seed=0, dims=2, dropout=0.1):
    """UNet_16 (2D) or PseudoConv3dModel (3D; ``dropout`` applies), 4
    classes, seeded random weights."""
    from advchain_tpu_torch.models import (PseudoConv3dModel,
                                           SegmentationModel, UNet)
    module = (UNet(input_channel=1, num_classes=4, feature_scale=4)
              if dims == 2 else
              PseudoConv3dModel(num_classes=4, dropout=dropout))
    return SegmentationModel.create(module, seed=seed, device=device)


# the episodes' power-iteration setting: the headline's "smart", the 3D
# episode's default (bench.py:384-392)
POWER_ITERATION = {2: "smart", 3: False}


def _kernel_modules():
    from advchain_tpu_torch.kernels import (band_sample, stencil_warp,
                                            zband_sample)
    return {"band": band_sample, "zband": zband_sample,
            "stencil": stencil_warp}


def reset_launch_counts():
    from advchain_tpu_torch.kernels import plane_sample
    for mod in _kernel_modules().values():
        mod.reset_launch_counts()
    plane_sample.reset_launch_counts()


def launch_counts():
    """Launches per family: band and zband (the corner-level pairs),
    band_grid and zband_grid (the grid-level pairs), stencil, the dispatch
    predicate (slope), and corner and plane (the two routes of one kernel
    pair, counted apart)."""
    from advchain_tpu_torch.kernels import (band_sample, plane_sample,
                                            zband_sample)
    counts = {fam: {"fwd": mod.FWD_LAUNCHES, "bwd": mod.BWD_LAUNCHES}
              for fam, mod in _kernel_modules().items()}
    counts["zband_grid"] = {"fwd": zband_sample.GRID_FWD_LAUNCHES,
                            "bwd": zband_sample.GRID_BWD_LAUNCHES}
    counts["band_grid"] = {"fwd": band_sample.GRID_FWD_LAUNCHES,
                           "bwd": band_sample.GRID_BWD_LAUNCHES}
    # the dispatch predicate: one launch per same-shape composition
    counts["slope"] = {"fwd": _kernel_modules()["stencil"].SLOPE_LAUNCHES}
    counts.update({route: dict(c) for route, c in
                   plane_sample.LAUNCHES.items()})
    return counts


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def sampler(dims):
    """(family name, kernel module) of the corner sampler for 2D / 3D."""
    from advchain_tpu_torch.kernels import band_sample, zband_sample
    return ("band", band_sample) if dims == 2 else ("zband", zband_sample)


def route_family(dims):
    """The kernel family this process's switches send bilinear sampling
    to: band / zband_grid, or corner / plane under
    ``LEGACY_SWITCH[dims]=0``."""
    if os.environ.get(LEGACY_SWITCH[dims]) == "0":
        return {2: "corner", 3: "plane"}[dims]
    return DEFAULT_FAMILY[dims]


def sample_grids(n, shape, device, seed=0):
    """(name, padding, grid) for an image of spatial ``shape``.  2D: a
    30-degree rotation and a near-identity warp of up to 1.5 px; 3D: a
    10-degree rotation about each axis and a near-identity warp of up to 1
    voxel (the scaling-and-squaring compositions)."""
    import torch
    from advchain_tpu_torch.ops.affine import affine_grid
    gen = torch.Generator(device=device).manual_seed(seed)
    dims = len(shape)
    size = (n, 1) + tuple(shape)
    if dims == 2:
        a = math.radians(30.0)
        rot = torch.tensor([[math.cos(a), -math.sin(a), 0.0],
                            [math.sin(a), math.cos(a), 0.0]])
        name, disp = "rot30", 1.5
    else:
        c, s = math.cos(math.radians(10.0)), math.sin(math.radians(10.0))
        rx = torch.tensor([[1, 0, 0], [0, c, -s], [0, s, c]])
        ry = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        rz = torch.tensor([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        rot = torch.cat([rz @ ry @ rx, torch.zeros(3, 1)], dim=1)
        name, disp = "rot10xyz", 1.0
    eye = torch.eye(dims, dims + 1)
    rot_grid = affine_grid(rot.to(device).expand(n, dims, dims + 1), size)
    ident = affine_grid(eye.to(device).expand(n, dims, dims + 1), size)
    # one pixel/voxel per axis, channel 0 along the last axis
    scale = torch.tensor([disp * 2 / (s - 1) for s in reversed(shape)],
                         device=device)
    near = ident + (2 * torch.rand(ident.shape, generator=gen,
                                   device=device) - 1) * scale
    return [(name, "zeros", rot_grid), ("near_identity", "border", near)]


def kernel_inputs(n, c, shape, grid, padding, device, seed=0):
    """img, base indices (tuple), folded weights and a cotangent for the
    sampler kernels of ``len(shape)`` dims."""
    import torch
    from advchain_tpu_torch.ops.grid_sample import (corner_weights,
                                                    corner_weights_3d)
    gen = torch.Generator(device=device).manual_seed(seed + c)
    img = torch.randn((n, c) + tuple(shape), generator=gen, device=device)
    prep = corner_weights if len(shape) == 2 else corner_weights_3d
    *idx, wts = prep(grid, *shape, padding, True)
    g = torch.randn(n, c, grid[0, ..., 0].numel(), generator=gen,
                    device=device)
    return img, tuple(idx), wts, g


def check_kernels(n, shape, device, channels=(1, 2, 5)):
    """Phases 2 and 6: each kernel against its twin.  Returns the largest
    errors."""
    fam, mod = sampler(len(shape))
    fwd, fwd_plain = (getattr(mod, f"{fam}_sample_fwd"),
                      getattr(mod, f"{fam}_sample_fwd_plain"))
    bwd, bwd_plain = (getattr(mod, f"{fam}_sample_bwd"),
                      getattr(mod, f"{fam}_sample_bwd_plain"))
    worst = {"fwd": 0.0, "bwd": 0.0}
    for name, padding, grid in sample_grids(n, shape, device):
        for c in channels:
            img, idx, wts, g = kernel_inputs(n, c, shape, grid, padding,
                                             device)
            hold_against_twin(
                f"{fam:5s} {name:13s} {padding:6s} C={c}", device,
                lambda: fwd(img, *idx, wts), lambda: fwd_plain(img, *idx, wts),
                lambda: bwd(g, img, *idx, wts),
                lambda: bwd_plain(g, img, *idx, wts), worst)
    return worst


def hold_against_twin(label, device, fwd, fwd_plain, bwd, bwd_plain, worst):
    """Run a sampler kernel pair and its twins on the same inputs; raise
    unless fwd and ``d_w`` are within TOL_FWD / TOL_DW and ``d_img`` within
    TOL_DIMG_REL of its largest entry.  Updates ``worst``."""
    import torch
    with torch.no_grad():
        out, ref = fwd(), fwd_plain()
        (d_img, d_w), (r_img, r_w) = bwd(), bwd_plain()
    sync(device)
    e_fwd = float((out - ref).abs().max())
    e_dw = float((d_w - r_w).abs().max())
    scale = float(r_img.abs().max())
    e_dimg = float((d_img - r_img).abs().max())
    print(f"[kernels] {label}: fwd {e_fwd:.3e} d_w {e_dw:.3e} d_img "
          f"{e_dimg:.3e} (max|d_img| {scale:.3e})", flush=True)
    if not (e_fwd <= TOL_FWD and e_dw <= TOL_DW
            and e_dimg <= TOL_DIMG_REL * scale):
        raise AssertionError(
            f"kernel disagrees with its twin: {label} fwd {e_fwd} d_w "
            f"{e_dw} d_img {e_dimg} (limit {TOL_DIMG_REL * scale})")
    worst["fwd"] = max(worst["fwd"], e_fwd)
    worst["bwd"] = max(worst["bwd"], e_dw, e_dimg)


def check_nearest(device, cases=((BATCH, SHAPE), (BATCH3D, SHAPE3D))):
    """Phase 6: 2D and 3D nearest sampling (on the band and z-band kernels)
    on the card against the same calls on the CPU (the plain twins), output
    and image gradient, at the main paths' shapes (C=1, rotation grids,
    zeros padding)."""
    import torch
    from advchain_tpu_torch.ops.grid_sample import grid_sample
    for n, shape in cases:
        _, padding, grid = sample_grids(n, shape, device)[0]
        gen = torch.Generator(device=device).manual_seed(11)
        img = torch.randn((n, 1) + tuple(shape), generator=gen,
                          device=device)
        cot = torch.randn(img.shape, generator=gen, device=device)
        res = []
        for dev in (device, "cpu"):
            x = img.detach().to(dev).clone().requires_grad_(True)
            out = grid_sample(x, grid.to(dev), mode="nearest",
                              padding_mode=padding)
            (out * cot.to(dev)).sum().backward()
            res.append((out.detach().cpu(), x.grad.cpu()))
        e_out = float((res[0][0] - res[1][0]).abs().max())
        e_img = float((res[0][1] - res[1][1]).abs().max())
        scale = float(res[1][1].abs().max())
        print(f"[nearest] {len(shape)}D {tuple(shape)}: out {e_out:.3e} "
              f"d_img {e_img:.3e} (max|d_img| {scale:.3e})", flush=True)
        if not (e_out <= TOL_FWD and e_img <= TOL_DIMG_REL * scale):
            raise AssertionError(f"{len(shape)}D nearest sampling on the "
                                 f"card disagrees with the CPU")


def check_episode_against_cpu(device, batch=2, shape=(64, 64)):
    """Phases 3 and 7: the same small episodes on ``device`` and on the CPU
    (plain twins), with identical weights and transform parameters (and,
    in 3D, dropout 0).

    Full chain without PGD: dist within 1e-3 absolute in 2D, 1e-4
    relative in 3D (morph's 8 or more self-compositions amplify rounding,
    tests/test_reference_e2e.py).  Morph-free chain, one PGD step on the
    noise alone: with power iteration the new noise is the unit-normalised
    gradient of the divergence, which runs back through the affine warp's
    backward kernel and the network, so each sample's direction must agree
    to cosine 0.999, and dist to 1e-2 relative.  (A PGD step's outcome is
    not compared tighter: ReLU and max-pool switches move gradients between
    two devices, and affine's sign-of-gradient update would amplify
    them.)"""
    import torch
    dims = len(shape)
    model_d = build_model(device, dims=dims, dropout=0.0)
    model_c = build_model("cpu", dims=dims, dropout=0.0)
    model_c.module.load_state_dict(model_d.module.state_dict())
    data = torch.as_tensor(make_input(batch, shape))
    results = {}
    for names, n_iter, flags in (
            (("noise", "bias", "affine", "morph"), 0, None),
            (("noise", "bias", "affine"), 1, [True, False, False])):
        solvers = [build_solver(batch, shape, names) for _ in range(2)]
        gen = torch.Generator().manual_seed(7)
        params = [t.init_params(gen) for t in solvers[0].chain_of_transforms]
        dists = []
        for solver, model, dev in ((solvers[0], model_d, device),
                                   (solvers[1], model_c, "cpu")):
            solver.set_transformation(params)
            d = solver.adversarial_training(
                data.to(dev), model, optimize_flags=flags, n_iter=n_iter,
                lazy_load=True, power_iteration="smart", step_sizes=1.0)
            dists.append(float(d))
        diff = abs(dists[0] - dists[1])
        noise = [s.chain_of_transforms[0].param.cpu().reshape(batch, -1)
                 for s in solvers]
        cos = float(torch.nn.functional.cosine_similarity(*noise).min())
        key = f"{dims}D " + "+".join(names) + f" n_iter={n_iter}"
        print(f"[reference] {key}: dist {dists[0]:.6e} vs cpu "
              f"{dists[1]:.6e} (abs {diff:.2e}, rel "
              f"{diff / abs(dists[1]):.2e}), noise cosine {cos:.7f}",
              flush=True)
        if n_iter == 0:
            ok = diff < 1e-3 if dims == 2 else diff <= 1e-4 * abs(dists[1])
        else:
            ok = diff < 1e-2 * abs(dists[1]) and cos > 0.999
        if not ok:
            raise AssertionError(f"episode disagrees with the CPU run: {key}")
        results[key] = (diff, cos)
    return results


def episode_once(solver, model, data, power_iteration="smart"):
    dist = solver.adversarial_training(data=data, model=model, n_iter=1,
                                       power_iteration=power_iteration,
                                       step_sizes=1.0)
    sync(data.device)
    return dist


def run_episode(device, batch, shape, warm=2, reps=5):
    """Phases 4 and 8: returns (launch counts of one episode, median
    seconds per episode, all rep times, final loss, peak device bytes
    allocated, adaptive step counts of that episode)."""
    import torch
    from advchain_tpu_torch.ops import integrate
    dims = len(shape)
    solver = build_solver(batch, shape)
    model = build_model(device, dims=dims)
    data = torch.as_tensor(make_input(batch, shape), device=device)
    pi = POWER_ITERATION[dims]
    for _ in range(warm):
        episode_once(solver, model, data, pi)
    times = []
    launches = steps = None
    if data.is_cuda:
        torch.cuda.reset_peak_memory_stats()
    for i in range(reps):
        if i == 0:
            reset_launch_counts()
            integrate.ADAPTIVE_STEPS.clear()
        t0 = time.perf_counter()
        dist = episode_once(solver, model, data, pi)
        times.append(time.perf_counter() - t0)
        if i == 0:
            launches = launch_counts()
            steps = list(integrate.ADAPTIVE_STEPS)
            loss = float(dist)
            adv = solver.adv_data
            warped = solver.warped_back_adv_output
            if not (math.isfinite(loss)
                    and tuple(adv.shape) == (batch, 1) + tuple(shape)
                    and bool(torch.isfinite(adv).all())
                    and tuple(warped.shape) == (batch, 4) + tuple(shape)
                    and bool(torch.isfinite(warped).all())):
                raise AssertionError(f"episode output is not finite or has "
                                     f"the wrong shape (loss {loss})")
    fam = route_family(dims)
    for used in [fam] + (["stencil"] if dims == 2 else []):
        if not (launches[used]["fwd"] > 0 and launches[used]["bwd"] > 0):
            raise AssertionError(f"the {dims}D episode did not launch both "
                                 f"{used} kernels: {launches}")
    # one dispatch predicate per composition whose grid takes a gradient:
    # in 2D one per stencil backward; in 3D one per squaring of the PGD
    # step's two exponentiations (the forward and the inverse morph; the
    # final pass's two take none)
    compositions = launches["stencil"]["bwd"] if dims == 2 \
        else sum(steps[:2])
    if len(steps) != (0 if dims == 2 else 4) \
            or launches["slope"]["fwd"] != compositions:
        raise AssertionError(f"the {dims}D episode launched "
                             f"{launches['slope']['fwd']} dispatch predicates "
                             f"for {compositions} differentiated "
                             f"compositions (adaptive steps {steps})")
    # a legacy route replaces the default family's bilinear launches (the
    # episodes sample nothing with nearest); no route takes the
    # corner-level band or z-band pair since the grid-level pairs
    idle = ([DEFAULT_FAMILY[dims]] if fam != DEFAULT_FAMILY[dims] else []) \
        + [CORNER_LEVEL[dims]]
    for other in idle:
        if any(launches[other].values()):
            raise AssertionError(f"the {dims}D episode on the {fam} route "
                                 f"launched {other} kernels: {launches}")
    peak = torch.cuda.max_memory_allocated() if data.is_cuda else 0
    return launches, statistics.median(times), times, loss, peak, steps


def time_ms(fn, iters=20):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events).
    The launches are queued behind a sleep kernel that outlasts their
    enqueueing, so the events time the device's work and not the host's
    launch rate (a 3D sampler kernel runs for less time than a Python call
    takes to launch it)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0  # bounds one call's enqueue time
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # cycles at the H100's 1.98 GHz peak clock: at a lower clock the sleep
    # only lasts longer
    torch.cuda._sleep(int(min(2 * iters * host_s, 2.0) * SM_CLOCK_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_bwd_ms(fn, inputs, cot):
    """The row entries of the library's backward alone and of its forward
    and backward together: ``fn()`` computes the library call's output
    from ``inputs``; its graph is built before the first timed window,
    which times only ``torch.autograd.grad`` of it with ``cot`` (retaining
    the graph)."""
    import torch
    out = fn()
    alone = time_ms(lambda: torch.autograd.grad(out, inputs, cot,
                                                retain_graph=True))
    both = time_ms(lambda: torch.autograd.grad(fn(), inputs, cot))
    return {"bwd_library_ms": alone, "fwd_bwd_library_ms": both}


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_kernels(n, shape, device, channels=(1, 2, 5)):
    """Phases 5 and 9: timings per case: kernel, twin, library, and the
    bound.  Bytes: each input read once and each output written once (f32
    and int32, 4 bytes); operations: the weighted sum's multiplies and adds
    (forward), the weight gradient's and the scatter's (backward)."""
    import torch
    import torch.nn.functional as F
    dims = len(shape)
    fam, mod = sampler(dims)
    fwd, fwd_plain = (getattr(mod, f"{fam}_sample_fwd"),
                      getattr(mod, f"{fam}_sample_fwd_plain"))
    bwd, bwd_plain = (getattr(mod, f"{fam}_sample_bwd"),
                      getattr(mod, f"{fam}_sample_bwd_plain"))
    k = 2 ** dims  # corners
    s = math.prod(shape)
    rows = []
    for name, padding, grid in sample_grids(n, shape, device):
        p = grid[0, ..., 0].numel()
        for c in channels:
            img, idx, wts, g = kernel_inputs(n, c, shape, grid, padding,
                                             device)
            f4 = 4
            fwd_bytes = f4 * (n * c * s + dims * n * p + k * n * p
                              + n * c * p)
            bwd_bytes = f4 * (n * c * p + n * c * s + dims * n * p
                              + k * n * p + n * c * s + k * n * p)
            fwd_bound = bound_ms(fwd_bytes, (2 * k - 1) * n * c * p)
            bwd_bound = bound_ms(bwd_bytes, 4 * k * n * c * p)
            img_g = img.clone().requires_grad_(True)
            grid_g = grid.clone().requires_grad_(True)
            g_img = g.reshape(img.shape)

            def lib():
                return F.grid_sample(img_g, grid_g, mode="bilinear",
                                     padding_mode=padding, align_corners=True)

            with torch.no_grad():
                row = {
                    "kernel": fam, "case": name, "padding": padding, "C": c,
                    "fwd_ms": time_ms(lambda: fwd(img, *idx, wts)),
                    "fwd_plain_ms": time_ms(lambda: fwd_plain(img, *idx,
                                                              wts)),
                    "fwd_library_ms": time_ms(lambda: F.grid_sample(
                        img, grid, mode="bilinear", padding_mode=padding,
                        align_corners=True)),
                    "fwd_bound_ms": fwd_bound[0],
                    "bwd_ms": time_ms(lambda: bwd(g, img, *idx, wts)),
                    "bwd_plain_ms": time_ms(lambda: bwd_plain(g, img, *idx,
                                                              wts)),
                    "bwd_bound_ms": bwd_bound[0],
                }
            row.update(library_bwd_ms(lib, (img_g, grid_g), g_img))
            row["bound_by"] = [fwd_bound[1], bwd_bound[1]]
            rows.append(row)
            print("[timing] " + json.dumps(row), flush=True)
    return rows


def time_nearest(device, cases=((BATCH, SHAPE), (BATCH3D, SHAPE3D))):
    """Phase 9: nearest sampling rides the sampler kernels with unit
    corner-0 weights; time each kernel on those inputs (C=1, the rotation
    grid, zeros padding) beside its twin and ``F.grid_sample(mode=
    "nearest")``, with the kernels' byte bound."""
    import torch
    import torch.nn.functional as F
    from advchain_tpu_torch.ops.grid_sample import nearest_weights
    rows = []
    for n, shape in cases:
        dims = len(shape)
        fam, mod = sampler(dims)
        name, padding, grid = sample_grids(n, shape, device)[0]
        gen = torch.Generator(device=device).manual_seed(5)
        img = torch.randn((n, 1) + tuple(shape), generator=gen,
                          device=device)
        idx, wts = nearest_weights(grid, shape, padding)
        p = wts.shape[2]
        g = torch.randn(n, 1, p, generator=gen, device=device)
        k, s = 2 ** dims, math.prod(shape)
        fwd_bound = bound_ms(4 * (n * s + dims * n * p + k * n * p + n * p),
                             (2 * k - 1) * n * p)
        bwd_bound = bound_ms(4 * (n * p + 2 * n * s + dims * n * p
                                  + 2 * k * n * p), 4 * k * n * p)
        img_g = img.clone().requires_grad_(True)
        g_img = g.reshape((n, 1) + tuple(grid.shape[1:-1]))

        def lib():
            return F.grid_sample(img_g, grid, mode="nearest",
                                 padding_mode=padding, align_corners=True)

        with torch.no_grad():
            row = {
                "kernel": fam, "mode": "nearest", "case": name,
                "padding": padding, "C": 1,
                "fwd_ms": time_ms(lambda: getattr(mod, f"{fam}_sample_fwd")(
                    img, *idx, wts)),
                "fwd_plain_ms": time_ms(lambda: getattr(
                    mod, f"{fam}_sample_fwd_plain")(img, *idx, wts)),
                "fwd_library_ms": time_ms(lambda: F.grid_sample(
                    img, grid, mode="nearest", padding_mode=padding,
                    align_corners=True)),
                "fwd_bound_ms": fwd_bound[0],
                "bwd_ms": time_ms(lambda: getattr(mod, f"{fam}_sample_bwd")(
                    g, img, *idx, wts)),
                "bwd_plain_ms": time_ms(lambda: getattr(
                    mod, f"{fam}_sample_bwd_plain")(g, img, *idx, wts)),
                "bwd_bound_ms": bwd_bound[0],
            }
        row.update(library_bwd_ms(lib, img_g, g_img))
        row["bound_by"] = [fwd_bound[1], bwd_bound[1]]
        rows.append(row)
        print("[timing] " + json.dumps(row), flush=True)
    return rows


def profile_episode(device, batch, shape, path):
    """Profile one episode (see :func:`profile_run`); returns its
    summary."""
    import torch
    dims = len(shape)
    solver = build_solver(batch, shape)
    model = build_model(device, dims=dims)
    data = torch.as_tensor(make_input(batch, shape), device=device)
    pi = POWER_ITERATION[dims]
    return profile_run(f"{dims}D episode",
                       lambda: episode_once(solver, model, data, pi), path)


def profile_run(label, fn, path):
    """Device time of one call of ``fn`` (after one warm-up call) by
    kernel (torch.profiler), written to ``path`` as JSON; prints the busy
    time, the kernel launches and the largest kernels, and returns the
    wall and busy times and the launch count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    wall = (time.perf_counter() - t0) * 1e3
    rows = [{"name": e.key, "count": e.count,
             "device_ms": e.self_device_time_total / 1e3}
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    launches = sum(r["count"] for r in rows)
    # the port's kernels, by the names in their sources
    samp = sum(r["device_ms"] for r in rows
               if any(k in r["name"] for k in PORT_KERNEL_NAMES))
    summary = {"wall_ms": wall, "device_busy_ms": busy,
               "device_launches": launches, "port_kernels_ms": samp}
    with open(path, "w") as f:
        json.dump(dict(summary, kernels=rows[:60]), f, indent=1)
    print(f"[profile] {label} {wall:.1f} ms under the profiler, "
          f"device busy {busy:.1f} ms over {launches} kernel launches, the "
          f"port's kernels {samp:.1f} ms; top: " + "; ".join(
              f"{r['name'][:50]} {r['device_ms']:.1f} ms x{r['count']}"
              for r in rows[:6]), flush=True)
    return summary


# ---------------------------------------------------------------- slice 3
def stencil_flows(n, shape, device, seed=0):
    """(name, flow) pairs (N, 2, H, W) for the stencil kernels: a
    near-identity flow of up to 1.9 px (the early scaling-and-squaring
    compositions), the same with its border rows and columns reset to the
    base grid (exactly +-1: the lower bound's slope, taps within the
    gather's window), and one of up to 20 px whose top rows run past the
    border, with 5% of its entries set to exactly +-1."""
    import torch
    from advchain_tpu_torch.ops.integrate import base_grid
    gen = torch.Generator(device=device).manual_seed(seed)
    h, w = shape
    base = base_grid(n, shape, device=device)
    px = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)],
                      device=device).reshape(1, 2, 1, 1)

    def jitter(disp):
        return base + (2 * torch.rand(base.shape, generator=gen,
                                      device=device) - 1) * disp * px

    far = jitter(20.0)
    far[:, :, :8] *= 1.3
    pick = torch.rand(far.shape, generator=gen, device=device) < 0.05
    sign = torch.where(torch.rand(far.shape, generator=gen, device=device)
                       < 0.5, -1.0, 1.0)
    far = torch.where(pick, sign, far)
    near = jitter(1.9)
    border = torch.where(base.abs() == 1, base, near)
    return [("near_identity", near.contiguous()),
            ("near_border_pm1", border.contiguous()),
            ("far_bounds", far.contiguous())]


def morph_squarings(device, batch=BATCH, shape=SHAPE, seed=0):
    """The 8 squaring inputs (N, 2, H, W) of one seeded headline morph
    (``AdvMorph`` with the headline config, parameters from a seeded
    generator, scaled by epsilon): each composition's flow, captured from
    ``compose_flow`` as the exponentiation calls it."""
    import torch
    from advchain_tpu_torch.augmentor import AdvMorph
    from advchain_tpu_torch.ops import integrate
    morph = AdvMorph(spatial_dims=2,
                     config_dict=chain_configs(batch, shape)["morph"])
    params = morph.init_params(torch.Generator().manual_seed(seed)).to(
        device)
    flows, real = [], integrate.compose_flow

    def capture(flow1, flow2):
        flows.append(flow2.detach().clone())
        return real(flow1, flow2)

    integrate.compose_flow = capture
    try:
        with torch.no_grad():
            morph.demons_compose(morph._duv(params, training=False))
    finally:
        integrate.compose_flow = real
    if len(flows) != 8:
        raise AssertionError(f"the headline morph composed {len(flows)} "
                             f"times, not 8")
    return flows


def stencil_inputs(n, c, flow, seed=0):
    import torch
    gen = torch.Generator(device=flow.device).manual_seed(seed + c)
    shape = (n, c) + tuple(flow.shape[2:])
    return (torch.randn(shape, generator=gen, device=flow.device),
            torch.randn(shape, generator=gen, device=flow.device))


def stencil_cases(n, shape, device, channels=(1, 2, 5)):
    """Phase 10's cases, (label, img, flow, g): :func:`stencil_flows` at
    each channel count, and at the main path's shape the 8 squaring inputs
    of :func:`morph_squarings`, each warping itself (C=2), as the
    exponentiation does."""
    cases = []
    for name, flow in stencil_flows(n, shape, device):
        for c in channels:
            img, g = stencil_inputs(n, c, flow)
            cases.append((f"{name} C={c}", img, flow, g))
    if (n, tuple(shape)) == (BATCH, SHAPE):
        for k, flow in enumerate(morph_squarings(device)):
            cases.append((f"squaring {k} C=2", flow, flow,
                          stencil_inputs(n, 2, flow, seed=k)[1]))
    return cases


def check_stencil(n, shape, device, channels=(1, 2, 5)):
    """Phase 10: the stencil kernels against their twins on
    :func:`stencil_cases`, the backward with both dispatch slopes (1, the
    stencil's, and 0.5, the sampler's).  Forward within TOL_FWD absolute;
    ``d_flow`` within TOL_DFLOW_REL and ``d_img`` within TOL_DIMG_REL of
    their largest entries (channel sums, and the atomics of taps outside
    the gather's window, reassociate); the count of those taps equal to its
    plain version's.  Returns the largest absolute errors."""
    import torch
    from advchain_tpu_torch.kernels import stencil_warp as sw
    worst = {"fwd": 0.0, "bwd": 0.0}
    slopes = [torch.tensor([s], device=device) for s in (1.0, 0.5)]
    for label, img, flow, g in stencil_cases(n, shape, device, channels):
        with torch.no_grad():
            out = sw.stencil_warp_fwd(img, flow)
            ref = sw.stencil_warp_fwd_plain(img, flow)
        sync(device)
        e_fwd = float((out - ref).abs().max())
        msg = [f"fwd {e_fwd:.3e}"]
        ok = e_fwd <= TOL_FWD
        for slope in slopes:
            with torch.no_grad():
                d_img, d_flow = sw.stencil_warp_bwd(g, img, flow, slope)
                r_img, r_flow = sw.stencil_warp_bwd_plain(g, img, flow,
                                                          slope)
            sync(device)
            e_flow = float((d_flow - r_flow).abs().max())
            e_img = float((d_img - r_img).abs().max())
            s_flow = float(r_flow.abs().max())
            s_img = float(r_img.abs().max())
            msg.append(f"slope {float(slope):.1f}: d_flow {e_flow:.3e} "
                       f"(max {s_flow:.3e}) d_img {e_img:.3e} (max "
                       f"{s_img:.3e})")
            ok = (ok and e_flow <= TOL_DFLOW_REL * s_flow
                  and e_img <= TOL_DIMG_REL * s_img)
            worst["bwd"] = max(worst["bwd"], e_flow, e_img)
        outside = int(sw.LAST_OUT_OF_WINDOW) if device != "cpu" else None
        expect = sw.out_of_window_plain(flow)
        msg.append(f"taps outside the window {outside} (plain {expect})")
        print(f"[stencil] {label}: " + "; ".join(msg), flush=True)
        if not ok or (outside is not None and outside != expect):
            raise AssertionError(f"stencil kernel disagrees with its twin: "
                                 f"{label}: " + "; ".join(msg))
        worst["fwd"] = max(worst["fwd"], e_fwd)
    return worst


def check_stencil_determinism(n, shape, device):
    """Phase 10: two backward runs on the near-identity flow (every tap in
    the gather's window) give the same ``d_img`` bit for bit."""
    import torch
    from advchain_tpu_torch.kernels import stencil_warp as sw
    _, flow = stencil_flows(n, shape, device)[0]
    img, g = stencil_inputs(n, 2, flow)
    with torch.no_grad():
        runs = [sw.stencil_warp_bwd(g, img, flow) for _ in range(2)]
    sync(device)
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"[stencil] near_identity: two backward runs bit-identical "
          f"{same}", flush=True)
    if not same:
        raise AssertionError("the stencil backward is not deterministic on "
                             "the near-identity flow")


def check_dispatch_slope(device):
    """Phase 10: the dispatch predicate's kernel against its twin, equal
    ``[slope, dpx]``, on phase 10's 2D flows and the 3D episode's
    near-identity grid at half, once and twice its displacement, below and
    past each radius.  Returns the largest |kernel - twin|."""
    import torch
    from advchain_tpu_torch.kernels import stencil_warp as sw
    from advchain_tpu_torch.ops.integrate import base_grid
    flows = [(name, 2, f) for name, f in stencil_flows(BATCH, SHAPE, device)]
    near3 = sample_grids(BATCH3D, SHAPE3D, device)[1][2].movedim(-1, 1)
    base3 = base_grid(BATCH3D, SHAPE3D, device=device)
    flows += [(f"{name}_3d", 1, (base3 + k * (near3 - base3)).contiguous())
              for name, k in (("half", 0.5), ("near_identity", 1.0),
                              ("twice", 2.0))]
    sides, worst = set(), 0.0
    for name, radius, flow in flows:
        out = sw.dispatch_slope(flow, radius)
        ref = sw.dispatch_slope_plain(flow, radius)
        sync(device)
        print(f"[slope] {name}: [slope, dpx] {out.tolist()} (plain "
              f"{ref.tolist()})", flush=True)
        if not torch.equal(out, ref):
            raise AssertionError(f"the dispatch predicate disagrees with its "
                                 f"twin on {name}")
        worst = max(worst, float((out - ref).abs().max()))
        sides.add(float(ref[0]))
    if sides != {0.5, 1.0}:
        raise AssertionError(f"the predicate's cases took one side: {sides}")
    return worst


def make_labels(batch, shape):
    """Random integer labels (bench.py:432-435)."""
    return np.random.RandomState(0).randint(0, 4, (batch,) + tuple(shape))


def build_train_step(device, batch, shape, names=("noise", "bias", "affine",
                                                  "morph"),
                     supervised=False):
    """(step, state, batch dict) of the headline train step (bench.py:
    408-447): UNet_16 with seeded random weights, Adam 1e-4, n_iter=1,
    smart power iteration, mse + contour; or the supervised step."""
    import torch
    from advchain_tpu_torch.parallel import (TrainState,
                                             make_adversarial_train_step,
                                             make_supervised_train_step)
    model = build_model(device)
    opt = torch.optim.Adam(model.module.parameters(), lr=LR)
    if supervised:
        step = make_supervised_train_step(model, opt)
    else:
        step = make_adversarial_train_step(
            model, build_solver(batch, shape, names), opt, n_iter=1,
            power_iteration="smart")
    data = {"image": torch.as_tensor(make_image(batch, shape),
                                     device=device),
            "label": torch.as_tensor(make_labels(batch, shape),
                                     device=device)}
    return step, TrainState.create(model, opt), data


def check_train_step_against_cpu(device, batch=2, shape=(32, 32), steps=2):
    """Phase 11: the same adversarial train steps on ``device`` and on the
    CPU: identical weights, and the transform draws made by two CPU
    generators of one seed.  Held to tests/test_torch_train.py's
    tolerances: step 1's supervised loss to 1e-5 relative, consistency
    loss to 0.12 (the morph DIVERGENCE bound) and total to 1.2e-2; step
    2's supervised and total losses to 1e-2 and consistency to 0.12;
    every weight after step 1 within 2 lr (Adam's first step moves a
    weight by about lr * sign(g))."""
    import torch
    runs = []
    for dev in (device, "cpu"):
        # seeded weights: the same on both devices
        step, state, data = build_train_step(dev, batch, shape)
        gen = torch.Generator().manual_seed(3)
        metrics, first = [], None
        for i in range(steps):
            state, m = step(state, data, gen)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                first = {k: v.detach().cpu().clone() for k, v in
                         state.model.module.state_dict().items()}
        runs.append((metrics, first))
    (m_d, w_d), (m_c, w_c) = runs
    rel = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in a}
           for a, b in zip(m_d, m_c)]
    w_err = max(float((w_d[k] - w_c[k]).abs().max()) for k in w_c
                if "running" not in k and "num_batches" not in k)
    print(f"[train-ref] batch {batch} {shape}: losses {m_d} vs cpu {m_c}, "
          f"relative {rel}, weights after step 1 max {w_err:.3e} "
          f"(2 lr = {2 * LR:.1e})", flush=True)
    ok = (rel[0]["supervised_loss"] < 1e-5
          and rel[0]["consistency_loss"] < 0.12
          and rel[0]["total_loss"] < 1.2e-2
          and all(r["supervised_loss"] < 1e-2 and r["total_loss"] < 1e-2
                  and r["consistency_loss"] < 0.12 for r in rel[1:])
          and w_err <= 2 * LR * (1 + 1e-4))
    if not ok:
        raise AssertionError("train step on the card disagrees with the CPU")
    return rel, w_err


def run_train_step(device, batch, shape, supervised=False, warm=2, reps=5):
    """Phase 12: returns (launch counts of one step, median seconds per
    step, all rep times, the first timed step's metrics, peak device bytes
    allocated)."""
    import torch
    step, state, data = build_train_step(device, batch, shape,
                                         supervised=supervised)
    gen = torch.Generator(device=device).manual_seed(1)
    for _ in range(warm):
        state, _ = step(state, data, gen)
    sync(device)
    if data["image"].is_cuda:
        torch.cuda.reset_peak_memory_stats()
    times, launches, first = [], None, None
    for i in range(reps):
        if i == 0:
            reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, data, gen)
        sync(device)
        times.append(time.perf_counter() - t0)
        if i == 0:
            launches = launch_counts()
            first = {k: float(v) for k, v in metrics.items()}
            if not all(math.isfinite(v) for v in first.values()):
                raise AssertionError(f"train step loss is not finite: "
                                     f"{first}")
    if not supervised:
        for fam in (route_family(2), "stencil"):
            if not (launches[fam]["fwd"] > 0 and launches[fam]["bwd"] > 0):
                raise AssertionError(f"the train step did not launch both "
                                     f"{fam} kernels: {launches}")
        if launches["slope"]["fwd"] != launches["stencil"]["bwd"]:
            raise AssertionError(f"the train step did not launch one "
                                 f"dispatch predicate per differentiated "
                                 f"composition: {launches}")
    peak = torch.cuda.max_memory_allocated() if data["image"].is_cuda else 0
    return launches, statistics.median(times), times, first, peak


def time_stencil(n, shape, device, channels=(2,)):
    """Phase 13: kernel, twin and ``F.grid_sample`` (bilinear, border,
    align_corners=True) times on the near-identity flow, with the bounds;
    the backward on each of the 8 squaring inputs of a seeded headline
    morph (each warping itself), with its share of taps outside the
    gather's window; the dispatch predicate.  The library's channel-last
    grid is copied before the timed window.  Bytes: forward reads img and
    flow and writes out; backward reads g, img and flow and writes d_img
    and d_flow (on a squaring img is flow: read once); the predicate reads
    the flow.  Operations: 9 per (pixel,
    channel) and 12 per pixel forward, 24 and 22 backward, 8 per pixel for
    the predicate."""
    import torch
    import torch.nn.functional as F
    from advchain_tpu_torch.kernels import stencil_warp as sw
    p = math.prod(shape)
    rows = []
    _, flow = stencil_flows(n, shape, device)[0]
    grid = flow.movedim(1, -1).contiguous()
    for c in channels:
        img, g = stencil_inputs(n, c, flow)
        fwd_bound = bound_ms(4 * n * p * (2 * c + 2), n * p * (9 * c + 12))
        bwd_bound = bound_ms(4 * n * p * (3 * c + 4), n * p * (24 * c + 22))
        img_g = img.clone().requires_grad_(True)
        grid_g = grid.clone().requires_grad_(True)

        def lib():
            return F.grid_sample(img_g, grid_g, mode="bilinear",
                                 padding_mode="border", align_corners=True)

        with torch.no_grad():
            row = {
                "kernel": "stencil", "case": "near_identity",
                "padding": "border", "C": c,
                "fwd_ms": time_ms(lambda: sw.stencil_warp_fwd(img, flow)),
                "fwd_plain_ms": time_ms(
                    lambda: sw.stencil_warp_fwd_plain(img, flow)),
                "fwd_library_ms": time_ms(lambda: F.grid_sample(
                    img, grid, mode="bilinear", padding_mode="border",
                    align_corners=True)),
                "fwd_bound_ms": fwd_bound[0],
                "bwd_ms": time_ms(lambda: sw.stencil_warp_bwd(g, img, flow)),
                "bwd_plain_ms": time_ms(
                    lambda: sw.stencil_warp_bwd_plain(g, img, flow)),
                "bwd_bound_ms": bwd_bound[0],
            }
        row.update(library_bwd_ms(lib, (img_g, grid_g), g))
        row["bound_by"] = [fwd_bound[1], bwd_bound[1]]
        rows.append(row)
        print("[timing] " + json.dumps(row), flush=True)
    squarings = []
    for k, phi in enumerate(morph_squarings(device)):
        g = stencil_inputs(n, 2, phi, seed=k)[1]
        with torch.no_grad():
            ms = time_ms(lambda: sw.stencil_warp_bwd(g, phi, phi))
        squarings.append({
            "squaring": k, "bwd_ms": ms,
            "dpx": float(sw.dispatch_slope(phi, 2)[1]),
            "out_of_window_share": int(sw.LAST_OUT_OF_WINDOW) / (4 * n * p)})
    # g, the flow (also the image) and d_img: 2 planes each; d_flow 2
    total = {"kernel": "stencil", "case": "headline morph squarings",
             "bwd_ms": sum(r["bwd_ms"] for r in squarings),
             "bwd_bound_ms": len(squarings) * bound_ms(
                 4 * n * p * (2 + 2 + 2 + 2), n * p * (24 * 2 + 22))[0],
             "squarings": squarings}
    print("[timing] " + json.dumps(total), flush=True)
    print("[stencil] out-of-window share per squaring: " + json.dumps(
        [round(r["out_of_window_share"], 6) for r in squarings]), flush=True)
    rows[0]["squarings_bwd_ms"] = total["bwd_ms"]
    rows[0]["squarings_bwd_bound_ms"] = total["bwd_bound_ms"]
    slope_bound = bound_ms(4 * n * p * 2, 8 * n * p)
    with torch.no_grad():
        slope_row = {
            "kernel": "slope", "case": "near_identity", "padding": "border",
            "C": 2, "fwd_ms": time_ms(lambda: sw.dispatch_slope(flow, 2)),
            "fwd_plain_ms": time_ms(lambda: sw.dispatch_slope_plain(flow, 2)),
            "fwd_bound_ms": slope_bound[0], "bound_by": [slope_bound[1]],
            "fwd_library_ms": None}
    print("[timing] " + json.dumps(slope_row), flush=True)
    return rows, slope_row


# ---------------------------------------------------------------- slice 4
@contextlib.contextmanager
def legacy_route(dims):
    """``LEGACY_SWITCH[dims]=0`` inside the block (2D sampling on the
    corner kernels, 3D trilinear on the plane kernels); the environment is
    restored after it."""
    name = LEGACY_SWITCH[dims]
    prev = os.environ.get(name)
    os.environ[name] = "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def flat_grids(n, shape, device):
    """Phase 14's grids: :func:`sample_grids`' two, with 5% of the
    near-identity grid's entries set to exactly +-1, so that bases sit on
    the last column (in 2D its +1 tap wraps to the next row) and on the
    last row and plane (taps past the plane's flat end read zero), beside
    the rotation's samples past the border."""
    import torch
    grids = sample_grids(n, shape, device)
    name, padding, near = grids[1]
    gen = torch.Generator(device=device).manual_seed(1)
    pick = torch.rand(near.shape, generator=gen, device=device) < 0.05
    sign = torch.where(torch.rand(near.shape, generator=gen, device=device)
                       < 0.5, -1.0, 1.0)
    grids[1] = (name, padding, torch.where(pick, sign, near))
    return grids


def flat_inputs(n, c, shape, grid, padding, k, device, seed=0):
    """(route, img, index tuple, weights, cotangent, offsets) for the
    corner (2D) or plane (3D) kernels with ``k`` taps, built as the routes
    build them: K=4 the folded bilinear weights on offsets (0, 1, w, w+1)
    (in 3D those of the dz = 0 launch); 2D K=1 nearest's unit tap; 3D K=2
    the first two of those weights on offsets (0, 1), the taps of JAX's
    4-base formulation."""
    import torch
    from advchain_tpu_torch.ops.grid_sample import (corner_weights,
                                                    nearest_weights,
                                                    plane_weights)
    gen = torch.Generator(device=device).manual_seed(seed + c)
    img = torch.randn((n, c) + tuple(shape), generator=gen, device=device)
    *lead, h, w = shape
    if not lead:
        if k == 1:
            (yidx, xidx), wts = nearest_weights(grid, shape, padding)
        else:
            yidx, xidx, wts = corner_weights(grid, h, w, padding, True)
        route, idx = "corner", (yidx * w + xidx,)
    else:
        zidx, yxidx, wts = plane_weights(grid, lead[0], h, w, padding, True)
        route, idx, wts = "plane", (zidx[0], yxidx), wts[0]
    img = img.reshape(n, c, *lead, h * w)
    g = torch.randn(n, c, idx[-1].shape[1], generator=gen, device=device)
    offsets = {1: (0,), 2: (0, 1), 4: (0, 1, w, w + 1)}[k]
    return route, img, idx, wts[:, :k].contiguous(), g, offsets


def check_flat_kernels(n, shape, device, channels, taps):
    """Phase 14: the corner (2D) or plane (3D) kernels against their twins
    on :func:`flat_grids`, for each channel count and tap count, at phase
    2's tolerances.  Returns the largest errors."""
    from advchain_tpu_torch.kernels import plane_sample as ps
    worst = {"fwd": 0.0, "bwd": 0.0}
    for name, padding, grid in flat_grids(n, shape, device):
        for c in channels:
            for k in taps:
                route, img, idx, wts, g, offs = flat_inputs(
                    n, c, shape, grid, padding, k, device)
                kern = {f"{kind}{plain}": getattr(
                    ps, f"{route}_sample_{kind}{plain}")
                    for kind in ("fwd", "bwd") for plain in ("", "_plain")}
                hold_against_twin(
                    f"{route:6s} {name:13s} {padding:6s} C={c} K={k}",
                    device, lambda: kern["fwd"](img, *idx, wts, offs),
                    lambda: kern["fwd_plain"](img, *idx, wts, offs),
                    lambda: kern["bwd"](g, img, *idx, wts, offs),
                    lambda: kern["bwd_plain"](g, img, *idx, wts, offs),
                    worst)
    return worst


def compare_routes(device, batch, shape):
    """Phases 15 and 16: the episode on the default route and on the legacy
    route (``LEGACY_SWITCH=0``), each with a fresh model of one seed (so
    one dropout draw) and the same injected transform parameters.  The
    routes compute one function; returns (default loss, legacy loss)."""
    import torch
    dims = len(shape)
    data = torch.as_tensor(make_input(batch, shape), device=device)
    gen = torch.Generator().manual_seed(7)
    params, losses = None, []
    for legacy in (False, True):
        solver = build_solver(batch, shape)
        model = build_model(device, dims=dims)
        if params is None:
            params = [t.init_params(gen) for t in solver.chain_of_transforms]
        solver.set_transformation(params)
        with legacy_route(dims) if legacy else contextlib.nullcontext():
            dist = solver.adversarial_training(
                data=data, model=model, n_iter=1, lazy_load=True,
                power_iteration=POWER_ITERATION[dims], step_sizes=1.0)
        losses.append(float(dist))
    return tuple(losses)


def run_legacy_episode(device, batch, shape, card):
    """Phases 15 and 16: compare the routes' losses (within TOL_ROUTES
    relative), then count one episode's launches on the legacy route and
    time 3 episodes after 2 warm-ups.  Returns run_episode's result."""
    dims = len(shape)
    loss_d, loss_l = compare_routes(device, batch, shape)
    rel = abs(loss_l - loss_d) / abs(loss_d)
    fam = {2: "corner", 3: "plane"}[dims]
    print(f"[legacy] {dims}D {fam} route: loss {loss_l:.8e} vs default "
          f"route {loss_d:.8e} (relative {rel:.3e})", flush=True)
    if not rel <= TOL_ROUTES:
        raise AssertionError(f"the {dims}D {fam} route's loss is {rel:.3e} "
                             f"relative off the default route's")
    with legacy_route(dims):
        result = run_episode(device, batch, shape, reps=3)
    launches, sec, times, loss, peak, steps = result
    print(f"[legacy] {dims}D episode on the {fam} route, batch {batch} "
          f"{'x'.join(map(str, shape))}: loss {loss:.6e}, launches "
          f"{json.dumps(launches)}, adaptive steps {steps}, median "
          f"{sec * 1e3:.1f} ms ({batch / sec:.3f} samples/s) over "
          f"{[round(t * 1e3, 1) for t in times]} ms, peak "
          f"{peak / 1e9:.2f} GB on {card}", flush=True)
    return result


def time_flat_kernels(n, shape, device, c, k=4):
    """Phase 17: kernel, twin and ``F.grid_sample`` times of the corner
    (2D: the image warps' case, the rotation grid, zeros padding) or plane
    (3D: the compositions' case, near-identity, border) pair, with the
    bounds of one launch: each input read once and each output written
    once (f32 and int32, 4 bytes), the weighted sum's operations.  A 3D
    sample is two plane launches (one per z tap): ``sample_*_ms`` times
    both, the work ``F.grid_sample`` does in one call."""
    import torch
    import torch.nn.functional as F
    from advchain_tpu_torch.kernels import plane_sample as ps
    from advchain_tpu_torch.ops.grid_sample import plane_weights
    dims = len(shape)
    name, padding, grid = sample_grids(n, shape, device)[dims - 2]
    route, img, idx, wts, g, offs = flat_inputs(n, c, shape, grid, padding,
                                                k, device)
    fwd, bwd = (getattr(ps, f"{route}_sample_fwd"),
                getattr(ps, f"{route}_sample_bwd"))
    fwd_plain, bwd_plain = (getattr(ps, f"{route}_sample_fwd_plain"),
                            getattr(ps, f"{route}_sample_bwd_plain"))
    calls = [(idx, wts)]
    if dims == 3:  # the dz = 1 launch of the same sample
        zidx, yxidx, wz = plane_weights(grid, *shape, padding, True)
        calls.append(((zidx[1], yxidx), wz[1]))
    p, s = wts.shape[2], img[0, 0].numel()
    fwd_bound = bound_ms(4 * (n * c * s + len(idx) * n * p + k * n * p
                              + n * c * p), (2 * k - 1) * n * c * p)
    bwd_bound = bound_ms(4 * (n * c * p + 2 * n * c * s + len(idx) * n * p
                              + 2 * k * n * p), 4 * k * n * c * p)
    full = img.reshape((n, c) + tuple(shape))
    img_g = full.clone().requires_grad_(True)
    grid_g = grid.clone().requires_grad_(True)
    g_full = g.reshape((n, c) + tuple(grid.shape[1:-1]))

    def lib():
        return F.grid_sample(img_g, grid_g, mode="bilinear",
                             padding_mode=padding, align_corners=True)

    with torch.no_grad():
        row = {
            "kernel": route, "case": name, "padding": padding, "C": c,
            "K": k,
            "fwd_ms": time_ms(lambda: fwd(img, *idx, wts, offs)),
            "fwd_plain_ms": time_ms(lambda: fwd_plain(img, *idx, wts,
                                                      offs)),
            "fwd_library_ms": time_ms(lambda: F.grid_sample(
                full, grid, mode="bilinear", padding_mode=padding,
                align_corners=True)),
            "fwd_bound_ms": fwd_bound[0],
            "sample_fwd_ms": time_ms(lambda: [fwd(img, *i, w, offs)
                                              for i, w in calls]),
            "bwd_ms": time_ms(lambda: bwd(g, img, *idx, wts, offs)),
            "bwd_plain_ms": time_ms(lambda: bwd_plain(g, img, *idx, wts,
                                                      offs)),
            "bwd_bound_ms": bwd_bound[0],
            "sample_bwd_ms": time_ms(lambda: [bwd(g, img, *i, w, offs)
                                              for i, w in calls]),
        }
    row.update(library_bwd_ms(lib, (img_g, grid_g), g_full))
    row["bound_by"] = [fwd_bound[1], bwd_bound[1]]
    print("[timing] " + json.dumps(row), flush=True)
    return [row]


# ---------------------------------------------------------------- slice 5
# estimated operations of a grid-level pair beyond the corner arithmetic:
# per point, the axes' coordinate prep and the raw weights (forward), and
# also the chain rule to d_grid (backward), in 2D and 3D
GRID_PREP_OPS = {2: {"fwd": 40, "bwd": 100}, 3: {"fwd": 60, "bwd": 150}}


def grid_cases(n, shape, device):
    """Phases 2 and 6's grids for the grid-level pairs, (name, grid (N, P,
    d)): the near-identity warp, the same with 5% exact +-1 entries
    (:func:`flat_grids`: bases on the border rows and planes, where taps
    collapse) and the rotation (samples past the image or volume)."""
    (rot_name, _, rot), (near_name, _, near) = sample_grids(n, shape, device)
    pm1 = flat_grids(n, shape, device)[1][2]
    return [(name, g.reshape(n, -1, len(shape)).contiguous())
            for name, g in ((near_name, near), ("near_pm1", pm1),
                            (rot_name, rot))]


def grid_module(dims):
    """(family, module) of the grid-level pair for 2D / 3D."""
    from advchain_tpu_torch.kernels import band_sample, zband_sample
    return (("band_grid", band_sample) if dims == 2
            else ("zband_grid", zband_sample))


def check_grid_kernels(n, shape, device, channels=(1, 3, 5)):
    """Phases 2 and 6: the grid-level pair of ``len(shape)`` dims against
    its plain versions on each of :func:`grid_cases`, for each channel
    count, mode, padding (in 3D also ``edge`` with both dispatch slopes)
    and align_corners.  Forward within TOL_GRID_FWD
    absolute (it repeats its plain fold: 0 in every case so far),
    ``d_img`` and ``d_grid`` within TOL_DIMG_REL and TOL_DFLOW_REL of their
    largest entries (atomics and the channel sum reassociate); nearest
    mode's ``d_grid`` exactly zero.  Returns the largest errors."""
    import torch
    fam, mod = grid_module(len(shape))
    kern = {f"{kind}{plain}": getattr(mod, f"{fam}_sample_{kind}{plain}")
            for kind in ("fwd", "bwd") for plain in ("", "_plain")}
    paddings = [(padding, None) for padding in mod.PADDING_MODES]
    if len(shape) == 3:
        # the 3D compositions' edge padding with both dispatch slopes
        paddings += [("edge", torch.tensor([s], device=device))
                     for s in (1.0, 0.5)]
    worst = {"fwd": 0.0, "bwd": 0.0}
    for name, grid in grid_cases(n, shape, device):
        for c in channels:
            gen = torch.Generator(device=device).manual_seed(c)
            img = torch.randn((n, c) + tuple(shape), generator=gen,
                              device=device)
            g = torch.randn(n, c, grid.shape[1], generator=gen, device=device)
            for mode in mod.MODES:
                for padding, slope in paddings:
                    for align in (True, False):
                        args = (padding, align, mode)
                        kw = {} if slope is None else {"lower_slope": slope}
                        with torch.no_grad():
                            out = kern["fwd"](img, grid, *args)
                            ref = kern["fwd_plain"](img, grid, *args)
                            r_img, r_grid = kern["bwd_plain"](g, img, grid,
                                                              *args, **kw)
                            d_img, d_grid = kern["bwd"](g, img, grid, *args,
                                                        **kw)
                        e_fwd = float((out - ref).abs().max())
                        s_img = float(r_img.abs().max())
                        s_grid = float(r_grid.abs().max())
                        e_img = float((d_img - r_img).abs().max())
                        e_grid = float((d_grid - r_grid).abs().max())
                        ok = e_fwd <= TOL_GRID_FWD
                        if mode == "nearest":
                            ok = ok and float(d_grid.abs().max()) == 0.0
                        pad = padding if slope is None else \
                            f"{padding}:{float(slope):.1f}"
                        label = (f"{fam} {name:13s} C={c} {mode:8s} "
                                 f"{pad:10s} align={int(align)}")
                        print(f"[grid] {label}: fwd {e_fwd:.3e} d_img "
                              f"{e_img:.3e} (max {s_img:.3e}) d_grid "
                              f"{e_grid:.3e} (max {s_grid:.3e})", flush=True)
                        ok = (ok and e_img <= TOL_DIMG_REL * s_img
                              and e_grid <= TOL_DFLOW_REL * s_grid)
                        if not ok:
                            raise AssertionError(
                                f"the {fam} pair disagrees with its plain "
                                f"versions: {label} fwd {e_fwd} d_img "
                                f"{e_img} d_grid {e_grid}")
                        worst["fwd"] = max(worst["fwd"], e_fwd)
                        worst["bwd"] = max(worst["bwd"], e_img, e_grid)
    return worst


@contextlib.contextmanager
def count_calls(modules, names):
    """Count the calls of each ``<module>.<name>`` made inside the block,
    summed over ``modules`` (the callers look the attribute up at call
    time); restored after it."""
    calls = dict.fromkeys(names, 0)
    saved = [(module, name, getattr(module, name)) for module in modules
             for name in names]

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for module, name, fn in saved:
        setattr(module, name, counted(name, fn))
    try:
        yield calls
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def time_grid_kernels(n, shape, device, channels=(1, 3, 5)):
    """Phases 5 and 9: the grid-level pair of ``len(shape)`` dims alone
    beside its plain versions and ``F.grid_sample`` on each of
    :func:`sample_grids` (bilinear or trilinear), and in nearest mode on
    the rotation at C=1.  Bytes: the forward reads img and the grid and
    writes out, the backward reads g, img and the grid and writes d_img and
    d_grid (its zeroing of d_img is one more write, not counted);
    operations: the corner arithmetic per (point, channel) and
    GRID_PREP_OPS per point.  Rows as :func:`time_kernels`'."""
    import torch
    import torch.nn.functional as F
    dims = len(shape)
    fam, mod = grid_module(dims)
    fn = {f"{kind}{plain}": getattr(mod, f"{fam}_sample_{kind}{plain}")
          for kind in ("fwd", "bwd") for plain in ("", "_plain")}
    prep = GRID_PREP_OPS[dims]
    s = math.prod(shape)
    rows = []
    cases = [(name, padding, gridd, c, "bilinear")
             for name, padding, gridd in sample_grids(n, shape, device)
             for c in channels]
    rot_name, rot_pad, rot = sample_grids(n, shape, device)[0]
    cases.append((rot_name, rot_pad, rot, 1, "nearest"))
    for name, padding, gridd, c, mode in cases:
        grid = gridd.reshape(n, -1, dims).contiguous()
        p = grid.shape[1]
        gen = torch.Generator(device=device).manual_seed(c)
        img = torch.randn((n, c) + tuple(shape), generator=gen,
                          device=device)
        g = torch.randn(n, c, p, generator=gen, device=device)
        taps = 1 if mode == "nearest" else 2 ** dims
        fwd_bound = bound_ms(4 * (n * c * s + dims * n * p + n * c * p),
                             (2 * taps - 1) * n * c * p + prep["fwd"] * n * p)
        bwd_bound = bound_ms(4 * (n * c * p + 2 * n * c * s
                                  + 2 * dims * n * p),
                             4 * taps * n * c * p + prep["bwd"] * n * p)
        args = (padding, True, mode)
        img_g = img.clone().requires_grad_(True)
        grid_g = gridd.clone().requires_grad_(True)
        g_lib = g.reshape((n, c) + tuple(gridd.shape[1:-1]))

        def lib():
            return F.grid_sample(img_g, grid_g, mode=mode,
                                 padding_mode=padding, align_corners=True)

        with torch.no_grad():
            row = {
                "kernel": fam, "mode": mode, "case": name,
                "padding": padding, "C": c,
                "fwd_ms": time_ms(lambda: fn["fwd"](img, grid, *args)),
                "fwd_plain_ms": time_ms(lambda: fn["fwd_plain"](img, grid,
                                                                *args)),
                "fwd_library_ms": time_ms(lambda: F.grid_sample(
                    img, gridd, mode=mode, padding_mode=padding,
                    align_corners=True)),
                "fwd_bound_ms": fwd_bound[0],
                "bwd_ms": time_ms(lambda: fn["bwd"](g, img, grid, *args)),
                "bwd_plain_ms": time_ms(lambda: fn["bwd_plain"](g, img, grid,
                                                                *args)),
                "bwd_bound_ms": bwd_bound[0],
            }
        row.update(library_bwd_ms(lib, (img_g, grid_g), g_lib))
        row["bound_by"] = [fwd_bound[1], bwd_bound[1]]
        rows.append(row)
        print("[timing] " + json.dumps(row), flush=True)
    return rows


def wall_ms(fn, iters=20):
    """Host-clock time per call of ``fn`` over ``iters`` calls ending in a
    synchronize, after one warm-up call: what a host-bound caller pays."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def time_grid_routes(n, shape, device, c=3, case=1):
    """Phases 5 and 9: one whole bilinear (2D) or trilinear (3D) sample on
    :func:`sample_grids`' ``case`` (2D: the rotation, zeros, the image
    warps' call; 3D: near-identity, border, the compositions'), C
    channels, forward and forward+backward (gradients to the image and the
    grid), three ways in turns (a b c c b a): (a) the pre-fusion route,
    the host-side fold (``corner_weights`` / ``corner_weights_3d``,
    autograd over it) and the corner-level pair; (b) the grid-level pair;
    (c) ``F.grid_sample``, the yardstick the port never calls.  Each as
    wall ms (:func:`wall_ms`) and device ms (:func:`time_ms`), the mean of
    its two turns."""
    import torch
    import torch.nn.functional as F
    from advchain_tpu_torch.kernels import _coords
    from advchain_tpu_torch.kernels.band_sample import (BandGridSample,
                                                        BandSample)
    from advchain_tpu_torch.kernels.zband_sample import (ZBandGridSample,
                                                         ZBandSample)
    dims = len(shape)
    fold, corner_level, grid_level = (
        (_coords.corner_weights, BandSample, BandGridSample) if dims == 2
        else (_coords.corner_weights_3d, ZBandSample, ZBandGridSample))
    case_name, padding, gridd = sample_grids(n, shape, device)[case]
    gen = torch.Generator(device=device).manual_seed(c)
    img = torch.randn((n, c) + tuple(shape), generator=gen, device=device)
    cot = torch.randn((n, c) + tuple(gridd.shape[1:-1]), generator=gen,
                      device=device)

    def pre_fusion(x, gr):
        *idx, wts = fold(gr, *shape, padding, True)
        return corner_level.apply(x, *idx, wts)

    def fused(x, gr):  # what grid_sample_2d / grid_sample_3d run
        return grid_level.apply(x, gr.reshape(n, -1, dims).contiguous(),
                                padding, True, "bilinear")

    def library(x, gr):
        return F.grid_sample(x, gr, mode="bilinear", padding_mode=padding,
                             align_corners=True)

    routes = {"pre_fusion": pre_fusion, "fused": fused, "library": library}
    x = img.clone().requires_grad_(True)
    gr = gridd.clone().requires_grad_(True)

    def fwd(route):
        with torch.no_grad():
            route(img, gridd)

    def fwd_bwd(route):
        out = route(x, gr)
        torch.autograd.grad(out, (x, gr), cot.reshape(out.shape))

    times = {name: {} for name in routes}
    for name in ("pre_fusion", "fused", "library", "library", "fused",
                 "pre_fusion"):
        route = routes[name]
        for kind, fn in (("fwd", lambda: fwd(route)),
                         ("fwd_bwd", lambda: fwd_bwd(route))):
            times[name].setdefault(f"wall_{kind}_ms", []).append(wall_ms(fn))
            times[name].setdefault(f"device_{kind}_ms", []).append(
                time_ms(fn))
    result = {name: {key: statistics.mean(v) for key, v in t.items()}
              for name, t in times.items()}
    print(f"[routes] a {dims}D sample, N={n} C={c} "
          f"{'x'.join(map(str, shape))} {case_name} {padding}: "
          f"{json.dumps(result)}", flush=True)
    return result


def assert_grid_only(label, dims, launches, expected, folds):
    """Raise unless a run sampled through the grid-level pair alone: its
    launches equal ``expected``, the corner-level pair never launched, and
    no host-side fold was called (``folds``, from :func:`count_calls`)."""
    fam = DEFAULT_FAMILY[dims]
    if launches[fam] != expected \
            or any(launches[CORNER_LEVEL[dims]].values()) \
            or any(folds.values()):
        raise AssertionError(
            f"the {label} did not sample through the {fam} pair alone "
            f"({expected['fwd']} / {expected['bwd']} launches, no "
            f"{CORNER_LEVEL[dims]} launch, no fold): {launches}, {folds}")


def assert_stencil_launches(label, launches):
    """Raise unless a 2D episode or train step launched the stencil pair
    STENCIL_LAUNCHES times and one dispatch predicate per differentiated
    composition."""
    if launches["stencil"] != STENCIL_LAUNCHES \
            or launches["slope"]["fwd"] != STENCIL_LAUNCHES["bwd"]:
        raise AssertionError(
            f"the {label} did not launch the stencil pair "
            f"{STENCIL_LAUNCHES['fwd']} / {STENCIL_LAUNCHES['bwd']} times "
            f"with one dispatch predicate per differentiated composition: "
            f"{launches}")


def slope_record(launches, row, err, shape_note):
    """The ``kernels`` line's entry of the dispatch predicate, which has
    no library call (``F.grid_sample`` computes no predicate) and no
    backward; ``err``: the largest |kernel - twin| of phase 10."""
    return {
        "name": KERNEL_NAMES["slope"], "route": "cuda",
        "source": KERNEL_SOURCES["slope"],
        "replaces": REPLACES["slope"]["fwd"],
        "launches": launches["slope"]["fwd"], "max_abs_err": err,
        "ms": row["fwd_ms"], "plain_ms": row["fwd_plain_ms"],
        "bound_ms": row["fwd_bound_ms"], "bound_by": row["bound_by"][0],
        "library_ms": None, "shape": f"{shape_note} flow near_identity"}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def kernel_records(fam, launches, worst, rows, case, c_head, shape_note):
    """The ``kernels`` line's entries of one kernel pair, timed at its most
    frequent call on its path: the ``case`` rows with ``c_head``
    channels."""
    head = next(r for r in rows if r["case"] == case and r["C"] == c_head)
    records = [{
        "name": f"{KERNEL_NAMES[fam]}_{kind}", "route": "cuda",
        "source": KERNEL_SOURCES[fam], "replaces": REPLACES[fam][kind],
        "launches": launches[fam][kind], "max_abs_err": worst[kind],
        "ms": head[f"{kind}_ms"], "plain_ms": head[f"{kind}_plain_ms"],
        "bound_ms": head[f"{kind}_bound_ms"],
        "bound_by": head["bound_by"][i],
        "library_ms": head[f"{kind}_library_ms"],
        "shape": f"{shape_note} C={c_head} {case} {head['padding']}",
    } for i, kind in enumerate(("fwd", "bwd"))]
    for rec, kind in zip(records, ("fwd", "bwd")):
        if f"sample_{kind}_ms" in head:
            # the launches of one sampler call, the work library_ms times
            # (a 3D sample is two plane launches)
            rec["sample_ms"] = head[f"sample_{kind}_ms"]
    # library_ms of a backward times the library's backward alone
    records[1]["library_fwd_bwd_ms"] = head["fwd_bwd_library_ms"]
    if "squarings_bwd_ms" in head:  # the stencil backward (phase 13)
        records[1].update(squarings_ms=head["squarings_bwd_ms"],
                          squarings_bound_ms=head["squarings_bwd_bound_ms"])
    return records


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="PATH",
                        help="also write a profile of one 2D episode to PATH")
    parser.add_argument("--profile3d", metavar="PATH",
                        help="also write a profile of one 3D episode to PATH")
    parser.add_argument("--profile-train", metavar="PATH",
                        help="also write a profile of one headline train "
                             "step to PATH")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from advchain_tpu_torch.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cuda"
    card = card_line()
    print(card, flush=True)  # name, power limit, as nvidia-smi gives them
    t0 = time.perf_counter()
    _build.build(BUILD)
    print(f"[build] {' + '.join(n + '.cu' for n in BUILD)} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    # the host-side folds' callers: the ops routes and the plain versions
    fold_modules = [importlib.import_module(f"advchain_tpu_torch.{name}")
                    for name in ("ops.grid_sample", "kernels._coords")]

    # 2D: the headline episode, its bilinear samples on the band grid pair
    worst2 = check_kernels(BATCH, SHAPE, device)
    worst_b = check_grid_kernels(BATCH, SHAPE, device, channels=(1, 2, 4, 5))
    check_episode_against_cpu(device)
    with count_calls(fold_modules, FOLDS) as folds2:
        launches2, sec, times, loss, peak, _ = run_episode(device, BATCH,
                                                           SHAPE)
    print(f"[episode] batch {BATCH} {SHAPE[0]}x{SHAPE[1]}: loss {loss:.6e}, "
          f"launches band_grid fwd {launches2['band_grid']['fwd']} bwd "
          f"{launches2['band_grid']['bwd']}, stencil fwd "
          f"{launches2['stencil']['fwd']} bwd "
          f"{launches2['stencil']['bwd']}, dispatch predicates "
          f"{launches2['slope']['fwd']}, host-side fold calls over 7 "
          f"episodes {json.dumps(folds2)}, median {sec * 1e3:.1f} ms "
          f"({BATCH / sec:.2f} img/s) over "
          f"{[round(t * 1e3, 1) for t in times]} ms, peak "
          f"{peak / 1e9:.2f} GB on {card}", flush=True)
    assert_grid_only("2D episode", 2, launches2, GRID_LAUNCHES["episode2d"],
                     folds2)
    assert_stencil_launches("2D episode", launches2)
    if args.profile:
        profile_episode(device, BATCH, SHAPE, args.profile)
    rows2 = time_kernels(BATCH, SHAPE, device)
    rows_b = time_grid_kernels(BATCH, SHAPE, device, channels=(1, 4))
    time_grid_routes(BATCH, SHAPE, device, c=1, case=0)

    # 3D: the volume episode, its trilinear and nearest samples on the
    # fused z-band pair
    worst3 = check_kernels(BATCH3D, SHAPE3D, device, channels=(1, 3, 5))
    worst_g = check_grid_kernels(BATCH3D, SHAPE3D, device)
    check_nearest(device)
    check_episode_against_cpu(device, 2, (8, 32, 32))
    with count_calls(fold_modules, FOLDS) as folds:
        launches3, sec3, times3, loss3, peak3, steps = run_episode(
            device, BATCH3D, SHAPE3D)
    print(f"[episode3d] batch {BATCH3D} 1x{'x'.join(map(str, SHAPE3D))}: "
          f"loss {loss3:.6e}, launches {json.dumps(launches3)}, host-side "
          f"fold calls over 7 episodes {json.dumps(folds)}, adaptive steps "
          f"{steps}, median {sec3 * 1e3:.1f} ms ({BATCH3D / sec3:.3f} "
          f"vol/s), reps {[round(t * 1e3, 1) for t in times3]} ms (spread "
          f"{(max(times3) - min(times3)) * 1e3:.1f} ms), peak "
          f"{peak3 / 1e9:.2f} GB on {card}", flush=True)
    assert_grid_only("3D episode", 3, launches3, GRID_LAUNCHES["episode3d"],
                     folds)
    if args.profile3d:
        prof3 = profile_episode(device, BATCH3D, SHAPE3D, args.profile3d)
        print(f"[profile] 3D episode: device busy "
              f"{prof3['device_busy_ms']:.1f} ms of the unprofiled median "
              f"{sec3 * 1e3:.1f} ms, idle share "
              f"{1 - prof3['device_busy_ms'] / (sec3 * 1e3):.3f}, "
              f"{prof3['device_launches']} kernel launches", flush=True)
    rows3 = time_kernels(BATCH3D, SHAPE3D, device, channels=(1, 3, 5))
    rows_g = time_grid_kernels(BATCH3D, SHAPE3D, device)
    time_nearest(device)
    time_grid_routes(BATCH3D, SHAPE3D, device)

    # the fused adversarial train step, with every 2D composition on the
    # stencil kernels
    worst_s = check_stencil(BATCH, SHAPE, device)
    odd = check_stencil(3, (17, 23), device)
    worst_s = {k: max(worst_s[k], odd[k]) for k in worst_s}
    check_stencil_determinism(BATCH, SHAPE, device)
    worst_slope = check_dispatch_slope(device)
    check_train_step_against_cpu(device)
    with count_calls(fold_modules, FOLDS) as folds_t:
        launches_t, sec_t, times_t, first_t, peak_t = run_train_step(
            device, BATCH, SHAPE)
    print(f"[train] adversarial step, batch {BATCH} {SHAPE[0]}x{SHAPE[1]}: "
          f"losses {first_t}, launches stencil fwd "
          f"{launches_t['stencil']['fwd']} bwd "
          f"{launches_t['stencil']['bwd']}, band_grid fwd "
          f"{launches_t['band_grid']['fwd']} bwd "
          f"{launches_t['band_grid']['bwd']}, dispatch predicates "
          f"{launches_t['slope']['fwd']}, host-side fold calls over 7 "
          f"steps {json.dumps(folds_t)}, median {sec_t * 1e3:.1f} ms "
          f"({BATCH / sec_t:.2f} img/s) over "
          f"{[round(t * 1e3, 1) for t in times_t]} ms, peak "
          f"{peak_t / 1e9:.2f} GB on {card}", flush=True)
    assert_grid_only("train step", 2, launches_t, GRID_LAUNCHES["train"],
                     folds_t)
    assert_stencil_launches("train step", launches_t)
    _, sec_s, times_s, first_s, peak_s = run_train_step(
        device, BATCH, SHAPE, supervised=True)
    print(f"[train] supervised step, batch {BATCH}: loss {first_s}, median "
          f"{sec_s * 1e3:.1f} ms ({BATCH / sec_s:.2f} img/s) over "
          f"{[round(t * 1e3, 1) for t in times_s]} ms, peak "
          f"{peak_s / 1e9:.2f} GB on {card}", flush=True)
    if args.profile_train:
        step, state, data = build_train_step(device, BATCH, SHAPE)
        gen = torch.Generator(device=device).manual_seed(1)

        def one_step():
            step(state, data, gen)
            sync(device)

        profile_run("train step", one_step, args.profile_train)
    rows_s, slope_row = time_stencil(BATCH, SHAPE, device)

    # the legacy flat-index routes: corner kernels (2D) and plane kernels
    # (3D), selected by the JAX package's switches
    worst_c = check_flat_kernels(BATCH, SHAPE, device, (1, 2, 5), (1, 4))
    worst_p = check_flat_kernels(BATCH3D, SHAPE3D, device, (1, 3, 5), (2, 4))
    launches_c = run_legacy_episode(device, BATCH, SHAPE, card)[0]
    if not (launches_c["corner"] == launches2["band_grid"]
            and launches_c["stencil"] == launches2["stencil"]):
        raise AssertionError(f"the corner route's launches {launches_c} "
                             f"differ from the band route's {launches2}")
    launches_p = run_legacy_episode(device, BATCH3D, SHAPE3D, card)[0]
    rows_c = time_flat_kernels(BATCH, SHAPE, device, 1)
    rows_p = time_flat_kernels(BATCH3D, SHAPE3D, device, 3)

    shape2 = f"N={BATCH} {SHAPE[0]}x{SHAPE[1]}"
    shape3 = f"N={BATCH3D} {'x'.join(map(str, SHAPE3D))}"
    kernels = (kernel_records("band", launches2, worst2, rows2, "rot30", 1,
                              shape2)
               + kernel_records("band_grid", launches2, worst_b, rows_b,
                                "rot30", 1, shape2)
               + kernel_records("zband", launches3, worst3, rows3,
                                "near_identity", 3, shape3)
               + kernel_records("zband_grid", launches3, worst_g, rows_g,
                                "near_identity", 3, shape3)
               + kernel_records("stencil", launches_t, worst_s, rows_s,
                                "near_identity", 2, shape2)
               + kernel_records("corner", launches_c, worst_c, rows_c,
                                "rot30", 1, shape2 + " K=4")
               + kernel_records("plane", launches_p, worst_p, rows_p,
                                "near_identity", 3, shape3 + " K=4")
               + [slope_record(launches_t, slope_row, worst_slope, shape2)])
    print(f"[episode] {BATCH / sec:.2f} img/s (2D), {BATCH3D / sec3:.3f} "
          f"vol/s (3D), train step {BATCH / sec_t:.2f} img/s (supervised "
          f"{BATCH / sec_s:.2f}) on {card}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
