#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (advchain_tpu_torch) once on one GPU.

    python3 chip_smoke.py [--profile PATH] [--profile3d PATH]
                          [--profile-train PATH] [--profile3d-legacy PATH]
                          [--profile-legacy2d PATH]
                          [--profile-constrained PATH]
                          [--profile-random-chain PATH]
                          [--profile-train-bf16 PATH]

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
     shapes (N=128, 192x192, C in {1, 2, 5}, K in {1, 4}) and the flat
     plane kernels at the 3D episode's (N=2, 12x192x192, C in {1, 3, 5},
     K in {2, 4}), on phase 2's and 6's grids with 5% of the
     near-identity entries on exactly +-1 (bases on the last column, row
     and plane: the 2D wrap and the plane edge); and the plane grid pair
     (the 3D route under ADVCHAIN_ZBAND=0) against its plain versions as
     phase 6 holds the z-band grid pair (C in {1, 3, 5}, three grids,
     zeros / border / reflection and edge with both dispatch slopes, both
     align_corners); and the corner backward on the cases of
     ``corner_bwd_cases`` (the tile kernel at the tap square, the flat
     kernel at other K and offsets; every point on one pixel, rows right to
     left, a permutation with no coincident taps, rasters no multiple of
     the tile, of one point and under one block), d_img and d_w within
     1e-5 of their largest entries, one launch of the expected kernel each;
 15. run the headline episode with ADVCHAIN_BAND_KERNEL=0 (set inside a
     try/finally that restores the environment): its loss against the
     band route's with the same weights and injected transform
     parameters (within 1e-4 relative), its launches (corner as many as
     the band grid pair on the default route, every backward on the
     corner tile kernel, the band pairs 0, stencil unchanged) and 3 timed
     episodes after 2 warm-ups;
 16. the same for the 3D volume episode with ADVCHAIN_ZBAND=0: the plane
     grid pair launched as often as the default route's z-band grid pair
     (44 / 22), the flat plane pair and the z-band pairs 0 times, no call
     of a host-side fold (``plane_weights`` included);
 17. time the corner and flat plane kernels (the plane pair per launch and
     per sample, two launches), the plane grid pair, their twins and
     ``F.grid_sample``, and a whole 3D sample on the plane route three ways
     in turns (``plane_weights`` with two flat launches, the plane grid
     pair, ``F.grid_sample``); time the corner tile backward and the kept
     flat backward in turns at the image warps' call (N=128, C=1, 192x192,
     the rotation, zeros), at C=4, on the near-identity grid, and the flat
     one at K=1, with the global atomics per point reckoned from the
     indices;
 18. run one constrained solve (config #3 of bench.py:294-346: noise ->
     bias -> affine -> morph with "lowest" padding on the affine and the
     morph, batch 4 at 192x192, UNet_16, mse + contour, n_iter=3, the
     anatomy ellipse of bench.py:317-321, penalty weight 50, volume
     tolerance 5e-4) with every band grid and stencil wrapper call logged,
     and hold rows 1-4 against their plain versions at N=4, 192x192 at
     the logged channel counts, paddings, align_corners and modes (C in
     {1, 2, 5, 6} for the band grid pair, 2 for the stencil), on phase
     2's grids and phase 10's flows;
 19. the constrained solve at batch 2, 64x64 on the card against the CPU
     with the same weights and injected parameters (the full chain
     without PGD: dist and the volume score; the morph-free chain with one
     penalised step on the noise: its direction and dist), and the
     README's manual loop (``compute_transform_grads``, then
     ``optimize_parameters()`` with no argument) at step 1.0 on the card
     against the CPU from the same parameters, and at a small step on
     the card alone: the divergence ascends);
 20. config #2 of bench.py:245-291, the random chain (batch 128,
     192x192): each call ``init_random_transformation()`` then
     ``forward(data)``; time 5 calls after 2 warm-ups, count one call's
     launches and assert that every 2D sample launched the band grid
     pair and every composition the stencil, with no host-side fold;
 21. config #3 timed: 5 solves after 2 warm-ups, the share that preserve
     the volume, each solve's launches (the same assertion, and a
     differentiated sample and composition in each) and the peak memory;
     then print the ``kernels`` line for all eighteen kernel records, with
     each record's launches in one random-chain call and one constrained
     solve beside the main paths';
 22. the wrapper's bf16 compute mode (UNet_16, batch 2, 64x64, the same
     weights with moved running statistics): ``predict`` logits f32 and
     within JAX's bound (5% of the f32 logits' scale, argmax agreement
     above 0.99) against the card's f32 and the CPU's bf16; the headline
     chain's episode with injected parameters and the running statistics
     (JAX's bf16 test's settings): n_iter=0 adv_data bit-equal to f32's,
     dist within 2%; n_iter=1 dist within 10%, parameter cosines above
     0.95; one bf16 ``apply_train`` leaves every buffer f32 and finite;
 23. the headline episode of phase 4 in bf16, timed in turns with f32
     (f32, bf16, bf16, f32; 5 episodes after 2 warm-ups each), each
     turn's launches equal to phase 4's, with its peak memory;
 24. the headline train step of phase 12 in bf16, in the same turns, each
     turn's launches equal to phase 12's;
 25. the UNet's options (encoder and decoder dropout 0.1, self-attention
     with gamma 0.5, spectral norm): logits on the card against the CPU
     within 1e-4 (batch 2, 64x64, both BN modes, the card's dropout masks
     handed to the CPU); one headline episode (its frozen passes leave
     every spectral u / sigma bit-equal and replay one dropout mask per
     module; launches equal to phase 4's) and one train step (every
     spectral u written back); UNetv2 (feature scale 4) and
     DeeplySupervisedUNet (64 base filters, multi_out) forward and
     backward at batch 8, 192x192 against the CPU (outputs within 1e-4,
     gradients at cosine above 0.999);
 26. the retry ladder's seven scripted cases (tests/test_torch_anatomy.py's
     noise + affine chain, "lowest" padding, UNet_16): at batch 2, 64x64
     on the card and the CPU (the same steps, inits, redraws and
     warnings, JAX's where known, the dist within 1e-2 where every draw
     comes from the transforms' own generators), then at config #3's
     batch 4, 192x192 on the card with each case's launches and ms.
The last line of standard output is the device record.  ``--profile PATH``
/ ``--profile3d PATH`` / ``--profile-train PATH`` / ``--profile3d-legacy
PATH`` / ``--profile-legacy2d PATH`` / ``--profile-constrained PATH`` /
``--profile-random-chain PATH`` / ``--profile-train-bf16 PATH``
additionally write a torch.profiler summary of one 2D episode / 3D episode
/ train step / 3D episode with ADVCHAIN_ZBAND=0 / 2D episode with
ADVCHAIN_BAND_KERNEL=0 (with the channels and padding of each of its
corner backward calls) / constrained solve (with the FFT convolutions'
device time by caller and input shapes) / random-chain call / bf16 train
step to PATH, each with its device time by kernel class (BatchNorm,
convolution, upsampling, other).

Convolutions and matmuls run in full f32 (TF32 off): morph's 8 or more
self-compositions amplify rounding.  The bf16 phases cast the network
alone; every kernel of the port still takes f32.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import logging
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
                  # one flat kernel pair serves the corner (2D) and plane
                  # (3D) contracts; the plane grid pair is the 3D route
                  "corner": _CSRC + "plane_sample.cu",
                  # the corner route's bilinear backward (K = 4)
                  "corner_tile": _CSRC + "plane_sample.cu",
                  "plane": _CSRC + "plane_sample.cu",
                  "plane_grid": _CSRC + "plane_sample.cu"}
KERNEL_NAMES = {"band": "band_sample", "band_grid": "band_grid_sample",
                "zband": "zband_sample",
                "zband_grid": "zband_grid_sample",
                "stencil": "stencil_warp", "slope": "dispatch_slope",
                "corner": "corner_sample",
                "corner_tile": "corner_tile_sample", "plane": "plane_sample",
                "plane_grid": "plane_grid_sample"}
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
            "corner_tile": {"bwd": f"{_GM}:283"},
            "plane": {"fwd": f"{_GM}:466", "bwd": f"{_GM}:603"},
            "plane_grid": {"fwd": f"{_GM}:466", "bwd": f"{_GM}:603"}}
# substrings of the port's CUDA kernel names (the profiler's rows)
PORT_KERNEL_NAMES = ("band_sample", "band_grid", "zband_grid",
                     "stencil_warp", "dispatch_slope", "plane_sample",
                     "plane_grid", "corner_tile")
# the switches that send 2D / 3D sampling to the corner / plane kernels
LEGACY_SWITCH = {2: "ADVCHAIN_BAND_KERNEL", 3: "ADVCHAIN_ZBAND"}
# the family the default route sends bilinear sampling to, and the one
# LEGACY_SWITCH sends it to
DEFAULT_FAMILY = {2: "band_grid", 3: "zband_grid"}
LEGACY_FAMILY = {2: "corner", 3: "plane_grid"}
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
# the host-side folds that no default route, nor the 3D plane route, calls
FOLDS = ("corner_weights", "corner_weights_3d", "nearest_weights",
         "plane_weights")
# each grid-level pair's module
GRID_MODULES = {"band_grid": "band_sample", "zband_grid": "zband_sample",
                "plane_grid": "plane_sample"}


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


def build_model(device, seed=0, dims=2, dropout=0.1, compute_dtype=None,
                **options):
    """UNet_16 (2D, with the UNet's ``options``) or PseudoConv3dModel (3D;
    ``dropout`` applies), 4 classes, seeded random weights, the wrapper's
    ``compute_dtype``."""
    from advchain_tpu_torch.models import (PseudoConv3dModel,
                                           SegmentationModel, UNet)
    module = (UNet(input_channel=1, num_classes=4, feature_scale=4,
                   **options)
              if dims == 2 else
              PseudoConv3dModel(num_classes=4, dropout=dropout))
    return SegmentationModel.create(module, seed=seed, device=device,
                                    compute_dtype=compute_dtype)


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
    to: band / zband_grid, or corner / plane_grid under
    ``LEGACY_SWITCH[dims]=0``."""
    if os.environ.get(LEGACY_SWITCH[dims]) == "0":
        return LEGACY_FAMILY[dims]
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


def run_episode(device, batch, shape, warm=2, reps=5, compute_dtype=None):
    """Phases 4, 8 and 23: returns (launch counts of one episode, median
    seconds per episode, all rep times, final loss, peak device bytes
    allocated, adaptive step counts of that episode)."""
    import torch
    from advchain_tpu_torch.ops import integrate
    dims = len(shape)
    solver = build_solver(batch, shape)
    model = build_model(device, dims=dims, compute_dtype=compute_dtype)
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
        counts = family_launches(launches, used)
        if not (counts["fwd"] > 0 and counts["bwd"] > 0):
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


# kernel-name substrings of the profile's classes (cuDNN's and PyTorch's
# native kernels; the FFT convolution's transforms and complex products
# count as convolution)
KERNEL_CLASSES = {
    "batchnorm": ("batch_norm", "batchnorm", "bn_fw", "bn_bw"),
    "upsample": ("upsample",),
    "convolution": ("conv", "implicit_gemm", "xmma", "fft", "cf32",
                    "dgrad", "wgrad", "fprop", "implicit_convolve",
                    "nchwtonhwc", "nhwctonchw"),
}
# the FFT convolution's kernels (cuFFT transforms, complex products)
FFT_KERNELS = ("fft", "cf32")


def kernel_class(name):
    low = name.lower()
    for cls, keys in KERNEL_CLASSES.items():
        if any(k in low for k in keys):
            return cls
    return "other"


def conv_callers(prof):
    """The FFT convolutions' device time by the launching op and its input
    shapes (needs ``record_shapes``): rows of (op, shapes, calls, ms)."""
    rows = {}
    for e in prof.events():
        ms = sum(k.duration for k in e.kernels
                 if any(f in k.name.lower() for f in FFT_KERNELS)) / 1e3
        if ms > 0:
            key = (e.name, json.dumps(e.input_shapes[:2]))
            calls, total = rows.get(key, (0, 0.0))
            rows[key] = (calls + 1, total + ms)
    return sorted(((op, shapes, n, ms) for (op, shapes), (n, ms)
                   in rows.items()), key=lambda r: -r[3])


def profile_run(label, fn, path, shapes=False):
    """Device time of one call of ``fn`` (after one warm-up call) by
    kernel (torch.profiler), written to ``path`` as JSON; prints the busy
    time, the kernel launches, the share of each kernel class
    (``KERNEL_CLASSES``) and the largest kernels, and returns the wall and
    busy times, the launch count and the class totals.  ``shapes``: also
    record the ops' input shapes and print the FFT convolutions by caller
    (:func:`conv_callers`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
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
    classes = {}
    for r in rows:
        cls = kernel_class(r["name"])
        classes[cls] = classes.get(cls, 0.0) + r["device_ms"]
    summary = {"wall_ms": wall, "device_busy_ms": busy,
               "device_launches": launches, "port_kernels_ms": samp,
               "classes_ms": classes}
    if shapes:
        summary["fft_callers"] = [
            {"op": op, "input_shapes": sh, "calls": n, "device_ms": ms}
            for op, sh, n, ms in conv_callers(prof)]
    with open(path, "w") as f:
        json.dump(dict(summary, kernels=rows[:60]), f, indent=1)
    print(f"[profile] {label} {wall:.1f} ms under the profiler, "
          f"device busy {busy:.1f} ms over {launches} kernel launches, the "
          f"port's kernels {samp:.1f} ms; by class: " + ", ".join(
              f"{c} {ms:.1f} ms ({ms / busy:.1%})"
              for c, ms in sorted(classes.items(), key=lambda kv: -kv[1]))
          + "; top: " + "; ".join(
              f"{r['name'][:50]} {r['device_ms']:.1f} ms x{r['count']}"
              for r in rows[:6]), flush=True)
    for row in summary.get("fft_callers", [])[:8]:
        print(f"[profile] {label} FFT convolutions: {row['op']} on "
              f"{row['input_shapes']}: {row['calls']} calls, "
              f"{row['device_ms']:.2f} ms", flush=True)
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
                     supervised=False, compute_dtype=None, **options):
    """(step, state, batch dict) of the headline train step (bench.py:
    408-447): UNet_16 (with the UNet's ``options``) with seeded random
    weights and the wrapper's ``compute_dtype``, Adam 1e-4, n_iter=1,
    smart power iteration, mse + contour; or the supervised step."""
    import torch
    from advchain_tpu_torch.parallel import (TrainState,
                                             make_adversarial_train_step,
                                             make_supervised_train_step)
    model = build_model(device, compute_dtype=compute_dtype, **options)
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


def run_train_step(device, batch, shape, supervised=False, warm=2, reps=5,
                   compute_dtype=None):
    """Phases 12 and 24: returns (launch counts of one step, median seconds
    per step, all rep times, the first timed step's metrics, peak device
    bytes allocated)."""
    import torch
    step, state, data = build_train_step(device, batch, shape,
                                         supervised=supervised,
                                         compute_dtype=compute_dtype)
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
    fam = LEGACY_FAMILY[dims]
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
    if dims == 2:  # the flat kernel, which the tap square no longer takes
        def bwd(g, img, idx, w, offsets):
            return ps._bwd("corner", g, img, None, idx, w, offsets)
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


def grid_pair(fam):
    """A grid-level pair's kernels and plain versions by kind ("fwd",
    "fwd_plain", "bwd", "bwd_plain"), its modes, and the call arguments
    after ``(img, grid)`` for a padding, align_corners and mode (the plane
    pair samples trilinear only and takes no mode)."""
    mod = importlib.import_module(
        f"advchain_tpu_torch.kernels.{GRID_MODULES[fam]}")
    fn = {f"{kind}{plain}": getattr(mod, f"{fam}_sample_{kind}{plain}")
          for kind in ("fwd", "bwd") for plain in ("", "_plain")}
    if fam == "plane_grid":
        return fn, ("bilinear",), lambda padding, align, mode: (padding,
                                                                 align)
    return fn, mod.MODES, lambda padding, align, mode: (padding, align, mode)


def check_grid_kernels(n, shape, device, channels=(1, 3, 5), fam=None):
    """Phases 2, 6 and 14: the grid-level pair ``fam`` (default: the
    default route's of ``len(shape)`` dims) against its plain versions on
    each of :func:`grid_cases`, for each channel count, mode, padding (in
    3D also ``edge`` with both dispatch slopes) and align_corners.  Forward
    within TOL_GRID_FWD absolute (it repeats its plain fold: 0 in every
    case so far), ``d_img`` and ``d_grid`` within TOL_DIMG_REL and
    TOL_DFLOW_REL of their largest entries (atomics and the channel sum
    reassociate); nearest mode's ``d_grid`` exactly zero.  Returns the
    largest errors."""
    import torch
    from advchain_tpu_torch.kernels._corners import PADDING_MODES
    fam = fam or DEFAULT_FAMILY[len(shape)]
    kern, modes, call_args = grid_pair(fam)
    paddings = [(padding, None) for padding in PADDING_MODES]
    if len(shape) == 3:
        # the 3D compositions' edge padding with both dispatch slopes
        paddings += [("edge", torch.tensor([s], device=device))
                     for s in (1.0, 0.5)]
    worst = {"fwd": 0.0, "bwd": 0.0}
    for name, grid in grid_cases(n, shape, device):
        for c in channels:
            for mode in modes:
                for padding, slope in paddings:
                    for align in (True, False):
                        hold_grid_case(fam, kern, call_args, name, grid,
                                       shape, c, mode, padding, align, slope,
                                       worst)
    return worst


def hold_grid_case(fam, kern, call_args, name, grid, shape, c, mode,
                   padding, align, slope, worst):
    """One case of :func:`check_grid_kernels`: the pair and its plain
    versions on a seeded image of ``c`` channels and spatial ``shape`` at
    ``grid`` (N, P, d); raises on a disagreement, updates ``worst``."""
    import torch
    n, device = grid.shape[0], grid.device
    gen = torch.Generator(device=device).manual_seed(c)
    img = torch.randn((n, c) + tuple(shape), generator=gen, device=device)
    g = torch.randn(n, c, grid.shape[1], generator=gen, device=device)
    args = call_args(padding, align, mode)
    kw = {} if slope is None else {"lower_slope": slope}
    with torch.no_grad():
        out = kern["fwd"](img, grid, *args)
        ref = kern["fwd_plain"](img, grid, *args)
        r_img, r_grid = kern["bwd_plain"](g, img, grid, *args, **kw)
        d_img, d_grid = kern["bwd"](g, img, grid, *args, **kw)
    e_fwd = float((out - ref).abs().max())
    s_img = float(r_img.abs().max())
    s_grid = float(r_grid.abs().max())
    e_img = float((d_img - r_img).abs().max())
    e_grid = float((d_grid - r_grid).abs().max())
    ok = e_fwd <= TOL_GRID_FWD
    if mode == "nearest":
        ok = ok and float(d_grid.abs().max()) == 0.0
    pad = padding if slope is None else f"{padding}:{float(slope):.1f}"
    label = f"{fam} {name:13s} C={c} {mode:8s} {pad:10s} align={int(align)}"
    print(f"[grid] {label}: fwd {e_fwd:.3e} d_img {e_img:.3e} (max "
          f"{s_img:.3e}) d_grid {e_grid:.3e} (max {s_grid:.3e})", flush=True)
    ok = (ok and e_img <= TOL_DIMG_REL * s_img
          and e_grid <= TOL_DFLOW_REL * s_grid)
    if not ok:
        raise AssertionError(
            f"the {fam} pair disagrees with its plain versions: {label} fwd "
            f"{e_fwd} d_img {e_img} d_grid {e_grid}")
    worst["fwd"] = max(worst["fwd"], e_fwd)
    worst["bwd"] = max(worst["bwd"], e_img, e_grid)


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


def time_grid_kernels(n, shape, device, channels=(1, 3, 5), fam=None):
    """Phases 5, 9 and 17: the grid-level pair ``fam`` (default: the
    default route's of ``len(shape)`` dims) alone beside its plain
    versions and ``F.grid_sample`` on each of :func:`sample_grids`
    (bilinear or trilinear), and, where the pair has a nearest mode, in
    nearest mode on the rotation at C=1.  Bytes: the forward reads img and
    the grid and writes out, the backward reads g, img and the grid and
    writes d_img and d_grid (its zeroing of d_img is one more write, not
    counted); operations: the corner arithmetic per (point, channel) and
    GRID_PREP_OPS per point.  Rows as :func:`time_kernels`'."""
    import torch
    import torch.nn.functional as F
    dims = len(shape)
    fam = fam or DEFAULT_FAMILY[dims]
    fn, modes, call_args = grid_pair(fam)
    prep = GRID_PREP_OPS[dims]
    s = math.prod(shape)
    rows = []
    cases = [(name, padding, gridd, c, "bilinear")
             for name, padding, gridd in sample_grids(n, shape, device)
             for c in channels]
    if "nearest" in modes:
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
        args = call_args(padding, True, mode)
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


def time_grid_routes(n, shape, device, c=3, case=1, legacy=False):
    """Phases 5, 9 and 17: one whole bilinear (2D) or trilinear (3D) sample
    on :func:`sample_grids`' ``case`` (2D: the rotation, zeros, the image
    warps' call; 3D: near-identity, border, the compositions'), C
    channels, forward and forward+backward (gradients to the image and the
    grid), three ways in turns (a b c c b a): (a) the pre-fusion route,
    the host-side fold (``corner_weights`` / ``corner_weights_3d``,
    autograd over it) and the corner-level pair, or with ``legacy`` (3D)
    ``plane_weights`` and one flat plane launch per z tap, summed; (b) the
    grid-level pair (with ``legacy`` the plane grid pair); (c)
    ``F.grid_sample``, the yardstick the port never calls.  Each as wall ms
    (:func:`wall_ms`) and device ms (:func:`time_ms`), the mean of its two
    turns."""
    import torch
    import torch.nn.functional as F
    from advchain_tpu_torch.kernels import _coords
    from advchain_tpu_torch.kernels.band_sample import (BandGridSample,
                                                        BandSample)
    from advchain_tpu_torch.kernels.plane_sample import (PlaneGridSample,
                                                         PlaneSample)
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
        if legacy:
            zidx, yxidx, wts = _coords.plane_weights(gr, *shape, padding,
                                                     True)
            flat = x.reshape(n, c, shape[0], -1)
            offs = (0, 1, shape[2], shape[2] + 1)
            return (PlaneSample.apply(flat, zidx[0], yxidx, wts[0], offs)
                    + PlaneSample.apply(flat, zidx[1], yxidx, wts[1], offs))
        *idx, wts = fold(gr, *shape, padding, True)
        return corner_level.apply(x, *idx, wts)

    def fused(x, gr):  # what grid_sample_2d / grid_sample_3d run
        gr = gr.reshape(n, -1, dims).contiguous()
        if legacy:
            return PlaneGridSample.apply(x, gr, padding, True)
        return grid_level.apply(x, gr, padding, True, "bilinear")

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
    print(f"[routes] a {dims}D sample{' (plane route)' if legacy else ''}, "
          f"N={n} C={c} "
          f"{'x'.join(map(str, shape))} {case_name} {padding}: "
          f"{json.dumps(result)}", flush=True)
    return result


# ---------------------------------------------------------------- slice 9
def corner_bwd_cases(n, shape, device):
    """Phase 14's corner backward cases, (label, img (N, C, S), idx, w, g,
    offsets, raster width, family), where the family is the kernel the
    wrapper must launch: ``corner_tile`` at the tap square (0, 1, W, W+1),
    else ``corner`` (the flat kernel).  On :func:`flat_grids` (5% of
    near-identity bases on exact +-1: the last column's wrap) at C in {1,
    2, 4, 5} with the raster width and at C=1 without it (one row); K in
    {1, 2, 3} at the square's leading offsets and K in {1, 2, 3, 4} at
    irregular ones; inputs that stress the merge, at C in {1, 4} with
    ``min(n, 4)`` samples: every point on one pixel, each raster row's
    bases right to left, a random permutation of bases two pixels apart
    (no coincident taps); and rasters of 37 x 45 points (no multiple of
    the 8 x 32 tile), of one point, and of 2 x 10 x 10 points (fewer than
    one block's)."""
    import torch
    from advchain_tpu_torch.kernels.plane_sample import tile_offsets
    from advchain_tpu_torch.ops.grid_sample import corner_weights
    h, w = shape
    s = h * w
    square = (0, 1, w, w + 1)
    irregular = (0, 2, w + 3, 2 * w + 1)
    gen = torch.Generator(device=device).manual_seed(9)

    def rand(*size):
        return torch.rand(size, generator=gen, device=device)

    def case(label, idx, wts, c, offsets, width):
        nb, p = idx.shape
        img = torch.randn(nb, c, s, generator=gen, device=device)
        g = torch.randn(nb, c, p, generator=gen, device=device)
        return (label, img, idx.int().contiguous(), wts.contiguous(), g,
                offsets, width, "corner_tile" if tile_offsets(offsets)
                else "corner")

    cases = []
    for name, padding, grid in flat_grids(n, shape, device):
        yidx, xidx, wts = corner_weights(grid, h, w, padding, True)
        idx, wo, p = yidx * w + xidx, grid.shape[2], yidx.shape[1]
        for c in (1, 2, 4, 5):
            cases.append(case(f"{name} C={c}", idx, wts, c, square, wo))
        cases.append(case(f"{name} C=1 one row", idx, wts, 1, square, None))
        for k in (1, 2, 3):
            cases.append(case(f"{name} K={k}", idx, wts[:, :k], 2,
                              square[:k], wo))
        for k in (1, 2, 3, 4):
            cases.append(case(f"{name} K={k} irregular", idx,
                              rand(n, k, p), 2, irregular[:k], wo))
    ns = min(n, 4)
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    evens = (rows[::2] * w + cols[:, ::2]).reshape(-1)
    order = torch.argsort(rand(ns, evens.numel()), dim=1)
    ry = torch.arange(37, device=device)[:, None] * (h - 1) // 36
    rx = torch.arange(45, device=device)[None, :] * (w - 1) // 44
    stress = [
        ("one pixel", torch.full((ns, s), (h // 2) * w + w // 2,
                                 device=device), w),
        ("rows right to left", (rows * w + (w - 1 - cols)).reshape(1, -1)
         .expand(ns, s), w),
        ("permutation", evens[order], (w + 1) // 2),
        ("raster 37x45", (ry * w + rx).reshape(1, -1).expand(ns, -1), 45),
        ("one point", torch.full((ns, 1), s - 1, device=device), 1),
        ("2x10x10", (rand(2, 100) * s).long(), 10),
    ]
    for name, idx, wo in stress:
        for c in (1, 4):
            cases.append(case(f"{name} C={c}", idx,
                              rand(idx.shape[0], 4, idx.shape[1]), c, square,
                              wo))
    return cases


def check_corner_bwd(n, shape, device):
    """Phase 14: the corner backward on each of :func:`corner_bwd_cases`
    against its plain version, ``d_img`` and ``d_w`` within TOL_DIMG_REL
    of their largest entries; on the card each call must launch its
    family's kernel once.  Returns the largest absolute errors per
    family."""
    import torch
    from advchain_tpu_torch.kernels import plane_sample as ps
    worst = {"corner": 0.0, "corner_tile": 0.0}
    for label, img, idx, wts, g, offs, width, fam in corner_bwd_cases(
            n, shape, device):
        before = ps.LAUNCHES[fam]["bwd"]
        with torch.no_grad():
            d_img, d_w = ps.corner_sample_bwd(g, img, idx, wts, offs, width)
            r_img, r_w = ps.corner_sample_bwd_plain(g, img, idx, wts, offs)
        sync(device)
        launched = ps.LAUNCHES[fam]["bwd"] - before
        errs = [float((a - b).abs().max()) for a, b in ((d_img, r_img),
                                                         (d_w, r_w))]
        scales = [float(b.abs().max()) for b in (r_img, r_w)]
        print(f"[corner bwd] {fam:11s} {label:28s} K={len(offs)}: d_img "
              f"{errs[0]:.3e} (max {scales[0]:.3e}) d_w {errs[1]:.3e} (max "
              f"{scales[1]:.3e})", flush=True)
        if torch.device(device).type == "cuda" and launched != 1:
            raise AssertionError(f"corner backward {label}: {launched} "
                                 f"{fam} launches, expected 1")
        if not all(e <= TOL_DIMG_REL * sc for e, sc in zip(errs, scales)):
            raise AssertionError(f"corner backward {label} disagrees with "
                                 f"its plain version: {errs} (limits "
                                 f"{[TOL_DIMG_REL * sc for sc in scales]})")
        worst[fam] = max(worst[fam], *errs)
    return worst


def tile_blocks(n, p, wo, device, tile_w=32):
    """The corner tile kernel's mapping of a batch of ho x wo rasters
    (advchain_corner_tile_sample_bwd): tiles of 256 points ``tile_w``
    wide (8 x 32 as built), or of one row, one point a thread.  Returns
    each point's block (N, P) and its thread in the block (P,)."""
    import torch
    ho, tw = p // wo, 1
    while tw < wo and tw < (256 if ho == 1 else tile_w):
        tw *= 2
    th = 256 // tw
    r = torch.arange(p, device=device) // wo
    col = torch.arange(p, device=device) % wo
    tiles_x = -(-wo // tw)
    tile = (r // th) * tiles_x + col // tw
    per_sample = tiles_x * -(-ho // th)
    block = torch.arange(n, device=device)[:, None] * per_sample + tile
    return block, (r % th) * tw + col % tw


def corner_atomics(idx, wts, offsets, s, wo, tile_w=32):
    """Global atomics per point that a corner backward at these inputs
    issues, reckoned from idx and w alone: one per valid tap of nonzero
    weight (``point``, the flat kernel; a lane of the tile kernel owns one
    point, so this is also its lane's count), and one per distinct tap
    address among a warp's points (``warp``) and a block's (``block``, the
    corner tile kernel where every block's box fits) under
    :func:`tile_blocks` with ``tile_w``."""
    import torch
    n, p = idx.shape
    off = torch.tensor(offsets, device=idx.device)
    f = idx.long()[:, None, :] + off[None, :, None]        # (N, K, P)
    live = (f >= 0) & (f < s) & (wts != 0)
    block, thread = tile_blocks(n, p, wo, idx.device, tile_w)
    counts = {"point": float(live.sum()) / (n * p)}
    for name, gid in (("warp", block * 8 + thread // 32), ("block", block)):
        key = (gid[:, None, :].expand_as(f) * (s + 1) + f)[live]
        counts[name] = torch.unique(key).numel() / (n * p)
    return counts


def time_corner_bwd(n, shape, device):
    """Phase 17: the corner tile backward and the kept flat backward (the
    "was" figure) in turns (tile, flat, flat, tile), each with its zero
    fill, at the image warps' call (the rotation, zeros, C=1), at C=4 (the
    warp-back of predictions) and on the near-identity grid with border
    padding, all K=4 with the raster width; the flat backward alone at K=1
    (nearest, which it keeps); beside the bound, the twin, the atomics per
    point (:func:`corner_atomics`) and ``F.grid_sample``'s backward."""
    import torch
    import torch.nn.functional as F
    from advchain_tpu_torch.kernels import plane_sample as ps
    grids = sample_grids(n, shape, device)
    rows = []
    for gi, c, k in ((0, 1, 4), (0, 4, 4), (1, 1, 4), (0, 1, 1)):
        name, padding, grid = grids[gi]
        _, img, (idx,), wts, g, offs = flat_inputs(n, c, shape, grid,
                                                   padding, k, device)
        wo, p, s = grid.shape[2], idx.shape[1], img.shape[2]
        bound = bound_ms(4 * (n * c * p + 2 * n * c * s + n * p
                              + 2 * k * n * p), 4 * k * n * c * p)
        fns = {"tile": lambda: ps.corner_sample_bwd(g, img, idx, wts, offs,
                                                    wo),
               "flat": lambda: ps._bwd("corner", g, img, None, idx, wts,
                                       offs)}
        order = ["tile", "flat", "flat", "tile"] if k == 4 else ["flat"]
        times = {}
        with torch.no_grad():
            for form in order:
                times.setdefault(form, []).append(time_ms(fns[form]))
            plain = time_ms(lambda: ps.corner_sample_bwd_plain(
                g, img, idx, wts, offs))
        mode = "bilinear" if k == 4 else "nearest"
        img_g = img.reshape((n, c) + tuple(shape)).clone().requires_grad_()
        grid_g = grid.clone().requires_grad_(k == 4)

        def lib():
            return F.grid_sample(img_g, grid_g, mode=mode,
                                 padding_mode=padding, align_corners=True)

        row = {"kernel": "corner_tile" if k == 4 else "corner",
               "case": name, "padding": padding, "C": c, "K": k,
               **{f"{form}_ms": statistics.mean(t)
                  for form, t in times.items()},
               "turns_ms": times, "plain_ms": plain, "bound_ms": bound[0],
               "bound_by": bound[1],
               "atomics_per_point": corner_atomics(idx, wts, offs, s, wo)}
        row.update(library_bwd_ms(
            lib, (img_g, grid_g) if k == 4 else img_g,
            g.reshape((n, c) + tuple(grid.shape[1:-1]))))
        rows.append(row)
        print("[timing] " + json.dumps(row), flush=True)
    return rows


def tile_record(launches, worst, rows, shape_note):
    """The ``kernels`` line's entry of the corner tile backward, timed at
    the image warps' call (the rotation, C=1) with its zero fill; the kept
    flat backward's time in the same turns is ``flat_ms``."""
    head = rows[0]
    return {
        "name": f"{KERNEL_NAMES['corner_tile']}_bwd", "route": "cuda",
        "source": KERNEL_SOURCES["corner_tile"],
        "replaces": REPLACES["corner_tile"]["bwd"],
        "launches": launches["corner_tile"]["bwd"],
        "max_abs_err": worst["corner_tile"], "ms": head["tile_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["bwd_library_ms"],
        "library_fwd_bwd_ms": head["fwd_bwd_library_ms"],
        "flat_ms": head["flat_ms"],
        "shape": f"{shape_note} C={head['C']} {head['case']} "
                 f"{head['padding']}"}


def family_launches(launches, fam):
    """A route family's launches each way; the corner route's backward
    counts both its kernels (the tile kernel takes its bilinear calls)."""
    counts = dict(launches[fam])
    if fam == "corner":
        counts["bwd"] += launches["corner_tile"]["bwd"]
    return counts


@contextlib.contextmanager
def corner_calls():
    """Record each corner sample of the 2D route made inside the block:
    its channels, padding (from the fold that built its weights), taps,
    and whether its backward ran; restored after it."""
    gs = importlib.import_module("advchain_tpu_torch.ops.grid_sample")
    real = {name: getattr(gs, name)
            for name in ("corner_weights", "nearest_weights", "CornerSample")}
    calls, last = [], {}

    def fold(name, pos):
        def wrapper(grid, *args, **kwargs):
            last["padding"] = args[pos]
            return real[name](grid, *args, **kwargs)
        return wrapper

    class Recorded:
        @staticmethod
        def apply(img, idx, w, offsets, width=None):
            out = real["CornerSample"].apply(img, idx, w, offsets, width)
            rec = {"C": img.shape[1], "padding": last.get("padding"),
                   "K": len(offsets), "backward": False}
            calls.append(rec)
            if out.requires_grad:
                out.register_hook(lambda grad: rec.update(backward=True))
            return out

    gs.corner_weights = fold("corner_weights", 2)
    gs.nearest_weights = fold("nearest_weights", 1)
    gs.CornerSample = Recorded
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(gs, name, fn)


def profile_legacy_2d(device, path, median_s, peak):
    """The 2D headline episode with ADVCHAIN_BAND_KERNEL=0: the (C,
    padding) of each corner sample whose backward runs, from one recorded
    episode, then :func:`profile_episode`; prints and writes to ``path``
    the busy time, launches and idle share against the unprofiled median
    ``median_s``, and the peak device bytes ``peak`` of the timed run."""
    import torch
    with legacy_route(2):
        solver = build_solver(BATCH, SHAPE)
        model = build_model(device)
        data = torch.as_tensor(make_input(BATCH, SHAPE), device=device)
        with corner_calls() as calls:
            episode_once(solver, model, data, POWER_ITERATION[2])
        prof = profile_episode(device, BATCH, SHAPE, path)
    bwd = [(c["C"], c["padding"]) for c in calls if c["backward"]]
    idle = 1 - prof["device_busy_ms"] / (median_s * 1e3)
    extra = {"median_ms": median_s * 1e3, "idle_share": idle,
             "peak_gb": peak / 1e9, "corner_calls": calls,
             "corner_bwd_calls": bwd}
    with open(path) as f:
        summary = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(summary, **extra), f, indent=1)
    print(f"[profile] 2D episode on the corner route: device busy "
          f"{prof['device_busy_ms']:.1f} ms of the unprofiled median "
          f"{median_s * 1e3:.1f} ms, idle share {idle:.3f}, "
          f"{prof['device_launches']} kernel launches, peak "
          f"{peak / 1e9:.2f} GB; corner backward calls (C, padding): {bwd} "
          f"of {len(calls)} corner samples", flush=True)
    return dict(prof, **extra)


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


def profile_3d(device, path, median_s):
    """Profile one 3D episode on this process's route (:func:`profile_run`)
    and print its device busy time against the unprofiled median
    ``median_s``: the idle share."""
    prof = profile_episode(device, BATCH3D, SHAPE3D, path)
    print(f"[profile] 3D episode on the {route_family(3)} route: device "
          f"busy {prof['device_busy_ms']:.1f} ms of the unprofiled median "
          f"{median_s * 1e3:.1f} ms, idle share "
          f"{1 - prof['device_busy_ms'] / (median_s * 1e3):.3f}, "
          f"{prof['device_launches']} kernel launches", flush=True)
    return prof


# --------------------------------------------------------------- slice 10
# config #3, the constrained solve (bench.py:294-346)
CONSTRAINED_BATCH = 4
CONSTRAINED_N_ITER = 3
ANATOMY_WEIGHT = 50.0
VOLUME_TOL = 5e-4


def make_anatomy(batch, shape):
    """bench.py:317-321's ellipse (radii 40 x 34 px at 192x192, centred),
    scaled with the image."""
    h, w = shape
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    mask = (((ii - h / 2) / (40.0 * h / 192)) ** 2
            + ((jj - w / 2) / (34.0 * w / 192)) ** 2) < 1.0
    return np.broadcast_to(mask, (batch, 1) + tuple(shape)).astype(
        np.float32)


def build_constrained_solver(batch, shape, names=("noise", "bias", "affine",
                                                  "morph"), device=None):
    """Config #3's solver: the headline chain with "lowest" padding on the
    affine and the morph, mse + contour; ``device`` is where the
    transforms' own draws go (None: the GPU)."""
    from advchain_tpu_torch.augmentor import (
        AdvAffine, AdvBias, AdvMorph, AdvNoise,
        ComposeAdversarialTransformSolver)
    cls = {"noise": AdvNoise, "bias": AdvBias, "affine": AdvAffine,
           "morph": AdvMorph}
    cfg = chain_configs(batch, shape)
    chain = []
    for i, n in enumerate(names):
        pad = {"image_padding_mode": "lowest"} \
            if n in ("affine", "morph") else {}
        chain.append(cls[n](config_dict=cfg[n], seed=i, device=device,
                            **pad))
    return ComposeAdversarialTransformSolver(
        chain_of_transforms=chain, divergence_types=["mse", "contour"],
        divergence_weights=[1.0, 0.5])


def constrained_solve(solver, model, data, anatomy, n_iter=CONSTRAINED_N_ITER,
                      tol=VOLUME_TOL, **kw):
    dist = solver.adversarial_training(
        data=data, model=model, n_iter=n_iter, anatomy_mask_images=anatomy,
        anatomy_reg_weight=ANATOMY_WEIGHT, volume_preserve_tolerance=tol,
        step_sizes=1.0, **kw)
    sync(data.device)
    return dist


@contextlib.contextmanager
def sampler_calls():
    """Record each band grid and stencil wrapper call made inside the
    block: ("band_grid", kind, C, padding, align_corners, mode) or
    ("stencil", kind, C); restored after it."""
    from advchain_tpu_torch.kernels import band_sample, stencil_warp
    calls = []
    real = {}

    def logged(mod, name, key):
        fn = getattr(mod, name)
        real[(mod, name)] = fn

        def wrapper(*args, **kwargs):
            calls.append(key(*args, **kwargs))
            return fn(*args, **kwargs)
        setattr(mod, name, wrapper)

    def band(kind):
        def key(*args, **kwargs):
            img = args[0] if kind == "fwd" else args[1]
            rest = list(args[2:] if kind == "fwd" else args[3:])
            opts = dict(zip(("padding_mode", "align_corners", "mode"), rest))
            opts.update(kwargs)
            return ("band_grid", kind, img.shape[1],
                    opts.get("padding_mode", "zeros"),
                    bool(opts.get("align_corners", True)),
                    opts.get("mode", "bilinear"))
        return key

    def stencil(kind):
        return lambda *args, **kwargs: (
            "stencil", kind, (args[0] if kind == "fwd" else args[1]).shape[1])

    for kind in ("fwd", "bwd"):
        logged(band_sample, f"band_grid_sample_{kind}", band(kind))
        logged(stencil_warp, f"stencil_warp_{kind}", stencil(kind))
    try:
        yield calls
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)


def check_constrained_calls(calls, n, shape, device):
    """Phase 18: rows 1-4 against their plain versions at ``n`` x
    ``shape`` with the channel counts, paddings, align_corners and modes
    that the constrained solve called them with (``calls``, from
    :func:`sampler_calls`), on phase 2's grids and phase 10's flows.
    Returns the largest errors by family."""
    band = sorted({c[2:] for c in calls if c[0] == "band_grid"},
                  key=str)
    stencil = sorted({c[2] for c in calls if c[0] == "stencil"})
    print(f"[constrained] band grid calls (C, padding, align, mode): "
          f"{band}; stencil channels {stencil}", flush=True)
    kern, _, call_args = grid_pair("band_grid")
    worst = {"fwd": 0.0, "bwd": 0.0}
    for name, grid in grid_cases(n, shape, device):
        for c, padding, align, mode in band:
            hold_grid_case("band_grid", kern, call_args, name, grid, shape,
                           c, mode, padding, align, None, worst)
    worst_s = check_stencil(n, shape, device, channels=tuple(stencil))
    return {"band_grid": worst, "stencil": worst_s}


@contextlib.contextmanager
def counted_samples():
    """Count the kernels' callers inside the block: 2D samples
    (``grid_sample_2d``; every one should launch the band grid forward)
    and flow compositions (``compose_flow``; every one the stencil
    forward).  The dict is filled when the block ends."""
    gs = importlib.import_module("advchain_tpu_torch.ops.grid_sample")
    integ = importlib.import_module("advchain_tpu_torch.ops.integrate")
    calls = {}
    with count_calls([gs, integ], ("grid_sample_2d",)) as samples, \
            count_calls([integ], ("compose_flow",)) as compositions:
        try:
            yield calls
        finally:
            calls.update(samples, **compositions)


def assert_on_kernels(label, launches, calls, folds):
    """Raise unless every 2D sample of a run launched the band grid
    forward, every flow composition the stencil forward, each
    differentiated composition one dispatch predicate, and no run took
    the corner-level pair or a host-side fold."""
    if (launches["band_grid"]["fwd"] != calls["grid_sample_2d"]
            or launches["stencil"]["fwd"] != calls["compose_flow"]
            or launches["slope"]["fwd"] != launches["stencil"]["bwd"]
            or any(launches["band"].values()) or any(folds.values())):
        raise AssertionError(
            f"the {label} did not run every sample on the band grid pair "
            f"and every composition on the stencil: launches {launches}, "
            f"calls {calls}, folds {folds}")


def check_constrained_against_cpu(device, batch=2, shape=(64, 64)):
    """Phase 19: the constrained solve on ``device`` and on the CPU from
    the same weights and injected parameters (``lazy_load=True``, a
    tolerance of 1.0, so no redraw depends on the device).  The full chain
    without PGD: dist within 1e-3 absolute and the volume score equal up
    to k / numel (k: the roundtrip's pixels within 1e-5 of 0.5); the
    morph-free chain with one penalised PGD step on the noise: the new
    noise's direction to cosine 0.999 and dist to 1e-2 relative, as phase
    3 holds the episode."""
    import torch
    model_d, model_c = build_model(device), build_model("cpu")
    model_c.module.load_state_dict(model_d.module.state_dict())
    data = torch.as_tensor(make_image(batch, shape))
    anatomy = torch.as_tensor(make_anatomy(batch, shape))
    for names, n_iter, flags in (
            (("noise", "bias", "affine", "morph"), 0, None),
            (("noise", "bias", "affine"), 1, [True, False, False])):
        solvers = [build_constrained_solver(batch, shape, names, device=d)
                   for d in (device, "cpu")]
        gen = torch.Generator().manual_seed(7)
        params = [t.init_params(gen) for t in solvers[0].chain_of_transforms]
        dists, scores = [], []
        for solver, model, dev in ((solvers[0], model_d, device),
                                   (solvers[1], model_c, "cpu")):
            solver.set_transformation(params)
            dists.append(float(constrained_solve(
                solver, model, data.to(dev), anatomy.to(dev), n_iter=n_iter,
                tol=1.0, lazy_load=True, optimize_flags=flags)))
            scores.append(float(solver.compute_anatomy_misoverlapping_loss(
                anatomy.to(dev))))
        with torch.no_grad():
            rec = solvers[1].predict_backward(solvers[1].predict_forward(
                anatomy))
        k = int(((rec - 0.5).abs() <= 1e-5).sum())
        diff = abs(dists[0] - dists[1])
        noise = [s.chain_of_transforms[0].param.cpu().reshape(batch, -1)
                 for s in solvers]
        cos = float(torch.nn.functional.cosine_similarity(*noise).min())
        key = "+".join(names) + f" n_iter={n_iter}"
        print(f"[constrained-ref] {key}: dist {dists[0]:.6e} vs cpu "
              f"{dists[1]:.6e} (abs {diff:.2e}), volume score {scores[0]:.6e}"
              f" vs {scores[1]:.6e} (k={k}), noise cosine {cos:.7f}",
              flush=True)
        ok = abs(scores[0] - scores[1]) <= k / anatomy.numel() + 1e-7
        if n_iter == 0:
            ok = ok and diff < 1e-3
        else:
            ok = ok and diff < 1e-2 * abs(dists[1]) and cos > 0.999
        if not ok:
            raise AssertionError(f"constrained solve disagrees with the CPU "
                                 f"run: {key}")


def manual_step(solver, model, data, init_output, flags, step=None):
    """One round of the README's manual loop: ``compute_transform_grads``
    (stashing each flagged transform's gradient), then for each flagged
    transform ``optimize_parameters()`` with no argument (after
    ``set_step_size(step)`` when given), ``rescale_parameters()`` and
    ``eval()``.  Returns (the divergence before the step, the gradients)."""
    import torch
    before, grads = solver.compute_transform_grads(data, model, init_output,
                                                   optimize_flags=flags)
    for t, f, g in zip(solver.chain_of_transforms, flags, grads):
        if (g is None) == f or t.grad is not g:
            raise AssertionError(f"compute_transform_grads stashed no "
                                 f"gradient on the flagged {t.get_name()}")
        if f:
            if step is not None:
                t.set_step_size(step)
            want = t.update(t.param, g, t.get_step_size())
            if not torch.equal(t.optimize_parameters(), want):
                raise AssertionError("optimize_parameters() did not take "
                                     "the stashed gradient's step")
            t.rescale_parameters()
            t.eval()
    return float(before), grads


def divergence(solver, model, data, init_output, flags):
    return float(solver.compute_transform_grads(data, model, init_output,
                                                optimize_flags=flags)[0])


def check_manual_loop(device, batch=2, shape=(64, 64), step=0.02):
    """Phase 19: the README's manual loop (:func:`manual_step`).

    The recipe as written (every transform flagged, the default step 1.0)
    on ``device`` and on the CPU from the same weights and injected
    parameters: the divergence before the step within 1e-3 absolute (as
    phase 3 holds the full chain); the noise's, bias's and morph's
    gradients to cosine 0.999; the affine's sign-of-gradient step equal
    on every entry whose CPU gradient exceeds 1e-3 of its largest; the
    divergence after the card's step within 1e-3 of the CPU's on the
    card's stepped parameters; and where the CPU's own step moves the
    divergence by more than 2e-3, the card's moves it the same way.  A
    step of 1.0 is not first order, so the recipe need not ascend.

    Then on ``device`` alone, from fresh random parameters, the noise,
    bias and morph take a step of ``step``, small enough for the
    first-order gain to show: the divergence ascends."""
    import torch
    names = ("noise", "bias", "affine", "morph")
    models = {device: build_model(device), "cpu": build_model("cpu")}
    models["cpu"].module.load_state_dict(models[device].module.state_dict())
    data = torch.as_tensor(make_image(batch, shape))
    flags = [True] * len(names)
    solvers = {d: build_constrained_solver(batch, shape, device=d)
               for d in (device, "cpu")}
    gen = torch.Generator().manual_seed(7)
    params = [t.init_params(gen) for t in solvers["cpu"].chain_of_transforms]
    res = {}
    for d, solver in solvers.items():
        solver.set_transformation([p.to(d) for p in params])
        init = solver.get_init_output(models[d], data.to(d))
        before, grads = manual_step(solver, models[d], data.to(d), init,
                                    flags)
        after = divergence(solver, models[d], data.to(d), init, flags)
        res[d] = (before, [g.cpu() for g in grads], after, init)
    stepped = [t.param.cpu() for t in solvers[device].chain_of_transforms]
    solvers["cpu"].set_transformation(stepped)
    same = divergence(solvers["cpu"], models["cpu"], data, res["cpu"][3],
                      flags)
    (b_d, g_d, a_d, _), (b_c, g_c, a_c, _) = res[device], res["cpu"]
    cos = {n: float(torch.nn.functional.cosine_similarity(
        x.reshape(1, -1), y.reshape(1, -1))) for n, x, y in
        zip(names, g_d, g_c) if n != "affine"}
    ga, gb = g_d[names.index("affine")], g_c[names.index("affine")]
    big = gb.abs() > 1e-3 * gb.abs().max()
    signs = bool((torch.sign(ga) == torch.sign(gb))[big].all())
    print(f"[manual-loop] recipe at step 1.0: {device} {b_d:.6e} -> "
          f"{a_d:.6e} (cpu on its step {a_c:.6e}, on the card's "
          f"{same:.6e}); cpu before {b_c:.6e}; gradient cosines "
          + ", ".join(f"{n} {c:.7f}" for n, c in cos.items())
          + f"; affine signs agree on {int(big.sum())} of {big.numel()} "
          f"entries: {signs}", flush=True)
    gain_d, gain_c = a_d - b_d, a_c - b_c
    if not (abs(b_d - b_c) < 1e-3 and min(cos.values()) > 0.999 and signs
            and abs(a_d - same) < 1e-3
            and (abs(gain_c) <= 2e-3 or gain_d * gain_c > 0)):
        raise AssertionError("the manual loop on the card disagrees with "
                             "the CPU's")
    solver = build_constrained_solver(batch, shape, device=device)
    data = data.to(device)
    flags = [n != "affine" for n in names]
    solver.init_random_transformation()
    init = solver.get_init_output(models[device], data)
    before, _ = manual_step(solver, models[device], data, init, flags, step)
    after = divergence(solver, models[device], data, init, flags)
    print(f"[manual-loop] {device}, noise, bias and morph at step {step}: "
          f"divergence {before:.6e} -> {after:.6e}", flush=True)
    if not after > before:
        raise AssertionError("the manual loop's step did not ascend")


def run_random_chain(device, batch, shape, warm=2, reps=5):
    """Phase 20, config #2 (bench.py:245-291): each call draws the chain's
    parameters (``init_random_transformation``) and applies it
    (``forward``), ending in a synchronize.  Returns (launches of one
    call, the sample counts of that call, host-side fold calls, median
    seconds, rep times, peak bytes)."""
    import torch
    solver = build_solver(batch, shape)
    for t in solver.chain_of_transforms:
        t.device = device
    data = torch.as_tensor(make_image(batch, shape), device=device)

    def once():
        solver.init_random_transformation()
        out = solver.forward(data)
        sync(device)
        return out

    for _ in range(warm):
        once()
    if data.is_cuda:
        torch.cuda.reset_peak_memory_stats()
    times = []
    fold_modules = [importlib.import_module(f"advchain_tpu_torch.{name}")
                    for name in ("ops.grid_sample", "kernels._coords")]
    for i in range(reps):
        reset_launch_counts()
        with counted_samples() as calls, \
                count_calls(fold_modules, FOLDS) as folds:
            t0 = time.perf_counter()
            out = once()
            times.append(time.perf_counter() - t0)
        if i == 0:
            launches, first_calls, first_folds = (launch_counts(),
                                                  dict(calls), dict(folds))
            if not (tuple(out.shape) == (batch, 1) + tuple(shape)
                    and bool(torch.isfinite(out).all())
                    and len(solver.diffs) == len(solver.chain_of_transforms)):
                raise AssertionError("the random chain's output is not "
                                     "finite or has the wrong shape")
    peak = torch.cuda.max_memory_allocated() if data.is_cuda else 0
    return (launches, first_calls, first_folds, statistics.median(times),
            times, peak)


def run_constrained(device, batch, shape, warm=2, reps=5):
    """Phase 21, config #3: ``reps`` solves after ``warm``, each one
    ``adversarial_training`` with the anatomy mask (a fresh
    rejection-sampled init, ``n_iter`` penalised PGD steps, the volume
    check, the ladder when it fails), ending in a synchronize; after each,
    untimed, the volume score against the tolerance.  Returns (launches
    and sample counts of each solve, median seconds, rep times, the share
    of solves that preserve the volume, losses, peak bytes)."""
    import torch
    solver = build_constrained_solver(batch, shape)
    model = build_model(device)
    data = torch.as_tensor(make_image(batch, shape), device=device)
    anatomy = torch.as_tensor(make_anatomy(batch, shape), device=device)
    for _ in range(warm):
        constrained_solve(solver, model, data, anatomy)
    if data.is_cuda:
        torch.cuda.reset_peak_memory_stats()
    fold_modules = [importlib.import_module(f"advchain_tpu_torch.{name}")
                    for name in ("ops.grid_sample", "kernels._coords")]
    times, runs, losses, passed = [], [], [], 0
    for _ in range(reps):
        reset_launch_counts()
        with counted_samples() as calls, \
                count_calls(fold_modules, FOLDS) as folds:
            t0 = time.perf_counter()
            dist = constrained_solve(solver, model, data, anatomy)
            times.append(time.perf_counter() - t0)
        runs.append((launch_counts(), dict(calls), dict(folds)))
        losses.append(float(dist))
        warped = solver.warped_back_adv_output
        if not (math.isfinite(losses[-1])
                and tuple(warped.shape) == (batch, 4) + tuple(shape)
                and bool(torch.isfinite(warped).all())):
            raise AssertionError(f"constrained solve output is not finite "
                                 f"or has the wrong shape ({losses[-1]})")
        passed += float(solver.compute_anatomy_misoverlapping_loss(
            anatomy)) <= VOLUME_TOL
    peak = torch.cuda.max_memory_allocated() if data.is_cuda else 0
    return (runs, statistics.median(times), times, passed / reps, losses,
            peak)


# --------------------------------------------------------------- slice 11
# JAX's bf16 quality bounds (tests/test_models.py:187-277): logits within
# 5% of the f32 logits' scale, argmax agreement above 0.99; an episode's
# dist within 2% (n_iter=0, adv_data exact) or 10% (n_iter=1, parameter
# cosines above 0.95)
BF16_LOGITS = 0.05
BF16_ARGMAX = 0.99
BF16_DIST = {0: 0.02, 1: 0.10}
BF16_COSINE = 0.95
# the options run on the card (phase 25), and the self-attention's gamma
# set away from its init of 0 so that the block changes the output
UNET_OPTIONS = {"encoder_dropout": 0.1, "decoder_dropout": 0.1,
                "self_attention": True, "spectral": True}
ATTENTION_GAMMA = 0.5
ZOO_BATCH = 8
TOL_ZOO = 1e-4               # f32 logits, card against the CPU
# the retry ladder's scripted cases (tests/test_torch_anatomy.py:328-347):
# (n_iter, scores: the init's, then the decisions'); P passes, F fails
LADDER_TOL = 0.5
P, F = 0.0, 1.0
LADDER = {
    "pass": (1, [P, P]),
    "fail_pass": (1, [P, F, P]),
    "fail_fail_pass": (1, [P, F, F, P]),
    "exhausted": (1, [P, F, F, F]),
    "init_retry": (1, [F, P, P]),
    "init_exhausted": (1, [F] * 11 + [P]),
    "n_iter2_reinit": (2, [P, F, F, F, P]),
}
# JAX's outcomes at n_iter=1: (PGD steps, chain inits, redraws, warnings)
LADDER_EXPECTED = {
    "pass": (1, 1, 0, []),
    "fail_pass": (2, 1, 0, ["one more"]),
    "fail_fail_pass": (3, 2, 0, ["one more", "new initialization"]),
    "exhausted": (3, 3, 0, ["one more", "new initialization", "3X"]),
    "init_retry": (1, 1, 1, []),
    "init_exhausted": (1, 1, 11, ["random initialization"]),
}
# the cases whose every draw comes from the transforms' own (CPU)
# generators, so that the card and the CPU take the same parameters: a
# ladder re-init draws from a device generator
LADDER_SAME_DRAWS = ("pass", "fail_pass", "init_retry", "init_exhausted")


def perturb_running_stats(module, seed=0):
    """Running statistics away from their (0, 1) init, from a numpy seed,
    so that running-statistics forwards are tested."""
    import torch
    from advchain_tpu_torch.models.unet import FrozenStatsBN
    r = np.random.RandomState(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, FrozenStatsBN):
                n = m.num_features
                m.running_mean.copy_(torch.from_numpy(
                    r.uniform(-0.5, 0.5, n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    r.uniform(0.5, 1.5, n).astype(np.float32)))


def logit_gap(ours, ref):
    """(max |ours - ref| over max |ref|, argmax agreement over classes)."""
    ours, ref = ours.detach().cpu(), ref.detach().cpu()
    return (float((ours - ref).abs().max() / ref.abs().max()),
            float((ours.argmax(1) == ref.argmax(1)).float().mean()))


def copy_of(model, device, compute_dtype=None, **options):
    """A wrapper of the same UNet (``options``) on ``device`` with
    ``model``'s weights."""
    other = build_model(device, compute_dtype=compute_dtype, **options)
    other.module.load_state_dict(model.module.state_dict())
    return other


def check_bf16_against_cpu(device, batch=2, shape=(64, 64)):
    """Phase 22: the wrapper's bf16 mode on ``device`` against its f32 and
    against bf16 on the CPU (UNet_16, the same weights, running statistics
    moved from their init).

    Logits: f32 on both devices; ``predict`` within JAX's bound
    (``BF16_LOGITS`` of the f32 scale, argmax ``BF16_ARGMAX``) against the
    card's f32 and the CPU's bf16; the batch-statistics gap is printed (on
    random weights JAX's own bf16 misses the bound there,
    tests/test_torch_bf16.py).  Episodes, the headline chain with the same
    injected parameters, JAX's test's settings (running statistics, no
    power iteration, step 1.0): ``n_iter=0`` ``adv_data`` bit-equal to
    f32's and dist within 2%; ``n_iter=1`` dist within 10% and every
    transform's parameters at cosine above 0.95.  One bf16 ``apply_train``
    leaves every parameter and buffer f32 and finite, the running
    statistics moved."""
    import torch
    bf16 = torch.bfloat16
    f32 = build_model(device)
    perturb_running_stats(f32.module)
    low, cpu = copy_of(f32, device, bf16), copy_of(f32, "cpu", bf16)
    x = torch.as_tensor(make_image(batch, shape))
    with torch.no_grad():
        p32, p16 = f32.predict(x.to(device)), low.predict(x.to(device))
        c16 = cpu.predict(x)
        b32 = f32.apply_fixed(x.to(device), train=True)
        b16 = low.apply_fixed(x.to(device), train=True)
    gaps = {"f32": logit_gap(p16, p32), "cpu_bf16": logit_gap(p16, c16),
            "batch_stats_f32": logit_gap(b16, b32)}
    print(f"[bf16] logits (scale gap, argmax agreement), batch {batch} "
          f"{shape}: predict against f32 {gaps['f32']}, against the CPU's "
          f"bf16 {gaps['cpu_bf16']}; batch statistics against f32 "
          f"{gaps['batch_stats_f32']}; dtypes {p16.dtype} / {c16.dtype}",
          flush=True)
    if not (p16.dtype == c16.dtype == b16.dtype == torch.float32
            and all(gaps[k][0] < BF16_LOGITS and gaps[k][1] > BF16_ARGMAX
                    for k in ("f32", "cpu_bf16"))):
        raise AssertionError(f"bf16 logits outside JAX's bound: {gaps}")
    gen = torch.Generator().manual_seed(7)
    params = [t.init_params(gen)
              for t in build_solver(batch, shape).chain_of_transforms]
    runs = {}
    for n_iter in (0, 1):
        for name, model in (("f32", f32), ("bf16", low)):
            model.eval()
            solver = build_solver(batch, shape)
            solver.set_transformation(params)
            dist = solver.adversarial_training(
                x.to(device), model, n_iter=n_iter, lazy_load=True,
                step_sizes=1.0)
            model.train()
            runs[name] = (float(dist), solver.adv_data.cpu(),
                          [t.param.cpu() for t in solver.chain_of_transforms])
        (d32, a32, q32), (d16, a16, q16) = runs["f32"], runs["bf16"]
        rel = abs(d16 - d32) / abs(d32)
        cos = [float(torch.nn.functional.cosine_similarity(
            u.reshape(1, -1), v.reshape(1, -1))) for u, v in zip(q16, q32)]
        print(f"[bf16] episode n_iter={n_iter}, running statistics: dist "
              f"{d16:.6e} vs f32 {d32:.6e} (rel {rel:.3e}), adv_data "
              f"bit-equal {torch.equal(a16, a32)}, parameter cosines "
              f"{[round(c, 5) for c in cos]}", flush=True)
        ok = rel < BF16_DIST[n_iter] and (
            torch.equal(a16, a32) if n_iter == 0
            else min(cos) > BF16_COSINE)
        if not ok:
            raise AssertionError(f"the bf16 episode (n_iter={n_iter}) is "
                                 f"outside JAX's bound")
    before = {k: v.clone() for k, v in low.module.state_dict().items()}
    low.apply_train(x.to(device)).square().mean().backward()
    tensors = [*low.module.parameters(), *low.module.buffers()]
    moved = [k for k, v in low.module.state_dict().items()
             if "running" in k and not torch.equal(v, before[k])]
    if not (all(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
                for t in tensors if t.is_floating_point())
            and len(moved) == 36):
        raise AssertionError(f"a bf16 apply_train left a buffer not f32 or "
                             f"not finite, or {36 - len(moved)} running "
                             f"statistics unmoved")
    print(f"[bf16] apply_train: every parameter and buffer f32 and finite, "
          f"{len(moved)} running statistics moved", flush=True)
    return gaps


def in_turns(label, run, card):
    """f32, bf16, bf16, f32: ``run(compute_dtype)`` returns (launches, median
    seconds, rep times, peak bytes); prints each turn, returns {mode:
    [results]}."""
    import torch
    out = {"f32": [], "bf16": []}
    for dt in (None, torch.bfloat16, torch.bfloat16, None):
        mode = "f32" if dt is None else "bf16"
        launches, sec, times, peak = run(dt)
        out[mode].append((launches, sec, times, peak))
        print(f"[{label}] {mode}: median {sec * 1e3:.2f} ms "
              f"({BATCH / sec:.2f} img/s) over "
              f"{[round(t * 1e3, 2) for t in times]} ms, peak "
              f"{peak / 1e9:.3f} GB on {card}", flush=True)
    return out


def spectral_stats(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if k.endswith((".u", ".sigma"))}


def dropouts(module):
    from advchain_tpu_torch.models.unet import EpisodeDropout
    return [m for m in module.modules()
            if isinstance(m, EpisodeDropout) and m.p > 0]


@contextlib.contextmanager
def mask_log(module):
    """Record, for each active dropout, the mask object of every forward."""
    log = {i: [] for i, _ in enumerate(dropouts(module))}
    handles = [m.register_forward_hook(
        lambda mod, args, out, i=i: log[i].append(mod._mask))
        for i, m in enumerate(dropouts(module))]
    try:
        yield log
    finally:
        for h in handles:
            h.remove()


def options_model(device):
    """UNet_16 with UNET_OPTIONS, seeded weights, gamma ATTENTION_GAMMA."""
    import torch
    model = build_model(device, **UNET_OPTIONS)
    with torch.no_grad():
        model.module.self_atn.gamma.fill_(ATTENTION_GAMMA)
    return model


def check_options_against_cpu(device, batch=2, shape=(64, 64)):
    """Phase 25, first part: the options model's logits on ``device``
    against the CPU's on the same weights within TOL_ZOO, with running
    and with batch statistics (the card's dropout masks handed to the CPU
    model)."""
    import torch
    model = options_model(device)
    perturb_running_stats(model.module)
    cpu = copy_of(model, "cpu", **UNET_OPTIONS)
    x = torch.as_tensor(make_image(batch, shape))
    errs = {}
    with torch.no_grad():
        for train in (False, True):
            model.begin_episode(3)
            ours = model.apply_fixed(x.to(device), train=train)
            for a, b in zip(dropouts(model.module), dropouts(cpu.module)):
                b._mask = None if a._mask is None else a._mask.cpu()
            ref = cpu.apply_fixed(x, train=train)
            errs["batch" if train else "running"] = float(
                (ours.cpu() - ref).abs().max())
    print(f"[options] logits against the CPU (max abs): {errs}",
          flush=True)
    if not max(errs.values()) <= TOL_ZOO:
        raise AssertionError(f"the options model disagrees with the CPU: "
                             f"{errs}")
    return errs


def run_options(device, batch, shape):
    """Phase 25: one headline episode and one train step through the
    options model.  The episode's frozen passes leave every spectral ``u``
    / ``sigma`` bit-equal and replay one dropout mask per module across
    the PGD step (a second episode draws new ones); the train step's
    ``apply_train`` moves every ``u``.  Returns (the episode's launches,
    its ms, the step's ms)."""
    import torch
    model = options_model(device)
    solver = build_solver(batch, shape)
    data = torch.as_tensor(make_image(batch, shape), device=device)
    stats = spectral_stats(model.module)
    episode_once(solver, model, data)  # warm
    reset_launch_counts()
    with mask_log(model.module) as log:
        t0 = time.perf_counter()
        dist = episode_once(solver, model, data)
        ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    masks = {i: v[0] for i, v in log.items()}
    fixed = all(len(v) >= 3 and all(m is v[0] for m in v)
                for v in log.values())
    with mask_log(model.module) as log2:
        episode_once(solver, model, data)
    redrawn = all(not torch.equal(v[0], masks[i]) for i, v in log2.items())
    kept = all(torch.equal(v, stats[k])
               for k, v in spectral_stats(model.module).items())
    print(f"[options] episode batch {batch}: loss {float(dist):.6e}, "
          f"{ms:.1f} ms, {len(log)} dropouts each one mask over "
          f"{sorted({len(v) for v in log.values()})} forwards: {fixed}, "
          f"redrawn in the next episode: {redrawn}; {len(stats)} spectral "
          f"statistics bit-equal: {kept}", flush=True)
    if not (math.isfinite(float(dist)) and fixed and redrawn and kept
            and len(log) == 9 and len(stats) == 36):
        raise AssertionError("the options model's episode broke the fixed "
                             "network's contract")
    step, state, batch_data = build_train_step(device, batch, shape,
                                               **UNET_OPTIONS)
    with torch.no_grad():
        state.model.module.self_atn.gamma.fill_(ATTENTION_GAMMA)
    before = spectral_stats(state.model.module)
    gen = torch.Generator(device=device).manual_seed(1)
    t0 = time.perf_counter()
    state, metrics = step(state, batch_data, gen)
    sync(device)
    step_ms = (time.perf_counter() - t0) * 1e3
    after = spectral_stats(state.model.module)
    moved = [k for k in after if k.endswith(".u")
             and not torch.equal(after[k], before[k])]
    losses = {k: float(v) for k, v in metrics.items()}
    print(f"[options] train step batch {batch}: losses {losses}, "
          f"{step_ms:.1f} ms (first step), {len(moved)} of 18 spectral u "
          f"moved", flush=True)
    if not (all(math.isfinite(v) for v in losses.values())
            and len(moved) == 18):
        raise AssertionError("the options model's train step did not "
                             "write every spectral u back")
    return launches, ms, step_ms


def check_zoo_nets(device, batch=ZOO_BATCH, shape=SHAPE):
    """Phase 25, second part: UNetv2 (feature scale 4) and
    DeeplySupervisedUNet (64 base filters, ``multi_out``) forward and
    backward with batch statistics on ``device`` and on the CPU with the
    same weights (the loss: the mean square of every output).  Every output
    within TOL_ZOO of the CPU's; the gradients of the input, of the first
    convolution and of the head at cosine above 0.999 with the CPU's, as
    phase 3 holds a PGD direction (the input's and the first layer's run
    back through every BatchNorm, whose backward cancels: on the CPU f32
    sits up to ~1e-2 of their largest entries from f64, so they are not
    held entrywise; the largest gaps are printed)."""
    import torch
    from advchain_tpu_torch.models import (DeeplySupervisedUNet,
                                           SegmentationModel, UNetv2)
    nets = {"UNetv2": (lambda: UNetv2(1, 4, 4), {}),
            "DeeplySupervisedUNet": (lambda: DeeplySupervisedUNet(1, 4, 64),
                                     {"multi_out": True})}
    x = torch.as_tensor(make_image(batch, shape))
    errs = {}
    for name, (make, kw) in nets.items():
        card = SegmentationModel.create(make(), seed=0, device=device)
        cpu = make()
        cpu.load_state_dict(card.module.state_dict())
        res = []
        for module, dev in ((card.module, device), (cpu, "cpu")):
            module.train(True)
            inp = x.to(dev).detach().requires_grad_(True)
            outs = module(inp, **kw)
            outs = outs if isinstance(outs, tuple) else (outs,)
            sum(o.square().mean() for o in outs).backward()
            res.append(([o.detach().cpu() for o in outs],
                        {"d_input": inp.grad.cpu(),
                         "d_first": module.inc.conv.conv[0].weight.grad.cpu(),
                         "d_head": module.outc.conv.weight.grad.cpu()}))
        (o_d, g_d), (o_c, g_c) = res
        errs[name] = {"outputs": max(float((a - b).abs().max())
                                     for a, b in zip(o_d, o_c))}
        for k in g_d:
            a, b = g_d[k].reshape(1, -1), g_c[k].reshape(1, -1)
            errs[name][k] = (
                float(torch.nn.functional.cosine_similarity(a, b)),
                float((a - b).abs().max() / b.abs().max()))
    print(f"[zoo] batch {batch} {shape} against the CPU: the outputs' "
          f"largest gap, each gradient's (cosine, largest gap over its "
          f"largest entry): {errs}", flush=True)
    if not all(e["outputs"] <= TOL_ZOO
               and all(e[k][0] > 0.999 for k in ("d_input", "d_first",
                                                 "d_head"))
               for e in errs.values()):
        raise AssertionError(f"a zoo net disagrees with the CPU: {errs}")
    return errs


class LadderRecorder:
    """Scripted volume scores and the counts of one episode: PGD steps,
    chain inits and the geometric transform's stateful redraws (as
    tests/test_torch_anatomy.py's recorder)."""

    def __init__(self, solver, script):
        self.steps = self.inits = self.redraws = 0
        self.script = list(script)

        def score(mask):
            return self.script.pop(0)
        solver.compute_anatomy_misoverlapping_loss = score
        init = type(solver).init_random_transformation
        step = type(solver).pgd_step
        geo = solver.chain_of_transforms[-1]
        redraw = type(geo).init_parameters

        def init_random(*a, **kw):
            self.inits += 1
            return init(solver, *a, **kw)

        def pgd_step(*a, **kw):
            self.steps += 1
            return step(solver, *a, **kw)

        def init_parameters(*a, **kw):
            self.redraws += 1
            return redraw(geo, *a, **kw)
        solver.init_random_transformation = init_random
        solver.pgd_step = pgd_step
        geo.init_parameters = init_parameters


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def ladder_case(device, case, batch, shape, params, state):
    """One scripted case of the retry ladder on ``device``: the noise and
    affine chain of tests/test_torch_anatomy.py's ladder ("lowest" padding,
    mse + contour), UNet_16 with the weights ``state``, the ellipse,
    ``lazy_load`` on the injected ``params``.  Returns (steps, inits,
    redraws, warnings, dist, launches, ms)."""
    import torch
    n_iter, script = LADDER[case]
    solver = build_constrained_solver(batch, shape, ("noise", "affine"),
                                      device=device)
    model = build_model(device)
    model.module.load_state_dict(state)
    solver.set_transformation([p.to(device) for p in params])
    for t in solver.chain_of_transforms:
        t.is_training = False
    data = torch.as_tensor(make_image(batch, shape), device=device)
    anatomy = torch.as_tensor(make_anatomy(batch, shape), device=device)
    rec = LadderRecorder(solver, script)
    handler = _Warnings()
    log = logging.getLogger("advchain_tpu_torch.augmentor.compose")
    log.addHandler(handler)
    reset_launch_counts()
    try:
        t0 = time.perf_counter()
        dist = float(solver.adversarial_training(
            data, model, n_iter=n_iter, lazy_load=True,
            anatomy_mask_images=anatomy, anatomy_reg_weight=ANATOMY_WEIGHT,
            volume_preserve_tolerance=LADDER_TOL))
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        log.removeHandler(handler)
    if rec.script or not math.isfinite(dist):
        raise AssertionError(f"ladder case {case}: {len(rec.script)} "
                             f"scripted scores left, dist {dist}")
    return (rec.steps, rec.inits, rec.redraws, handler.messages, dist,
            launch_counts(), ms)


def run_ladder(device, batch=CONSTRAINED_BATCH, shape=SHAPE,
               ref_batch=2, ref_shape=(64, 64)):
    """Phase 26: every scripted case of the retry ladder.  At ``ref_batch``
    x ``ref_shape`` on ``device`` and on the CPU from the same weights and
    injected parameters: the same PGD steps, inits, redraws and warnings,
    JAX's where tests/test_torch_anatomy.py lists them, and where every
    draw comes from the transforms' own generators the dist within 1e-2
    relative.  At config #3's ``batch`` x ``shape`` on ``device`` (after
    one warm case): the same counts again, and each case's port kernel
    launches and ms."""
    import torch
    rows = {}
    runs = {}
    for b, sh in ((ref_batch, ref_shape), (batch, shape)):
        gen = torch.Generator().manual_seed(9)
        params = [t.init_params(gen) for t in build_constrained_solver(
            b, sh, ("noise", "affine"), device="cpu").chain_of_transforms]
        state = build_model("cpu").module.state_dict()
        runs[b, sh] = lambda dev, case, b=b, sh=sh, params=params, \
            state=state: ladder_case(dev, case, b, sh, params, state)
    small, big = runs[ref_batch, ref_shape], runs[batch, shape]
    big(device, "pass")  # warm
    for case in LADDER:
        card, cpu, full = small(device, case), small("cpu", case), \
            big(device, case)
        launches = kernel_launches(full[5])
        rows[case] = {"steps": full[0], "inits": full[1],
                      "redraws": full[2], "warnings": len(full[3]),
                      "port_launches": sum(launches.values()),
                      "ms": full[6]}
        print(f"[ladder] {case}: steps {full[0]}, inits {full[1]}, redraws "
              f"{full[2]}, warnings {full[3]}; at {ref_batch} x {ref_shape} "
              f"dist {card[4]:.6e} (cpu {cpu[4]:.6e}); at {batch} x {shape}"
              f" port launches {({k: v for k, v in launches.items() if v})}"
              f", {full[6]:.1f} ms", flush=True)
        same = card[:4] == cpu[:4] == full[:4]
        if case in LADDER_EXPECTED:
            steps, inits, redraws, warns = LADDER_EXPECTED[case]
            same = same and card[:3] == (steps, inits, redraws) and len(
                card[3]) == len(warns) and all(
                w in m for w, m in zip(warns, card[3]))
        if case in LADDER_SAME_DRAWS:
            same = same and abs(card[4] - cpu[4]) <= 1e-2 * abs(cpu[4])
        if not same:
            raise AssertionError(f"ladder case {case} on the card differs "
                                 f"from the CPU or from JAX's outcome: "
                                 f"{card[:5]} vs {cpu[:5]}, {full[:5]}")
    return rows


def kernel_launches(launches):
    """Launches by kernel record name (the ``kernels`` line's names)."""
    out = {f"{KERNEL_NAMES[fam]}_{kind}": launches[fam][kind]
           for fam in ("band", "band_grid", "zband", "zband_grid",
                       "stencil", "corner", "plane", "plane_grid")
           for kind in ("fwd", "bwd")}
    out[f"{KERNEL_NAMES['corner_tile']}_bwd"] = launches["corner_tile"]["bwd"]
    out[KERNEL_NAMES["slope"]] = launches["slope"]["fwd"]
    return out


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
    parser.add_argument("--profile3d-legacy", metavar="PATH",
                        help="also write a profile of one 3D episode on the "
                             "plane route (ADVCHAIN_ZBAND=0) to PATH")
    parser.add_argument("--profile-legacy2d", metavar="PATH",
                        help="also write a profile of one 2D episode on the "
                             "corner route (ADVCHAIN_BAND_KERNEL=0) to PATH")
    parser.add_argument("--profile-constrained", metavar="PATH",
                        help="also write a profile of one constrained solve "
                             "(config #3) to PATH")
    parser.add_argument("--profile-random-chain", metavar="PATH",
                        help="also write a profile of one random-chain call "
                             "(config #2) to PATH")
    parser.add_argument("--profile-train-bf16", metavar="PATH",
                        help="also write a profile of one headline train "
                             "step in the wrapper's bf16 mode to PATH")
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
        profile_3d(device, args.profile3d, sec3)
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

    # the legacy routes, selected by the JAX package's switches: the
    # flat-index corner kernels (2D) and the plane grid kernels (3D); the
    # flat plane kernels are the TPU plane kernels' kernel-level
    # counterpart
    worst_c = check_flat_kernels(BATCH, SHAPE, device, (1, 2, 5), (1, 4))
    worst_ct = check_corner_bwd(BATCH, SHAPE, device)
    # the flat corner backward's record: its own cases (K=4 at the tap
    # square takes the tile kernel)
    worst_c["bwd"] = worst_ct["corner"]
    worst_p = check_flat_kernels(BATCH3D, SHAPE3D, device, (1, 3, 5), (2, 4))
    worst_pg = check_grid_kernels(BATCH3D, SHAPE3D, device, fam="plane_grid")
    launches_c, sec_c, _, _, peak_c, _ = run_legacy_episode(device, BATCH,
                                                            SHAPE, card)
    # every bilinear backward of the route on the tile kernel
    if not (family_launches(launches_c, "corner") == launches2["band_grid"]
            and launches_c["corner_tile"]["bwd"]
            == launches2["band_grid"]["bwd"]
            and launches_c["stencil"] == launches2["stencil"]):
        raise AssertionError(f"the corner route's launches {launches_c} "
                             f"differ from the band route's {launches2}")
    if args.profile_legacy2d:
        profile_legacy_2d(device, args.profile_legacy2d, sec_c, peak_c)
    with count_calls(fold_modules, FOLDS) as folds_p:
        launches_p, sec_p = run_legacy_episode(device, BATCH3D, SHAPE3D,
                                               card)[:2]
    print(f"[legacy] 3D plane route: plane_grid {launches_p['plane_grid']}, "
          f"flat plane {launches_p['plane']}, host-side fold calls "
          f"{json.dumps(folds_p)}", flush=True)
    if not (launches_p["plane_grid"] == launches3["zband_grid"]
            and not any(launches_p["plane"].values())
            and not any(folds_p.values())):
        raise AssertionError(
            f"the 3D plane route did not sample through the plane grid pair "
            f"alone ({launches3['zband_grid']} launches, no flat plane "
            f"launch, no fold): {launches_p}, {folds_p}")
    if args.profile3d_legacy:
        with legacy_route(3):
            profile_3d(device, args.profile3d_legacy, sec_p)
    rows_c = time_flat_kernels(BATCH, SHAPE, device, 1)
    rows_ct = time_corner_bwd(BATCH, SHAPE, device)
    rows_p = time_flat_kernels(BATCH3D, SHAPE3D, device, 3)
    rows_pg = time_grid_kernels(BATCH3D, SHAPE3D, device, channels=(3,),
                                fam="plane_grid")
    time_grid_routes(BATCH3D, SHAPE3D, device, legacy=True)

    # slice 10: the solver's host API through bench.py's configs #2 and
    # #3; the constrained solve's kernel calls, logged on one solve, then
    # held against the plain versions at those settings
    solver_c = build_constrained_solver(CONSTRAINED_BATCH, SHAPE)
    model_c = build_model(device)
    data_c = torch.as_tensor(make_image(CONSTRAINED_BATCH, SHAPE),
                             device=device)
    anatomy_c = torch.as_tensor(make_anatomy(CONSTRAINED_BATCH, SHAPE),
                                device=device)
    with sampler_calls() as logged:
        constrained_solve(solver_c, model_c, data_c, anatomy_c)
    worst_cs = check_constrained_calls(logged, CONSTRAINED_BATCH, SHAPE,
                                       device)
    check_constrained_against_cpu(device)
    check_manual_loop(device)
    launches_rc, calls_rc, folds_rc, sec_rc, times_rc, peak_rc = \
        run_random_chain(device, BATCH, SHAPE)
    print(f"[random-chain] config #2, batch {BATCH} {SHAPE[0]}x{SHAPE[1]}: "
          f"median {sec_rc * 1e3:.2f} ms ({BATCH / sec_rc:.2f} img/s) over "
          f"{[round(t * 1e3, 2) for t in times_rc]} ms, launches band_grid "
          f"{launches_rc['band_grid']}, stencil {launches_rc['stencil']}, "
          f"samples {calls_rc}, host-side folds {folds_rc}, peak "
          f"{peak_rc / 1e9:.2f} GB on {card}", flush=True)
    assert_on_kernels("random chain", launches_rc, calls_rc, folds_rc)
    if not (launches_rc["band_grid"]["fwd"] and launches_rc["stencil"]["fwd"]):
        raise AssertionError(f"the random chain launched no band grid or "
                             f"stencil forward: {launches_rc}")
    if args.profile_random_chain:
        solver_rc = build_solver(BATCH, SHAPE)
        data_rc = torch.as_tensor(make_image(BATCH, SHAPE), device=device)

        def random_chain_call():
            solver_rc.init_random_transformation()
            solver_rc.forward(data_rc)
            sync(device)

        prof_rc = profile_run("random chain", random_chain_call,
                              args.profile_random_chain)
        print(f"[profile] random chain: device busy "
              f"{prof_rc['device_busy_ms']:.2f} ms of the unprofiled median "
              f"{sec_rc * 1e3:.2f} ms, idle share "
              f"{1 - prof_rc['device_busy_ms'] / (sec_rc * 1e3):.3f}",
              flush=True)
    runs_cs, sec_cs, times_cs, share_cs, losses_cs, peak_cs = \
        run_constrained(device, CONSTRAINED_BATCH, SHAPE)
    per_solve = [sum(sum(v.values()) for v in run[0].values())
                 for run in runs_cs]
    print(f"[constrained] config #3, batch {CONSTRAINED_BATCH} "
          f"{SHAPE[0]}x{SHAPE[1]}, n_iter={CONSTRAINED_N_ITER}: median "
          f"{sec_cs * 1e3:.2f} ms per solve over "
          f"{[round(t * 1e3, 2) for t in times_cs]} ms, volume preserved in "
          f"{share_cs:.2f} of {len(runs_cs)} solves (tolerance "
          f"{VOLUME_TOL}), losses {losses_cs}, the port's kernel launches "
          f"per solve {per_solve} (first: band_grid "
          f"{runs_cs[0][0]['band_grid']}, stencil {runs_cs[0][0]['stencil']},"
          f" dispatch predicates {runs_cs[0][0]['slope']['fwd']}), samples "
          f"{[r[1] for r in runs_cs]}, peak {peak_cs / 1e9:.2f} GB on {card}",
          flush=True)
    for launches, calls, folds in runs_cs:
        assert_on_kernels("constrained solve", launches, calls, folds)
        if not (launches["band_grid"]["bwd"] and launches["stencil"]["bwd"]):
            raise AssertionError(f"a constrained solve ran no differentiated "
                                 f"sample or composition: {launches}")
    if args.profile_constrained:
        prof_cs = profile_run("constrained solve", lambda: constrained_solve(
            solver_c, model_c, data_c, anatomy_c), args.profile_constrained,
            shapes=True)
        print(f"[profile] constrained solve: device busy "
              f"{prof_cs['device_busy_ms']:.2f} ms of the unprofiled median "
              f"{sec_cs * 1e3:.2f} ms, idle share "
              f"{1 - prof_cs['device_busy_ms'] / (sec_cs * 1e3):.3f}",
              flush=True)

    # slice 11: the model zoo; the wrapper's bf16 mode on the headline
    # episode and train step, the UNet's options, UNetv2 and
    # DeeplySupervisedUNet, and the retry ladder's branches
    check_bf16_against_cpu(device)

    def episode_turn(dt):
        with count_calls(fold_modules, FOLDS) as folds_e:
            launches, sec_e, times_e, loss_e, peak_e, _ = run_episode(
                device, BATCH, SHAPE, compute_dtype=dt)
        if not (math.isfinite(loss_e)
                and kernel_launches(launches) == kernel_launches(launches2)):
            raise AssertionError(f"the 2D episode ({dt}) launched "
                                 f"{launches}, not phase 4's {launches2}")
        assert_grid_only("2D episode", 2, launches,
                         GRID_LAUNCHES["episode2d"], folds_e)
        assert_stencil_launches("2D episode", launches)
        return launches, sec_e, times_e, peak_e

    turns_e = in_turns("episode-bf16", episode_turn, card)

    def train_turn(dt):
        with count_calls(fold_modules, FOLDS) as folds_b:
            launches, sec_b, times_b, _, peak_b = run_train_step(
                device, BATCH, SHAPE, compute_dtype=dt)
        if kernel_launches(launches) != kernel_launches(launches_t):
            raise AssertionError(f"the train step ({dt}) launched "
                                 f"{launches}, not phase 12's {launches_t}")
        assert_grid_only("train step", 2, launches, GRID_LAUNCHES["train"],
                         folds_b)
        assert_stencil_launches("train step", launches)
        return launches, sec_b, times_b, peak_b

    turns_t = in_turns("train-bf16", train_turn, card)
    if args.profile_train_bf16:
        step, state, data = build_train_step(device, BATCH, SHAPE,
                                             compute_dtype=torch.bfloat16)
        gen = torch.Generator(device=device).manual_seed(1)

        def one_bf16_step():
            step(state, data, gen)
            sync(device)

        profile_run("train step bf16", one_bf16_step,
                    args.profile_train_bf16)
    check_options_against_cpu(device)
    launches_o, ms_o, step_ms_o = run_options(device, BATCH, SHAPE)
    if kernel_launches(launches_o) != kernel_launches(launches2):
        raise AssertionError(f"the options model's episode launched "
                             f"{launches_o}, not phase 4's {launches2}")
    check_zoo_nets(device)
    ladder = run_ladder(device)

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
               + [tile_record(launches_c, worst_ct, rows_ct,
                              shape2 + " K=4")]
               + kernel_records("plane", launches_p, worst_p, rows_p,
                                "near_identity", 3, shape3 + " K=4")
               + kernel_records("plane_grid", launches_p, worst_pg, rows_pg,
                                "near_identity", 3, shape3)
               + [slope_record(launches_t, slope_row, worst_slope, shape2)])
    by_name = (kernel_launches(launches_rc),
               kernel_launches(runs_cs[0][0]))
    bf16_names = (kernel_launches(turns_e["bf16"][0][0]),
                  kernel_launches(turns_t["bf16"][0][0]))
    for rec in kernels:
        rec["launches_random_chain"] = by_name[0][rec["name"]]
        rec["launches_constrained_solve"] = by_name[1][rec["name"]]
        rec["launches_episode_bf16"] = bf16_names[0][rec["name"]]
        rec["launches_train_bf16"] = bf16_names[1][rec["name"]]
    for rec in kernels:
        fam = "stencil" if rec["name"].startswith("stencil") else \
            "band_grid" if rec["name"].startswith("band_grid") else None
        if fam is not None:  # the constrained solve's own calls (phase 18)
            kind = rec["name"].rsplit("_", 1)[1]
            rec["max_abs_err_constrained"] = worst_cs[fam][kind]
    print(f"[episode] {BATCH / sec:.2f} img/s (2D), {BATCH3D / sec3:.3f} "
          f"vol/s (3D), train step {BATCH / sec_t:.2f} img/s (supervised "
          f"{BATCH / sec_s:.2f}), random chain {BATCH / sec_rc:.2f} img/s, "
          f"constrained solve {sec_cs * 1e3:.2f} ms ({share_cs:.2f} "
          f"preserved) on {card}", flush=True)

    def medians(turns):
        return {mode: round(BATCH / statistics.median(r[1] for r in runs), 2)
                for mode, runs in turns.items()}

    print(f"[bf16] img/s, medians over turns: episode "
          f"{medians(turns_e)}, train step {medians(turns_t)}; peaks GB "
          f"episode {[round(r[3] / 1e9, 3) for r in turns_e['bf16']]} "
          f"(f32 {[round(r[3] / 1e9, 3) for r in turns_e['f32']]}), train "
          f"{[round(r[3] / 1e9, 3) for r in turns_t['bf16']]} (f32 "
          f"{[round(r[3] / 1e9, 3) for r in turns_t['f32']]}); options "
          f"episode {ms_o:.1f} ms, first step {step_ms_o:.1f} ms; ladder ms "
          f"{ {c: round(r['ms'], 1) for c, r in ladder.items()} } on {card}",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
