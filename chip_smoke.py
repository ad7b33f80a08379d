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
  2. hold the band grid pair (the default 2D route, bilinear and nearest)
     against its plain versions on the card at the main path's shapes
     (N=128, 192x192) at C in {1, 2, 4, 5} with three paddings and both
     align_corners on a near-identity warp, that grid with 5% exact +-1
     entries, and a 30-degree rotation;
  3. check the 2D episode on a small input against the same episode on the
     CPU (plain twins), with identical weights and transform parameters;
  4. run the headline adversarial episode (noise -> bias -> affine -> morph,
     batch 128 at 192x192, UNet_16 with 4 classes and seeded random
     weights, mse + contour, n_iter=1, smart power iteration), count the
     kernel launches of one episode (12 / 6 on the band grid pair, no call
     of a host-side fold; 32 / 16 on the
     stencil pair and 16 dispatch predicates, one per composition whose
     grid takes a gradient) and time 5 episodes after 2 warm-ups;
  5. time each 2D kernel, its twin and ``F.grid_sample`` (the library
     yardstick, never used by the port; a backward row times the library's
     backward alone, its graph built before the timed window, and its
     forward and backward together), and a whole 2D sample two ways in
     turns: the band grid pair and ``F.grid_sample``;
  6. hold the fused grid-level z-band pair (trilinear and nearest) against
     its plain versions at the 3D episode's shapes (N=2, 12x192x192, C in
     {1, 3, 5}) with three paddings and both align_corners on a
     near-identity warp of up to 1 voxel, that grid with 5% exact +-1
     entries, and a 10-degree rotation about each axis (samples past the
     volume); and 2D and 3D nearest sampling on the card against the CPU;
  7. check a small 3D episode (batch 2, 1x8x32x32, dropout 0) against the
     same episode on the CPU;
  8. run the 3D volume episode of bench.py:349-404 (noise -> bias ->
     affine -> morph in 3D, batch 2 at 1x12x192x192, PseudoConv3dModel
     with 4 classes, dropout 0.1 and seeded random weights, mse,
     n_iter=1), count its kernel launches (44 / 22 on the fused pair, no
     call of the host-side fold, one dispatch
     predicate per squaring of the PGD step's two exponentiations), print
     its adaptive step counts and time 5 episodes after 2 warm-ups;
  9. time the fused z-band kernels, their plain versions and
     ``F.grid_sample`` on 5-D input, nearest sampling on the pair, and a
     whole 3D sample two ways in turns: the fused pair and
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
     the kernel launches of one step (12 / 8 on the band grid pair, no
     call of a host-side fold; 32 / 16 on the
     stencil pair and 16 dispatch predicates, 54 of the BatchNorm
     backward pair) and time 5 steps after 2 warm-ups; then time the
     supervised step the same way (18 of the BatchNorm pair);
 13. time the stencil kernels, their twins and ``F.grid_sample`` (the
     backward alone) at the composition shape (N=128, C=2, 192x192), the
     backward summed over the 8 squaring inputs of a seeded headline morph
     with each one's share of taps outside the gather's window, and the
     dispatch predicate;
 14. hold the flat-index corner kernels (the 2D route under
     ADVCHAIN_BAND_KERNEL=0) against their twins at the 2D episode's
     shapes (N=128, 192x192, C in {1, 2, 5}, K in {1, 4}) on phase 2's
     grids with 5% of the near-identity entries on exactly +-1 (bases on
     the last column and row: the 2D wrap); and the plane grid pair
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
     (44 / 22), the z-band grid pair 0 times, no call of a host-side fold
     (``plane_weights`` included);
 17. time the corner kernels, the plane grid pair, their twins and
     ``F.grid_sample``, and a whole 3D sample on the plane route two ways
     in turns (the plane grid pair, ``F.grid_sample``); time the corner
     tile backward and the kept flat backward in turns at the image warps'
     call (N=128, C=1, 192x192, the rotation, zeros), at C=4, on the
     near-identity grid, and the flat one at K=1, with the global atomics
     per point reckoned from the indices;
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
     turn's sampling launches equal to phase 4's, with its peak memory;
 24. the headline train step of phase 12 in bf16, in the same turns, each
     turn's sampling launches equal to phase 12's (the bf16 mode keeps
     the library's BatchNorm);
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
     batch 4, 192x192 on the card with each case's launches and ms;
 27. the cardiac-2D recipe of examples/cardiac_2d.py:50-118 at batch 128,
     1x192x192: a seeded synthetic int16 volume (10x256x256) and uint8
     label written as gzip NRRD and gzip NIfTI, ``load_image_label`` of
     slice 5 and of the whole volume bit-equal to numpy's crop and
     rescale, 128 slices stacked, a seeded UNet_16 checkpoint loaded by
     ``get_unet_model``, the recipe's chain (noise, bias, morph, affine):
     the random augmentation, ``adversarial_training(lazy_load=True,
     n_iter=1)``, a ``random_chain`` sub-chain solve and
     ``reset_transformation``, the figure through the ``vis`` functions
     (on matplotlib's Agg where it is installed, else on recording axes
     whose panels are checked and tiled into a PNG);
     5 passes timed by part after 2 warm-ups, the losses finite, every
     sample of a pass on the band grid pair and every composition on the
     stencil, no host-side fold;
 28. RandAugment at batch 128, 1x192x192 (the recipe's slices): every op
     of the augmentation space at bin 9, both signs, nearest and
     bilinear, without and with fill, and Color and Contrast at batch 8
     with 3 channels, each against the CPU (nearest geometric ops equal
     but at the tie pixels, whose count is printed; the rest within
     1e-6), each geometric call one band grid forward launch, no
     backward, no fold; replay bit-equal; ``MyRandAugment(num_ops=2,
     magnitude=9)`` timed over 20 calls, its launches, each op's ms and
     the peak;
 29. one headline train step, ``save_checkpoint`` of the TrainState and
     its generator, ``save_transform_state``, both restored into fresh
     objects bit for bit (``weights_only`` loads), the next step from
     both within 1e-5 relative; ``checked`` on a clean episode and on one
     with a NaN pixel; ``Timer``, ``benchmark`` and a ``start_trace`` /
     ``stop_trace`` trace of one episode; ``interpolate(mode="nearest")``
     2D and 3D bit-equal to the CPU and ``depthwise_conv`` within 1e-6;
 30. the data-parallel train steps: two ranks spawned on this card (both
     on cuda:0, gloo, the kernels built once above), each with 64 of the
     128 rows; the supervised step, the headline step without its PGD
     step (n_iter 0) and the headline step, each against the
     single-process step at batch 128 from the same weights and generator
     state on rank 0 (losses within the JAX package's bounds, rtol 1e-4
     total and 1e-3 consistency; running statistics within rtol 1e-4 /
     atol 1e-5; the applied gradients, summed over the ranks, within 3x
     the relative L2 gap of the single-process step against itself with
     its input perturbed by 1e-7 relative: at this width its first-level
     gradients move that much under rounding-size changes); every
     rank's weights equal; each rank's band grid, stencil and predicate
     launches equal to phase 12's; the collectives and bytes a step, the
     peak per rank, and the step's median in turns with the single-process
     step (a record: the ranks share one card and gloo stages through the
     host);
 31. ``sharded_grid_sample`` on the two ranks (space = 2) at the 3D
     episode's volume (N=2, C in {1, 3}, 12x192x192) and at batch 128,
     1x192x192: both routes, bilinear (forward and both gradients; the
     halo route with zeros and border) and nearest, each rank's rows
     against the dense kernel call on the whole volume (1e-5 of its max,
     nearest exact), the z-band and band launches per call and the ms a
     call;
 32. ``halo_exchange`` (halo 4) and ``sharded_gaussian_smooth`` (the
     morph's sigma 1, kernel 5) on the morph's fields of both episodes,
     against slicing the padded tensor and the dense op; the 3D velocity
     field, 3 planes a shard, is refused.
 33. the spatially partitioned train steps: two ranks spawned on this card
     on a ('data', 'space') = (1, 2) mesh, each with the 128 rows and 96
     of the 192 planes (``shard_batch_spatial``): the supervised step and
     the headline step, each against the single-process step at batch 128
     from the same weights and generator state with its compositions on
     the sampler (``ops.integrate.sampler_compositions``, JAX's
     ``ADVCHAIN_STENCIL=0``, which the space step is) under phase 30's
     gates (the gradients within 3x the perturbation floor or 1e-5), and
     against the default (stencil) single-process step, recorded; every
     rank's weights equal; per rank no stencil launch and no dispatch
     predicate, the band grid launches equal on both ranks; the
     collectives and bytes a step; each rank's peak at most 0.75x the
     single-process step's; the step's median in turns with the
     single-process step (a record);
 34. the same on (2, 2), four ranks of 64 rows and 96 planes; the peak
     recorded, not gated;
 35. the 3D volume train step (PseudoConv3dModel, dropout 0.1, the 3D
     chain with mse, Adam 1e-4, n_iter 1) on (1, 2), 6 of the 12 planes a
     rank, under phase 33's gates (no peak gate), its 3D step counts equal
     to the single-process step's, the z-band launches per rank; the same
     step with a space all-reduce dropped (the PGD step's sum of the
     replicated parameters' gradients, or the weight gradients' sum over
     'space'), which the gates must fail;
 36. every block of ``models/blocks.py`` (the spectral variants, the
     domain banks, the two functions, the 3D ones) on the card against the
     CPU at UNet_16's level widths with 2 rows (16 channels at 192x192 to
     128 at 12x12; the 3D ones at the 3D episode's 2 x 8 x 12x192x192):
     a training forward with the statistics written back and its
     backward (outputs within 1e-4 of the largest entry, statistics within
     1e-5, gradients within 1e-2 relative L2 of the CPU's in float64: a
     ReLU that rounding flips moves a pixel's share), then an eval
     forward; then
     each block's forward and backward timed at 128 rows (the 3D ones at
     2), the median of 5 after 2 warm-ups;
 37. the headline train step on (1, 2), two ranks on this card over gloo,
     with UNet_16 with self-attention (gamma 0.5), UNetv2 (feature scale
     4) and DeeplySupervisedUNet (16 base filters), each under phase 33's
     gates against the single-process step with sampler compositions;
     per rank phase 33's band grid launches, no stencil launch, no
     dispatch predicate, and the attention's all-gathers of its keys and
     values; the collectives, the peak per rank and the step's median in
     turns with the single-process step (a record);
 38. ``ops.stencil_warp_3d`` at the 3D episode's volume (N=2, C in {1, 3},
     12x192x192, both grid layouts, displacements under a voxel with
     entries exactly on +-1) against the z-band grid pair's plain versions
     and the CPU (forward 1e-6, gradients 1e-5 of their largest entries),
     one forward and one backward launch a call, and its ms;
 39. the headline train step at 224x224 on (1, 4), four ranks on this
     card over gloo, each with the 128 rows and 56 of the 224 planes: 56,
     28, 14 and 7 rows a rank down to the third level, then (4, 3, 4, 3)
     rows of the bottom level, which no rank could halve; with UNet_16 and
     with UNet_16 with self-attention (gamma 0.5), each under phase 33's
     gates against the single-process step with sampler compositions;
     per rank phase 33's band grid launches, no stencil launch, no
     dispatch predicate; each level's rows per rank, the collectives,
     bytes, peak per rank and the step's median in turns with the
     single-process step (a record);
 40. every block of ``models/blocks.py`` inside a (1, 2) space group, two
     ranks on this card over gloo, at phase 36's sizes (128 rows at
     UNet_16's level widths, the 3D ones at 2 x 8 x 12x192x192, D split
     6 + 6), each rank's rows against the dense block on the card from the
     same weights and inputs, at phase 36's gates: outputs within 1e-4 of
     the largest entry, written statistics within 1e-5, input and
     parameter gradients (summed over the ranks) within 1e-2 relative L2;
     no kernel launch;
 41. the 3D model's Conv3d weight gradient (``conv3d_wgrad``, the pair
     that replaces cuDNN's for ``ZDecomposedConv3d``) at the 3D cell's two
     layers (N=2, 12x192x192, 1 -> 8 and 8 -> 4 channels), at UNet3D's
     1 -> 32 input layer (N=2, 16x192x192, the one layer of it that the
     width rule gives the pair) and at ragged shapes against its plain twin
     in float64, each no farther from it than cuDNN's ``conv3d_weight``,
     and bit-equal over two runs; 4 launches in one PseudoConv3dModel 3D
     adversarial train step and 2 in one UNet3D step (at 16x192x192), none
     in either episode; the ms of each layer's call, its bound, the twin's
     and cuDNN's ``conv3d_weight``;
 42. the 2D models' training BatchNorm (``kernels/batch_norm.py``: the
     library's forward and write-back, and the pair that replaces cuDNN's
     NCHW backward ``bn_bw_1C11_kernel_new``; the gates in
     ``tests/batch_norm_gates.py``) at UNet_16's five BatchNorm shapes at
     batch 128 and at ragged ones: the forward and write-back equal to
     ``F.batch_norm``'s bit for bit, the backward against the plain twin
     in float64 beside cuDNN's, two runs bit-equal; a module with an
     in-place ReLU after it against float64; the ms of the pair and of
     each of its kernels at the widest and the narrowest shape against
     their byte bounds, the twin's and cuDNN's backward and forward.  Its
     launches are counted in phase 12's train steps at their own shapes
     (54 in the adversarial step, 18 in the supervised one).
Then the ``kernels`` line for all fourteen kernel records, each with its
launches in one random-chain call, one constrained solve, the bf16 episode
and train step, one cardiac recipe pass, the 20 timed RandAugment calls,
each rank's data-parallel train step, phase 31's sharded calls, each
rank's space steps of phases 33-35, 37 and 39, phase 40's block passes,
and one ``stencil_warp_3d`` call beside the main paths'.
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
import tempfile
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
KERNEL_SOURCES = {"band_grid": _CSRC + "band_sample.cu",
                  "zband_grid": _CSRC + "zband_sample.cu",
                  "stencil": _CSRC + "stencil_warp.cu",
                  "slope": _CSRC + "stencil_warp.cu",
                  # the flat kernel pair with one plane is the corner
                  # route (2D); the plane grid pair is the 3D route
                  "corner": _CSRC + "plane_sample.cu",
                  # the corner route's bilinear backward (K = 4)
                  "corner_tile": _CSRC + "plane_sample.cu",
                  "plane_grid": _CSRC + "plane_sample.cu",
                  # the 3D model's Conv3d weight gradient (not a Pallas
                  # kernel: cuDNN's, which the port no longer calls there)
                  "wgrad": _CSRC + "conv3d_wgrad.cu",
                  # the 2D models' training BatchNorm backward (not a
                  # Pallas kernel: cuDNN's, which the port no longer calls
                  # there)
                  "bn": _CSRC + "batch_norm.cu"}
KERNEL_NAMES = {"band_grid": "band_grid_sample",
                "zband_grid": "zband_grid_sample",
                "stencil": "stencil_warp", "slope": "dispatch_slope",
                "corner": "corner_sample",
                "corner_tile": "corner_tile_sample",
                "plane_grid": "plane_grid_sample", "wgrad": "conv3d_wgrad",
                "bn": "batch_norm"}
# the sources to build, one nvcc each
BUILD = sorted({src.rsplit("/", 1)[1][:-3] for src in KERNEL_SOURCES.values()})
# the TPU kernels each pair replaces
_GM = "advchain_tpu/kernels/gather_matmul.py"
REPLACES = {"band_grid": {"fwd": f"{_GM}:839", "bwd": f"{_GM}:923"},
            "zband_grid": {"fwd": f"{_GM}:1081", "bwd": f"{_GM}:1230"},
            "stencil": {"fwd": "advchain_tpu/kernels/stencil.py:132",
                        "bwd": "advchain_tpu/kernels/stencil.py:172"},
            # not a Pallas kernel: the lax.cond predicate of compose_flow
            "slope": {"fwd": "advchain_tpu/ops/integrate.py:103"},
            "corner": {"fwd": f"{_GM}:134", "bwd": f"{_GM}:283"},
            "corner_tile": {"bwd": f"{_GM}:283"},
            "plane_grid": {"fwd": f"{_GM}:466", "bwd": f"{_GM}:603"},
            # not a Pallas kernel: JAX leaves the Conv3d's weight gradient
            # to lax.conv_general_dilated's transpose
            "wgrad": {"bwd": "advchain_tpu/models/unet.py:328"},
            # not a Pallas kernel: JAX leaves BatchNorm's backward to XLA's
            # differentiation of TorchBatchNorm
            "bn": {"bwd": "advchain_tpu/models/norm.py:34"}}
# substrings of the port's CUDA kernel names (the profiler's rows)
PORT_KERNEL_NAMES = ("band_grid", "zband_grid",
                     "stencil_warp", "dispatch_slope", "plane_sample",
                     "plane_grid", "corner_tile", "conv3d_wgrad",
                     "batch_norm_grad_reduce", "batch_norm_grad_input")
# the switches that send 2D / 3D sampling to the corner / plane kernels
LEGACY_SWITCH = {2: "ADVCHAIN_BAND_KERNEL", 3: "ADVCHAIN_ZBAND"}
# the family the default route sends bilinear sampling to, and the one
# LEGACY_SWITCH sends it to
DEFAULT_FAMILY = {2: "band_grid", 3: "zband_grid"}
LEGACY_FAMILY = {2: "corner", 3: "plane_grid"}
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


def zoo_net(name):
    """Phase 37's networks at UNet_16's widths, 4 classes."""
    from advchain_tpu_torch import models
    return {"unet_attention": lambda: models.UNet(1, 4, feature_scale=4,
                                                  self_attention=True),
            "unetv2": lambda: models.UNetv2(1, 4, 4),
            "deeply_supervised": lambda: models.DeeplySupervisedUNet(
                1, 4, 16)}[name]()


def build_model(device, seed=0, dims=2, dropout=0.1, compute_dtype=None,
                net=None, **options):
    """UNet_16 (2D, with the UNet's ``options``), :func:`zoo_net`'s
    ``net`` (a self-attention's ``gamma`` set to ATTENTION_GAMMA, off its
    init of 0, so that the block moves the output), PseudoConv3dModel
    (3D; ``dropout`` applies) or, with ``net="unet3d"``, the 3D U-Net at
    its published widths, 4 classes, seeded random weights, the wrapper's
    ``compute_dtype``."""
    import torch
    from advchain_tpu_torch.models import (PseudoConv3dModel,
                                           SegmentationModel, UNet, UNet3D)
    if dims == 3:
        module = (UNet3D(1, 4, 32) if net == "unet3d"
                  else PseudoConv3dModel(num_classes=4, dropout=dropout))
    elif net is not None:
        module = zoo_net(net)
    else:
        module = UNet(input_channel=1, num_classes=4, feature_scale=4,
                      **options)
    model = SegmentationModel.create(module, seed=seed, device=device,
                                     compute_dtype=compute_dtype)
    if net is not None and getattr(model.module, "self_atn", None) \
            is not None:
        with torch.no_grad():
            model.module.self_atn.gamma.fill_(ATTENTION_GAMMA)
    return model


# the episodes' power-iteration setting: the headline's "smart", the 3D
# episode's default (bench.py:384-392)
POWER_ITERATION = {2: "smart", 3: False}


# the Conv3d weight gradient's launches in one 3D adversarial train step
# (PseudoConv3dModel's two layers, each in the supervised and the
# consistency backward; UNet3D's 1 -> 32 layer alone, the width rule leaving
# its other 13 to cuDNN) and in one 3D episode (whose autograd.grad asks
# for no weight)
WGRAD_LAUNCHES = {"train3d": 4, "episode3d": 0, "train3d_unet3d": 2,
                  "episode3d_unet3d": 0}
# the program counter of the 2D training BatchNorm's backward pair
BN_COUNTER = "batchnorm.pair"
# the volume of the UNet3D cell (a depth three 2x2x2 pools divide)
SHAPE3D_UNET3D = (16, 192, 192)
# the 3D cell's two layers and UNet3D's input layer: (N, Cin, Cout) + the
# volume
WGRAD_SHAPES = {"conv1": (BATCH3D, 1, 8) + SHAPE3D,
                "conv2": (BATCH3D, 8, 4) + SHAPE3D,
                "unet3d_in": (BATCH3D, 1, 32) + SHAPE3D_UNET3D}
# ragged shapes: a single plane, H and W that no tile divides, Cout not a
# multiple of the 4 output channels a lane keeps
WGRAD_RAGGED = {"d1": (2, 1, 8, 1, 7, 37), "odd": (2, 8, 4, 5, 17, 33),
                "cout5": (1, 3, 5, 3, 40, 70), "tiny": (3, 1, 1, 2, 3, 3)}


def _kernel_modules():
    from advchain_tpu_torch.kernels import (band_sample, stencil_warp,
                                            zband_sample)
    return {"band": band_sample, "zband": zband_sample,
            "stencil": stencil_warp}


def reset_launch_counts():
    from advchain_tpu_torch import _trace
    from advchain_tpu_torch.kernels import conv3d_wgrad, plane_sample
    for mod in _kernel_modules().values():
        mod.reset_launch_counts()
    plane_sample.reset_launch_counts()
    conv3d_wgrad.reset_launch_counts()
    _trace.COUNTS.pop(BN_COUNTER, None)


def launch_counts():
    """Launches per family: band_grid and zband_grid (the grid-level
    pairs), stencil, the dispatch predicate (slope), corner and
    corner_tile (the corner route), plane_grid (the 3D plane route), the
    Conv3d weight gradient (wgrad) and the BatchNorm backward pair
    (batch_norm, the program counter ``batchnorm.pair``).  band, zband and
    plane read 0: no route launches them, and cudabench/sut.py reads their
    counters."""
    from advchain_tpu_torch import _trace
    from advchain_tpu_torch.kernels import (band_sample, conv3d_wgrad,
                                            plane_sample, zband_sample)
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
    counts["wgrad"] = {"bwd": conv3d_wgrad.LAUNCHES}
    counts["batch_norm"] = {"bwd": _trace.COUNTS.get(BN_COUNTER, 0)}
    return counts


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


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
    # episodes sample nothing with nearest)
    default = DEFAULT_FAMILY[dims]
    if fam != default and any(launches[default].values()):
        raise AssertionError(f"the {dims}D episode on the {fam} route "
                             f"launched {default} kernels: {launches}")
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
                     supervised=False, compute_dtype=None, mesh=None,
                     n_iter=1, **options):
    """(step, state, batch dict) of the headline train step (bench.py:
    408-447): UNet_16 (with the UNet's ``options``) with seeded random
    weights and the wrapper's ``compute_dtype``, Adam 1e-4, ``n_iter``
    PGD steps (1), smart power iteration, mse + contour; or the supervised
    step.  A 3-D ``shape`` gives the 3D volume episode's step:
    PseudoConv3dModel (dropout 0.1) and its chain (mse, no power
    iteration).  With a ``mesh``: the data-parallel step, the state
    replicated from the mesh's first rank and this rank's rows of the
    batch; on a mesh whose ``space`` axis is larger than 1, this rank's
    block of the batch (its rows and its slab of the leading spatial
    axis)."""
    import torch
    from advchain_tpu_torch.parallel import (TrainState,
                                             make_adversarial_train_step,
                                             make_supervised_train_step,
                                             replicate_to_mesh, shard_batch,
                                             shard_batch_spatial)
    dims = len(shape)
    model = build_model(device, dims=dims, compute_dtype=compute_dtype,
                        **options)
    opt = torch.optim.Adam(model.module.parameters(), lr=LR)
    if supervised:
        step = make_supervised_train_step(model, opt, mesh=mesh)
    else:
        step = make_adversarial_train_step(
            model, build_solver(batch, shape, names), opt, n_iter=n_iter,
            power_iteration=POWER_ITERATION[dims], mesh=mesh)
    state = TrainState.create(model, opt)
    data = {"image": make_input(batch, shape),
            "label": make_labels(batch, shape)}
    if mesh is not None:
        names_m = tuple(mesh.mesh_dim_names)
        spatial = ("space" in names_m
                   and mesh.size(names_m.index("space")) > 1)
        place = shard_batch_spatial if spatial else shard_batch
        return step, replicate_to_mesh(state, mesh), place(data, mesh)
    return step, state, {k: torch.as_tensor(v, device=device)
                         for k, v in data.items()}


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
    last row and plane, beside the rotation's samples past the border."""
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
    """(img, flat index, weights, cotangent, offsets) for the corner
    kernels with ``k`` taps, built as the 2D route builds them:
    K=4 the folded bilinear weights on offsets (0, 1, w, w+1), K=1
    nearest's unit tap."""
    import torch
    from advchain_tpu_torch.ops.grid_sample import (corner_weights,
                                                    nearest_weights)
    gen = torch.Generator(device=device).manual_seed(seed + c)
    img = torch.randn((n, c) + tuple(shape), generator=gen, device=device)
    h, w = shape
    if k == 1:
        (yidx, xidx), wts = nearest_weights(grid, shape, padding)
    else:
        yidx, xidx, wts = corner_weights(grid, h, w, padding, True)
    idx = yidx * w + xidx
    img = img.reshape(n, c, h * w)
    g = torch.randn(n, c, idx.shape[1], generator=gen, device=device)
    offsets = {1: (0,), 2: (0, 1), 4: (0, 1, w, w + 1)}[k]
    return img, idx, wts[:, :k].contiguous(), g, offsets


def check_flat_kernels(n, shape, device, channels, taps):
    """Phase 14: the corner kernels against their twins on
    :func:`flat_grids`, for each channel count and tap count, at phase
    2's tolerances.  Returns the largest errors."""
    from advchain_tpu_torch.kernels import plane_sample as ps
    worst = {"fwd": 0.0, "bwd": 0.0}
    for name, padding, grid in flat_grids(n, shape, device):
        for c in channels:
            for k in taps:
                img, idx, wts, g, offs = flat_inputs(
                    n, c, shape, grid, padding, k, device)
                hold_against_twin(
                    f"corner {name:13s} {padding:6s} C={c} K={k}", device,
                    lambda: ps.corner_sample_fwd(img, idx, wts, offs),
                    lambda: ps.corner_sample_fwd_plain(img, idx, wts, offs),
                    lambda: ps.corner_sample_bwd(g, img, idx, wts, offs),
                    lambda: ps.corner_sample_bwd_plain(g, img, idx, wts,
                                                       offs),
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
    pair (the image warps' case, the rotation grid, zeros padding; the
    backward on the flat kernel, which the tap square no longer takes),
    with the bounds of one launch: each input read once and each output
    written once (f32 and int32, 4 bytes), the weighted sum's
    operations."""
    import torch
    import torch.nn.functional as F
    from advchain_tpu_torch.kernels import plane_sample as ps
    name, padding, grid = sample_grids(n, shape, device)[0]
    img, idx, wts, g, offs = flat_inputs(n, c, shape, grid, padding, k,
                                         device)
    p, s = wts.shape[2], img[0, 0].numel()
    fwd_bound = bound_ms(4 * (n * c * s + n * p + k * n * p + n * c * p),
                         (2 * k - 1) * n * c * p)
    bwd_bound = bound_ms(4 * (n * c * p + 2 * n * c * s + n * p
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
            "kernel": "corner", "case": name, "padding": padding, "C": c,
            "K": k,
            "fwd_ms": time_ms(lambda: ps.corner_sample_fwd(img, idx, wts,
                                                           offs)),
            "fwd_plain_ms": time_ms(lambda: ps.corner_sample_fwd_plain(
                img, idx, wts, offs)),
            "fwd_library_ms": time_ms(lambda: F.grid_sample(
                full, grid, mode="bilinear", padding_mode=padding,
                align_corners=True)),
            "fwd_bound_ms": fwd_bound[0],
            "bwd_ms": time_ms(lambda: ps._bwd(g, img, idx, wts, offs)),
            "bwd_plain_ms": time_ms(lambda: ps.corner_sample_bwd_plain(
                g, img, idx, wts, offs)),
            "bwd_bound_ms": bwd_bound[0],
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
    GRID_PREP_OPS per point.  A row per case: the kernel's, the plain
    version's and the library's ms each way and the bound."""
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
    grid), two ways in turns (a b b a): (a) the grid-level pair (with
    ``legacy`` (3D) the plane grid pair); (b) ``F.grid_sample``, the
    yardstick the port never calls.  Each as wall ms (:func:`wall_ms`) and
    device ms (:func:`time_ms`), the mean of its two turns."""
    import torch
    import torch.nn.functional as F
    from advchain_tpu_torch.kernels.band_sample import BandGridSample
    from advchain_tpu_torch.kernels.plane_sample import PlaneGridSample
    from advchain_tpu_torch.kernels.zband_sample import ZBandGridSample
    dims = len(shape)
    grid_level = BandGridSample if dims == 2 else ZBandGridSample
    case_name, padding, gridd = sample_grids(n, shape, device)[case]
    gen = torch.Generator(device=device).manual_seed(c)
    img = torch.randn((n, c) + tuple(shape), generator=gen, device=device)
    cot = torch.randn((n, c) + tuple(gridd.shape[1:-1]), generator=gen,
                      device=device)

    def fused(x, gr):  # what grid_sample_2d / grid_sample_3d run
        gr = gr.reshape(n, -1, dims).contiguous()
        if legacy:
            return PlaneGridSample.apply(x, gr, padding, True)
        return grid_level.apply(x, gr, padding, True, "bilinear")

    def library(x, gr):
        return F.grid_sample(x, gr, mode="bilinear", padding_mode=padding,
                             align_corners=True)

    routes = {"fused": fused, "library": library}
    x = img.clone().requires_grad_(True)
    gr = gridd.clone().requires_grad_(True)

    def fwd(route):
        with torch.no_grad():
            route(img, gridd)

    def fwd_bwd(route):
        out = route(x, gr)
        torch.autograd.grad(out, (x, gr), cot.reshape(out.shape))

    times = {name: {} for name in routes}
    for name in ("fused", "library", "library", "fused"):
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
        img, idx, wts, g, offs = flat_inputs(n, c, shape, grid, padding,
                                             k, device)
        wo, p, s = grid.shape[2], idx.shape[1], img.shape[2]
        bound = bound_ms(4 * (n * c * p + 2 * n * c * s + n * p
                              + 2 * k * n * p), 4 * k * n * c * p)
        fns = {"tile": lambda: ps.corner_sample_bwd(g, img, idx, wts, offs,
                                                    wo),
               "flat": lambda: ps._bwd(g, img, idx, wts, offs)}
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
    launches equal ``expected`` and no host-side fold was called
    (``folds``, from :func:`count_calls`)."""
    fam = DEFAULT_FAMILY[dims]
    if launches[fam] != expected or any(folds.values()):
        raise AssertionError(
            f"the {label} did not sample through the {fam} pair alone "
            f"({expected['fwd']} / {expected['bwd']} launches, no fold): "
            f"{launches}, {folds}")


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
    differentiated composition one dispatch predicate, and no run called
    a host-side fold."""
    if (launches["band_grid"]["fwd"] != calls["grid_sample_2d"]
            or launches["stencil"]["fwd"] != calls["compose_flow"]
            or launches["slope"]["fwd"] != launches["stencil"]["bwd"]
            or any(folds.values())):
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


# ---------------------------------------------------------------- slice 12
# the cardiac-2D recipe's synthetic volume (z, y, x) and the slice it reads
RECIPE_VOLUME = (10, 256, 256)
RECIPE_SLICE = 5
RA_BIN = 9                   # RandAugment's magnitude bin
RA_C3_BATCH = 8              # the 3-channel Color / Contrast cases
RA_REPS = 20                 # timed MyRandAugment calls
TIE_TOL = 1e-4               # px from a half-integer: either rounding
TOL_PHOTOMETRIC = 1e-6       # apply_op on the card against the CPU
TOL_RESUME = 1e-5            # resumed step's losses, relative (atomics)
TOL_DEPTHWISE = 1e-6
_NRRD_TYPES = {np.dtype(np.int16): "short", np.dtype(np.uint8): "uchar",
               np.dtype(np.float32): "float"}
_NIFTI_TYPES = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4,
                np.dtype(np.float32): 16}


def fold_callers():
    """The modules whose ``FOLDS`` attributes the ops and the plain versions
    call (what :func:`count_calls` wraps)."""
    return [importlib.import_module(f"advchain_tpu_torch.{name}")
            for name in ("ops.grid_sample", "kernels._coords")]


def nearest_tie_mask(op_name, magnitude, h, w, tol=TIE_TOL):
    """(h, w) bool: the output pixels of a RandAugment geometric op whose
    float64 source coordinate (x or y) lies within ``tol`` pixels of a
    half-integer.  Nearest sampling rounds half to even, so there an ulp
    of f32 rounding may pick either neighbour.  All False for the other
    ops."""
    from advchain_tpu_torch.utils.rand_augment import (GEOMETRIC_OPS,
                                                       _pixel_map)
    if op_name not in GEOMETRIC_OPS:
        return np.zeros((h, w), dtype=bool)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    sx, sy = (np.broadcast_to(v, (h, w)) for v in
              _pixel_map(op_name, magnitude, h, w)(xs, ys))
    return ((np.abs(sx - np.floor(sx) - 0.5) < tol)
            | (np.abs(sy - np.floor(sy) - 0.5) < tol))


def write_nrrd(path, arr):
    """``arr`` (z, y, x) as a gzip NRRD (sizes fastest axis first)."""
    import gzip
    kind = _NRRD_TYPES[arr.dtype]
    arr = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("<"))
    header = (f"NRRD0004\ntype: {kind}\n"
              f"dimension: {arr.ndim}\n"
              f"sizes: {' '.join(map(str, arr.shape[::-1]))}\n"
              f"endian: little\nencoding: gzip\n\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii") + gzip.compress(arr.tobytes()))


def write_nifti(path, arr):
    """``arr`` (z, y, x) as a NIfTI-1 file (x fastest, no intensity
    scaling), gzip-compressed when ``path`` ends in ``.gz``."""
    import gzip
    import struct
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, arr.ndim, *arr.shape[::-1],
                     *([1] * (7 - arr.ndim)))
    struct.pack_into("<hh", hdr, 70, _NIFTI_TYPES[arr.dtype],
                     8 * arr.dtype.itemsize)
    struct.pack_into("<ff", hdr, 108, 352.0, 0.0)  # vox_offset, scl_slope
    hdr[344:348] = b"n+1\0"
    data = np.transpose(arr, tuple(range(arr.ndim))[::-1]).astype(
        arr.dtype.newbyteorder("<")).tobytes(order="F")
    raw = bytes(hdr) + data
    with open(path, "wb") as f:
        f.write(gzip.compress(raw) if str(path).endswith(".gz") else raw)


def recipe_volume(shape=RECIPE_VOLUME, seed=0):
    """A synthetic short-axis stack from ``seed``: int16 intensities (a
    bright blood pool inside a darker wall on a noisy background, growing
    along z) and its uint8 label (0 background, 1 right ventricle, 2 wall,
    3 pool)."""
    r = np.random.RandomState(seed)
    depth, h, w = shape
    yy, xx = np.meshgrid(np.arange(h) - h / 2, np.arange(w) - w / 2,
                         indexing="ij")
    rad = np.hypot(yy / 1.1, xx)
    img = np.empty(shape, np.int16)
    label = np.zeros(shape, np.uint8)
    for k in range(depth):
        s = 1.0 + 0.03 * (k - depth / 2)
        pool, wall = rad < 22 * s, (rad >= 22 * s) & (rad < 32 * s)
        rv = (np.hypot(yy, xx + 40 * s) < 18 * s) & ~pool & ~wall
        label[k][rv], label[k][wall], label[k][pool] = 1, 2, 3
        vals = 300 + 900 * pool + 250 * wall + 700 * rv \
            + r.normal(0.0, 40.0, (h, w))
        img[k] = np.clip(vals, 0, 2000).astype(np.int16)
    return img, label


def write_recipe_files(directory, vol, label):
    """The volume and its label as gzip NRRD and as gzip NIfTI: {format:
    (image path, label path)}."""
    paths = {"nrrd": (os.path.join(directory, "img.nrrd"),
                      os.path.join(directory, "seg.nrrd")),
             "nifti": (os.path.join(directory, "img.nii.gz"),
                       os.path.join(directory, "seg.nii.gz"))}
    for fmt, (img_path, lbl_path) in paths.items():
        write = write_nrrd if fmt == "nrrd" else write_nifti
        write(img_path, vol)
        write(lbl_path, label)
    return paths


def check_recipe_loading(paths, vol, label, crop=SHAPE):
    """Phase 27: ``load_image_label`` of slice RECIPE_SLICE and of the whole
    volume (``slice_id=-1``), with the label, from each written format,
    bit-equal to a numpy recomputation of the centre crop and the min-max
    rescale."""
    from advchain_tpu_torch.utils import load_image_label
    hd, wd = ((s - c) // 2 for s, c in zip(vol.shape[1:], crop))
    window = (Ellipsis, slice(hd, hd + crop[0]), slice(wd, wd + crop[1]))
    for fmt, (img_path, lbl_path) in paths.items():
        for sid in (RECIPE_SLICE, -1):
            got, got_label = load_image_label(img_path, lbl_path,
                                              slice_id=sid, crop_size=crop)
            v = (vol[sid] if sid >= 0 else vol)[window].astype(np.float64)
            want = (v - v.min()) / (v.max() - v.min() + 1e-10)
            want_label = (label[sid] if sid >= 0 else label)[window]
            if not (got.dtype == want.dtype and np.array_equal(got, want)
                    and np.array_equal(got_label, want_label)):
                raise AssertionError(f"load_image_label({fmt}, slice_id="
                                     f"{sid}) differs from the crop and "
                                     f"rescale of the written volume")
    print(f"[recipe] load_image_label: slice {RECIPE_SLICE} and the whole "
          f"volume, image and label, from {sorted(paths)}: bit-equal to "
          f"numpy's crop and rescale", flush=True)


def recipe_batch(path, depth, batch, crop, device, channels=1):
    """``batch`` samples of ``channels`` consecutive slices each (cycling
    through the volume's ``depth``), each read and rescaled on its own by
    ``load_image_label``, as (batch, channels, *crop) f32 on ``device``."""
    import torch
    from advchain_tpu_torch.utils import load_image_label
    slices = [load_image_label(path, slice_id=k, crop_size=crop)
              for k in range(depth)]
    x = np.stack([[slices[(i + j) % depth] for j in range(channels)]
                  for i in range(batch)]).astype(np.float32)
    return torch.as_tensor(x, device=device)


def cardiac_chain(batch, shape, device=None):
    """The cardiac-2D recipe's chain (examples/cardiac_2d.py:28-49) in its
    order: noise, bias, morph, affine; seeded 0-3; ``device`` is where the
    transforms draw their parameters (None: the GPU)."""
    from advchain_tpu_torch.augmentor import (AdvAffine, AdvBias, AdvMorph,
                                              AdvNoise)
    size = (batch, 1, *shape)
    bias = AdvBias(config_dict={
        "epsilon": 0.3, "control_point_spacing": [shape[0] // 4] * 2,
        "downscale": 2, "data_size": size, "interpolation_order": 3,
        "init_mode": "random", "space": "log"}, seed=1, device=device)
    noise = AdvNoise(config_dict={"epsilon": 1, "xi": 1e-6,
                                  "data_size": size}, seed=0, device=device)
    affine = AdvAffine(config_dict={
        "rot": 30 / 180, "scale_x": 0.2, "scale_y": 0.2,
        "shift_x": 0.1, "shift_y": 0.1, "data_size": size,
        "forward_interp": "bilinear", "backward_interp": "bilinear"},
        seed=3, device=device)
    morph = AdvMorph(config_dict={
        "epsilon": 1.5, "data_size": size,
        "vector_size": [shape[0] // 16, shape[1] // 16],
        "forward_interp": "bilinear", "backward_interp": "bilinear"},
        seed=2, device=device)
    return [noise, bias, morph, affine]


class RecordingAxes:
    """The axes methods the ``vis`` functions call, recording what they
    draw (images as numpy arrays, line data), for a machine without
    matplotlib."""

    def __init__(self):
        self.images, self.lines, self.title = [], [], None

    def imshow(self, data, **kwargs):
        self.images.append(np.asarray(data, dtype=np.float64))

    def plot(self, x, y, **kwargs):
        self.lines.append((np.asarray(x), np.asarray(y)))

    def set_title(self, title, **kwargs):
        self.title = title

    def set_axis_off(self):
        pass

    def grid(self, *args):
        pass

    def axis(self, *args):
        pass


def write_png(path, img):
    """A uint8 (H, W) grayscale PNG, with zlib alone."""
    import struct
    import zlib
    h, w = img.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\0" + row.tobytes() for row in img.astype(np.uint8))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def draw_recipe_figure(path, image, rand_image, adv_image, init_output,
                       rand_recovered, adv_recovered, bias_field,
                       displacement):
    """The recipe's figure through the port's ``vis`` functions (sample
    0), saved to ``path``: with matplotlib's Agg backend where matplotlib
    is installed; else on :class:`RecordingAxes`, each panel's recorded
    image checked finite and the grid's lines counted, the images tiled
    into a grayscale PNG by :func:`write_png`.  Returns which."""
    import importlib.util
    from advchain_tpu_torch.utils import vis
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    if have_mpl:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(2, 5, figsize=(17, 7))
        ax = list(axes.ravel())
    else:
        ax = [RecordingAxes() for _ in range(10)]
    vis.plot_image(image[0, 0], ax[0], title="input")
    vis.plot_image(rand_image[0, 0], ax[1], title="random aug")
    vis.plot_image(adv_image[0, 0], ax[2], title="adversarial aug")
    vis.plot_noise((adv_image - image)[0, 0], ax[3], title="adv diff")
    vis.plot_bias_field(bias_field[0, 0], ax[4], title="random bias")
    for a, pred, title in ((ax[5], init_output, "predict (clean)"),
                           (ax[6], rand_recovered, "rand, warped back"),
                           (ax[7], adv_recovered, "adv, warped back")):
        vis.plot_general(pred.argmax(1)[0], a, title=title)
    # (H, W, 2) displacement -> the (2, H, W) offsets plot_warped_grid takes
    interval = 8
    vis.plot_warped_grid(displacement[0].movedim(-1, 0), ax[8],
                         bg_img=image[0, 0], interval=interval, show=True)
    if have_mpl:
        ax[9].set_axis_off()
        fig.tight_layout()
        fig.savefig(path, dpi=40)
        plt.close(fig)
        return "matplotlib"
    shape = tuple(image.shape[2:])
    n_lines = sum(-(-s // interval) for s in shape)
    panels = [a.images[0] for a in ax[:9]]
    if not (all(len(a.images) == 1 and p.shape == shape
                and np.isfinite(p).all() for a, p in zip(ax[:9], panels))
            and len(ax[8].lines) == n_lines
            and all(np.isfinite(x).all() and np.isfinite(y).all()
                    for x, y in ax[8].lines)):
        raise AssertionError("the vis functions drew no finite panel of "
                             "the image's shape, or the wrong grid lines")
    tiles = [(p - p.min()) / max(p.max() - p.min(), 1e-12) * 255.0
             for p in panels + [np.zeros(shape)]]
    rows = [np.concatenate(tiles[r * 5:r * 5 + 5], axis=1) for r in (0, 1)]
    write_png(path, np.concatenate(rows, axis=0))
    return "recorded"


def cardiac_recipe_once(solver, model, image, seed, figure_path):
    """One pass of the recipe (examples/cardiac_2d.py:66-118) on
    ``image``: the random augmentation, the adversarial one, a random
    sub-chain solve, the figure.  Returns (seconds per part, losses)."""
    import torch
    from advchain_tpu_torch.augmentor import ComposeAdversarialTransformSolver
    from advchain_tpu_torch.utils import random_chain
    chain = solver.chain_of_transforms
    dev = image.device
    sec = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        solver.init_random_transformation()
        rand_image = solver.forward(image)
        rand_predict = solver.get_net_output(model, rand_image)
        rand_recovered = solver.predict_backward(rand_predict)
        init_output = solver.get_init_output(model, image)
    bias_field, displacement = chain[1].bias_field, chain[2].displacement
    sync(dev)
    sec["random"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss = solver.adversarial_training(
        data=image, model=model, n_iter=1, lazy_load=True,
        optimize_flags=[True] * len(chain))
    losses = {"adversarial": float(loss)}
    sec["adversarial"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one_chain = random_chain(chain[:], max_length=len(chain),
                             rng=np.random.RandomState(seed))
    sub_solver = ComposeAdversarialTransformSolver(
        chain_of_transforms=one_chain, divergence_types=["mse", "contour"],
        divergence_weights=[1.0, 0.5])
    sub_loss = sub_solver.adversarial_training(
        data=image, model=model, init_output=init_output, n_iter=1,
        lazy_load=False, optimize_flags=[True] * len(one_chain),
        step_sizes=[1] * len(one_chain))
    losses["sub_chain"] = float(sub_loss)
    losses["sub_chain_names"] = [t.get_name() for t in one_chain]
    sub_solver.reset_transformation()
    sync(dev)
    sec["sub_chain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses["figure"] = draw_recipe_figure(
        figure_path, image, rand_image, solver.adv_data, init_output,
        rand_recovered, solver.warped_back_adv_output, bias_field,
        displacement)
    sec["figure"] = time.perf_counter() - t0
    return sec, losses


def run_cardiac_recipe(device, batch, crop, directory, warm=2, reps=5,
                       seed=0):
    """Phase 27: the cardiac-2D recipe on ``device`` at ``batch`` x 1 x
    ``crop``, read from NRRD and NIfTI files written under ``directory``,
    with a seeded UNet_16 checkpoint loaded through ``get_unet_model``.
    ``reps`` passes after ``warm``; each part's median seconds (the load
    of the batch included), the first timed pass's launches, sample and
    composition counts and host-side fold calls, the losses and the peak
    bytes."""
    import torch
    from advchain_tpu_torch.augmentor import ComposeAdversarialTransformSolver
    from advchain_tpu_torch.models import get_unet_model
    vol, label = recipe_volume()
    paths = write_recipe_files(directory, vol, label)
    check_recipe_loading(paths, vol, label, crop)
    ckpt = os.path.join(directory, "cardiac_seg_unet_16.pth")
    torch.save(build_model("cpu").module.state_dict(), ckpt)
    model = get_unet_model(ckpt, num_classes=4, model_arch="UNet_16",
                           device=device)
    solver = ComposeAdversarialTransformSolver(
        chain_of_transforms=cardiac_chain(batch, crop, device),
        divergence_types=["mse", "contour"], divergence_weights=[1.0, 0.5],
        debug=True)
    figure = os.path.join(directory, "cardiac_2d.png")
    fold_modules = fold_callers()
    parts = {"load": [], "random": [], "adversarial": [], "sub_chain": [],
             "figure": []}
    for i in range(warm + reps):
        if i == warm:
            reset_launch_counts()
            if torch.device(device).type == "cuda":
                torch.cuda.reset_peak_memory_stats()
        with counted_samples() as calls, \
                count_calls(fold_modules, FOLDS) as folds:
            t0 = time.perf_counter()
            image = recipe_batch(paths["nrrd"][0], vol.shape[0], batch,
                                 crop, device)
            sync(device)
            load_s = time.perf_counter() - t0
            sec, losses = cardiac_recipe_once(solver, model, image, seed,
                                              figure)
        if i == warm:
            launches, first_calls, first_folds = (launch_counts(),
                                                  dict(calls), dict(folds))
            first_losses = losses
        if i >= warm:
            for part, s in dict(sec, load=load_s).items():
                parts[part].append(s)
        if not all(math.isfinite(losses[k])
                   for k in ("adversarial", "sub_chain")):
            raise AssertionError(f"the recipe's losses are not finite: "
                                 f"{losses}")
    if not (os.path.getsize(figure) > 0
            and tuple(solver.adv_data.shape) == (batch, 1) + tuple(crop)):
        raise AssertionError("the recipe wrote no figure or its "
                             "adversarial batch has the wrong shape")
    peak = torch.cuda.max_memory_allocated() \
        if torch.device(device).type == "cuda" else 0
    return {"image": image, "paths": paths, "depth": vol.shape[0],
            "median_s": {k: statistics.median(v) for k, v in parts.items()},
            "launches": launches, "calls": first_calls,
            "folds": first_folds, "losses": first_losses, "peak": peak}


def rand_augment_cases(shape):
    """(op, magnitude) for every op of MyRandAugment's augmentation space
    at bin RA_BIN, both signs of the signed ones."""
    from advchain_tpu_torch.utils import MyRandAugment
    space = MyRandAugment()._augmentation_space(31, shape)
    cases = []
    for op, (mags, signed) in space.items():
        m = float(mags[RA_BIN]) if mags.ndim else 0.0
        cases += [(op, m)] + ([(op, -m)] if signed else [])
    return cases


def hold_rand_augment(x, op, mag, interp, fill, ref=None):
    """Phase 28: one ``apply_op`` call on ``x``'s device against the same
    call on the CPU (``ref``, when given, is that result).  Geometric ops
    in nearest mode must be equal everywhere but at the tie pixels of
    :func:`nearest_tie_mask`; the others within TOL_PHOTOMETRIC.  On the
    card the call must launch the band grid forward once for a geometric
    op and nothing else, and call no host-side fold.  Returns (CPU
    result, largest error outside the ties, mismatched pixels, tie pixels
    of one image)."""
    import torch
    from advchain_tpu_torch.utils import apply_op
    from advchain_tpu_torch.utils.rand_augment import GEOMETRIC_OPS
    fold_modules = fold_callers()
    geometric = op in GEOMETRIC_OPS
    reset_launch_counts()
    with count_calls(fold_modules, FOLDS) as folds:
        out = apply_op(x, op, mag, interp=interp, fill=fill)
        sync(x.device)
    launches = kernel_launches(launch_counts())
    if ref is None:
        ref = apply_op(x.cpu(), op, mag, interp=interp, fill=fill)
    h, w = x.shape[2:]
    exact = geometric and interp == "nearest"
    ties = torch.from_numpy(nearest_tie_mask(op, mag, h, w, TIE_TOL)) \
        if exact else torch.zeros(h, w, dtype=torch.bool)
    diff = (out.cpu() - ref).abs()
    wrong = diff > (0.0 if exact else TOL_PHOTOMETRIC)
    err = float(torch.where(ties, 0.0, diff).max())
    label = f"{op} {mag:+.4g} {interp} fill={fill} {tuple(x.shape)}"
    if bool((wrong & ~ties).any()):
        raise AssertionError(f"apply_op on the card differs from the CPU "
                             f"outside the ties: {label}, largest error "
                             f"{err}")
    want = {name: 0 for name in launches}
    if x.is_cuda and geometric:
        want[f"{KERNEL_NAMES['band_grid']}_fwd"] = 1
    # on the CPU the plain version folds; on the card nothing may
    if launches != want or (x.is_cuda and any(folds.values())):
        raise AssertionError(f"apply_op {label} launched {launches} and "
                             f"called the folds {folds}")
    return ref, err, int(wrong.sum()), int(ties.sum())


def check_rand_augment(device, x, x3):
    """Phase 28: every op of the augmentation space at bin RA_BIN (both
    signs) on ``x``, in nearest and bilinear mode, without and with
    ``fill=0.5``, and Color and Contrast on the 3-channel ``x3``, each
    held by :func:`hold_rand_augment`; then replay with
    ``reuse_param=True`` bit-equal for 4 seeds.  Returns the largest
    errors (nearest outside the ties, bilinear, photometric) and the tie
    counts of the nearest geometric cases."""
    import torch
    from advchain_tpu_torch.utils import MyRandAugment
    from advchain_tpu_torch.utils.rand_augment import GEOMETRIC_OPS
    worst = {"nearest": 0.0, "bilinear": 0.0, "photometric": 0.0}
    ties = {}
    refs = {}
    cases = [(x, op, mag, interp, fill)
             for op, mag in rand_augment_cases(tuple(x.shape[2:]))
             for interp in ("nearest", "bilinear") for fill in (None, 0.5)]
    for op in ("Color", "Contrast"):
        m = dict(rand_augment_cases(tuple(x.shape[2:])))[op]
        cases += [(x3, op, m, "nearest", None), (x3, op, -m, "nearest", None)]
    for img, op, mag, interp, fill in cases:
        geometric = op in GEOMETRIC_OPS
        # a photometric op ignores interp and fill: one CPU result each
        key = (img.shape[1], op, mag) + ((interp, fill) if geometric else ())
        refs[key], err, wrong, n_ties = hold_rand_augment(
            img, op, mag, interp, fill, refs.get(key))
        kind = interp if geometric else "photometric"
        worst[kind] = max(worst[kind], err)
        if geometric and interp == "nearest":
            ties[f"{op} {mag:+.4g} fill={fill}"] = (wrong, n_ties)
    for seed in range(4):
        aug = MyRandAugment(num_ops=2, magnitude=RA_BIN, seed=seed,
                            fill=0.5 if seed % 2 else None)
        first = aug(x)
        if not torch.equal(first, aug(x, reuse_param=True)):
            raise AssertionError(f"MyRandAugment replay is not bit-equal "
                                 f"(seed {seed}, {aug.op_sequence})")
    print(f"[rand-augment] {len(cases)} apply_op calls on {tuple(x.shape)} "
          f"and {tuple(x3.shape)} against the CPU: largest errors "
          f"{json.dumps(worst)}; nearest geometric cases (mismatched "
          f"pixels over the batch, tie pixels of one image): "
          f"{json.dumps(ties)}; replay bit-equal for 4 seeds", flush=True)
    return worst, ties


def time_rand_augment(device, x, warm=2, reps=RA_REPS):
    """Phase 28: ``reps`` calls of ``MyRandAugment(num_ops=2,
    magnitude=RA_BIN, seed=0)`` on ``x`` after ``warm``, each ending in a
    synchronize: the median seconds, the launches of the timed calls (one
    band grid forward per geometric op drawn, no backward, no fold), the
    ops drawn and the peak bytes; then each op's host time per call
    (:func:`wall_ms`) at bin RA_BIN, in both modes for the geometric
    ones."""
    import torch
    from advchain_tpu_torch.utils import MyRandAugment, apply_op
    from advchain_tpu_torch.utils.rand_augment import GEOMETRIC_OPS
    fold_modules = fold_callers()
    aug = MyRandAugment(num_ops=2, magnitude=RA_BIN, seed=0)
    for _ in range(warm):
        aug(x)
    sync(device)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, drawn = [], []
    with count_calls(fold_modules, FOLDS) as folds:
        for _ in range(reps):
            t0 = time.perf_counter()
            out = aug(x)
            sync(device)
            times.append(time.perf_counter() - t0)
            drawn.append(aug.op_sequence)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_geo = sum(op in GEOMETRIC_OPS for seq in drawn for op, _ in seq)
    flat = kernel_launches(launches)
    fwd = f"{KERNEL_NAMES['band_grid']}_fwd"
    if not (flat[fwd] == n_geo and n_geo > 0
            and not any(v for k, v in flat.items() if k != fwd)
            and not any(folds.values())
            and tuple(out.shape) == tuple(x.shape)
            and bool(torch.isfinite(out).all())):
        raise AssertionError(f"MyRandAugment launched {flat} for {n_geo} "
                             f"geometric ops (folds {folds})")
    op_ms = {}
    for op, mag in rand_augment_cases(tuple(x.shape[2:])):
        if mag < 0:
            continue
        for interp in (("nearest", "bilinear") if op in GEOMETRIC_OPS
                       else ("nearest",)):
            name = op if op not in GEOMETRIC_OPS else f"{op} {interp}"
            op_ms[name] = wall_ms(lambda: apply_op(x, op, mag, interp=interp))
    return {"median_s": statistics.median(times), "times": times,
            "launches": launches, "drawn": drawn, "n_geometric": n_geo,
            "peak": peak, "op_ms": op_ms}


def train_parts(device, batch, shape, seed):
    """(step, solver, state) of the headline adversarial train step with
    UNet_16 weights from ``seed`` and a fresh Adam; the solver's
    transforms draw on ``device``."""
    import torch
    from advchain_tpu_torch.parallel import (TrainState,
                                             make_adversarial_train_step)
    model = build_model(device, seed=seed)
    opt = torch.optim.Adam(model.module.parameters(), lr=LR)
    solver = build_solver(batch, shape)
    for t in solver.chain_of_transforms:
        t.device = device
    step = make_adversarial_train_step(model, solver, opt, n_iter=1,
                                       power_iteration="smart")
    return step, solver, TrainState.create(model, opt)


def tensors_of(tree, prefix=""):
    """{path: tensor} of every tensor in nested dicts and lists."""
    import torch
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else (
        enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    out = {}
    for k, v in items:
        out.update(tensors_of(v, f"{prefix}/{k}"))
    return out


def check_resume(device, batch, shape, directory):
    """Phase 29: one headline train step, then ``save_checkpoint`` of the
    TrainState with the step's generator state, and
    ``save_transform_state`` of its solver after
    ``init_random_transformation``; both files load with
    ``weights_only=True``; both restored into fresh objects (other
    weights, an empty Adam, another generator) on ``device``, every tensor
    bit-equal; then the next step from the restored state and from the
    original, every loss within TOL_RESUME relative.  Returns the step's
    losses, the relative gaps, the tensors compared and the save and
    restore seconds."""
    import torch
    from advchain_tpu_torch.utils import (restore_checkpoint,
                                          restore_transform_state,
                                          save_checkpoint,
                                          save_transform_state)
    data = {"image": torch.as_tensor(make_image(batch, shape),
                                     device=device),
            "label": torch.as_tensor(make_labels(batch, shape),
                                     device=device)}
    step, solver, state = train_parts(device, batch, shape, 0)
    gen = torch.Generator(device=device).manual_seed(1)
    state, _ = step(state, data, gen)
    solver.init_random_transformation()
    sync(device)
    t0 = time.perf_counter()
    ckpt = save_checkpoint(os.path.join(directory, "train_state.pt"),
                           {"state": state, "generator": gen.get_state()})
    tfile = save_transform_state(os.path.join(directory, "transforms.pt"),
                                 solver)
    save_s = time.perf_counter() - t0
    for path in (ckpt, tfile):
        torch.load(path, weights_only=True)
    step2, solver2, state2 = train_parts(device, batch, shape, 1)
    gen2 = torch.Generator(device=device).manual_seed(99)
    t0 = time.perf_counter()
    tree = restore_checkpoint(ckpt, target={"state": state2,
                                            "generator": gen2.get_state()})
    gen2.set_state(tree["generator"])
    restore_transform_state(tfile, solver2)
    sync(device)
    restore_s = time.perf_counter() - t0
    ours = tensors_of({"module": state.model.module.state_dict(),
                       "optimizer": state.optimizer.state_dict(),
                       "generator": gen.get_state(),
                       "episodes": state.model._episodes.get_state(),
                       "transforms": solver.get_transformation_parameters()})
    back = tensors_of({"module": state2.model.module.state_dict(),
                       "optimizer": state2.optimizer.state_dict(),
                       "generator": gen2.get_state(),
                       "episodes": state2.model._episodes.get_state(),
                       "transforms": solver2.get_transformation_parameters()})
    unequal = [k for k in ours if not (k in back
                                       and back[k].device == ours[k].device
                                       and torch.equal(back[k], ours[k]))]
    if (unequal or ours.keys() != back.keys() or state2.step != state.step
            or state2.model.episode_seed != state.model.episode_seed):
        raise AssertionError(f"the restored state differs: {unequal[:8]}")
    state, m1 = step(state, data, gen)
    state2, m2 = step2(state2, data, gen2)
    m1 = {k: float(v) for k, v in m1.items()}
    m2 = {k: float(v) for k, v in m2.items()}
    rel = {k: abs(m1[k] - m2[k]) / abs(m1[k]) for k in m1}
    print(f"[resume] {len(ours)} tensors bit-equal after restore (module, "
          f"Adam, generators, transforms); checkpoint "
          f"{os.path.getsize(ckpt) / 1e6:.2f} MB, save {save_s * 1e3:.1f} ms, "
          f"restore {restore_s * 1e3:.1f} ms; next step original {m1}, "
          f"resumed {m2}, relative {rel}", flush=True)
    if not (all(math.isfinite(v) for v in m1.values())
            and max(rel.values()) <= TOL_RESUME):
        raise AssertionError(f"the resumed step's losses differ: {rel}")
    return {"losses": m1, "relative": rel, "tensors": len(ours),
            "save_s": save_s, "restore_s": restore_s}


def check_checked(device, batch, shape):
    """Phase 29: ``checked`` passes a clean headline episode (a finite
    loss) and raises FloatingPointError on the same episode with one NaN
    pixel in its input."""
    import torch
    from advchain_tpu_torch.utils import checked
    solver = build_solver(batch, shape)
    model = build_model(device)
    data = torch.as_tensor(make_image(batch, shape), device=device)
    safe = checked(lambda x: episode_once(solver, model, x))
    t0 = time.perf_counter()
    loss = float(safe(data))
    clean_s = time.perf_counter() - t0
    bad = data.clone()
    bad[0, 0, 0, 0] = float("nan")
    raised = None
    try:
        safe(bad)
    except FloatingPointError as err:
        raised = str(err)
    print(f"[checked] clean episode loss {loss:.6e} in {clean_s:.2f} s "
          f"under the check; with one NaN pixel: {raised}", flush=True)
    if not (math.isfinite(loss) and raised is not None):
        raise AssertionError("checked did not pass the clean episode or "
                             "did not raise on the NaN")
    return clean_s


def time_episode_utils(device, batch, shape, directory):
    """Phase 29: one headline episode timed by ``Timer`` and by
    ``benchmark`` (2 warm-ups, 5 reps), and one traced by ``start_trace``
    / ``stop_trace`` inside a ``trace`` region: the Chrome trace must hold
    the region and, on the card, the band grid kernels.  Returns (Timer
    ms, benchmark stats, trace path)."""
    import torch
    from advchain_tpu_torch.utils import (Timer, benchmark, start_trace,
                                          stop_trace, trace)
    solver = build_solver(batch, shape)
    model = build_model(device)
    data = torch.as_tensor(make_image(batch, shape), device=device)

    def episode():
        return solver.adversarial_training(data=data, model=model, n_iter=1,
                                           power_iteration="smart",
                                           step_sizes=1.0)

    episode()
    with Timer() as t:
        t.sync(episode())
    stats = benchmark(episode, warmup=2, reps=5)
    start_trace(os.path.join(directory, "trace"))
    with trace("advchain_episode"):
        episode()
    sync(device)
    path = stop_trace()
    with open(path) as f:
        text = f.read()
    if not ("advchain_episode" in text
            and ("band_grid" in text or not data.is_cuda)):
        raise AssertionError(f"the trace {path} lacks the region or the "
                             f"band grid kernels")
    return t.ms, stats, path


def check_ops_gaps(device):
    """Phase 29: ``interpolate(mode="nearest")`` on the card against the
    CPU, bit-equal, 2D (N=128, 192x192 -> 100x100) and 3D (N=2,
    12x192x192 -> 7x100x100); ``depthwise_conv`` with a Gaussian kernel
    from ``gaussian_kernel_1d``, 2D (5x5, N=128, C=2) and 3D (3x5x5, N=2,
    C=3), within TOL_DEPTHWISE."""
    import torch
    from advchain_tpu_torch.ops import (depthwise_conv, gaussian_kernel_1d,
                                        interpolate)
    gen = torch.Generator().manual_seed(12)
    errs = {}
    for shape, size in (((BATCH, 1) + SHAPE, (100, 100)),
                        ((BATCH3D, 1) + SHAPE3D, (7, 100, 100))):
        x = torch.randn(shape, generator=gen)
        out = interpolate(x.to(device), size=size, mode="nearest")
        if not torch.equal(out.cpu(), interpolate(x, size=size,
                                                  mode="nearest")):
            raise AssertionError(f"nearest interpolate {shape} -> {size} "
                                 f"differs from the CPU")
    g5, g3 = gaussian_kernel_1d(5, 1.0), gaussian_kernel_1d(3, 0.8)
    for shape, k in (((BATCH, 2) + SHAPE, g5[:, None] * g5[None]),
                     ((BATCH3D, 3) + SHAPE3D,
                      g3[:, None, None] * g5[None, :, None] * g5[None, None])):
        x = torch.randn(shape, generator=gen)
        out = depthwise_conv(x.to(device), k.to(device)).cpu()
        errs[len(shape) - 2] = float((out - depthwise_conv(x, k)).abs().max())
    print(f"[ops] nearest interpolate 2D and 3D bit-equal to the CPU; "
          f"depthwise_conv largest error {errs}", flush=True)
    if max(errs.values()) > TOL_DEPTHWISE:
        raise AssertionError(f"depthwise_conv differs from the CPU: {errs}")
    return errs


# ------------------------------------------------------------- phases 30-32
DP_WORLD = 2                 # ranks sharing the one card, over gloo
DP_TURNS = 4                 # timed turns after one warm-up (phase 30)
TOL_DP_LOSS = {"total_loss": 1e-4, "supervised_loss": 1e-4,
               "consistency_loss": 1e-3}   # the JAX package's bounds
TOL_DP_RTOL, TOL_DP_ATOL = 1e-4, 1e-5      # running statistics
# phase 30's steps compared with the single-process step, besides the
# headline step: build_train_step's options
DP_COMPARED = {"supervised": {"supervised": True}, "no_pgd": {"n_iter": 0}}
DP_PERTURB = 1e-7            # the reference's input perturbation, relative
# the applied gradients' relative L2 gap, over the single-process step's
# own gap under that perturbation
TOL_DP_GRAD = 3.0
SS_DISP = {2: 0.05, 3: 0.08}  # the sampled warps' normalised displacement
SS_MAX_DISP = {2: 0.06, 3: 0.1}  # the static bound handed to the halo route
SS_REPS = 5                  # timed calls per case (phase 31)
TOL_SS = 1e-5                # of the dense call's max (phase 31)
RANK_TIMEOUT_S = 900.0


def _rank_entry(rank, fn, world, directory, device, args):
    """A spawned rank: one card means both ranks on cuda:0 (LOCAL_RANK 0);
    joins the gloo group through a file store, runs ``fn`` and saves its
    result."""
    import torch
    from advchain_tpu_torch.parallel import initialize_distributed
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cuda":
        os.environ["LOCAL_RANK"] = "0"
    initialize_distributed(init_method=f"file://{directory}/store",
                           world_size=world, rank=rank, backend="gloo")
    try:
        torch.save(fn(rank, world, device, *args),
                   os.path.join(directory, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(fn, world, device, *args, timeout=RANK_TIMEOUT_S,
                parent=None):
    """Every rank's ``fn(rank, world, device, *args)`` from ``world``
    spawned processes on one gloo group, which meets in a fresh temporary
    directory under ``parent`` (default: the checkout's ``build/``).  A
    failed rank stops the others and raises here; so does a run past
    ``timeout``."""
    import torch
    import torch.multiprocessing as mp
    if parent is None:
        parent = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "build")
    os.makedirs(parent, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=parent) as directory:
        ctx = mp.start_processes(_rank_entry,
                                 args=(fn, world, directory, device, args),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks ran past {timeout} s")
        return [torch.load(os.path.join(directory, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _weights(model):
    return {k: v.detach().cpu().clone()
            for k, v in model.module.state_dict().items()}


def _grads(model):
    """The gradients the last optimiser step applied (a data-parallel
    step's are summed over the ranks)."""
    return {k: p.grad.detach().cpu().clone()
            for k, p in model.module.named_parameters()}


def _step_record(state, metrics):
    from advchain_tpu_torch.ops.integrate import ADAPTIVE_STEPS
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "weights": _weights(state.model), "grads": _grads(state.model),
            # the 3D exponentiations' step counts since the last clear
            "adaptive_steps": list(ADAPTIVE_STEPS)}


def _single_steps(dev, batch, shape, sampler=False, **kw):
    """Rank 0's references for a compared step: the single-process step on
    the whole batch from the data-parallel step's weights and generator
    state, and the same on the image perturbed by ``DP_PERTURB`` relative;
    ``sampler``: with every composition on the sampler
    (``ops.integrate.sampler_compositions``, JAX's ``ADVCHAIN_STENCIL=0``).
    Returns their records and the first's (step, state, data,
    generator)."""
    import torch
    from advchain_tpu_torch.ops.integrate import (ADAPTIVE_STEPS,
                                                  sampler_compositions)
    recs, runs = {}, {}
    for key, pert in (("single", 0.0), ("perturbed", DP_PERTURB)):
        step, state, data = build_train_step(dev, batch, shape, **kw)
        ADAPTIVE_STEPS.clear()
        if pert:
            noise = torch.randn(data["image"].shape, device=dev,
                                generator=torch.Generator(
                                    device=dev).manual_seed(5))
            data["image"] = data["image"] * (1 + pert * noise)
        gen = torch.Generator(device=dev).manual_seed(1)
        with (sampler_compositions() if sampler
              else contextlib.nullcontext()):
            state, m = step(state, data, gen)
        recs[key] = _step_record(state, m)
        runs[key] = (step, state, data, gen)
    return recs, runs["single"]


def dp_train_rank(rank, world, device, batch, shape, turns):
    """Phase 30 on one rank: the supervised step, the headline step
    without its PGD step and the headline step, each data-parallel on
    this rank's rows from fresh weights, and on rank 0 its references
    (:func:`_single_steps`); then ``turns`` timed turns of the headline
    step (a data-parallel step, then the single-process step) after one
    warm-up.  The headline step's first data-parallel step is the counted
    one: launches, collectives and peak memory."""
    import torch
    import torch.distributed as dist
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.parallel import make_mesh, replicate_to_mesh
    from advchain_tpu_torch.parallel.mesh import mesh_device
    mesh = make_mesh(device_type=device)
    dev = mesh_device(mesh)
    out = {"compared": {}}
    for name, kw in DP_COMPARED.items():
        step, state, data = build_train_step(dev, batch, shape, mesh=mesh,
                                             **kw)
        gen = replicate_to_mesh(torch.Generator(device=dev).manual_seed(1),
                                mesh)
        state, m = step(state, data, gen)
        out["compared"][name] = _step_record(state, m)
        if rank == 0:
            out["compared"][name].update(
                _single_steps(dev, batch, shape, **kw)[0])
        del step, state, data
    step, state, data = build_train_step(dev, batch, shape, mesh=mesh)
    gen = replicate_to_mesh(torch.Generator(device=dev).manual_seed(1), mesh)
    out.update(rows=int(data["image"].shape[0]), device=str(dev),
               transport=collectives.transport(mesh.get_group("data"),
                                               dev.type))
    dist.barrier()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    collectives.reset_counts()
    state, m = step(state, data, gen)
    sync(dev)
    out["launches"] = launch_counts()
    out["collectives"] = dict(collectives.COUNTS)
    out["peak"] = (torch.cuda.max_memory_allocated()
                   if dev.type == "cuda" else 0)
    out["compared"]["headline"] = _step_record(state, m)
    single = None
    if rank == 0:
        recs, single = _single_steps(dev, batch, shape)
        out["compared"]["headline"].update(recs)
    dp_ms, single_ms = [], []
    for i in range(1 + turns):
        dist.barrier()
        t0 = time.perf_counter()
        state, _ = step(state, data, gen)
        sync(dev)
        dist.barrier()
        if i:
            dp_ms.append((time.perf_counter() - t0) * 1e3)
        if single is not None:
            s_step, s_state, s_data, s_gen = single
            t0 = time.perf_counter()
            s_state, _ = s_step(s_state, s_data, s_gen)
            sync(dev)
            if i:
                single_ms.append((time.perf_counter() - t0) * 1e3)
        dist.barrier()
    out["dp_ms"], out["single_ms"] = dp_ms, single_ms
    return out


def _rel_l2(grads, ref):
    """The relative L2 gap of a whole gradient."""
    import torch
    diff = torch.cat([(grads[k].double() - v.double()).flatten()
                      for k, v in ref.items()])
    full = torch.cat([v.double().flatten() for v in ref.values()])
    return float(diff.norm() / full.norm())


def _worst_leaf(grads, ref):
    """The leaf furthest from the per-leaf yardstick (1e-4 of the leaf's
    largest entry plus 1e-5 of the largest entry of any leaf: a
    convolution bias that feeds a BatchNorm has an exact gradient of 0 and
    a computed one of rounding size), and its gap over the yardstick."""
    scale = max(float(g.abs().max()) for g in ref.values())
    return max((float((grads[k].double() - v.double()).abs().max())
                / (1e-4 * float(v.abs().max()) + 1e-5 * scale), k)
               for k, v in ref.items())[::-1]


def _check_dp_step(recs, name, grad_rel_l2=0.0):
    """One compared step: every rank's metrics and weights equal; the
    losses within the JAX package's bounds of the single-process step's;
    the running statistics within rtol 1e-4 / atol 1e-5; the applied
    gradients' relative L2 gap within ``TOL_DP_GRAD`` times the
    single-process step's own gap under the input perturbation, or within
    ``grad_rel_l2`` where that is larger.  Returns the loss gaps, both
    relative L2 gaps and both worst leaves."""
    import torch
    ref = recs[0][name]
    for r, rec in enumerate(recs[1:], 1):
        if rec[name]["metrics"] != ref["metrics"]:
            raise AssertionError(f"{name}: rank {r}'s metrics "
                                 f"{rec[name]['metrics']} are not rank 0's "
                                 f"{ref['metrics']}")
        for k, v in ref["weights"].items():
            if not torch.equal(rec[name]["weights"][k], v):
                raise AssertionError(f"{name}: rank {r}'s {k} differs from "
                                     f"rank 0's")
    single = ref["single"]
    rel = {k: abs(ref["metrics"][k] - v) / abs(v)
           for k, v in single["metrics"].items()}
    if any(rel[k] > TOL_DP_LOSS[k] for k in rel):
        raise AssertionError(f"{name}: the data-parallel step's losses are "
                             f"not the single-process step's: gaps {rel}")
    for k, v in single["weights"].items():
        if "running" not in k:
            continue
        gap = (ref["weights"][k].double() - v.double()).abs()
        if bool((gap > TOL_DP_ATOL + TOL_DP_RTOL * v.double().abs()).any()):
            raise AssertionError(f"{name}: running statistic {k} off the "
                                 f"single-process step's by "
                                 f"{float(gap.max()):.3e}")
    dp = _rel_l2(ref["grads"], single["grads"])
    floor = _rel_l2(ref["perturbed"]["grads"], single["grads"])
    if dp > max(TOL_DP_GRAD * floor, grad_rel_l2):
        raise AssertionError(f"{name}: the parallel step's applied "
                             f"gradients are {dp:.3e} off the "
                             f"single-process step's (relative L2), more "
                             f"than {TOL_DP_GRAD}x its own {floor:.3e} under "
                             f"a {DP_PERTURB} input perturbation and more "
                             f"than {grad_rel_l2}")
    return {"losses": rel, "grad_rel_l2": dp, "perturbed_rel_l2": floor,
            "worst_leaf": _worst_leaf(ref["grads"], single["grads"]),
            "perturbed_worst_leaf": _worst_leaf(ref["perturbed"]["grads"],
                                                single["grads"])}


def check_dp_train(outs):
    """Phase 30's gates (:func:`_check_dp_step`) on each compared step."""
    recs = [o["compared"] for o in outs]
    return {name: _check_dp_step(recs, name) for name in recs[0]}


def _near_grid(n, shape, disp, seed, device):
    """A warp within ``disp`` (normalised) of the identity, clipped to
    [-1, 1] as the morph's grids are (samples exactly on the end planes),
    (N, *S, d)."""
    import torch
    from advchain_tpu_torch.ops.integrate import base_grid
    gen = torch.Generator().manual_seed(seed)
    base = torch.movedim(base_grid(n, shape), 1, -1)
    u = (torch.rand(base.shape, generator=gen) * 2 - 1) * disp
    return torch.clamp(base + u, -1.0, 1.0).to(device)


SS_CASES = [  # (dims, C, mode, padding, route)
    (dims, c, mode, pad, route)
    for dims, chans in ((3, (1, 3)), (2, (1,)))
    for c in chans
    for mode in ("bilinear", "nearest")
    for route in ("gather", "halo")
    for pad in (("zeros", "border") if route == "halo" and mode == "bilinear"
                else ("zeros",))
]


def ss_rank(rank, world, device, cases, shapes, reps):
    """Phase 31 on one rank: ``sharded_grid_sample`` over a (1, world)
    mesh at each case (``shapes[dims]`` = (N, spatial)), its local rows
    held against the dense call on the whole volume (forward; both
    gradients for bilinear), its launches counted on the first call (the
    dense calls are not counted), and timed."""
    import torch
    import torch.distributed as dist
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.ops.grid_sample import grid_sample
    from advchain_tpu_torch.parallel import (make_spatial_mesh,
                                             shard_volume,
                                             sharded_grid_sample)
    from advchain_tpu_torch.parallel.mesh import mesh_device
    mesh = make_spatial_mesh(1, world, device_type=device)
    dev = mesh_device(mesh)
    out = {}
    for dims, c, mode, pad, route in cases:
        n, sp = shapes[dims]
        gen = torch.Generator().manual_seed(11 * dims + c)
        x = torch.rand((n, c) + tuple(sp), generator=gen).to(dev)
        g = _near_grid(n, sp, SS_DISP[dims], 5 + dims, dev)
        d_loc = sp[0] // world
        rows = slice(rank * d_loc, (rank + 1) * d_loc)
        md = SS_MAX_DISP[dims] if route == "halo" else None
        grad = mode == "bilinear"
        xl = shard_volume(x, mesh).requires_grad_(grad)
        gl = g[:, rows].contiguous().requires_grad_(grad)
        ct = torch.rand(xl.shape[:2] + gl.shape[1:-1],
                        generator=gen).to(dev) - 0.5

        def call():
            y = sharded_grid_sample(xl, gl, mesh, mode=mode,
                                    padding_mode=pad, max_disp=md)
            if grad:
                dx, dg = torch.autograd.grad(y, (xl, gl), ct)
                return y, dx, dg
            return (y,)

        dist.barrier()
        reset_launch_counts()
        collectives.reset_counts()
        got = call()
        sync(dev)
        launches = launch_counts()
        # the halo route is the one that exchanges neighbour bands
        took = ("halo" if collectives.COUNTS["neighbour_exchange"]
                else "gather")
        # the dense call on the whole volume, on this rank
        xd = x.clone().requires_grad_(grad)
        gd = g.clone().requires_grad_(grad)
        yd = grid_sample(xd, gd, mode=mode, padding_mode=pad)
        want = [yd[:, :, rows]]
        if grad:
            ct_full = collectives.all_gather(ct, dim=2,
                                             group=mesh.get_group("space"))
            dx, dg = torch.autograd.grad(yd, (xd, gd), ct_full)
            want += [dx[:, :, rows], dg[:, rows]]
        errs = []
        for a, b in zip(got, want):
            scale = float(b.detach().abs().max())
            errs.append(float((a - b).detach().abs().max())
                        / max(scale, 1e-30))
        times = []
        for _ in range(reps):
            dist.barrier()
            t0 = time.perf_counter()
            call()
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        out[dims, c, mode, pad, route] = {
            "launches": launches, "route": took, "errs": errs,
            "ms": statistics.median(times), "times": times}
    return out


def check_ss(outs):
    """Phase 31's gates: the route each case asked for; forward and
    gradients within ``TOL_SS`` of the dense call's max, nearest exact."""
    for r, out in enumerate(outs):
        for (dims, c, mode, pad, route), rec in out.items():
            if rec["route"] != route:
                raise AssertionError(f"rank {r}: {dims}D C={c} {mode} {pad} "
                                     f"took the {rec['route']} route, not "
                                     f"{route}")
            tol = 0.0 if mode == "nearest" else TOL_SS
            if max(rec["errs"]) > tol:
                raise AssertionError(f"rank {r}: {dims}D C={c} {mode} {pad} "
                                     f"{route} off the dense call by "
                                     f"{rec['errs']} of its max")


def halo_gauss_rank(rank, world, device, fields, reps):
    """Phase 32 on one rank: ``halo_exchange`` (halo 4, the morph
    Gaussian's) and ``sharded_gaussian_smooth`` (sigma 1, kernel 5: the
    morph's) on each field shape, against slicing the padded tensor and
    the dense ``gaussian_smooth``; a field thinner than the halo is
    refused."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from advchain_tpu_torch.ops.conv import gaussian_smooth
    from advchain_tpu_torch.parallel import (halo_exchange,
                                             make_spatial_mesh,
                                             shard_volume,
                                             sharded_gaussian_smooth)
    from advchain_tpu_torch.parallel.mesh import mesh_device
    mesh = make_spatial_mesh(1, world, device_type=device)
    dev = mesh_device(mesh)
    out = {}
    for name, shape in fields.items():
        gen = torch.Generator().manual_seed(len(shape) + shape[2])
        x = (torch.rand(shape, generator=gen) * 2 - 1).to(dev)
        d_loc = shape[2] // world
        xl = shard_volume(x, mesh)
        if d_loc < 4:
            try:
                sharded_gaussian_smooth(xl, mesh)
            except AssertionError as e:
                out[name] = {"refused": str(e)}
                continue
            raise AssertionError(f"{name}: a shard of {d_loc} planes was "
                                 f"not refused")
        pads = [0, 0] * (x.dim() - 3) + [4, 4]
        xp = F.pad(x, pads)
        h = halo_exchange(xl, 4, 2, mesh)
        halo_ok = torch.equal(h, xp[:, :, rank * d_loc:
                                    rank * d_loc + d_loc + 8])
        ys = sharded_gaussian_smooth(xl, mesh)
        yd = gaussian_smooth(x)[:, :, rank * d_loc:(rank + 1) * d_loc]
        err = float((ys - yd).abs().max())
        times = {}
        for label, fn in (("halo", lambda: halo_exchange(xl, 4, 2, mesh)),
                          ("gauss", lambda: sharded_gaussian_smooth(xl,
                                                                    mesh))):
            ts = []
            for _ in range(reps):
                dist.barrier()
                t0 = time.perf_counter()
                fn()
                sync(dev)
                ts.append((time.perf_counter() - t0) * 1e3)
            times[label] = statistics.median(ts)
        out[name] = {"halo_equal": halo_ok, "gauss_err": err, "ms": times}
    return out


def check_halo_gauss(outs):
    """Phase 32's gates: the exchange equal to slicing the padded tensor,
    the smoothing within 1e-6 of the dense op."""
    for r, out in enumerate(outs):
        for name, rec in out.items():
            if "refused" in rec:
                continue
            if not rec["halo_equal"] or rec["gauss_err"] > 1e-6:
                raise AssertionError(f"rank {r}: {name}: {rec}")


def parallel_rank(rank, world, device, cfg):
    """Phases 30-32 in one pair of spawned ranks."""
    return {"dp": dp_train_rank(rank, world, device, cfg["batch"],
                                cfg["shape"], cfg["turns"]),
            "ss": ss_rank(rank, world, device, cfg["ss_cases"],
                          cfg["ss_shapes"], cfg["ss_reps"]),
            "hg": halo_gauss_rank(rank, world, device, cfg["fields"],
                                  cfg["hg_reps"])}


def parallel_config(batch=BATCH, shape=SHAPE, batch3d=None, shape3d=None,
                    turns=DP_TURNS, reps=SS_REPS):
    """Phases 30-32's sizes: the headline train step, the episodes'
    volumes for the sampler, the morph's fields for the Gaussian."""
    batch3d = BATCH3D if batch3d is None else batch3d
    shape3d = SHAPE3D if shape3d is None else shape3d
    vec2 = tuple(s // 16 for s in shape)
    vec3 = (max(shape3d[0] // 2, 2),) + tuple(s // 16 for s in shape3d[1:])
    return {"batch": batch, "shape": shape, "turns": turns,
            "ss_cases": SS_CASES, "ss_reps": reps,
            "ss_shapes": {2: (batch, shape), 3: (batch3d, shape3d)},
            "fields": {"2d_velocity": (batch, 2) + vec2,
                       "2d_field": (batch, 2) + tuple(shape),
                       "3d_field": (batch3d, 3) + tuple(shape3d),
                       "3d_velocity": (batch3d, 3) + vec3},
            "hg_reps": reps}


def run_parallel(device, cfg, world=DP_WORLD):
    """Phases 30-32: spawn the ranks, hold every gate."""
    outs = spawn_ranks(parallel_rank, world, device, cfg)
    dp = check_dp_train([o["dp"] for o in outs])
    check_ss([o["ss"] for o in outs])
    check_halo_gauss([o["hg"] for o in outs])
    return outs, dp


# ------------------------------------------------------------- phases 33-35
SPACE_TURNS = 2              # timed turns after one warm-up (phases 33-34)
SPACE_PEAK_GATE = 0.75       # phase 33: peak per rank over the single step's
# the applied gradients' relative L2 gap that passes whatever the
# perturbation floor (f32 reduction order over the ranks): just above the
# largest sound gaps, 7.2e-6 on the CPU (tests/test_torch_space_train.py,
# which holds 1e-4) and 3.9e-7 on the card (phase 35, whose perturbation
# floor is 1.2e-7)
TOL_SPACE_GRAD = 1e-5
# phase 35's planted faults, each a dropped space all-reduce that its gates
# must fail: the PGD step's sum of the replicated transform parameters'
# gradients, and the weight gradients' sum over 'space' (summed over 'data'
# alone)
PLANTED_FAULTS = ("pgd_space_sum", "weight_space_sum")
# the phases' ('data', 'space') meshes
SPACE_MESHES = {"space_1x2": (1, 2), "space_2x2": (2, 2),
                "volume_1x2": (1, 2)}


@contextlib.contextmanager
def planted_fault(name, mesh):
    """The space step with one of ``PLANTED_FAULTS`` planted."""
    import dataclasses
    import advchain_tpu_torch.parallel.train as train
    from advchain_tpu_torch.augmentor import \
        ComposeAdversarialTransformSolver as solver
    saved = solver._sum_replicated_grads, train._optimizer_step
    if name == "pgd_space_sum":
        solver._sum_replicated_grads = lambda self, grads, flags, space: grads
    else:
        data = mesh.get_group("data")
        train._optimizer_step = lambda opt, loss, dg=None: saved[1](
            opt, loss, dataclasses.replace(dg, group=data))
    try:
        yield
    finally:
        solver._sum_replicated_grads, train._optimizer_step = saved


def space_train_rank(rank, world, device, mesh_shape, batch, shape, turns):
    """Phases 33-35 on one rank: on a ``mesh_shape`` ('data', 'space')
    mesh, the supervised step (2D) and the headline step (or, for a 3-D
    ``shape``, the 3D volume step), each on this rank's rows and slab from
    fresh weights, and on rank 0 its references (:func:`_single_steps`,
    whose peak memory rank 0 records); then ``turns`` timed turns of the
    headline step (the space step, then the single-process step) after
    one warm-up.  The headline step's first space step is the counted
    one: launches, collectives, peak memory and the 3D step counts.  The
    3D step also runs once with each of ``PLANTED_FAULTS``."""
    import torch
    import torch.distributed as dist
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.ops.integrate import ADAPTIVE_STEPS
    from advchain_tpu_torch.parallel import (make_spatial_mesh,
                                             replicate_to_mesh)
    from advchain_tpu_torch.parallel.mesh import mesh_device
    mesh = make_spatial_mesh(*mesh_shape, device_type=device)
    dev = mesh_device(mesh)
    cuda = dev.type == "cuda"
    out = {"compared": {}}
    for name, kw in ({"supervised": {"supervised": True}}
                     if len(shape) == 2 else {}).items():
        step, state, data = build_train_step(dev, batch, shape, mesh=mesh,
                                             **kw)
        gen = replicate_to_mesh(torch.Generator(device=dev).manual_seed(1),
                                mesh)
        state, m = step(state, data, gen)
        out["compared"][name] = _step_record(state, m)
        if rank == 0:
            out["compared"][name].update(
                _single_steps(dev, batch, shape, **kw)[0])
        del step, state, data
    step, state, data = build_train_step(dev, batch, shape, mesh=mesh)
    gen = replicate_to_mesh(torch.Generator(device=dev).manual_seed(1), mesh)
    out.update(block=tuple(data["image"].shape), device=str(dev),
               transport=collectives.transport(mesh.get_group("space"),
                                               dev.type))
    dist.barrier()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    collectives.reset_counts()
    ADAPTIVE_STEPS.clear()
    state, m = step(state, data, gen)
    sync(dev)
    out["launches"] = launch_counts()
    out["collectives"] = dict(collectives.COUNTS)
    out["peak"] = torch.cuda.max_memory_allocated() if cuda else 0
    out["compared"]["headline"] = _step_record(state, m)
    single = None
    if rank == 0:
        # the default single-process step (stencil compositions): its peak,
        # its time in the turns, its gaps recorded; the gates hold the step
        # against the one with its compositions on the sampler
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        recs, single = _single_steps(dev, batch, shape)
        out["single_peak"] = torch.cuda.max_memory_allocated() if cuda else 0
        out["compared"]["headline"]["stencil"] = recs
        out["compared"]["headline"].update(
            _single_steps(dev, batch, shape, sampler=True)[0])
    if len(shape) == 3:
        out["planted"] = {}
        for fault in PLANTED_FAULTS:
            f_step, f_state, f_data = build_train_step(dev, batch, shape,
                                                       mesh=mesh)
            f_gen = replicate_to_mesh(
                torch.Generator(device=dev).manual_seed(1), mesh)
            with planted_fault(fault, mesh):
                f_state, f_m = f_step(f_state, f_data, f_gen)
            out["planted"][fault] = _step_record(f_state, f_m)
            del f_step, f_state, f_data
    space_ms, single_ms = [], []
    for i in range(1 + turns):
        dist.barrier()
        t0 = time.perf_counter()
        state, _ = step(state, data, gen)
        sync(dev)
        dist.barrier()
        if i:
            space_ms.append((time.perf_counter() - t0) * 1e3)
        if single is not None:
            s_step, s_state, s_data, s_gen = single
            t0 = time.perf_counter()
            s_state, _ = s_step(s_state, s_data, s_gen)
            sync(dev)
            if i:
                single_ms.append((time.perf_counter() - t0) * 1e3)
        dist.barrier()
    out["space_ms"], out["single_ms"] = space_ms, single_ms
    return out


def check_space_train(outs, peak_gate=None):
    """Phases 33-35's gates: phase 30's on each compared step
    (:func:`_check_dp_step`: ranks equal, losses at the JAX package's
    bounds, running statistics, applied gradients within 3x the
    perturbation floor, or within ``TOL_SPACE_GRAD``) against the
    single-process step with its
    compositions on the sampler, and the gaps to the default step's
    (stencil) recorded; every rank's step launched no stencil kernel and
    no dispatch predicate, and as many band grid and z-band grid kernels
    as the others; the 3D step counts the single-process step's; with
    ``peak_gate``, each rank's peak at most that share of the
    single-process step's; the gates fail each planted fault, whose gaps
    and failed gate are returned under ``planted``."""
    gaps = {name: _check_dp_step([o["compared"] for o in outs], name,
                                 TOL_SPACE_GRAD)
            for name in outs[0]["compared"]}
    head = outs[0]["compared"]["headline"]
    gaps["planted"] = {}
    for fault, rec in outs[0].get("planted", {}).items():
        gap = gaps["planted"][fault] = {
            "losses": {k: abs(rec["metrics"][k] - v) / abs(v)
                       for k, v in head["single"]["metrics"].items()},
            "grad_rel_l2": _rel_l2(rec["grads"], head["single"]["grads"])}
        try:
            _check_dp_step([{"planted": dict(o["planted"][fault],
                                             single=head["single"],
                                             perturbed=head["perturbed"])}
                            for o in outs], "planted", TOL_SPACE_GRAD)
        except AssertionError as e:
            gap["failed"] = str(e)
        else:
            raise AssertionError(f"the space step's gates passed the "
                                 f"planted fault {fault}: gaps {gap}")
    stencil = head["stencil"]["single"]
    gaps["headline"]["stencil_losses"] = {
        k: abs(head["metrics"][k] - v) / abs(v)
        for k, v in stencil["metrics"].items()}
    gaps["headline"]["stencil_grad_rel_l2"] = _rel_l2(head["grads"],
                                                      stencil["grads"])
    gaps["headline"]["stencil_perturbed_rel_l2"] = _rel_l2(
        head["stencil"]["perturbed"]["grads"], stencil["grads"])
    for r, o in enumerate(outs):
        lc = o["launches"]
        if lc["stencil"]["fwd"] or lc["stencil"]["bwd"] or \
                lc["slope"]["fwd"]:
            raise AssertionError(f"rank {r}'s space step launched the "
                                 f"stencil or the dispatch predicate: "
                                 f"stencil {lc['stencil']}, predicates "
                                 f"{lc['slope']['fwd']}")
        for fam in ("band_grid", "zband_grid"):
            if lc[fam] != outs[0]["launches"][fam]:
                raise AssertionError(f"rank {r} launched {fam} {lc[fam]}, "
                                     f"rank 0 {outs[0]['launches'][fam]}")
        steps = o["compared"]["headline"]["adaptive_steps"]
        want = outs[0]["compared"]["headline"]["single"]["adaptive_steps"]
        if steps != want:
            raise AssertionError(f"rank {r}'s 3D step counts {steps} are "
                                 f"not the single-process step's {want}")
        if peak_gate is not None and \
                o["peak"] > peak_gate * outs[0]["single_peak"]:
            raise AssertionError(
                f"rank {r}'s peak {o['peak'] / 1e9:.3f} GB is over "
                f"{peak_gate}x the single-process step's "
                f"{outs[0]['single_peak'] / 1e9:.3f} GB")
    return gaps


def space_rank(rank, world, device, cfg):
    """Phases 33 and 35 in one pair of spawned ranks, or phase 34 in four:
    each configured space step."""
    return {name: space_train_rank(rank, world, device, SPACE_MESHES[name],
                                   c["batch"], c["shape"], c["turns"])
            for name, c in cfg.items()
            if SPACE_MESHES[name][0] * SPACE_MESHES[name][1] == world}


def space_config(batch=BATCH, shape=SHAPE, batch3d=None, shape3d=None,
                 turns=SPACE_TURNS):
    """Phases 33-35's sizes: the headline train step on (1, 2) and (2, 2),
    the 3D volume step on (1, 2) (no timed turns)."""
    batch3d = BATCH3D if batch3d is None else batch3d
    shape3d = SHAPE3D if shape3d is None else shape3d
    return {"space_1x2": {"batch": batch, "shape": shape, "turns": turns},
            "volume_1x2": {"batch": batch3d, "shape": shape3d, "turns": 0},
            "space_2x2": {"batch": batch, "shape": shape, "turns": turns}}


def run_space(device, cfg, peak_gate=SPACE_PEAK_GATE):
    """Phases 33-35: spawn two ranks (33, 35), then four (34); hold every
    gate (phase 33's peak against ``peak_gate``).  Returns each phase's
    per-rank outputs and gaps."""
    pairs = spawn_ranks(space_rank, 2, device, cfg)
    fours = spawn_ranks(space_rank, 4, device, cfg)
    outs = {name: [o[name] for o in (fours if name == "space_2x2"
                                     else pairs)] for name in cfg}
    gaps = {name: check_space_train(
        outs[name], peak_gate if name == "space_1x2" else None)
        for name in cfg}
    return outs, gaps


# ------------------------------------------- phase 36: the block zoo
BLOCK_REPS = 5               # timed fwd + bwd calls per block (phase 36)
TOL_BLOCK = 1e-4             # outputs, of the CPU's largest entry
TOL_BLOCK_STATS = 1e-5       # written running statistics and spectral u
# gradients, relative L2 to the CPU's in float64: a ReLU input that f32
# rounding puts on the other side of 0 moves one pixel's share of the
# gradient, 1/sqrt(pixels) (1.3e-3 at 2 x 32 x 96x96, measured on the card
# for DomainPoolDown, whose CPU f32 gap is 3e-7); a wrong backward is O(1)
TOL_BLOCK_GRAD = 1e-2


def block_cases(n, shape, n3, shape3):
    """Phase 36's blocks, (name, factory, input shapes, int arguments), at
    UNet_16's level widths and resolutions: 16 channels at ``shape``, 32
    at half, 64 at a quarter, 128 at an eighth and a sixteenth, ``n``
    rows; the 3D ones at ``n3`` x ``shape3`` (8 -> 16 channels)."""
    from advchain_tpu_torch.models import blocks as b
    lv = [(n,) + tuple(s // 2 ** i for s in shape) for i in range(5)]

    def at(level, c):
        return lv[level][:1] + (c,) + lv[level][1:]
    vol = (n3, 8) + tuple(shape3)
    half3 = (n3, 16) + tuple(s // 2 for s in shape3)
    return [
        ("ConvDown", lambda: b.ConvDown(16, 32), [at(0, 16)], ()),
        ("ResConvDown_spectral", lambda: b.ResConvDown(32, 64,
                                                       spectral=True),
         [at(1, 32)], ()),
        ("ResConv_spectral", lambda: b.ResConv(64, 64, spectral=True),
         [at(2, 64)], ()),
        ("ResBilinearUp", lambda: b.ResBilinearUp(128, 128, 64),
         [at(4, 128), at(3, 128)], ()),
        ("ResConvUp_spectral", lambda: b.ResConvUp(64, 64, 32,
                                                   spectral=True),
         [at(3, 64), at(2, 64)], ()),
        ("SqeUp", lambda: b.SqeUp(32, 32, 16), [at(2, 32), at(1, 32)], ()),
        ("DilationConv", lambda: b.DilationConv(16, 16, dilation=2),
         [at(0, 16)], ()),
        ("OutConvRelu", lambda: b.OutConvRelu(16, 4), [at(0, 16)], ()),
        ("SELayer", lambda: b.SELayer(64), [at(2, 64)], ()),
        ("CSELayer", lambda: b.CSELayer(64), [at(2, 64)], ()),
        ("ChannelSELayer", lambda: b.ChannelSELayer(64), [at(2, 64)], ()),
        ("SpatialSELayer", lambda: b.SpatialSELayer(64), [at(2, 64)], ()),
        ("ChannelSpatialSELayer", lambda: b.ChannelSpatialSELayer(64),
         [at(2, 64)], ()),
        ("BatchInstanceNorm", lambda: b.BatchInstanceNorm(32), [at(1, 32)],
         ()),
        ("AdaptiveInstanceNorm", lambda: b.AdaptiveInstanceNorm(),
         [at(3, 128), (128,), (128,)], ()),
        ("AdaptiveBatchNorm", lambda: b.AdaptiveBatchNorm(),
         [at(3, 128), (128,), (128,)], ()),
        ("bilinear_additive_upsampling",
         lambda: _Fn(b.bilinear_additive_upsampling, 32), [at(4, 128)], ()),
        ("spatial_pyramid_pool",
         lambda: _Fn(b.spatial_pyramid_pool, (1, 2, 4)), [at(4, 128)], ()),
        ("DomainInConv", lambda: b.DomainInConv(1, 16, 3), [at(0, 1)], (1,)),
        ("DomainPoolDown", lambda: b.DomainPoolDown(16, 32, 3),
         [at(0, 16)], (2,)),
        ("DomainDoubleConv", lambda: b.DomainDoubleConv(32, 32, 2),
         [at(1, 32)], (0,)),
        ("DomainUp", lambda: b.DomainUp(32, 16, 16, 3),
         [at(1, 32), at(0, 16)], (1,)),
        ("UnetConv2", lambda: b.UnetConv2(32, 32), [at(1, 32)], ()),
        ("Conv2DBatchNorm", lambda: b.Conv2DBatchNorm(64, 64), [at(2, 64)],
         ()),
        ("Conv2DBatchNormRelu", lambda: b.Conv2DBatchNormRelu(128, 128),
         [at(3, 128)], ()),
        ("UnetConv3", lambda: b.UnetConv3(8, 16), [vol], ()),
        ("UnetUp3", lambda: b.UnetUp3(16, 8, 8, z_scale_factor=2),
         [vol, half3], ()),
    ]


class _Fn:
    """A function of ``models.blocks`` with its static argument, called
    as a block without parameters."""

    def __init__(self, fn, arg):
        self.fn, self.arg = fn, arg

    def __call__(self, x):
        return self.fn(x, self.arg)

    def modules(self):
        return []

    def named_parameters(self):
        return []

    def named_buffers(self):
        return []

    def train(self, mode=True):
        return self

    def eval(self):
        return self

    def to(self, device):
        return self

    def double(self):
        return self


def _seeded_block(make, seed=0):
    """A block on the CPU with seeded weights, running statistics away
    from (0, 1) and a BatchInstanceNorm gate in (0.2, 0.8)."""
    import torch
    torch.manual_seed(seed)
    block = make()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in block.named_buffers():
            if name.endswith("running_mean"):
                t.copy_(torch.rand(t.shape, generator=gen) - 0.5)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
        for name, p in block.named_parameters():
            if name.endswith("gate"):
                p.copy_(0.2 + 0.6 * torch.rand(p.shape, generator=gen))
    return block


def _block_inputs(shapes, seed=0):
    """The inputs of a block case (numpy draws): feature maps of unit
    scale, and for a forward's affine pair a weight (C,) about 1 then its
    bias about 0."""
    r = np.random.RandomState(seed)
    out = []
    for i, s in enumerate(shapes):
        a = r.randn(*s).astype(np.float32)
        if len(s) == 1:
            a = (1.0 + 0.3 * a) if i == 1 else 0.2 * a
        out.append(a)
    return out


def _block_pass(block, arrays, ints, device, ct=None, dtype=None,
                space=None):
    """One training forward of ``block`` on ``device`` (in ``dtype``, None
    for f32) with the statistics written back, and the backward of
    ``sum(out * ct)`` (``ct`` drawn if None): ((out, input gradients,
    parameter gradients, buffers) on the CPU, ct).  Inside a ``space``
    group the block takes this rank's slab of each feature map and ``ct``
    (the dense output's) its rows of the output, or a replicated output's
    share."""
    import torch
    from advchain_tpu_torch.models.unet import _StatsWriter
    block.train()
    for m in block.modules():
        if isinstance(m, _StatsWriter):
            m.write_back = True
    xs = [torch.as_tensor(a, device=device, dtype=dtype) for a in arrays]
    if space is not None:
        xs = [space.slab(x) if x.dim() > 1 else x for x in xs]
    xs = [x.clone().requires_grad_(True) for x in xs]
    y = block(*xs, *ints)
    if ct is None:
        ct = torch.as_tensor(np.random.RandomState(7).randn(
            *y.shape).astype(np.float32))
    ct_y = ct
    if space is not None:
        ct_y = ct / space.n if y.dim() == 2 \
            else space.take(ct, space.level(y))
    (y * ct_y.to(device, y.dtype)).sum().backward()
    return (y.detach().cpu(), [x.grad.cpu() for x in xs],
            {k: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
             for k, p in block.named_parameters()},
            {k: v.detach().cpu().clone() for k, v in block.named_buffers()
             if not k.endswith("num_batches_tracked")}), ct


def _gap(a, b):
    """|a - b|'s largest entry over b's largest, and their relative L2
    gap."""
    a, b = a.double().flatten(), b.double().flatten()
    scale = max(float(b.abs().max()), 1e-30)
    return (float((a - b).abs().max()) / scale,
            float((a - b).norm()) / max(float(b.norm()), 1e-30))


def check_blocks(device, n=2, shape=SHAPE, n3=BATCH3D, shape3=SHAPE3D):
    """Phase 36: every block of ``models/blocks.py`` on ``device`` against
    the same block on the CPU (the same weights and inputs): a training
    forward with the running statistics and spectral ``u`` / ``sigma``
    written back and the backward of ``sum(out * ct)``, then an eval
    forward.  The outputs within TOL_BLOCK of the CPU's largest entry, the
    written statistics within TOL_BLOCK_STATS; the input and parameter
    gradients (all leaves together) within TOL_BLOCK_GRAD relative L2 of
    the CPU's in float64 (the CPU's own f32 gap beside them).  Returns
    each block's gaps."""
    import copy
    import torch
    errs = {}
    for name, make, shapes, ints in block_cases(n, shape, n3, shape3):
        cpu = _seeded_block(make)
        card = copy.deepcopy(cpu).to(device)
        f64 = copy.deepcopy(cpu).double()
        arrays = _block_inputs(shapes)
        (y_c, dx_c, dp_c, buf_c), ct = _block_pass(cpu, arrays, ints, "cpu")
        (y_d, dx_d, dp_d, buf_d), _ = _block_pass(card, arrays, ints, device,
                                                  ct)
        (_, dx_r, dp_r, _), _ = _block_pass(f64, arrays, ints, "cpu", ct,
                                            torch.float64)
        cpu.eval()
        card.eval()
        with torch.no_grad():
            e_c = cpu(*[torch.as_tensor(a) for a in arrays], *ints)
            e_d = card(*[torch.as_tensor(a, device=device) for a in arrays],
                       *ints).cpu()
        rec = {"train": _gap(y_d, y_c)[0], "eval": _gap(e_d, e_c)[0]}
        if buf_c:
            rec["stats"] = max(_gap(buf_d[k], v)[0]
                               for k, v in buf_c.items())
        bad = {k: v for k, v in rec.items()
               if v > (TOL_BLOCK_STATS if k == "stats" else TOL_BLOCK)}
        grads = {"d_inputs": (dx_d, dx_c, dx_r)}
        if dp_c:
            grads["d_params"] = tuple(
                [torch.cat([g[k].flatten() for k in dp_c])]
                for g in (dp_d, dp_c, dp_r))
        for key, (ours, cpu32, ref) in grads.items():
            rec[key] = max(_gap(a, b)[1] for a, b in zip(ours, ref))
            rec[key + "_cpu_f32"] = max(_gap(a, b)[1]
                                        for a, b in zip(cpu32, ref))
            if rec[key] > TOL_BLOCK_GRAD:
                bad[key] = rec[key]
        errs[name] = rec
        if bad:
            raise AssertionError(f"block {name} on {device} disagrees with "
                                 f"the CPU: {bad} (all gaps {rec})")
    return errs


def time_blocks(device, n=BATCH, shape=SHAPE, n3=BATCH3D, shape3=SHAPE3D,
                warm=2, reps=BLOCK_REPS):
    """Phase 36: each block's training forward and backward at ``n`` rows
    (the 3D ones at ``n3``, the 3D episode's batch), the median ms of
    ``reps`` calls after ``warm``, each ending in a synchronize, and the
    peak memory of the calls."""
    import torch
    out = {}
    for name, make, shapes, ints in block_cases(n, shape, n3, shape3):
        block = _seeded_block(make).to(device)
        xs = [torch.as_tensor(a, device=device).requires_grad_(True)
              for a in _block_inputs(shapes)]
        block.train()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(warm + reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            block(*xs, *ints).square().mean().backward()
            torch.cuda.synchronize()
            if i >= warm:
                times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"ms": statistics.median(times),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "rows": shapes[0][0]}
        del block, xs
        torch.cuda.empty_cache()
    return out


# ------------------------------------------- phase 37: the space zoo
SPACE_ZOO_NETS = ("unet_attention", "unetv2", "deeply_supervised")
SPACE_ZOO_TURNS = 2          # timed turns after the counted step (37)


def space_zoo_rank(rank, world, device, batch, shape, turns,
                   nets=SPACE_ZOO_NETS):
    """Phases 37 and 39 on one rank of a (1, ``world``) mesh: for each of
    ``nets`` (:func:`zoo_net`'s, or ``"unet"``: UNet_16) the headline
    train step on this rank's slab from fresh weights (the counted step:
    launches, collectives, peak, each top-level module's output rows), on
    rank 0 its references (the single-process step with sampler
    compositions, and on the perturbed image; their peak), then ``turns``
    timed turns of the space step and the single-process step (the
    counted step and the references were their warm-ups)."""
    import torch
    import torch.distributed as dist
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.parallel import (make_spatial_mesh,
                                             replicate_to_mesh)
    from advchain_tpu_torch.parallel.mesh import mesh_device
    mesh = make_spatial_mesh(1, world, device_type=device)
    dev = mesh_device(mesh)
    cuda = dev.type == "cuda"
    out = {k: {} for k in ("compared", "launches", "collectives", "peak",
                           "single_peak", "space_ms", "single_ms", "rows")}
    out["device"] = str(dev)
    for net in nets:
        kind = None if net == "unet" else net
        step, state, data = build_train_step(dev, batch, shape, mesh=mesh,
                                             net=kind)
        gen = replicate_to_mesh(torch.Generator(device=dev).manual_seed(1),
                                mesh)
        rows = out["rows"][net] = {}

        def record(name):
            def hook(module, inputs, output):
                y = output[0] if isinstance(output, tuple) else output
                rows[name] = y.shape[2]
            return hook

        hooks = [m.register_forward_hook(record(name)) for name, m in
                 state.model.module.named_children()]
        dist.barrier()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        collectives.reset_counts()
        state, m = step(state, data, gen)
        sync(dev)
        for h in hooks:
            h.remove()
        out["launches"][net] = launch_counts()
        out["collectives"][net] = dict(collectives.COUNTS)
        out["peak"][net] = torch.cuda.max_memory_allocated() if cuda else 0
        out["compared"][net] = _step_record(state, m)
        single = None
        if rank == 0:
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            recs, single = _single_steps(dev, batch, shape, sampler=True,
                                         net=kind)
            out["single_peak"][net] = (torch.cuda.max_memory_allocated()
                                       if cuda else 0)
            out["compared"][net].update(recs)
        space_ms, single_ms = [], []
        for _ in range(turns):
            dist.barrier()
            t0 = time.perf_counter()
            state, _ = step(state, data, gen)
            sync(dev)
            dist.barrier()
            space_ms.append((time.perf_counter() - t0) * 1e3)
            if single is not None:
                s_step, s_state, s_data, s_gen = single
                t0 = time.perf_counter()
                s_state, _ = s_step(s_state, s_data, s_gen)
                sync(dev)
                single_ms.append((time.perf_counter() - t0) * 1e3)
            dist.barrier()
        out["space_ms"][net], out["single_ms"][net] = space_ms, single_ms
        del step, state, data, single
        if cuda:
            torch.cuda.empty_cache()
    return out


def check_space_zoo(outs, grid_launches, nets=SPACE_ZOO_NETS,
                    plain="unetv2"):
    """Phases 37 and 39's gates for each of ``nets``: phase 33's step
    gates (:func:`_check_dp_step` against the single-process step with
    sampler compositions, gradients within 3x the perturbation floor or
    TOL_SPACE_GRAD); every rank's band grid launches equal to
    ``grid_launches`` (phase 33's), no stencil launch and no dispatch
    predicate; the attention UNet's step ran more all-gathers than
    ``plain``'s on the same chain (its keys and values).  Returns the gaps
    and each rank's all-gathers of the attention a step."""
    recs = [o["compared"] for o in outs]
    gaps = {net: _check_dp_step(recs, net, TOL_SPACE_GRAD) for net in nets}
    gaps["attention_gathers"] = []
    for r, o in enumerate(outs):
        for net in nets:
            lc = o["launches"][net]
            if lc["band_grid"] != grid_launches:
                raise AssertionError(
                    f"rank {r}'s {net} space step launched band_grid "
                    f"{lc['band_grid']}, not phase 33's {grid_launches}")
            if lc["stencil"]["fwd"] or lc["stencil"]["bwd"] or \
                    lc["slope"]["fwd"]:
                raise AssertionError(
                    f"rank {r}'s {net} space step launched the stencil or "
                    f"the dispatch predicate: {lc['stencil']}, "
                    f"{lc['slope']}")
        extra = (o["collectives"]["unet_attention"]["all_gather"]
                 - o["collectives"][plain]["all_gather"])
        if extra <= 0:
            raise AssertionError(f"rank {r}: the attention UNet's step ran "
                                 f"no all-gather of its keys and values")
        gaps["attention_gathers"].append(extra)
    return gaps


def run_space_zoo(device, grid_launches, batch=BATCH, shape=SHAPE,
                  turns=SPACE_ZOO_TURNS):
    """Phase 37: spawn two ranks on a (1, 2) mesh and hold every gate."""
    outs = spawn_ranks(space_zoo_rank, 2, device, batch, shape, turns)
    return outs, check_space_zoo(outs, grid_launches)


# ------------------------------------------- phase 39: uneven levels
LEVELS_MESH = (1, 4)         # phase 39's ('data', 'space') mesh
LEVELS_SHAPE = (224, 224)    # 56 rows a rank: the bottom level (4, 3, 4, 3)
LEVELS_NETS = ("unet", "unet_attention")
LEVELS_TURNS = 1             # timed turns after the counted step (39)


def run_space_levels(device, grid_launches, batch=BATCH, shape=LEVELS_SHAPE,
                     turns=LEVELS_TURNS):
    """Phase 39: spawn four ranks on a (1, 4) mesh, run the headline step
    with UNet_16 and with the attention UNet, and hold phase 33's gates
    and launch counts; every rank's modules' rows add up to the dense
    network's."""
    world = LEVELS_MESH[0] * LEVELS_MESH[1]
    outs = spawn_ranks(space_zoo_rank, world, device, batch, shape, turns,
                       LEVELS_NETS)
    gaps = check_space_zoo(outs, grid_launches, LEVELS_NETS, plain="unet")
    for net in LEVELS_NETS:
        heights = {k: sum(o["rows"][net][k] for o in outs)
                   for k in outs[0]["rows"][net]}
        if heights["inc"] != shape[0] or heights["outc"] != shape[0] or \
                heights["down4"] != shape[0] // 16:
            raise AssertionError(f"{net}: the ranks' rows do not add up to "
                                 f"the levels' heights: {heights}")
    return outs, gaps


# ------------------------------------------- phase 40: the space blocks
def space_blocks_rank(rank, world, device, n, shape, n3, shape3):
    """Phase 40 on one rank of a (1, ``world``) mesh: each block of
    :func:`block_cases` twice from the same seeded weights, the dense
    block on the whole input and the block inside the mesh's space group
    on this rank's slab (the dense output's cotangent, this rank's rows of
    it, or a replicated output's share); returns its gaps: its output rows
    and written statistics over the dense ones' largest entry, and the
    relative L2 gaps of the input gradients (over every rank's rows) and
    of the parameter gradients (summed over the ranks, all leaves
    together); and the kernel launches of the slab passes."""
    import copy
    import torch
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.parallel import make_spatial_mesh
    from advchain_tpu_torch.parallel.mesh import (every_rank_group,
                                                  mesh_device)
    mesh = make_spatial_mesh(1, world, device_type=device)
    dev = mesh_device(mesh)
    group = mesh.get_group("space")
    space = collectives.SpaceGroup(group, world,
                                   mesh.get_local_rank("space"), mesh)

    def summed(t):
        return collectives.all_reduce(t.double(), group=group)

    out, launches = {}, {}
    for name, make, shapes, ints in block_cases(n, shape, n3, shape3):
        cpu = _seeded_block(make)
        dense, slab = copy.deepcopy(cpu).to(dev), cpu.to(dev)
        arrays = _block_inputs(shapes)
        (y_d, dx_d, dp_d, buf_d), ct = _block_pass(dense, arrays, ints, dev)
        del dense
        reset_launch_counts()
        with collectives.data_group(mesh.get_group("data"), shapes[0][0],
                                    space=space,
                                    reduce_group=every_rank_group(mesh)):
            sg = collectives.current_space()
            (y, dx, dp, buf), _ = _block_pass(slab, arrays, ints, dev, ct,
                                              space=sg)
            scale = max(float(y_d[y_d.isfinite()].abs().max()), 1e-30)
            if y.dim() > 2:
                y_d = sg.take(y_d, sg.level(y))
        sync(dev)
        launches[name] = kernel_launches(launch_counts())
        # equal entries count 0 (a pyramid bin all padding is -inf on both
        # sides), a NaN counts as infinitely far
        diff = torch.where(y == y_d, torch.zeros_like(y),
                           (y - y_d).abs()).nan_to_num(nan=math.inf)
        rec = {"out": float(collectives.all_reduce(
            diff.max()[None], "max", group)[0]) / scale}
        if buf_d:
            rec["stats"] = max(float((buf[k] - v).abs().max())
                               / max(float(v.abs().max()), 1e-30)
                               for k, v in buf_d.items())
        gaps = []
        for g, g_d in zip(dx, dx_d):
            if g_d.dim() > 1:  # a feature map: this rank's rows of it
                g_d = space.slab(g_d)
                diff = summed((g - g_d).double().square().sum()[None])
                norm = summed(g_d.double().square().sum()[None])
            else:  # an affine vector: each rank's part of its gradient
                diff = (summed(g) - g_d.double()).square().sum()[None]
                norm = g_d.double().square().sum()[None]
            gaps.append(float((diff / norm).sqrt()[0]))
        rec["d_inputs"] = max(gaps)
        if dp_d:
            ours = summed(torch.cat([dp[k].flatten() for k in dp_d]))
            ref = torch.cat([v.flatten() for v in dp_d.values()]).double()
            rec["d_params"] = float((ours - ref).norm() / ref.norm())
        out[name] = rec
        del slab, y, y_d, dx, dx_d
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"gaps": out, "launches": launches}


def check_space_blocks(outs):
    """Phase 40's gates, phase 36's: every rank's output rows within
    TOL_BLOCK of the dense block's largest entry, its written statistics
    within TOL_BLOCK_STATS, the input and parameter gradients within
    TOL_BLOCK_GRAD relative L2; no kernel launched.  Returns the gaps,
    the worst rank's of each."""
    gaps = {}
    for name in outs[0]["gaps"]:
        rec = {k: max(o["gaps"][name][k] for o in outs)
               for k in outs[0]["gaps"][name]}
        bad = {k: v for k, v in rec.items()
               if v > {"out": TOL_BLOCK, "stats": TOL_BLOCK_STATS}.get(
                   k, TOL_BLOCK_GRAD)}
        if bad:
            raise AssertionError(f"block {name} inside a space group "
                                 f"disagrees with the dense block: {bad} "
                                 f"(all gaps {rec})")
        for r, o in enumerate(outs):
            if any(o["launches"][name].values()):
                raise AssertionError(f"block {name} launched a kernel on "
                                     f"rank {r}: {o['launches'][name]}")
        gaps[name] = rec
    return gaps


def run_space_blocks(device, n=BATCH, shape=SHAPE, n3=BATCH3D,
                     shape3=SHAPE3D):
    """Phase 40: spawn two ranks on a (1, 2) mesh and hold its gates."""
    outs = spawn_ranks(space_blocks_rank, 2, device, n, shape, n3, shape3)
    return outs, check_space_blocks(outs)


# ------------------------------------------- phase 38: stencil_warp_3d
def stencil3d_grid(n, shape, device, seed=0):
    """A grid (N, D, H, W, 3) within 0.9 voxel of the identity, its entries
    at both ends of every axis exactly on -1 and +1."""
    import torch
    from advchain_tpu_torch.ops.integrate import base_grid
    base = base_grid(n, shape, device=device)
    scale = torch.tensor([2.0 / (s - 1) for s in shape[::-1]],
                         device=device).view(1, 3, 1, 1, 1)
    gen = torch.Generator(device=device).manual_seed(seed)
    grid = (base + 0.9 * scale * (2 * torch.rand(
        base.shape, generator=gen, device=device) - 1)).clamp(-1, 1)
    grid[:, 0, :, :, 0], grid[:, 0, :, :, -1] = -1.0, 1.0
    grid[:, 1, :, 0], grid[:, 1, :, -1] = -1.0, 1.0
    grid[:, 2, 0], grid[:, 2, -1] = -1.0, 1.0
    return grid.movedim(1, -1).contiguous()


def check_stencil_warp_3d(device, n=BATCH3D, shape=SHAPE3D,
                          channels=(1, 3)):
    """Phase 38: ``ops.stencil_warp_3d`` on ``device`` against the z-band
    grid pair's plain versions (``edge`` padding) on the same tensors and
    against the CPU, at C in ``channels``, both grid layouts, on
    :func:`stencil3d_grid`: the forward within TOL_GRID_FWD of the largest
    entry, ``d_img`` within TOL_DIMG_REL, ``d_grid`` within TOL_DFLOW_REL;
    exactly one forward launch of the pair per call, and one backward
    launch under a gradient, none without.  Returns the worst gaps, the
    launches of one call, and the ms of a forward and of a forward and
    backward."""
    import torch
    from advchain_tpu_torch.kernels import zband_sample as zs
    from advchain_tpu_torch.ops import stencil_warp_3d
    worst = {"fwd": 0.0, "d_img": 0.0, "d_grid": 0.0}
    for c in channels:
        gen = torch.Generator(device=device).manual_seed(c)
        img = torch.randn((n, c) + tuple(shape), generator=gen,
                          device=device)
        grid = stencil3d_grid(n, shape, device, seed=c)
        ct = torch.randn(img.shape, generator=gen, device=device)
        flat = grid.reshape(n, -1, 3)
        plain = (zs.zband_grid_sample_fwd_plain(img, flat, "edge", True,
                                                "bilinear"),
                 *zs.zband_grid_sample_bwd_plain(ct.reshape(n, c, -1), img,
                                                 flat, "edge", True,
                                                 "bilinear"))
        plain = tuple(t.cpu() for t in plain)
        for layout in ("last", "first"):
            g_in = grid if layout == "last" else grid.movedim(-1, 1)
            outs = {}
            for dev in (device, "cpu"):
                a = img.detach().to(dev).requires_grad_(True)
                g = g_in.detach().to(dev).requires_grad_(True)
                reset_launch_counts()
                y = stencil_warp_3d(a, g, 1, layout)
                (y * ct.to(dev)).sum().backward()
                sync(device)
                if dev == device:
                    call = launch_counts()["zband_grid"]
                    if call != {"fwd": 1, "bwd": 1}:
                        raise AssertionError(
                            f"stencil_warp_3d launched {call}, not one "
                            f"z-band grid forward and one backward")
                d_grid = g.grad if layout == "last" else g.grad.movedim(1,
                                                                        -1)
                outs[dev] = (y.detach().reshape(n, c, -1).cpu(),
                             a.grad.cpu(), d_grid.reshape(n, -1, 3).cpu())
            for ref in (plain, outs["cpu"]):
                for key, got, want in zip(worst, outs[device], ref):
                    worst[key] = max(worst[key], _gap(got, want)[0])
    tol = {"fwd": TOL_GRID_FWD, "d_img": TOL_DIMG_REL,
           "d_grid": TOL_DFLOW_REL}
    if any(worst[k] > tol[k] for k in worst):
        raise AssertionError(f"stencil_warp_3d disagrees with its plain "
                             f"versions or the CPU: {worst} (bounds {tol})")
    reset_launch_counts()
    with torch.no_grad():
        stencil_warp_3d(img, grid, 1)
    sync(device)
    if launch_counts()["zband_grid"] != {"fwd": 1, "bwd": 0}:
        raise AssertionError(f"stencil_warp_3d without a gradient launched "
                             f"{launch_counts()['zband_grid']}")
    a = img.detach().requires_grad_(True)
    g = grid.detach().requires_grad_(True)
    ms = {"fwd_ms": time_ms(lambda: stencil_warp_3d(img, grid, 1)),
          "fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
              stencil_warp_3d(a, g, 1), (a, g), ct))}
    return worst, call, ms


# --------------------------------------------------------------- phase 41
def wgrad_inputs(shape, device, seed=0):
    """x (N, Cin, D, H, W) and dy (N, Cout, D, H, W), normal, f32."""
    import torch
    n, cin, cout, *vol = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, cin, *vol), generator=gen, device=device)
    dy = torch.randn((n, cout, *vol), generator=gen, device=device)
    return x, dy


def check_conv3d_wgrad(device, cases=None):
    """Phase 41's gates: each case's kernel ``(dW, db)`` against the plain
    twin in float64 on the same inputs, as the largest gap over the
    largest float64 entry, no larger than cuDNN's ``conv3d_weight``
    (f32, TF32 off) at the 3D cell's shapes and within TOL_DW elsewhere
    (where both are a few ulps of short sums), and the same bits over two
    runs.  Returns {case: {"dw": gap, "db": gap, "cudnn_dw": gap}}."""
    import torch
    from advchain_tpu_torch.kernels import conv3d_wgrad as cw
    cases = cases or {**WGRAD_SHAPES, **WGRAD_RAGGED}
    out = {}
    for name, shape in cases.items():
        x, dy = wgrad_inputs(shape, device, seed=len(out))
        dw, db = cw.conv3d_wgrad(x, dy)
        dw2, db2 = cw.conv3d_wgrad(x, dy)
        ref_w, ref_b = cw.conv3d_wgrad_plain(x.double(), dy.double())
        lib = torch.nn.grad.conv3d_weight(x, tuple(ref_w.shape), dy,
                                          padding=1)
        sync(device)
        scale_w = float(ref_w.abs().max())
        gaps = {"dw": float((dw.double() - ref_w).abs().max()) / scale_w,
                "db": float((db.double() - ref_b).abs().max())
                / float(ref_b.abs().max()),
                "cudnn_dw": float((lib.double() - ref_w).abs().max())
                / scale_w}
        if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
            raise AssertionError(f"conv3d_wgrad {name} {shape}: two runs "
                                 f"differ")
        cap = gaps["cudnn_dw"] if name in WGRAD_SHAPES else TOL_DW
        if gaps["dw"] > cap or gaps["db"] > TOL_DW:
            raise AssertionError(f"conv3d_wgrad {name} {shape}: gaps "
                                 f"{gaps} against float64 (dW cap {cap})")
        out[name] = gaps
    return out


def count_wgrad_launches(device, batch=BATCH3D, shape=SHAPE3D,
                         shape_unet3d=SHAPE3D_UNET3D):
    """The Conv3d weight gradient's launches in one 3D adversarial train
    step and in one 3D episode (each after a warm one, from counts set to
    0 just before it), with PseudoConv3dModel at ``shape`` and with UNet3D
    at ``shape_unet3d``, asserted against WGRAD_LAUNCHES."""
    import torch
    got = {}
    for net, suffix, vol in ((None, "", shape),
                             ("unet3d", "_unet3d", shape_unet3d)):
        step, state, data = build_train_step(device, batch, vol, net=net)
        gen = torch.Generator(device=device).manual_seed(1)
        state, _ = step(state, data, gen)
        sync(device)
        reset_launch_counts()
        state, _ = step(state, data, gen)
        sync(device)
        got["train3d" + suffix] = launch_counts()["wgrad"]["bwd"]
        solver = build_solver(batch, vol)
        model = build_model(device, dims=3, net=net)
        image = data["image"]
        episode_once(solver, model, image, POWER_ITERATION[3])
        sync(device)
        reset_launch_counts()
        episode_once(solver, model, image, POWER_ITERATION[3])
        sync(device)
        got["episode3d" + suffix] = launch_counts()["wgrad"]["bwd"]
        del step, state, data, solver, model
    if got != WGRAD_LAUNCHES:
        raise AssertionError(f"conv3d_wgrad launched {got}, not "
                             f"{WGRAD_LAUNCHES}")
    return got


def time_conv3d_wgrad(device):
    """Phase 41's timings at WGRAD_SHAPES' layers: the kernel pair, its
    bound (x and dy read once, dW and db written once; the products' FMAs
    and the bias's adds), the twin on the card, and cuDNN's
    ``conv3d_weight`` (the weight gradient alone), the library
    yardstick the port no longer calls there."""
    import torch
    from advchain_tpu_torch.kernels import conv3d_wgrad as cw
    rows = []
    for name, shape in WGRAD_SHAPES.items():
        n, cin, cout, *vol = shape
        x, dy = wgrad_inputs(shape, device)
        voxels = n * math.prod(vol)
        nbytes = 4 * (x.numel() + dy.numel() + cout * cin * 27 + cout)
        flops = 2 * voxels * cin * cout * 27 + voxels * cout
        bound, by = bound_ms(nbytes, flops)
        rows.append({
            "layer": name, "shape": list(shape), "rows_per_warp":
            cw.rows_per_warp(n, cin, cout, *vol),
            "ms": time_ms(lambda: cw.conv3d_wgrad(x, dy)),
            "plain_ms": time_ms(lambda: cw.conv3d_wgrad_plain(x, dy),
                                iters=5),
            "library_ms": time_ms(lambda: torch.nn.grad.conv3d_weight(
                x, (cout, cin, 3, 3, 3), dy, padding=1), iters=5),
            "bound_ms": bound, "bound_by": by})
    return rows


def wgrad_record(launches, gaps, rows, shape_note):
    """The ``kernels`` line's entry of the Conv3d weight gradient, timed at
    the 3D cell's 8 -> 4 layer (``conv1``: the 1 -> 8 layer's row;
    ``unet3d_in``: UNet3D's 1 -> 32 layer's)."""
    head = next(r for r in rows if r["layer"] == "conv2")
    return {
        "name": KERNEL_NAMES["wgrad"], "route": "cuda",
        "source": KERNEL_SOURCES["wgrad"],
        "replaces": REPLACES["wgrad"]["bwd"],
        "launches": launches, "max_abs_err": max(
            max(g["dw"], g["db"]) for g in gaps.values()),
        "cudnn_err": {k: g["cudnn_dw"] for k, g in gaps.items()},
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "conv1": next(r for r in rows if r["layer"] == "conv1"),
        "unet3d_in": next(r for r in rows if r["layer"] == "unet3d_in"),
        "shape": f"{shape_note} Cin=8 Cout=4"}


def kernel_launches(launches):
    """Launches by kernel record name (the ``kernels`` line's names)."""
    out = {f"{KERNEL_NAMES[fam]}_{kind}": launches[fam][kind]
           for fam in ("band_grid", "zband_grid", "stencil", "corner",
                       "plane_grid")
           for kind in ("fwd", "bwd")}
    out[f"{KERNEL_NAMES['corner_tile']}_bwd"] = launches["corner_tile"]["bwd"]
    out[KERNEL_NAMES["slope"]] = launches["slope"]["fwd"]
    out[KERNEL_NAMES["wgrad"]] = launches["wgrad"]["bwd"]
    out[f"{KERNEL_NAMES['bn']}_bwd"] = launches["batch_norm"]["bwd"]
    return out


def sampler_launches(launches):
    """:func:`kernel_launches` but the BatchNorm pair's, which the model's
    precision decides (the bf16 compute mode keeps the library's): the
    kernels that the chain's sampling launches."""
    out = kernel_launches(launches)
    del out[f"{KERNEL_NAMES['bn']}_bwd"]
    return out


# --------------------------------------------------------------- phase 42
# the 2D training BatchNorm's backward pair: its launches in one headline
# adversarial train step (the PGD, supervised and consistency passes each
# take a backward through UNet_16's 18 layers; the clean pass takes none)
# and in one supervised step
BN_LAUNCHES = {"train": 54, "supervised": 18}
# the pair's kernels and the passes over an (N, C, H, W) tensor each must
# make: the sums read dy and x, then dx reads them again and writes dx
BN_KERNELS = {"batch_norm_grad_reduce_kernel": 2,
              "batch_norm_grad_input_kernel": 3}


def bn_gates():
    """``tests/batch_norm_gates.py``: the phase's gates and inputs, which
    the GPU tests share."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module("batch_norm_gates")


def assert_bn_launches(what, launches):
    """The pair's launches in a 2D train step, from counts set to 0 just
    before it, against BN_LAUNCHES."""
    got = launches["batch_norm"]["bwd"]
    if got != BN_LAUNCHES[what]:
        raise AssertionError(f"the {what} step launched the BatchNorm pair "
                             f"{got} times, not {BN_LAUNCHES[what]}")


def kernel_device_ms(fn, names, reps=10):
    """Mean device ms a launch of each kernel named in ``names``, each
    launched once a call, over ``reps`` calls of ``fn`` under the profiler
    (after one warm call, behind ``batch_norm_gates.lead_in``: a profile
    taken late in this process drops its earliest records)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync("cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bn_gates().lead_in()
        for _ in range(reps):
            fn()
        sync("cuda")
    out = {}
    for e in prof.key_averages():
        for name in names:
            if name in e.key and e.count:
                out[name] = e.self_device_time_total / 1e3 / e.count
                if e.count != reps:
                    raise AssertionError(f"the profiler recorded {e.count} "
                                         f"of {reps} launches of {name}")
    return out


def time_batch_norm(device, cases=("c16", "c256")):
    """Phase 42's timings at the widest and the narrowest of UNet_16's
    BatchNorm shapes: the pair's backward (CUDA events) and each of its
    kernels (the profiler), each against its byte bound (BN_KERNELS'
    passes, 5 in all); the twin on the card; cuDNN's backward alone
    (``library_ms``, what the pair replaces), with its forward
    (``library_fwd_bwd_ms``) and its forward alone (``library_fwd_ms``,
    the forward the port keeps).  The narrowest layer's 19 MB fit the 50
    MB L2: its repeated calls read warm."""
    import torch
    import torch.nn.functional as F
    from advchain_tpu_torch.kernels import batch_norm as bn
    gates = bn_gates()
    rows = []
    for name in cases:
        shape = gates.SHAPES[name]
        x, w, b, _, dy = gates.inputs(shape, device)
        mean, invstd = gates.saved_statistics(x, w, b)
        tensor_bytes = 4 * x.numel()
        row = {"layer": name, "shape": list(shape),
               "ms": time_ms(lambda: bn.batch_norm_bwd(x, dy, mean, invstd,
                                                       w)),
               "bound_ms": bound_ms(sum(BN_KERNELS.values()) * tensor_bytes,
                                    0)[0],
               "plain_ms": time_ms(lambda: bn.batch_norm_bwd_plain(
                   x, dy, mean, invstd, w), iters=5),
               "library_fwd_ms": time_ms(lambda: F.batch_norm(
                   x, None, None, w, b, training=True, eps=gates.EPS))}
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        lib = library_bwd_ms(
            lambda: F.batch_norm(leaves[0], None, None, leaves[1],
                                 leaves[2], training=True, eps=gates.EPS),
            leaves, dy)
        row.update(library_ms=lib["bwd_library_ms"],
                   library_fwd_bwd_ms=lib["fwd_bwd_library_ms"])
        per = kernel_device_ms(
            lambda: bn.batch_norm_bwd(x, dy, mean, invstd, w),
            list(BN_KERNELS))
        row["kernels"] = {
            k: {"ms": per.get(k),
                "bound_ms": bound_ms(passes * tensor_bytes, 0)[0]}
            for k, passes in BN_KERNELS.items()}
        for r in row["kernels"].values():
            r["share_of_bound"] = (r["bound_ms"] / r["ms"] if r["ms"]
                                   else None)
        rows.append(row)
    return rows


def bn_record(launches_t, launches_s, gaps, module_gaps, rows, shape_note):
    """The ``kernels`` line's entry of the BatchNorm backward pair, timed
    at UNet_16's widest BatchNorm layer (``c256``: the narrowest's row)."""
    head = next(r for r in rows if r["layer"] == "c16")
    return {
        "name": f"{KERNEL_NAMES['bn']}_bwd", "route": "cuda",
        "source": KERNEL_SOURCES["bn"], "replaces": REPLACES["bn"]["bwd"],
        "launches": launches_t["batch_norm"]["bwd"],
        "launches_supervised": launches_s["batch_norm"]["bwd"],
        "max_abs_err": max(max(g["dx"], g["dw"], g["db"])
                           for g in gaps.values()),
        "cudnn_err": {k: max(g["cudnn_dx"], g["cudnn_dw"], g["cudnn_db"])
                      for k, g in gaps.items()},
        "module_err": max(module_gaps.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": "bytes",
        "library_ms": head["library_ms"],
        "library_fwd_bwd_ms": head["library_fwd_bwd_ms"],
        "library_fwd_ms": head["library_fwd_ms"],
        "kernels_ms": head["kernels"],
        "c256": next(r for r in rows if r["layer"] == "c256"),
        "shape": f"{shape_note} C=16"}


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
    rows_b = time_grid_kernels(BATCH, SHAPE, device, channels=(1, 4))
    time_grid_routes(BATCH, SHAPE, device, c=1, case=0)

    # 3D: the volume episode, its trilinear and nearest samples on the
    # fused z-band pair
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
    rows_g = time_grid_kernels(BATCH3D, SHAPE3D, device)
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
          f"{launches_t['slope']['fwd']}, BatchNorm backward pair "
          f"{launches_t['batch_norm']['bwd']}, host-side fold calls over 7 "
          f"steps {json.dumps(folds_t)}, median {sec_t * 1e3:.1f} ms "
          f"({BATCH / sec_t:.2f} img/s) over "
          f"{[round(t * 1e3, 1) for t in times_t]} ms, peak "
          f"{peak_t / 1e9:.2f} GB on {card}", flush=True)
    assert_grid_only("train step", 2, launches_t, GRID_LAUNCHES["train"],
                     folds_t)
    assert_stencil_launches("train step", launches_t)
    assert_bn_launches("train", launches_t)
    launches_s, sec_s, times_s, first_s, peak_s = run_train_step(
        device, BATCH, SHAPE, supervised=True)
    assert_bn_launches("supervised", launches_s)
    print(f"[train] supervised step, batch {BATCH}: loss {first_s}, "
          f"BatchNorm backward pair {launches_s['batch_norm']['bwd']}, median "
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
    # flat-index corner kernels (2D) and the plane grid kernels (3D)
    worst_c = check_flat_kernels(BATCH, SHAPE, device, (1, 2, 5), (1, 4))
    worst_ct = check_corner_bwd(BATCH, SHAPE, device)
    # the flat corner backward's record: its own cases (K=4 at the tap
    # square takes the tile kernel)
    worst_c["bwd"] = worst_ct["corner"]
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
          f"host-side fold calls {json.dumps(folds_p)}", flush=True)
    if not (launches_p["plane_grid"] == launches3["zband_grid"]
            and not any(folds_p.values())):
        raise AssertionError(
            f"the 3D plane route did not sample through the plane grid pair "
            f"alone ({launches3['zband_grid']} launches, no fold): "
            f"{launches_p}, {folds_p}")
    if args.profile3d_legacy:
        with legacy_route(3):
            profile_3d(device, args.profile3d_legacy, sec_p)
    rows_c = time_flat_kernels(BATCH, SHAPE, device, 1)
    rows_ct = time_corner_bwd(BATCH, SHAPE, device)
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
                and sampler_launches(launches) == sampler_launches(launches2)):
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
        if sampler_launches(launches) != sampler_launches(launches_t):
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
    if sampler_launches(launches_o) != sampler_launches(launches2):
        raise AssertionError(f"the options model's episode launched "
                             f"{launches_o}, not phase 4's {launches2}")
    check_zoo_nets(device)
    ladder = run_ladder(device)

    # slice 12: the utilities.  The cardiac-2D recipe read from written
    # files, RandAugment on the band grid forward (nearest and bilinear),
    # checkpoint resume of the train step, checked, the timers, the trace
    # and the ops gaps
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        recipe = run_cardiac_recipe(device, BATCH, SHAPE, tmp)
        launches_r = recipe["launches"]
        assert_on_kernels("cardiac recipe", launches_r, recipe["calls"],
                          recipe["folds"])
        if not (launches_r["band_grid"]["bwd"]
                and launches_r["stencil"]["bwd"]):
            raise AssertionError(f"the cardiac recipe ran no differentiated "
                                 f"sample or composition: {launches_r}")
        print(f"[recipe] cardiac 2D, batch {BATCH} {SHAPE[0]}x{SHAPE[1]}: "
              f"losses {recipe['losses']}, median s per part "
              f"{json.dumps(recipe['median_s'])}, launches band_grid "
              f"{launches_r['band_grid']}, stencil {launches_r['stencil']}, "
              f"dispatch predicates {launches_r['slope']['fwd']}, samples "
              f"{recipe['calls']}, host-side folds {recipe['folds']}, peak "
              f"{recipe['peak'] / 1e9:.3f} GB on {card}", flush=True)
        x3 = recipe_batch(recipe["paths"]["nrrd"][0], recipe["depth"],
                          RA_C3_BATCH, SHAPE, device, channels=3)
        worst_ra, _ = check_rand_augment(device, recipe["image"], x3)
        ra = time_rand_augment(device, recipe["image"])
        print(f"[rand-augment] MyRandAugment(num_ops=2, magnitude={RA_BIN}) "
              f"at batch {BATCH} {SHAPE[0]}x{SHAPE[1]}: median "
              f"{ra['median_s'] * 1e3:.3f} ms a call "
              f"({BATCH / ra['median_s']:.2f} img/s) over "
              f"{[round(t * 1e3, 3) for t in ra['times']]} ms, "
              f"{ra['n_geometric']} geometric ops drawn in {RA_REPS} calls, "
              f"band_grid launches {ra['launches']['band_grid']}, peak "
              f"{ra['peak'] / 1e9:.3f} GB; ms per op call "
              f"{json.dumps({k: round(v, 4) for k, v in ra['op_ms'].items()})}"
              f" on {card}", flush=True)
        resume = check_resume(device, BATCH, SHAPE, tmp)
        checked_s = check_checked(device, BATCH, SHAPE)
        timer_ms, bench_ms, _ = time_episode_utils(device, BATCH, SHAPE, tmp)
        print(f"[profiling] headline episode: Timer {timer_ms:.2f} ms, "
              f"benchmark {json.dumps(bench_ms)}, phase 4's median "
              f"{sec * 1e3:.2f} ms; under checked {checked_s * 1e3:.1f} ms "
              f"on {card}", flush=True)
        check_ops_gaps(device)

    # phases 30-32: two ranks on this card over gloo
    t_par = time.perf_counter()
    par, gaps_dp = run_parallel(device, parallel_config())
    dp_launches = [kernel_launches(o["dp"]["launches"]) for o in par]
    for r, o in enumerate(par):
        dp = o["dp"]
        for fam in ("band_grid", "stencil", "slope"):
            if dp["launches"][fam] != launches_t[fam]:
                raise AssertionError(
                    f"rank {r}'s data-parallel step launched {fam} "
                    f"{dp['launches'][fam]}, not phase 12's "
                    f"{launches_t[fam]}")
        print(f"[dp-train] rank {r} of {DP_WORLD} on {dp['device']} "
              f"({dp['transport']}): {dp['rows']} of {BATCH} rows, "
              f"launches band_grid {dp['launches']['band_grid']}, stencil "
              f"{dp['launches']['stencil']}, dispatch predicates "
              f"{dp['launches']['slope']['fwd']}; {dp['collectives']['calls']}"
              f" collectives moving {dp['collectives']['bytes']} bytes a "
              f"step; peak {dp['peak'] / 1e9:.3f} GB", flush=True)
    dp0 = par[0]["dp"]
    for name, g in gaps_dp.items():
        print(f"[dp-train] {name} step against the single-process step: "
              f"metrics {dp0['compared'][name]['metrics']} (relative "
              f"{g['losses']}); applied gradients {g['grad_rel_l2']:.3e} "
              f"relative L2, against the single-process step's own "
              f"{g['perturbed_rel_l2']:.3e} under a {DP_PERTURB} input "
              f"perturbation (gate {TOL_DP_GRAD}x); worst leaf "
              f"{g['worst_leaf'][0]} at {g['worst_leaf'][1]:.2f}x the "
              f"per-leaf yardstick (1e-4 of its largest entry + 1e-5 of the "
              f"largest), perturbed {g['perturbed_worst_leaf'][1]:.2f}x",
              flush=True)
    print(f"[dp-train] batch {BATCH} {SHAPE[0]}x{SHAPE[1]} over {DP_WORLD} "
          f"ranks: headline step median "
          f"{statistics.median(dp0['dp_ms']):.1f}"
          f" ms (turns {[round(t, 1) for t in dp0['dp_ms']]}) against the "
          f"single-process step's {statistics.median(dp0['single_ms']):.1f} "
          f"ms ({[round(t, 1) for t in dp0['single_ms']]}) in turns; a "
          f"record, not a scaling claim: the two ranks share one card and "
          f"gloo stages every collective through host memory; on {card}",
          flush=True)
    # the launches of one sharded call (forward, and backward if
    # bilinear), by kernel: each call's are asserted below
    ss_launches = {}
    for r, o in enumerate(par):
        for (dims, c, mode, pad, route), rec in o["ss"].items():
            fam = DEFAULT_FAMILY[dims]
            want = {name: 0 for name in kernel_launches(rec["launches"])}
            want[f"{KERNEL_NAMES[fam]}_fwd"] = 1
            want[f"{KERNEL_NAMES[fam]}_bwd"] = int(mode == "bilinear")
            got = kernel_launches(rec["launches"])
            if got != want:
                raise AssertionError(
                    f"rank {r}: the sharded {dims}D {mode} call launched "
                    f"{ {k: n for k, n in got.items() if n} }, not one "
                    f"{fam} forward (and one backward if bilinear)")
            for name, n in got.items():
                ss_launches[name] = max(ss_launches.get(name, 0), n)
            print(f"[sharded-sample] rank {r}: {dims}D C={c} {mode} {pad} "
                  f"{route}: {fam} launches {rec['launches'][fam]}, max "
                  f"error / dense max {['%.3e' % e for e in rec['errs']]}, "
                  f"median {rec['ms']:.3f} ms a call"
                  f"{' (forward and backward)' if mode == 'bilinear' else ''}"
                  f" on {card}", flush=True)
    for r, o in enumerate(par):
        print(f"[halo-gauss] rank {r}: "
              f"{json.dumps({k: v for k, v in o['hg'].items()})} "
              f"on {card}", flush=True)
    print(f"[parallel] phases 30-32 in {time.perf_counter() - t_par:.1f} s",
          flush=True)

    # phases 33-35: the spatially partitioned train steps, two ranks on
    # (1, 2) and four on (2, 2), on this card over gloo
    t_space = time.perf_counter()
    space_outs, gaps_space = run_space(device, space_config())
    space_launches = {name: [kernel_launches(o["launches"]) for o in outs]
                      for name, outs in space_outs.items()}
    for name, outs in space_outs.items():
        for r, o in enumerate(outs):
            print(f"[space-train] {name} rank {r} of {len(outs)} on "
                  f"{o['device']} ({o['transport']}): block "
                  f"{list(o['block'])}, launches band_grid "
                  f"{o['launches']['band_grid']}, zband_grid "
                  f"{o['launches']['zband_grid']}, stencil "
                  f"{o['launches']['stencil']}, dispatch predicates "
                  f"{o['launches']['slope']['fwd']}; "
                  f"{o['collectives']['calls']} collectives moving "
                  f"{o['collectives']['bytes']} bytes a step "
                  f"({ {k: v for k, v in o['collectives'].items() if k not in ('calls', 'bytes')} }); "
                  f"peak {o['peak'] / 1e9:.3f} GB; 3D step counts "
                  f"{o['compared']['headline']['adaptive_steps']}",
                  flush=True)
        o0 = outs[0]
        for step_name, rec in o0["compared"].items():
            g = gaps_space[name][step_name]
            print(f"[space-train] {name} {step_name} step against the "
                  f"single-process step with sampler compositions: metrics "
                  f"{rec['metrics']} (relative {g['losses']}); applied "
                  f"gradients {g['grad_rel_l2']:.3e} relative L2, against "
                  f"its own {g['perturbed_rel_l2']:.3e} under a "
                  f"{DP_PERTURB} input perturbation (gate {TOL_DP_GRAD}x, "
                  f"or {TOL_SPACE_GRAD}); worst leaf {g['worst_leaf'][0]} "
                  f"at {g['worst_leaf'][1]:.2f}x the per-leaf yardstick",
                  flush=True)
            if "stencil_losses" in g:
                print(f"[space-train] {name} {step_name} step against the "
                      f"default single-process step (stencil "
                      f"compositions), recorded: losses "
                      f"{g['stencil_losses']}, gradients "
                      f"{g['stencil_grad_rel_l2']:.3e} relative L2, its "
                      f"own {g['stencil_perturbed_rel_l2']:.3e} under the "
                      f"perturbation", flush=True)
        for fault, g in gaps_space[name]["planted"].items():
            print(f"[space-train] {name} planted fault {fault}: losses "
                  f"{g['losses']}, gradients {g['grad_rel_l2']:.3e} "
                  f"relative L2 (gate {TOL_SPACE_GRAD}); failed: "
                  f"{g['failed']}", flush=True)
        peak_note = (f" (gate {SPACE_PEAK_GATE}x)" if name == "space_1x2"
                     else "")
        print(f"[space-train] {name}: peak per rank "
              f"{[round(o['peak'] / 1e9, 3) for o in outs]} GB against the "
              f"single-process step's {o0['single_peak'] / 1e9:.3f} GB"
              f"{peak_note}; step median "
              f"{statistics.median(o0['space_ms']) if o0['space_ms'] else float('nan'):.1f}"
              f" ms per rank (turns {[round(t, 1) for t in o0['space_ms']]})"
              f" against the single-process step's "
              f"{statistics.median(o0['single_ms']) if o0['single_ms'] else float('nan'):.1f}"
              f" ms ({[round(t, 1) for t in o0['single_ms']]}) in turns; a "
              f"record, not a scaling claim: the ranks share one card and "
              f"gloo stages every collective through host memory; on "
              f"{card}", flush=True)
    print(f"[space] phases 33-35 in {time.perf_counter() - t_space:.1f} s",
          flush=True)

    # phase 36: the block zoo on the card against the CPU, then timed
    t_blocks = time.perf_counter()
    block_errs = check_blocks(device)
    print(f"[blocks] {len(block_errs)} blocks at 2 rows, UNet_16's level "
          f"widths (the 3D ones at {BATCH3D} x 8 x "
          f"{'x'.join(map(str, SHAPE3D))}) against the CPU, gaps (outputs "
          f"over the largest entry, gradients relative L2, statistics over "
          f"the largest entry): {json.dumps(block_errs)}", flush=True)
    block_ms = time_blocks(device)
    print(f"[blocks] training forward + backward, median of {BLOCK_REPS} "
          f"after 2 warm-ups, at {BATCH} rows (the 3D ones at {BATCH3D}): "
          f"{json.dumps(block_ms)} on {card}", flush=True)
    print(f"[blocks] phase 36 in {time.perf_counter() - t_blocks:.1f} s",
          flush=True)

    # phase 37: the space-mesh zoo, two ranks on (1, 2) over gloo
    t_zoo = time.perf_counter()
    zoo_outs, gaps_zoo = run_space_zoo(
        device, space_outs["space_1x2"][0]["launches"]["band_grid"])
    zoo_launches = {net: [kernel_launches(o["launches"][net])
                          for o in zoo_outs] for net in SPACE_ZOO_NETS}
    z0 = zoo_outs[0]
    for net in SPACE_ZOO_NETS:
        g = gaps_zoo[net]
        print(f"[space-zoo] {net} on (1, 2), {BATCH} rows x "
              f"{SHAPE[0] // 2} of {SHAPE[0]} rows a rank: launches "
              f"band_grid "
              f"{[o['launches'][net]['band_grid'] for o in zoo_outs]}, "
              f"stencil {z0['launches'][net]['stencil']}; collectives "
              f"{[o['collectives'][net] for o in zoo_outs]}; against the "
              f"single-process step with sampler compositions: metrics "
              f"{z0['compared'][net]['metrics']} (relative {g['losses']}); "
              f"applied gradients {g['grad_rel_l2']:.3e} relative L2 against "
              f"its own {g['perturbed_rel_l2']:.3e} under a {DP_PERTURB} "
              f"input perturbation (gate {TOL_DP_GRAD}x, or "
              f"{TOL_SPACE_GRAD}); peak per rank "
              f"{[round(o['peak'][net] / 1e9, 3) for o in zoo_outs]} GB "
              f"against the single-process step's "
              f"{z0['single_peak'][net] / 1e9:.3f} GB; step median "
              f"{statistics.median(z0['space_ms'][net]):.1f} ms per rank "
              f"(turns {[round(t, 1) for t in z0['space_ms'][net]]}) against "
              f"the single-process step's "
              f"{statistics.median(z0['single_ms'][net]):.1f} ms "
              f"({[round(t, 1) for t in z0['single_ms'][net]]}) in turns; a "
              f"record: the ranks share one card over gloo; on {card}",
              flush=True)
    print(f"[space-zoo] the attention's all-gathers a step per rank "
          f"{gaps_zoo['attention_gathers']}; phase 37 in "
          f"{time.perf_counter() - t_zoo:.1f} s", flush=True)

    # phase 38: stencil_warp_3d on the z-band grid pair
    worst_sw3, sw3_call, sw3_ms = check_stencil_warp_3d(device)
    print(f"[stencil3d] N={BATCH3D} {'x'.join(map(str, SHAPE3D))} C in "
          f"(1, 3), both layouts, against the plain versions and the CPU: "
          f"{worst_sw3}; one call launched {sw3_call} on the z-band grid "
          f"pair; C=3: forward {sw3_ms['fwd_ms']:.4f} ms, forward and "
          f"backward {sw3_ms['fwd_bwd_ms']:.4f} ms on {card}", flush=True)

    # phase 39: the headline step on (1, 4) at 224x224, where the bottom
    # level splits (4, 3, 4, 3), four ranks on this card over gloo
    t_lv = time.perf_counter()
    lv_outs, gaps_lv = run_space_levels(
        device, space_outs["space_1x2"][0]["launches"]["band_grid"])
    lv_launches = {net: [kernel_launches(o["launches"][net])
                         for o in lv_outs] for net in LEVELS_NETS}
    l0 = lv_outs[0]
    for net in LEVELS_NETS:
        g = gaps_lv[net]
        rows = {k: [o["rows"][net][k] for o in lv_outs]
                for k in l0["rows"][net]}
        print(f"[space-levels] {net} on {LEVELS_MESH} at "
              f"{LEVELS_SHAPE[0]}x{LEVELS_SHAPE[1]}, {BATCH} rows: each "
              f"level's rows per rank {rows}; launches band_grid "
              f"{[o['launches'][net]['band_grid'] for o in lv_outs]}, "
              f"stencil {l0['launches'][net]['stencil']}; collectives "
              f"{[o['collectives'][net] for o in lv_outs]}; against the "
              f"single-process step with sampler compositions: metrics "
              f"{l0['compared'][net]['metrics']} (relative {g['losses']}); "
              f"applied gradients {g['grad_rel_l2']:.3e} relative L2 against "
              f"its own {g['perturbed_rel_l2']:.3e} under a {DP_PERTURB} "
              f"input perturbation (gate {TOL_DP_GRAD}x, or "
              f"{TOL_SPACE_GRAD}); peak per rank "
              f"{[round(o['peak'][net] / 1e9, 3) for o in lv_outs]} GB "
              f"against the single-process step's "
              f"{l0['single_peak'][net] / 1e9:.3f} GB; step "
              f"{[round(t, 1) for t in l0['space_ms'][net]]} ms per rank "
              f"against the single-process step's "
              f"{[round(t, 1) for t in l0['single_ms'][net]]} ms in turns; "
              f"a record: the ranks share one card over gloo; on {card}",
              flush=True)
    print(f"[space-levels] the attention's all-gathers a step per rank "
          f"{gaps_lv['attention_gathers']}; phase 39 in "
          f"{time.perf_counter() - t_lv:.1f} s", flush=True)

    # phase 40: every block inside a (1, 2) space group on the card
    t_sb = time.perf_counter()
    sb_outs, gaps_sb = run_space_blocks(device)
    print(f"[space-blocks] {len(gaps_sb)} blocks inside a (1, 2) space "
          f"group at {BATCH} rows, UNet_16's level widths (the 3D ones at "
          f"{BATCH3D} x 8 x {'x'.join(map(str, SHAPE3D))}, D split in two) "
          f"against the dense block on the card, the worst rank's gaps "
          f"(outputs and statistics over the largest entry, gradients "
          f"relative L2): {json.dumps(gaps_sb)}; no kernel launched; phase "
          f"40 in {time.perf_counter() - t_sb:.1f} s", flush=True)

    # phase 41: the 3D model's Conv3d weight gradient
    t_wg = time.perf_counter()
    gaps_wg = check_conv3d_wgrad(device)
    launches_wg = count_wgrad_launches(device)
    rows_wg = time_conv3d_wgrad(device)
    print(f"[wgrad] conv3d_wgrad against its float64 twin (largest gap "
          f"over the largest entry; cuDNN's conv3d_weight beside it): "
          f"{json.dumps(gaps_wg)}; two runs bit-equal; launches "
          f"{json.dumps(launches_wg)}; timings {json.dumps(rows_wg)}; phase "
          f"41 in {time.perf_counter() - t_wg:.1f} s on {card}", flush=True)

    # phase 42: the 2D models' training BatchNorm backward
    t_bn = time.perf_counter()
    gates_bn = bn_gates()
    gaps_bn = gates_bn.check_pair(device)
    module_bn = gates_bn.check_module(device)
    rows_bn = time_batch_norm(device)
    print(f"[batchnorm] the library's forward and write-back bit for bit, "
          f"the pair's backward against its float64 twin (largest gap over "
          f"the largest entry; cuDNN's backward beside it): "
          f"{json.dumps(gaps_bn)}; two runs bit-equal; the module with an "
          f"in-place ReLU: {json.dumps(module_bn)}; launches in the train "
          f"step {launches_t['batch_norm']['bwd']}, supervised "
          f"{launches_s['batch_norm']['bwd']}; timings "
          f"{json.dumps(rows_bn)}; phase 42 in "
          f"{time.perf_counter() - t_bn:.1f} s on {card}", flush=True)

    shape2 = f"N={BATCH} {SHAPE[0]}x{SHAPE[1]}"
    shape3 = f"N={BATCH3D} {'x'.join(map(str, SHAPE3D))}"
    kernels = (kernel_records("band_grid", launches2, worst_b, rows_b,
                              "rot30", 1, shape2)
               + kernel_records("zband_grid", launches3, worst_g, rows_g,
                                "near_identity", 3, shape3)
               + kernel_records("stencil", launches_t, worst_s, rows_s,
                                "near_identity", 2, shape2)
               + kernel_records("corner", launches_c, worst_c, rows_c,
                                "rot30", 1, shape2 + " K=4")
               + [tile_record(launches_c, worst_ct, rows_ct,
                              shape2 + " K=4")]
               + kernel_records("plane_grid", launches_p, worst_pg, rows_pg,
                                "near_identity", 3, shape3)
               + [slope_record(launches_t, slope_row, worst_slope, shape2)]
               + [wgrad_record(launches_wg["train3d"], gaps_wg, rows_wg,
                               shape3)]
               + [bn_record(launches_t, launches_s, gaps_bn, module_bn,
                            rows_bn, shape2)])
    by_name = (kernel_launches(launches_rc),
               kernel_launches(runs_cs[0][0]))
    bf16_names = (kernel_launches(turns_e["bf16"][0][0]),
                  kernel_launches(turns_t["bf16"][0][0]))
    for rec in kernels:
        rec["launches_random_chain"] = by_name[0][rec["name"]]
        rec["launches_constrained_solve"] = by_name[1][rec["name"]]
        rec["launches_episode_bf16"] = bf16_names[0][rec["name"]]
        rec["launches_train_bf16"] = bf16_names[1][rec["name"]]
    by_util = (kernel_launches(launches_r), kernel_launches(ra["launches"]))
    for rec in kernels:
        rec["launches_cardiac_recipe"] = by_util[0][rec["name"]]
        rec["launches_rand_augment"] = by_util[1][rec["name"]]
        rec["launches_dp_train_per_rank"] = [d[rec["name"]]
                                             for d in dp_launches]
        rec["launches_sharded_sampler_call"] = ss_launches.get(rec["name"],
                                                               0)
        # phases 33-35: one space step, per rank
        for key, name in (("launches_space_train_per_rank", "space_1x2"),
                          ("launches_space_train_2x2_per_rank",
                           "space_2x2"),
                          ("launches_space_volume_per_rank", "volume_1x2")):
            rec[key] = [d[rec["name"]] for d in space_launches[name]]
        # phase 37: one space step of each zoo network, per rank; phase
        # 38: one stencil_warp_3d call under a gradient
        rec["launches_space_zoo_per_rank"] = {
            net: [d[rec["name"]] for d in zoo_launches[net]]
            for net in SPACE_ZOO_NETS}
        # phase 39: one space step of each network, per rank; phase 40:
        # every block's slab passes, per rank
        rec["launches_space_levels_per_rank"] = {
            net: [d[rec["name"]] for d in lv_launches[net]]
            for net in LEVELS_NETS}
        rec["launches_space_blocks_per_rank"] = [
            sum(d[rec["name"]] for d in o["launches"].values())
            for o in sb_outs]
        rec["launches_stencil_warp_3d_call"] = sum(
            n for kind, n in sw3_call.items()
            if rec["name"] == f"{KERNEL_NAMES['zband_grid']}_{kind}")
        if rec["name"] == f"{KERNEL_NAMES['band_grid']}_fwd":
            # phase 28's apply_op calls against the CPU: bilinear, and
            # nearest outside the tie pixels
            rec["max_abs_err_rand_augment"] = max(worst_ra["bilinear"],
                                                  worst_ra["nearest"])
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
