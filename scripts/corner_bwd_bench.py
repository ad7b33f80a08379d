#!/usr/bin/env python3
"""Time the corner backward (``corner_sample_bwd``, the 2D route under
ADVCHAIN_BAND_KERNEL=0) in each design tried, on one GPU, in turns:

- ``flat``: the flat kernel, one thread a point and one global atomic a
  nonzero tap (the corner backward before the tile kernel; it keeps K=1
  and other offsets);
- ``box``: the corner tile kernel as built: a block's 8 x 32 points sum
  their taps in fixed point into a box of their source rectangle (at most
  1024 cells) in shared memory, two native int32 shared atomics a tap,
  flushed with one global f32 atomic per nonzero cell, capped at 40
  registers;
- ``box_16x16``: the same over 16 x 16 tiles (fewer atomics, half-warp
  rows) with a box of at most 2048 cells;
- ``box_unbounded``: the same without the register cap (62 registers);
- ``box_f32``: the same box in f32, with f32 shared atomics (a
  compare-and-swap loop on this card);
- ``tile_direct``: the same tiling with the box switched off, each tap a
  global atomic (what the tiling alone does);
- ``box_premerge``: the box, with a lane's +1-column taps handed to the
  next lane's base-column taps by warp shuffles where their cells
  coincide, before the shared atomics;
- ``box_float4``: the box, flushed with Hopper's float4 global atomics on
  aligned 16-byte groups of a box row (a lane owns its groups alone);

and two timing floors whose d_img is wrong (not held against the plain
backward): ``flat_no_atomics``, the flat kernel without its global
atomics, and ``tile_no_atomics``, the tile kernel without its box and
atomics (the tiling, bounds and d_w alone).

    python3 scripts/corner_bwd_bench.py --out PATH

Every tile design is built from ``csrc/plane_sample.cu`` with its text
replaced as below (one nvcc each, into ``build/corner_bwd/``) and called
through the C entry point ``advchain_corner_tile_sample_bwd``; ``flat``
through ``advchain_plane_sample_bwd`` with one plane.  Each is held
against the plain backward (``d_img`` and ``d_w`` within 1e-5 of their
largest entries) and timed with ``chip_smoke.time_ms`` (50 launches, each
with its zero fill of ``d_img``, as the wrapper's) at
``chip_smoke.sample_grids``' two 2D grids (the 30-degree rotation with
zeros padding and the near-identity warp with border padding) at N=128,
192x192, K=4 with the route's folded weights, C in {1, 4, 5}, in the order
a b c ... c b a; and the flat kernel and its floor at K=1 (nearest's unit
tap).
Beside each case the global atomics per point, reckoned from the indices
and weights (``chip_smoke.corner_atomics``: per point, which is also a
lane's, per warp's, per block's).  Then the flat kernel and the tile kernel as
built in turns on the inputs of each corner backward of one headline 2D
episode with ADVCHAIN_BAND_KERNEL=0, beside the share of nonzero
cotangents and weights and of blocks whose box fits.  Prints the card and one JSON line per case and
writes them to PATH.  Run from the root of a checkout.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.getcwd())

CSRC = "advchain_tpu_torch/kernels/csrc"
USE_BOX = "    const bool use_box = fits && block_most < 0x7f800000u;\n"
ADD = """\
        const float y = scale_pow2(contrib[k], up);  // |y| < 2^kFixBits
        const float hi = floorf(__fmul_rn(y, 1.f / (1 << kLoBits)));
        const int at = cell + (k >> 1) * bw + (k & 1);
        atomicAdd(box_hi + at, (int)hi);
        atomicAdd(box_lo + at, __float2uint_rn(
            __fsub_rn(y, __fmul_rn(hi, (float)(1 << kLoBits)))));
"""
READ = """\
        const int hi = box_hi[at];
        const unsigned lo = box_lo[at];
        if (hi == 0 && lo == 0u) continue;
        box_hi[at] = 0;
        box_lo[at] = 0u;
        const int64_t sum = (int64_t)hi * (1 << kLoBits) + lo;
        if (sum != 0) {
          atomicAdd(dp + row0 + j, scale_pow2(__ll2float_rn(sum), -up));
        }
"""
LOOP = """\
      for (int j = lane; j < bw; j += 32) {
        const int at = rr * bw + j;
""" + READ + """\
      }
"""
ADDS = """\
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (contrib[k] == 0.f) continue;  // and so the tap is valid
"""
F32_ADD = """\
        atomicAdd(reinterpret_cast<float*>(box_hi) + cell + (k >> 1) * bw
                  + (k & 1), contrib[k]);
"""
F32_READ = """\
        const float v = reinterpret_cast<float*>(box_hi)[at];
        if (v == 0.f) continue;
        box_hi[at] = 0;
        atomicAdd(dp + row0 + j, v);
"""
PREMERGE = """\
    if (use_box) {
      // lane i hands its +1-column taps to lane i + 1's base-column taps
      // where their cells coincide (every lane runs the shuffles)
#pragma unroll
      for (int a = 1; a < 4; a += 2) {
        const int mine = cell + (a >> 1) * bw;
        const int up_cell = __shfl_up_sync(0xffffffffu, mine + 1, 1);
        const float up_v = __shfl_up_sync(0xffffffffu, contrib[a], 1);
        const bool take = lane > 0 && up_v != 0.f
                          && ((ok >> (a - 1)) & 1u) && up_cell == mine;
        if (take) contrib[a - 1] = __fadd_rn(contrib[a - 1], up_v);
        const bool given = __shfl_down_sync(0xffffffffu, take, 1);
        if (given && lane < 31) contrib[a] = 0.f;
      }
    }
""" + ADDS
FLOAT4 = """\
      if ((stride & 3) || (s & 3)) {
        for (int j = lane; j < bw; j += 32) {
          const int at = rr * bw + j;
          const int hi = box_hi[at];
          const unsigned lo = box_lo[at];
          if (hi == 0 && lo == 0u) continue;
          box_hi[at] = 0;
          box_lo[at] = 0u;
          const int64_t sum = (int64_t)hi * (1 << kLoBits) + lo;
          if (sum != 0) {
            atomicAdd(dp + row0 + j, scale_pow2(__ll2float_rn(sum), -up));
          }
        }
        continue;
      }
      // aligned 16-byte groups over [row0, row0 + bw), one a lane; a group
      // holding a received cell lies inside the channel (s % 4 == 0)
      const int lead = (int)(row0 & 3);
      for (int q = lane; q < (lead + bw + 3) >> 2; q += 32) {
        float v[4];
        bool any = false;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * q + e - lead;
          v[e] = 0.f;
          if (j < 0 || j >= bw) continue;
          const int at = rr * bw + j;
          const int hi = box_hi[at];
          const unsigned lo = box_lo[at];
          if (hi == 0 && lo == 0u) continue;
          box_hi[at] = 0;
          box_lo[at] = 0u;
          v[e] = scale_pow2(__ll2float_rn((int64_t)hi * (1 << kLoBits) + lo),
                            -up);
          any |= v[e] != 0.f;
        }
        if (any) {
          atomicAdd(reinterpret_cast<float4*>(dp + row0 - lead + 4 * q),
                    make_float4(v[0], v[1], v[2], v[3]));
        }
      }
"""
TILE_16 = [("cap = ho == 1 ? 8 : 5;", "cap = ho == 1 ? 8 : 4;"),
           ("constexpr int kBoxCells = 1024;",
            "constexpr int kBoxCells = 2048;")]
BOUND = ("__launch_bounds__(kThreads, 6)\ncorner_tile_bwd_kernel(",
         "__launch_bounds__(kThreads)\ncorner_tile_bwd_kernel(")
DIRECT = "        atomicAdd(dp + b + (k >> 1) * stride + (k & 1), contrib[k]);\n"
FLAT_ADD = ("      if (contrib != 0.f) atomicAdd(ds + tp.off[j], "
            "contrib);\n")
# timing floors, not designs: their d_img is wrong and they are not held
FLOORS = {"flat_no_atomics": [(FLAT_ADD, "      (void)ds;\n")],
          "tile_no_atomics": [(USE_BOX, "    const bool use_box = false;\n"),
                              (DIRECT, "        (void)dp;\n")]}
DESIGNS = {"box": [], "box_16x16": TILE_16, "box_unbounded": [BOUND],
           "box_f32": [(ADD, F32_ADD), (READ, F32_READ)],
           "tile_direct": [(USE_BOX, "    const bool use_box = false;\n")],
           "box_premerge": [(ADDS, PREMERGE)],
           "box_float4": [(LOOP, FLOAT4)]}


def build(design):
    """The shared library of ``plane_sample.cu`` with ``design``'s text."""
    src = open(os.path.join(CSRC, "plane_sample.cu")).read()
    for old, new in [(text, text) for text in (USE_BOX, ADD, READ, LOOP,
                                               ADDS, BOUND[0], DIRECT,
                                               FLAT_ADD)] \
            + {**DESIGNS, **FLOORS}[design]:
        if old not in src:
            raise RuntimeError("plane_sample.cu's tile backward changed; "
                               "update the bench's text")
        src = src.replace(old, new)
    out = os.path.join("build", "corner_bwd")
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, f"corner_{design}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out, f"libcorner_{design}.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return cu, lib, subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", CSRC, "-o", lib, cu])


def load(lib):
    handle = ctypes.CDLL(os.path.abspath(lib))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    handle.advchain_corner_tile_sample_bwd.argtypes = ([ptr] * 6 + [i32] * 6
                                                       + [ptr])
    handle.advchain_corner_tile_sample_bwd.restype = i32
    handle.advchain_plane_sample_bwd.argtypes = [ptr] * 7 + [i32] * 10 + [ptr]
    handle.advchain_plane_sample_bwd.restype = i32
    return handle


def episode_calls(cs, ps):
    """The inputs of each corner backward of one headline 2D episode with
    ADVCHAIN_BAND_KERNEL=0 (after one warm-up episode), as (g, img, idx,
    w, offsets, width)."""
    import torch
    solver = cs.build_solver(cs.BATCH, cs.SHAPE)
    model = cs.build_model("cuda")
    data = torch.as_tensor(cs.make_input(cs.BATCH, cs.SHAPE), device="cuda")
    calls, real = [], ps.corner_sample_bwd

    def spy(g, img, idx, w, offsets, width=None):
        calls.append((g.clone(), img.clone(), idx.clone(), w.clone(),
                      tuple(offsets), width))
        return real(g, img, idx, w, offsets, width)

    with cs.legacy_route(2):
        cs.episode_once(solver, model, data)
        ps.corner_sample_bwd = spy
        try:
            cs.episode_once(solver, model, data)
        finally:
            ps.corner_sample_bwd = real
    return calls


def box_fits(idx, w, stride, s, wo, cells):
    """The share of the tile kernel's blocks whose box of live taps fits
    in ``cells``, and the share of taps with a nonzero weight."""
    import torch
    import chip_smoke as cs
    n, p = idx.shape
    block = cs.tile_blocks(n, p, wo, idx.device)[0]
    f = idx.long()[:, None, :] + torch.tensor(
        [0, 1, stride, stride + 1], device=idx.device)[None, :, None]
    live = ((f >= 0) & (f < s)).any(1)
    rb = torch.div(idx.long(), stride, rounding_mode="floor")
    extent = 1
    for v in (rb, idx.long() - rb * stride):  # base row, base column
        big = torch.iinfo(torch.int64).max
        lo = torch.full((int(block.max()) + 1,), big, device=idx.device)
        hi = torch.full_like(lo, -big)
        lo = lo.scatter_reduce(0, block[live], v[live], "amin")
        hi = hi.scatter_reduce(0, block[live], v[live], "amax")
        extent = extent * (hi - lo + 2).clamp(min=0)
    used = torch.zeros_like(extent, dtype=torch.bool)
    used[block[live]] = True
    fit = (extent <= cells) & used
    return (float(fit.sum()) / max(int(used.sum()), 1),
            float((w != 0).float().mean()))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    import torch
    import chip_smoke as cs
    from advchain_tpu_torch.kernels import plane_sample as ps
    if not torch.cuda.is_available():
        print("corner_bwd_bench: CUDA is not available", file=sys.stderr)
        return 2
    builds = {d: build(d) for d in {**DESIGNS, **FLOORS}}
    for design, (_, _, proc) in builds.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the {design} design")
    libs = {d: load(lib) for d, (_, lib, _) in builds.items()}
    card = cs.card_line()
    print(card, flush=True)
    n, shape = cs.BATCH, cs.SHAPE
    rows = []
    for gi, c, k in ((0, 1, 4), (0, 4, 4), (0, 5, 4), (1, 1, 4), (1, 4, 4),
                     (1, 5, 4), (0, 1, 1)):
        name, padding, grid = cs.sample_grids(n, shape, "cuda")[gi]
        img, idx, wts, g, offs = cs.flat_inputs(
            n, c, shape, grid, padding, k, "cuda")
        wo, p, s = grid.shape[2], idx.shape[1], img.shape[2]

        def run(design):
            if design == "flat":
                return ps._bwd(g, img, idx, wts, offs)
            d_img = torch.zeros_like(img)
            d_w = torch.empty_like(wts)
            stream = torch.cuda.current_stream().cuda_stream
            if design == "flat_no_atomics":
                err = libs[design].advchain_plane_sample_bwd(
                    g.data_ptr(), img.data_ptr(), None, idx.data_ptr(),
                    wts.data_ptr(), d_img.data_ptr(), d_w.data_ptr(), n, c,
                    1, s, p, k, *offs, *[0] * (4 - k), stream)
            else:
                err = libs[design].advchain_corner_tile_sample_bwd(
                    g.data_ptr(), img.data_ptr(), idx.data_ptr(),
                    wts.data_ptr(), d_img.data_ptr(), d_w.data_ptr(), n, c,
                    s, p, wo, offs[2], stream)
            if err:
                raise RuntimeError(f"{design} launch failed: CUDA error "
                                   f"{err}")
            return d_img, d_w

        # the tile designs take K = 4 only
        order = ["flat"] + (list(libs) if k == 4 else ["flat_no_atomics"])
        ref = ps.corner_sample_bwd_plain(g, img, idx, wts, offs)
        with torch.no_grad():
            for design in (d for d in order if d not in FLOORS):
                for ours, want in zip(run(design), ref):
                    scale = float(want.abs().max())
                    if float((ours - want).abs().max()) > 1e-5 * scale:
                        raise AssertionError(f"the {design} backward "
                                             f"disagrees with the plain one "
                                             f"on {name} C={c}")
            times = {}
            for design in order + order[::-1]:
                times.setdefault(design, []).append(
                    cs.time_ms(lambda: run(design), iters=50))
        row = {"case": name, "padding": padding, "C": c, "K": k,
               "card": card,
               "atomics_per_point": cs.corner_atomics(idx, wts, offs, s, wo),
               "atomics_per_point_16x16": cs.corner_atomics(
                   idx, wts, offs, s, wo, tile_w=16),
               **{f"{d}_ms": times[d] for d in order},
               **{f"{d}_mean_ms": statistics.mean(times[d]) for d in order}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    # the corner backwards of one headline 2D episode on the corner route:
    # the flat kernel and the tile kernel as built, in turns, on the
    # episode's own inputs
    for i, (g, img, idx, wts, offs, wo) in enumerate(episode_calls(cs, ps)):
        n, c, s = img.shape
        p = idx.shape[1]
        fns = {"flat": lambda: ps._bwd(g, img, idx, wts, offs),
               "box": lambda: ps.corner_sample_bwd(g, img, idx, wts, offs,
                                                   wo)}
        times = {}
        with torch.no_grad():
            for design in ["flat", "box", "box", "flat"]:
                times.setdefault(design, []).append(
                    cs.time_ms(fns[design], iters=50))
        fit, live_w = box_fits(idx, wts, offs[2], s, wo, 1024)
        row = {"case": f"episode call {i}", "C": c, "K": len(offs),
               "card": card, "raster_width": wo,
               "nonzero_g": float((g != 0).float().mean()),
               "nonzero_w": live_w, "boxes_that_fit": fit,
               "atomics_per_point": cs.corner_atomics(idx, wts, offs, s, wo),
               **{f"{d}_ms": times[d] for d in times},
               **{f"{d}_mean_ms": statistics.mean(t)
                  for d, t in times.items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
