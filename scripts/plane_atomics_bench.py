#!/usr/bin/env python3
"""Time the plane grid backward (``plane_grid_sample_bwd``) with its
in-row tap pairs added three ways on one GPU, in turns: as two scalar
atomics (the kernel as built), as one float4 atomic on the pair's aligned
16 bytes with two zero lanes where the pair's first index is not 3 mod 4,
and as one float2 atomic where that index is even (Hopper's vector float
atomics, compute capability 9.x).

    python3 scripts/plane_atomics_bench.py --out PATH

Each vector form is built from ``csrc/plane_sample.cu`` with the body of
its ``add_pair`` replaced (one nvcc each, into ``build/plane_atomics/``),
called through the same C entry point on a ``d_img`` with 4 floats of
slack after it (a float4 at the last pair stays inside the buffer), held
against the plain backward (``d_img`` and ``d_grid`` within 1e-5 of their
largest entries) and timed with ``chip_smoke.time_ms`` (50 launches, each
with its zero fill, as the wrapper's) at ``chip_smoke.sample_grids``' two
3D grids at the 3D episode's compositions' shape (N=2, C=3, 12x192x192:
the 10-degree rotation about each axis with zeros padding and the
near-identity warp with border padding), in the order a b c c b a.  The
z-band grid backward on the same inputs is timed beside them.  Prints the
card and one JSON line per grid and writes them to PATH.  Run from the
root of a checkout.
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
ADD_PAIR = '''\
__device__ __forceinline__ void add_pair(float* __restrict__ d_img,
                                         int64_t i, float a, float b) {
  if (a != 0.f) atomicAdd(d_img + i, a);
  if (b != 0.f) atomicAdd(d_img + i + 1, b);
}'''
VECTOR = {
    "float4": '''  if (a != 0.f && b != 0.f && (i & 3) != 3) {
    const int lane = (int)(i & 3);
    const float4 v = make_float4(lane == 0 ? a : 0.f,
                                 lane == 0 ? b : (lane == 1 ? a : 0.f),
                                 lane == 1 ? b : (lane == 2 ? a : 0.f),
                                 lane == 2 ? b : 0.f);
    atomicAdd(reinterpret_cast<float4*>(d_img + (i - lane)), v);
    return;
  }
''',
    "float2": '''  if (a != 0.f && b != 0.f && (i & 1) == 0) {
    atomicAdd(reinterpret_cast<float2*>(d_img + i), make_float2(a, b));
    return;
  }
''',
}


def build(form):
    """The shared library of the backward with ``form``'s add_pair."""
    src = open(os.path.join(CSRC, "plane_sample.cu")).read()
    if ADD_PAIR not in src:
        raise RuntimeError("plane_sample.cu's add_pair changed; update "
                           "ADD_PAIR")
    head, tail = ADD_PAIR.split("{\n", 1)
    src = src.replace(ADD_PAIR, head + "{\n" + VECTOR.get(form, "") + tail)
    out = os.path.join("build", "plane_atomics")
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, f"plane_{form}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out, f"libplane_{form}.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", CSRC, "-o", lib, cu], check=True)
    handle = ctypes.CDLL(os.path.abspath(lib))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    handle.advchain_plane_grid_sample_bwd.argtypes = ([ptr] * 6 + [i32] * 8
                                                      + [ptr])
    handle.advchain_plane_grid_sample_bwd.restype = i32
    return handle


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    import torch
    import chip_smoke as cs
    from advchain_tpu_torch.kernels import _corners
    from advchain_tpu_torch.kernels import plane_sample as ps
    from advchain_tpu_torch.kernels import zband_sample as zs
    if not torch.cuda.is_available():
        print("plane_atomics_bench: CUDA is not available", file=sys.stderr)
        return 2
    libs = {form: build(form) for form in ("scalar", "float4", "float2")}
    card = cs.card_line()
    print(card, flush=True)
    n, shape, c = cs.BATCH3D, cs.SHAPE3D, 3
    rows = []
    for name, padding, gridd in cs.sample_grids(n, shape, "cuda"):
        grid = gridd.reshape(n, -1, 3).contiguous()
        p = grid.shape[1]
        gen = torch.Generator(device="cuda").manual_seed(c)
        img = torch.randn((n, c) + shape, generator=gen, device="cuda")
        g = torch.randn(n, c, p, generator=gen, device="cuda")
        pad, align, _ = _corners.grid_flags(padding, True, "bilinear")

        def run(form):
            if form == "zband_grid":
                return zs.zband_grid_sample_bwd(g, img, grid, padding, True)
            buf = torch.zeros(img.numel() + 4, device="cuda")
            d_img = buf[:img.numel()].view(img.shape)
            d_grid = torch.empty_like(grid)
            err = libs[form].advchain_plane_grid_sample_bwd(
                g.data_ptr(), img.data_ptr(), grid.data_ptr(),
                d_img.data_ptr(), d_grid.data_ptr(), None, n, c, *shape, p,
                pad, align, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{form} launch failed: CUDA error {err}")
            return d_img, d_grid

        ref = ps.plane_grid_sample_bwd_plain(g, img, grid, padding, True)
        for form in libs:
            for ours, want in zip(run(form), ref):
                scale = float(want.abs().max())
                if float((ours - want).abs().max()) > 1e-5 * scale:
                    raise AssertionError(f"the {form} backward disagrees "
                                         f"with the plain one on {name}")
        order = list(libs) + ["zband_grid"]
        times = {}
        for form in order + order[::-1]:
            times.setdefault(form, []).append(
                cs.time_ms(lambda: run(form), iters=50))
        row = {"case": name, "padding": padding, "C": c, "card": card,
               **{f"{form}_ms": times[form] for form in order},
               **{f"{form}_mean_ms": statistics.mean(times[form])
                  for form in order}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
