#!/usr/bin/env python3
"""Time the stencil warp's backward on one GPU, in turns against the atomic
scatter it replaced, at the headline composition (N=128, C=2, 192x192, the
near-identity flow of ``chip_smoke.stencil_flows``) and on each of the 8
squaring inputs of a seeded headline morph (each warping itself), which
are what the scaling and squaring feeds it.

    python3 scripts/stencil_bwd_bench.py --out PATH [--scatter-tree TREE]

Run from the root of this tree.  ``--scatter-tree`` is the root of a
checkout of commit b055b3f (a ``git archive`` unpacked under ``build/``),
whose ``advchain_tpu_torch/kernels/csrc/stencil_warp.cu`` holds the scatter:
one thread a pixel, 4C global atomics into a ``d_img`` zeroed by the caller,
behind the C interface ``advchain_stencil_warp_bwd(g, img, flow, d_img,
d_flow, n, c, h, w, stream)``.  The script checks that the source declares
that interface, compiles it with this tree's flags, holds it against this
tree's plain version, and times it with its zeroing.  Prints one JSON line
per turn and writes them all to PATH.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# the scatter's C interface, as commit b055b3f declares it
SCATTER_ABI = (r"int\s+advchain_stencil_warp_bwd\(\s*const float\*\s*g,\s*"
               r"const float\*\s*img,\s*const float\*\s*flow,\s*"
               r"float\*\s*d_img,\s*float\*\s*d_flow,\s*int n,\s*int c,\s*"
               r"int h,\s*int w,\s*void\*\s*stream\)")


def load_scatter(tree: Path):
    """The scatter's library, built into build/stencil_bench."""
    from advchain_tpu_torch.kernels import _build
    src = tree / "advchain_tpu_torch" / "kernels" / "csrc" / "stencil_warp.cu"
    if not re.search(SCATTER_ABI, src.read_text()):
        raise SystemExit(f"stencil_bwd_bench: {src} does not declare the "
                         f"scatter's interface")
    out = ROOT / "build" / "stencil_bench" / "libscatter_stencil_warp.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.advchain_stencil_warp_bwd.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.advchain_stencil_warp_bwd.restype = i32
    return lib


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--scatter-tree", type=Path)
    args = parser.parse_args(argv)

    import torch
    from advchain_tpu_torch.kernels import _build
    from advchain_tpu_torch.kernels import stencil_warp as sw
    if not torch.cuda.is_available():
        raise SystemExit("stencil_bwd_bench: CUDA is not available")
    _build.build(["stencil_warp"])
    n = cs.BATCH
    _, flow = cs.stencil_flows(n, cs.SHAPE, "cuda")[0]
    img, g = cs.stencil_inputs(n, 2, flow)
    squarings = cs.morph_squarings("cuda")
    cots = [cs.stencil_inputs(n, 2, phi, seed=k)[1]
            for k, phi in enumerate(squarings)]
    variants = {"gather": sw.stencil_warp_bwd}
    if args.scatter_tree:
        lib = load_scatter(args.scatter_tree)

        def scatter(g_, img_, flow_):
            d_img = torch.zeros_like(img_)
            d_flow = torch.empty_like(flow_)
            err = lib.advchain_stencil_warp_bwd(
                g_.data_ptr(), img_.data_ptr(), flow_.data_ptr(),
                d_img.data_ptr(), d_flow.data_ptr(), *img_.shape,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"the scatter failed: CUDA error {err}")
            return d_img, d_flow

        for g_, img_, flow_ in [(g, img, flow)] + [
                (c, phi, phi) for c, phi in zip(cots, squarings)]:
            refs = sw.stencil_warp_bwd_plain(g_, img_, flow_)
            for got, ref in zip(scatter(g_, img_, flow_), refs):
                scale = float(ref.abs().max())
                if float((got - ref).abs().max()) > 1e-5 * scale:
                    raise AssertionError("the scatter is off this tree's "
                                         "plain version")
        variants["scatter"] = scatter
    card = cs.card_line()
    lines = []
    order = list(variants) + list(reversed(variants))
    for turn, name in enumerate(order):
        fn = variants[name]
        with torch.no_grad():
            head = cs.time_ms(lambda: fn(g, img, flow))
            per = [cs.time_ms(lambda: fn(c, phi, phi))
                   for c, phi in zip(cots, squarings)]
        lines.append({"turn": turn, "variant": name, "headline_ms": head,
                      "squarings_ms": per, "squarings_sum_ms": sum(per),
                      "card": card})
        print(json.dumps(lines[-1]), flush=True)
    with open(args.out, "w") as f:
        json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
