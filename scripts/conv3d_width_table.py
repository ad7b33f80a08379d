"""The width rule's table: the 3x3x3 Conv3d's weight and bias gradients
(dW + db) on the hand-written pair (``kernels.conv3d_wgrad``) against
cuDNN's (``aten.convolution_backward`` with only the weight and bias
outputs, f32, TF32 off), timed with CUDA events in turns (pair, cuDNN,
cuDNN, pair), at every 3x3x3 layer of ``UNet3D`` at 2 x 16 x 192 x 192,
at PseudoConv3dModel's two layers at 2 x 12 x 192 x 192, and at a few
widths between them that no model has, to place the crossing.

    python3 scripts/conv3d_width_table.py --out PATH

run from the root of a checkout on a machine with an NVIDIA GPU.  Each row
is a line of JSON on standard output (and appended to ``--out``): the
shape, the two times, the scratch the pair used and the least it could
(one block a plane), and the rule's choice for it."""

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

UNET3D = "unet3d"
PSEUDO = "pseudo3d"
BETWEEN = "between"


def rows():
    """[(group, label, (N, Cin, Cout, D, H, W))]."""
    from cudabench.reference import model_UNet3D
    out = []
    spatial = (16, 192, 192)
    layers = model_UNet3D.conv_layers(
        {"input_channel": 1, "num_classes": 4, "base_filters": 32}, spatial)
    for cin, cout, taps, pos in layers:
        if taps != 27:
            continue
        scale = round((math.prod(spatial) / pos) ** (1 / 3))
        vol = tuple(s // scale for s in spatial)
        out.append((UNET3D, f"{cin}->{cout}", (2, cin, cout) + vol))
    out += [(PSEUDO, "conv1", (2, 1, 8, 12, 192, 192)),
            (PSEUDO, "conv2", (2, 8, 4, 12, 192, 192))]
    out += [(BETWEEN, f"{a}x{b}", (2, a, b, 16, 192, 192))
            for a, b in ((1, 16), (4, 8), (8, 8), (8, 16), (16, 16),
                         (16, 32), (32, 32))]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from advchain_tpu_torch.kernels import conv3d_wgrad as cw
    from cudabench.harness import power_limit
    dev = torch.device("cuda")
    card = power_limit()
    for group, label, shape in rows():
        n, cin, cout, d, h, w = shape
        x, dy = cs.wgrad_inputs(shape, dev)
        weight = torch.zeros(cout, cin, 3, 3, 3, device=dev)

        def pair():
            return cw.conv3d_wgrad(x, dy)

        def cudnn():
            return torch.ops.aten.convolution_backward(
                dy, x, weight, [cout], [1] * 3, [1] * 3, [1] * 3, False,
                [0] * 3, 1, [False, True, True])

        iters = 20 if cin * cout <= 256 else 4
        times = {"pair": [], "cudnn": []}
        for name in ("pair", "cudnn", "cudnn", "pair"):
            times[name].append(cs.time_ms(pair if name == "pair" else cudnn,
                                          iters=iters))
        dw, db = pair()
        _, lib_w, lib_b = cudnn()
        rows_ = cw.rows_per_warp(n, cin, cout, d, h, w)
        scratch = 4 * cw._lib().advchain_conv3d_wgrad_scratch(
            n, cin, cout, d, h, w, rows_)
        least = cw.plane_scratch_bytes(n, cin, cout, d, w)
        pair_ms = sum(times["pair"]) / 2
        cudnn_ms = sum(times["cudnn"]) / 2
        line = {"group": group, "layer": label, "shape": list(shape),
                "products": cin * cout, "pair_ms": pair_ms,
                "cudnn_ms": cudnn_ms, "turns": times,
                "pair_over_cudnn": pair_ms / cudnn_ms,
                "scratch_bytes": scratch, "least_scratch_bytes": least,
                "rule_takes_pair": bool(cw.takes_pair(cin, cout)
                                        and cw.scratch_fits(n, cin, cout, d,
                                                            w)),
                "gap_dw_to_cudnn": float((dw - lib_w).abs().max()
                                         / lib_w.abs().max()),
                "device": torch.cuda.get_device_name(0),
                "card": card}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del x, dy, weight, dw, db, lib_w, lib_b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
