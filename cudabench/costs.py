"""The yardstick's arithmetic: the chip's published peaks, the model FLOPs
a training step requires, and the bytes its warps and flow compositions
must move at the least.  Everything is worked out from a configuration and
a traffic mix, never from the launches, so it reads the same work whatever
implements it."""

from __future__ import annotations

import math

from cudabench.reference.step import model_module

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAKS = {"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
F32 = 4  # bytes
GEOMETRIC = ("affine", "morph")
SQUARINGS = 8  # scaling-and-squaring steps of one exponentiation, at least


def forward_macs(config) -> list:
    """Multiply-accumulates of each convolution of one forward of one
    image or volume: [(macs, is_first_layer)]."""
    m = config["model"]
    layers = model_module(m["name"]).conv_layers(m["args"],
                                                 config["image"]["shape"])
    return [(cin * cout * taps * pos, i == 0)
            for i, (cin, cout, taps, pos) in enumerate(layers)]


def step_model_flops(config, step: str) -> float:
    """FLOPs (2 per multiply-accumulate) of every convolution in every
    model pass one training step of one image requires, recomputation not
    counted.  Each pass is its forward, and for a backward the data
    gradient (dgrad) of every layer whose input needs one and the weight
    gradient (wgrad) where the weights need one, each as many MACs as the
    forward:

    - adversarial: the clean forward; per PGD step a forward and the dgrad
      of every layer (the image's gradient reaches the transforms, no
      weight gradient); the supervised pass and the final consistency
      pass, each a forward, the wgrad of every layer and the dgrad of all
      but the first (their inputs need none);
    - supervised: the supervised pass alone."""
    layers = forward_macs(config)
    fwd = sum(m for m, _ in layers)
    train_pass = fwd + fwd + sum(m for m, first in layers if not first)
    if step == "supervised":
        macs = train_pass
    elif step == "adversarial":
        n_iter = int(config["solver"]["n_iter"])
        macs = fwd + n_iter * 2 * fwd + 2 * train_pass
    else:
        raise ValueError(f"unknown step {step!r}")
    return 2.0 * macs


def _warp(c, d, way):
    """Bytes per pixel of one warp of ``c`` channels by a ``d``-channel
    grid: forward reads the source and the grid and writes the output;
    'in+grid' backward reads the output's gradient, the source and the
    grid and writes both gradients; 'in' backward reads the output's
    gradient and the grid and writes the source's; 'grid' backward reads
    the output's gradient, the source and the grid and writes the grid's."""
    return {"fwd": 2 * c + d, "in+grid": 3 * c + 2 * d,
            "in": 2 * c + d, "grid": 2 * c + 2 * d}[way] * F32


def warp_bytes(config, batch: int, step: str) -> dict:
    """The least bytes one step's warps and flow compositions move, by
    item: {'warp.fwd', 'warp.bwd', 'compose.fwd', 'compose.bwd'}.

    Per evaluation of the chain (each PGD step, and the final pass) every
    geometric transform warps the image (C channels) and the validity
    mask of ones (1 channel) forward, and the prediction with the mask
    (classes + 1 channels) back; a morph exponentiates its velocity and
    its negation, ``SQUARINGS`` compositions of the d-channel flow with
    itself each (a composition reads the flow once and writes it).  A PGD
    step also runs every backward: the image's and the prediction's warps
    into their source and their grid, the mask's into its grid, each
    composition into its flow (read the gradient and the flow, write
    one gradient).  The final pass runs only the prediction's backward
    warps, into their source.  A supervised step moves none.  3D counts
    the least number of squarings, 8."""
    zero = {"warp.fwd": 0.0, "warp.bwd": 0.0, "compose.fwd": 0.0,
            "compose.bwd": 0.0}
    if step == "supervised":
        return zero
    shape = config["image"]["shape"]
    d = len(shape)
    pix = batch * math.prod(shape)
    c = int(config["image"]["channels"])
    k = int(config["model"]["args"].get("num_classes", 4))
    names = [e["name"] for e in config["chain"]]
    g = sum(n in GEOMETRIC for n in names)
    morphs = names.count("morph")
    n_iter = int(config["solver"]["n_iter"])
    fwd_one = g * (_warp(c, d, "fwd") + _warp(1, d, "fwd")
                   + _warp(k + 1, d, "fwd"))
    comp_fwd = morphs * 2 * SQUARINGS * 2 * d * F32
    out = dict(zero)
    out["warp.fwd"] = pix * fwd_one * (n_iter + 1)
    out["compose.fwd"] = pix * comp_fwd * (n_iter + 1)
    out["warp.bwd"] = pix * (n_iter * g * (_warp(c, d, "in+grid")
                                           + _warp(1, d, "grid")
                                           + _warp(k + 1, d, "in+grid"))
                             + g * _warp(k + 1, d, "in"))
    out["compose.bwd"] = pix * n_iter * morphs * 2 * SQUARINGS * 3 * d * F32
    return out
