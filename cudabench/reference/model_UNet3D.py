"""Plain PyTorch version of the 3D U-Net of Cicek, Abdulkadir, Lienkamp,
Brox and Ronneberger, "3D U-Net: Learning Dense Volumetric Segmentation
from Sparse Annotation", MICCAI 2016, arXiv:1606.06650, Fig. 2.

Analysis path: 4 levels of (3x3x3 conv -> BatchNorm -> ReLU) x 2, level
``l`` to ``b * 2**l`` then ``b * 2**(l + 1)`` channels (``b =
base_filters``, 32 in the paper: a 256 -> 512 bottom), the upper three
each followed by a 2x2x2 max pool of stride 2.  Synthesis path, levels 2
to 0: a 2x2x2 up-convolution of stride 2 that keeps its channels, the
concatenation [skip, up], then (3x3x3 conv -> BatchNorm -> ReLU) x 2 to
``b * 2**(l + 1)`` channels.  Head: a 1x1x1 convolution to the classes.

Departures from the paper, as the configuration's ``assumed`` states:
SAME padding (the paper's convolutions are valid, on 132 x 132 x 116
tiles), so the logits lie on the input's grid, which advchain's warp-back
needs; the classes are the configuration's.  BatchNorm normalises by the
batch's statistics (the training step's passes all do).  Parameter names
are those of the measured program's module."""

from __future__ import annotations

import torch
import torch.nn.functional as F

LEVELS = 4


def _plan(args):
    """([(block, cin, mid, cout)] encoder then decoder blocks, [(name,
    channels)] up-convolutions, head input channels)."""
    b = int(args.get("base_filters", 32))
    cin = int(args.get("input_channel", 1))
    widths = [b * 2 ** (l + 1) for l in range(LEVELS)]
    enc = [(f"encoder.{l}", cin if l == 0 else widths[l - 1], b * 2 ** l,
            widths[l]) for l in range(LEVELS)]
    below = widths[1:][::-1]
    ups = [(f"upconv.{k}", c) for k, c in enumerate(below)]
    dec = [(f"decoder.{k}", c + widths[l], widths[l], widths[l])
           for k, (c, l) in enumerate(zip(below, range(LEVELS - 2, -1, -1)))]
    return enc + dec, ups, widths[0]


def param_spec(args):
    """[(name, shape, kind)]; ``kind`` is ``conv_weight``, ``conv_bias``,
    ``bn_weight`` or ``bn_bias``.  An up-convolution's weight (Cin, Cout,
    2, 2, 2) is a ``conv_weight``: drawn on fan-in ``numel // shape[0]``,
    as torch's ``kaiming_normal_`` counts it."""
    blocks, ups, head = _plan(args)
    spec = []
    for name, cin, mid, cout in blocks:
        for j, (i, o) in ((1, (cin, mid)), (2, (mid, cout))):
            spec += [(f"{name}.conv{j}.weight", (o, i, 3, 3, 3),
                      "conv_weight"),
                     (f"{name}.conv{j}.bias", (o,), "conv_bias"),
                     (f"{name}.bn{j}.weight", (o,), "bn_weight"),
                     (f"{name}.bn{j}.bias", (o,), "bn_bias")]
    for name, c in ups:
        spec += [(f"{name}.weight", (c, c, 2, 2, 2), "conv_weight"),
                 (f"{name}.bias", (c,), "conv_bias")]
    n = int(args.get("num_classes", 4))
    spec += [("head.weight", (n, head, 1, 1, 1), "conv_weight"),
             ("head.bias", (n,), "conv_bias")]
    return spec


def conv_layers(args, spatial):
    """[(cin, cout, taps, output positions per sample)] of every
    convolution of one forward at input size ``spatial`` (D, H, W), in the
    forward's order, the input layer first.  An up-convolution counts its 8
    taps over the coarser level's positions (each input voxel meets each
    tap once); the head counts 1 tap."""
    blocks, ups, head = _plan(args)
    pos = [spatial[0] * spatial[1] * spatial[2] // 8 ** l
           for l in range(LEVELS)]
    out = []
    for l, (_, cin, mid, cout) in enumerate(blocks[:LEVELS]):
        out += [(cin, mid, 27, pos[l]), (mid, cout, 27, pos[l])]
    for (_, cin, mid, cout), (_, c), l in zip(
            blocks[LEVELS:], ups, range(LEVELS - 2, -1, -1)):
        out += [(c, c, 8, pos[l + 1]), (cin, mid, 27, pos[l]),
                (mid, cout, 27, pos[l])]
    out.append((head, int(args.get("num_classes", 4)), 1, pos[0]))
    return out


def _double(p, name, x, bn):
    for j in (1, 2):
        x = F.conv3d(x, p[f"{name}.conv{j}.weight"], p[f"{name}.conv{j}.bias"],
                     padding=1)
        x = F.relu(bn(x, p[f"{name}.bn{j}.weight"], p[f"{name}.bn{j}.bias"]))
    return x


def forward(p, x, args, bn, dropout=None):
    """Logits of ``x`` (N, C, D, H, W) under parameters ``p``; ``bn(x, w,
    b)`` is the BatchNorm to use; ``dropout`` is unused (the network has
    none)."""
    del dropout
    if any(s % 2 ** (LEVELS - 1) for s in x.shape[2:]):
        raise ValueError("the reference 3D U-Net takes sizes divisible by 8")
    blocks, ups, _ = _plan(args)
    skips = []
    for l, (name, _, _, _) in enumerate(blocks[:LEVELS]):
        if l:
            x = F.max_pool3d(x, 2, 2)
        x = _double(p, name, x, bn)
        skips.append(x)
    x = skips.pop()
    for (name, _, _, _), (up, _) in zip(blocks[LEVELS:], ups):
        x = F.conv_transpose3d(x, p[f"{up}.weight"], p[f"{up}.bias"],
                               stride=2)
        x = _double(p, name, torch.cat([skips.pop(), x], 1), bn)
    return F.conv3d(x, p["head.weight"], p["head.bias"])
