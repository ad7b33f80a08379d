"""Plain PyTorch version of upstream advchain's 3D demo model
(``PseudoConv3dModel`` in the cardiac notebook): Conv3d(1 -> 8, 3, pad 1)
-> BatchNorm3d -> ReLU -> dropout -> Conv3d(8 -> classes, 3, pad 1).
Dropout keeps one mask for the whole step (upstream's fixed dropout in
an adversarial episode): kept values scaled by ``1 / (1 - p)``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def param_spec(args):
    n = int(args.get("num_classes", 4))
    c = int(args.get("input_channel", 1))
    return [("conv1.weight", (8, c, 3, 3, 3), "conv_weight"),
            ("conv1.bias", (8,), "conv_bias"),
            ("bn1.weight", (8,), "bn_weight"),
            ("bn1.bias", (8,), "bn_bias"),
            ("conv2.weight", (n, 8, 3, 3, 3), "conv_weight"),
            ("conv2.bias", (n,), "conv_bias")]


def conv_layers(args, spatial):
    pos = spatial[0] * spatial[1] * spatial[2]
    return [(int(args.get("input_channel", 1)), 8, 27, pos),
            (8, int(args.get("num_classes", 4)), 27, pos)]


def dropout_modules(args):
    """[(rate, index among the module's submodules (module, conv1, bn1,
    drop, conv2), which seeds its mask, channels of its activation)]."""
    return [(float(args.get("dropout", 0.1)), 3, 8)]


def forward(p, x, args, bn, dropout=None):
    """``dropout``: the kept-mask (bool, the activation's shape) or None."""
    x = F.conv3d(x, p["conv1.weight"], p["conv1.bias"], padding=1)
    x = F.relu(bn(x, p["bn1.weight"], p["bn1.bias"]))
    if dropout is not None:
        keep = 1.0 - float(args.get("dropout", 0.1))
        x = torch.where(dropout[0], x / keep, torch.zeros_like(x))
    return F.conv3d(x, p["conv2.weight"], p["conv2.bias"], padding=1)
