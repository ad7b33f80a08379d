"""Plain PyTorch version of upstream advchain's ``UNet`` (``models/unet.py``:
``inconv`` / ``down`` / ``up`` / ``outconv``): (3x3 conv -> BatchNorm ->
ReLU) x 2 per level, 2x2 max pools down, bilinear x2 (align_corners=True)
up, the skip concatenated before the upsampled features, a 1x1 head.
Widths are ``64 / feature_scale`` doubling to ``512 / feature_scale``.
BatchNorm normalises by the batch's statistics (the training step's passes
all do).  Parameter names are upstream's state-dict names."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (block, input width factor, output width factor) in units of 64 / scale
_ENC = (("inc.conv", 0, 1), ("down1.mpconv.1", 1, 2), ("down2.mpconv.1", 2, 4),
        ("down3.mpconv.1", 4, 8), ("down4.mpconv.1", 8, 8))
_DEC = (("up1.conv", 16, 4), ("up2.conv", 8, 2), ("up3.conv", 4, 1),
        ("up4.conv", 2, 1))


def _blocks(args):
    base = 64 // int(args.get("feature_scale", 1))
    cin = int(args.get("input_channel", 1))
    out = []
    for name, a, b in _ENC + _DEC:
        i = cin if a == 0 else a * base
        out.append((name, i, b * base))
    return out, base


def param_spec(args):
    """[(name, shape, kind)] in upstream's order; ``kind`` is
    ``conv_weight``, ``conv_bias``, ``bn_weight`` or ``bn_bias``."""
    blocks, base = _blocks(args)
    spec = []
    for name, i, o in blocks:
        for j, (ci, co) in ((0, (i, o)), (3, (o, o))):
            conv, bn = f"{name}.conv.{j}", f"{name}.conv.{j + 1}"
            spec += [(f"{conv}.weight", (co, ci, 3, 3), "conv_weight"),
                     (f"{conv}.bias", (co,), "conv_bias"),
                     (f"{bn}.weight", (co,), "bn_weight"),
                     (f"{bn}.bias", (co,), "bn_bias")]
    n = int(args.get("num_classes", 4))
    spec += [("outc.conv.weight", (n, base, 1, 1), "conv_weight"),
             ("outc.conv.bias", (n,), "conv_bias")]
    return spec


def conv_layers(args, spatial):
    """[(cin, cout, taps, output positions per sample)] of every
    convolution of one forward at input size ``spatial`` (H, W)."""
    blocks, base = _blocks(args)
    h, w = spatial
    sizes = [(h, w)]
    for _ in range(4):
        sizes.append((sizes[-1][0] // 2, sizes[-1][1] // 2))
    levels = [0, 1, 2, 3, 4, 3, 2, 1, 0]
    out = []
    for (name, i, o), lv in zip(blocks, levels):
        pos = sizes[lv][0] * sizes[lv][1]
        out += [(i, o, 9, pos), (o, o, 9, pos)]
    out.append((base, int(args.get("num_classes", 4)), 1, h * w))
    return out


def _double(p, name, x, bn):
    for j in (0, 3):
        conv, norm = f"{name}.conv.{j}", f"{name}.conv.{j + 1}"
        x = F.conv2d(x, p[f"{conv}.weight"], p[f"{conv}.bias"], padding=1)
        x = bn(x, p[f"{norm}.weight"], p[f"{norm}.bias"])
        x = F.relu(x)
    return x


def forward(p, x, args, bn, dropout=None):
    """Logits of ``x`` (N, C, H, W) under parameters ``p``; ``bn(x, w, b)``
    is the BatchNorm to use; ``dropout`` is unused (UNet_16 has none)."""
    del dropout
    skips = []
    for k, (name, _, _) in enumerate(_blocks(args)[0][:5]):
        if k:
            x = F.max_pool2d(x, 2)
        x = _double(p, name, x, bn)
        skips.append(x)
    x = skips.pop()
    for name, _, _ in _blocks(args)[0][5:]:
        skip = skips.pop()
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        dh, dw = skip.shape[2] - x.shape[2], skip.shape[3] - x.shape[3]
        if dh or dw:
            raise ValueError("the reference UNet takes sizes divisible by 16")
        x = _double(p, name, torch.cat([skip, x], 1), bn)
    return F.conv2d(x, p["outc.conv.weight"], p["outc.conv.bias"])
