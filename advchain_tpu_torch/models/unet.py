"""The reference UNet as a torch ``nn.Module`` (port of
advchain_tpu/models/unet.py: UNet with DoubleConv / Down / Up / OutConv).

``UNet_16`` is ``feature_scale=4``, ``UNet_64`` is ``feature_scale=1``.
Module and parameter names follow the reference torch model
(``inc.conv.conv.0.weight``, ``down1.mpconv.1.conv.0.weight``,
``up1.conv.conv.0.weight``, ``outc.conv.weight``), so its ``.pth``
state dicts load directly.

BatchNorm follows the solver's fixed-network contract: in ``train()`` mode
it normalises by batch statistics and never writes the running statistics
back (the reference's ``_disable_tracking_bn_stats``); in ``eval()`` mode
it uses the running statistics.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["UNet", "DoubleConv", "Down", "Up", "OutConv", "FrozenStatsBN",
           "init_unet_"]


class FrozenStatsBN(nn.BatchNorm2d):
    """BatchNorm2d whose training mode uses batch statistics without
    updating the running ones."""

    def forward(self, x):
        if self.training:
            return F.batch_norm(x, None, None, self.weight, self.bias,
                                training=True, eps=self.eps)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=self.eps)


class DoubleConv(nn.Module):
    """(3x3 conv -> BN -> ReLU) x 2."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 3, padding=1), FrozenStatsBN(out_ch),
            nn.ReLU(inplace=True),
            nn.Conv2d(out_ch, out_ch, 3, padding=1), FrozenStatsBN(out_ch),
            nn.ReLU(inplace=True))

    def forward(self, x):
        return self.conv(x)


class InConv(nn.Module):
    """The input block (reference ``inconv``: a DoubleConv under
    ``.conv``)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x):
        return self.conv(x)


class Down(nn.Module):
    """2x2 max pool, then DoubleConv."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.mpconv = nn.Sequential(nn.MaxPool2d(2),
                                    DoubleConv(in_ch, out_ch))

    def forward(self, x):
        return self.mpconv(x)


class Up(nn.Module):
    """Bilinear x2 (align_corners=True), pad the skip to match, concat
    [skip, x], DoubleConv."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x, skip):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        dh = x.shape[2] - skip.shape[2]
        dw = x.shape[3] - skip.shape[3]
        skip = F.pad(skip, (dw // 2, int(dw / 2), dh // 2, int(dh / 2)))
        return self.conv(torch.cat([skip, x], dim=1))


class OutConv(nn.Module):
    """1x1 conv head."""

    def __init__(self, in_ch: int, num_classes: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, num_classes, 1)

    def forward(self, x):
        return self.conv(x)


class UNet(nn.Module):
    """Reference UNet (no dropout, self-attention or spectral norm)."""

    def __init__(self, input_channel: int = 1, num_classes: int = 4,
                 feature_scale: int = 1):
        super().__init__()
        fs = feature_scale
        self.inc = InConv(input_channel, 64 // fs)
        self.down1 = Down(64 // fs, 128 // fs)
        self.down2 = Down(128 // fs, 256 // fs)
        self.down3 = Down(256 // fs, 512 // fs)
        self.down4 = Down(512 // fs, 512 // fs)
        self.up1 = Up(1024 // fs, 256 // fs)
        self.up2 = Up(512 // fs, 128 // fs)
        self.up3 = Up(256 // fs, 64 // fs)
        self.up4 = Up(128 // fs, 64 // fs)
        self.outc = OutConv(64 // fs, num_classes)

    def forward(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        y = self.up4(y, x1)
        return self.outc(y)


@torch.no_grad()
def init_unet_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's init, in place: conv kernels ~ kaiming normal
    (fan_in, gain 2), conv biases 0, BN weight ~ N(1, 0.02), BN bias 0.
    Draws on the generator's device and copies into the parameters."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator,
                            device=generator.device)
            m.weight.copy_(w * math.sqrt(2.0 / fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.copy_(1.0 + 0.02 * torch.randn(
                m.weight.shape, generator=generator,
                device=generator.device))
            m.bias.zero_()
            m.reset_running_stats()
    return model
