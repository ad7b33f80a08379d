"""The reference UNet and the 3D demo model as torch ``nn.Module``s (port
of advchain_tpu/models/unet.py: UNet with DoubleConv / Down / Up / OutConv,
and PseudoConv3dModel).

``UNet_16`` is ``feature_scale=4``, ``UNet_64`` is ``feature_scale=1``.
Module and parameter names follow the reference torch model
(``inc.conv.conv.0.weight``, ``down1.mpconv.1.conv.0.weight``,
``up1.conv.conv.0.weight``, ``outc.conv.weight``), so its ``.pth``
state dicts load directly.

BatchNorm follows the solver's fixed-network contract: in ``train()`` mode
it normalises by batch statistics and never writes the running statistics
back (the reference's ``_disable_tracking_bn_stats``); in ``eval()`` mode
it uses the running statistics.  A training step's supervised pass alone
writes them back (``write_back``, set by ``SegmentationModel.apply_train``),
as torch's BatchNorm does: momentum 0.1, the unbiased batch variance into
the running variance, the biased one for normalisation, eps 1e-5.
Dropout (:class:`EpisodeDropout`) replays one mask for a whole adversarial
episode (the reference's Fixable dropout); ``SegmentationModel.
begin_episode`` redraws it.

The JAX package computes PseudoConv3dModel's 3x3x3 convolutions as
``ZDecomposedConv3d``, three 2D convolutions over z-shifted plane stacks,
because XLA's 3D convolution is slow on the TPU; it is the same SAME
convolution, so the port uses ``nn.Conv3d``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["UNet", "DoubleConv", "Down", "Up", "OutConv", "FrozenStatsBN",
           "FrozenStatsBN3d", "EpisodeDropout", "PseudoConv3dModel",
           "init_unet_"]


class _FrozenStats:
    """Training mode uses batch statistics without updating the running
    ones, unless ``write_back`` is set (the JAX package's TorchBatchNorm
    with a mutable ``batch_stats`` collection); eval mode uses the running
    ones."""

    write_back = False

    def forward(self, x):
        if self.training:
            if self.write_back:
                return F.batch_norm(x, self.running_mean, self.running_var,
                                     self.weight, self.bias, training=True,
                                     momentum=self.momentum, eps=self.eps)
            return F.batch_norm(x, None, None, self.weight, self.bias,
                                training=True, eps=self.eps)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=self.eps)


class FrozenStatsBN(_FrozenStats, nn.BatchNorm2d):
    """BatchNorm2d with frozen running statistics."""


class FrozenStatsBN3d(_FrozenStats, nn.BatchNorm3d):
    """BatchNorm3d with frozen running statistics."""


class EpisodeDropout(nn.Module):
    """Dropout whose mask stays fixed until :meth:`redraw`: every training
    forward of one episode multiplies by the same mask (Flax's
    ``nn.Dropout`` with the episode's fixed rng: kept values are scaled by
    ``1 / (1 - p)``, dropped ones are 0).  The mask is drawn on the input's
    device from a generator seeded with the episode seed, at the first
    forward of the episode."""

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {p}")
        self.p = float(p)
        self.seed = 0
        self._mask = None

    def redraw(self, seed: int) -> None:
        self.seed = int(seed)
        self._mask = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        mask = self._mask
        if mask is None or mask.shape != x.shape or mask.device != x.device:
            gen = torch.Generator(device=x.device).manual_seed(self.seed)
            mask = torch.rand(x.shape, generator=gen,
                              device=x.device) >= self.p
            self._mask = mask
        keep = 1.0 - self.p
        return torch.where(mask, x / keep, torch.zeros_like(x))


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

    def init_weights_(self, generator: torch.Generator):
        return init_unet_(self, generator)


class PseudoConv3dModel(nn.Module):
    """The reference's small 3D demo model: Conv3d(1 -> 8, 3, pad 1) ->
    BN3d -> ReLU -> dropout -> Conv3d(8 -> classes, 3, pad 1).  Parameter
    names ``conv1``, ``bn1``, ``conv2`` follow the Flax module's."""

    def __init__(self, num_classes: int = 4, dropout: float = 0.1,
                 input_channel: int = 1):
        super().__init__()
        self.conv1 = nn.Conv3d(input_channel, 8, 3, padding=1)
        self.bn1 = FrozenStatsBN3d(8)
        self.drop = EpisodeDropout(dropout)
        self.conv2 = nn.Conv3d(8, num_classes, 3, padding=1)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return self.conv2(self.drop(x))

    def init_weights_(self, generator: torch.Generator):
        """The JAX package's init: kaiming-normal convs, zero biases, BN
        weight 1 (TorchBatchNorm's default) and bias 0."""
        return init_unet_(self, generator, bn_weight_std=0.0)


@torch.no_grad()
def init_unet_(model: nn.Module, generator: torch.Generator,
               bn_weight_std: float = 0.02) -> nn.Module:
    """The JAX package's init, in place: conv kernels ~ kaiming normal
    (fan_in, gain 2), conv biases 0, BN weight ~ N(1, bn_weight_std), BN
    bias 0.  Draws on the generator's device and copies into the
    parameters."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator,
                            device=generator.device)
            m.weight.copy_(w * math.sqrt(2.0 / fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.weight.copy_(1.0 + bn_weight_std * torch.randn(
                m.weight.shape, generator=generator,
                device=generator.device))
            m.bias.zero_()
            m.reset_running_stats()
    return model
