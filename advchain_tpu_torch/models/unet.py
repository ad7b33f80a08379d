"""The reference UNet family and the 3D demo model as torch ``nn.Module``s
(port of advchain_tpu/models/unet.py: UNet with DoubleConv / Down / Up /
OutConv and its options, UNetv2, DeeplySupervisedUNet, SelfAttn2d,
PseudoConv3dModel).

``UNet_16`` is ``feature_scale=4``, ``UNet_64`` is ``feature_scale=1``.
Module and parameter names follow the reference torch model
(``inc.conv.conv.0.weight``, ``down1.mpconv.1.conv.0.weight``,
``up1.conv.conv.0.weight``, ``outc.conv.weight``, ``self_atn.gamma``),
so its ``.pth`` state dicts load directly.

BatchNorm follows the solver's fixed-network contract: in ``train()`` mode
it normalises by batch statistics and never writes the running statistics
back (the reference's ``_disable_tracking_bn_stats``); in ``eval()`` mode
it uses the running statistics.  A training step's supervised pass alone
writes them back (``write_back``, set by ``SegmentationModel.apply_train``),
as torch's BatchNorm does: momentum 0.1, the unbiased batch variance into
the running variance, the biased one for normalisation, eps 1e-5.
Spectral norm (:class:`SpectralConv2d`) follows Flax's ``SpectralNorm``:
one power iteration from the stored ``u`` on every forward, ``u`` and
``sigma`` written back under the same ``write_back``.
Dropout (:class:`EpisodeDropout`) replays one mask for a whole adversarial
episode (the reference's Fixable dropout); ``SegmentationModel.
begin_episode`` redraws it.  A rate of None or 0 is the identity, as Flax's
``nn.Dropout(0.0)`` is.

The JAX package computes PseudoConv3dModel's 3x3x3 convolutions as
``ZDecomposedConv3d``, three 2D convolutions over z-shifted plane stacks,
because XLA's 3D convolution is slow on the TPU; it is the same SAME
convolution, so the port's ``ZDecomposedConv3d`` is an ``nn.Conv3d``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["UNet", "UNetv2", "DeeplySupervisedUNet", "DoubleConv", "Down",
           "Up", "OutConv", "SelfAttn2d", "SpectralConv2d", "FrozenStatsBN",
           "FrozenStatsBN3d", "EpisodeDropout", "ZDecomposedConv3d",
           "PseudoConv3dModel", "init_unet_"]

LAST_LAYER_ACTS = (None, "softmax", "sigmoid")


class _StatsWriter:
    """A module whose training forward may write statistics back: only
    while ``write_back`` is set (``SegmentationModel.apply_train`` and the
    adaptive-BN forward set it; the JAX package's mutable ``batch_stats``
    collection)."""

    write_back = False


class _FrozenStats(_StatsWriter):
    """Training mode uses batch statistics without updating the running
    ones, unless ``write_back`` is set (the JAX package's TorchBatchNorm
    with a mutable ``batch_stats`` collection); eval mode uses the running
    ones."""

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


def _l2_normalize(x, eps):
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralConv2d(_StatsWriter, nn.Conv2d):
    """``nn.Conv2d`` under ``flax.linen.SpectralNorm(n_steps=1)`` (the JAX
    package's ``apply_maybe_spectral``).  Every forward, frozen ones
    included, takes one power iteration from the stored ``u`` (1, O) on the
    kernel as Flax lays it out, (kH * kW * I, O); ``u`` and ``v`` carry no
    gradient, ``sigma = v W u^T`` carries the kernel's, and the kernel is
    divided by ``sigma`` (0 maps to 1).  The bias is not normalised.  ``u``
    and ``sigma`` are written back only in a training forward with
    ``write_back`` set, never in a solver pass: neither torch's
    ``spectral_norm`` in eval mode (no iteration) nor in train mode (a write
    on every forward).  Buffers ``u`` and ``sigma`` carry Flax's
    ``<conv>/kernel/u`` and ``/sigma``."""

    eps = 1e-12

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size, **kwargs):
        super().__init__(in_channels, out_channels, kernel_size, **kwargs)
        self.register_buffer("u", torch.randn(1, out_channels))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self):
        w = self.weight
        mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
        with torch.no_grad():
            v = _l2_normalize(self.u @ mat.T, self.eps)
            u = _l2_normalize(v @ mat, self.eps)
        sigma = (v @ mat @ u.T)[0, 0]
        if self.training and self.write_back:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x):
        return self._conv_forward(x, self.normalized_weight(), self.bias)


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


def _dropout(p) -> EpisodeDropout:
    return EpisodeDropout(0.0 if p is None else p)


class DoubleConv(nn.Module):
    """(3x3 conv -> BN -> ReLU) x 2; ``spectral``: both convolutions under
    spectral norm (the reference's ``if_SN``)."""

    def __init__(self, in_ch: int, out_ch: int, spectral: bool = False):
        super().__init__()
        conv = SpectralConv2d if spectral else nn.Conv2d
        self.conv = nn.Sequential(
            conv(in_ch, out_ch, 3, padding=1), FrozenStatsBN(out_ch),
            nn.ReLU(inplace=True),
            conv(out_ch, out_ch, 3, padding=1), FrozenStatsBN(out_ch),
            nn.ReLU(inplace=True))

    def forward(self, x):
        return self.conv(x)


class InConv(nn.Module):
    """The input block (reference ``inconv``: a DoubleConv under
    ``.conv``)."""

    def __init__(self, in_ch: int, out_ch: int, spectral: bool = False):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch, spectral)

    def forward(self, x):
        return self.conv(x)


class Down(nn.Module):
    """2x2 max pool, then DoubleConv, then dropout."""

    def __init__(self, in_ch: int, out_ch: int, dropout=None,
                 spectral: bool = False):
        super().__init__()
        self.mpconv = nn.Sequential(nn.MaxPool2d(2),
                                    DoubleConv(in_ch, out_ch, spectral))
        self.drop = _dropout(dropout)

    def forward(self, x):
        return self.drop(self.mpconv(x))


class Up(nn.Module):
    """Bilinear x2 (align_corners=True), pad the skip to match, concat
    [skip, x], dropout on the concatenation, DoubleConv."""

    def __init__(self, in_ch: int, out_ch: int, dropout=None,
                 spectral: bool = False):
        super().__init__()
        self.drop = _dropout(dropout)
        self.conv = DoubleConv(in_ch, out_ch, spectral)

    def forward(self, x, skip):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        dh = x.shape[2] - skip.shape[2]
        dw = x.shape[3] - skip.shape[3]
        skip = F.pad(skip, (dw // 2, int(dw / 2), dh // 2, int(dh / 2)))
        return self.conv(self.drop(torch.cat([skip, x], dim=1)))


class OutConv(nn.Module):
    """1x1 conv head."""

    def __init__(self, in_ch: int, num_classes: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, num_classes, 1)

    def forward(self, x):
        return self.conv(x)


class SelfAttn2d(nn.Module):
    """Spatial self-attention (the reference's Self_Attn): 1x1 query and
    key convolutions to C // ``factor`` channels, a 1x1 value convolution,
    ``softmax(q k^T)`` over the last axis, ``gamma * (attention v) + x``.
    Returns (that, ``gamma * (attention v)``, the attention map (N, HW,
    HW)).  The two products run in f32 whatever the input's dtype (JAX's
    ``preferred_element_type=float32``) and the output takes the input's
    dtype; in JAX's bf16 mode the f32 output instead promotes the layers
    after it to f32."""

    def __init__(self, in_dim: int, factor: int = 8):
        super().__init__()
        self.query_conv = nn.Conv2d(in_dim, in_dim // factor, 1)
        self.key_conv = nn.Conv2d(in_dim, in_dim // factor, 1)
        self.value_conv = nn.Conv2d(in_dim, in_dim, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        n, c, h, w = x.shape
        q = self.query_conv(x).flatten(2).transpose(1, 2).float()
        k = self.key_conv(x).flatten(2).float()
        v = self.value_conv(x).flatten(2).transpose(1, 2).float()
        attention = torch.softmax(torch.matmul(q, k), dim=-1)
        out = torch.matmul(attention, v).transpose(1, 2).reshape(n, c, h, w)
        weighted = self.gamma.float() * out
        return (weighted + x.float()).to(x.dtype), weighted, attention


def _last_act(y, act):
    if act == "softmax":
        return torch.softmax(y, dim=1)
    if act == "sigmoid":
        return torch.sigmoid(y)
    return y


class UNet(nn.Module):
    """Reference UNet.  ``encoder_dropout``: dropout after ``inc`` and after
    each ``Down``'s DoubleConv; ``decoder_dropout``: on each ``Up``'s
    concatenation; ``self_attention``: :class:`SelfAttn2d` at the
    bottleneck; ``spectral``: spectral norm on every inc / down / up
    convolution (not the head); ``last_layer_act``: None, ``"softmax"``
    over the classes or ``"sigmoid"``.  Each forward keeps the bottleneck
    as ``hidden_feature`` and, with self-attention, its map as
    ``attention_map``, both detached (the JAX package's ``sow``)."""

    def __init__(self, input_channel: int = 1, num_classes: int = 4,
                 feature_scale: int = 1, encoder_dropout=None,
                 decoder_dropout=None, self_attention: bool = False,
                 spectral: bool = False, last_layer_act=None):
        super().__init__()
        if last_layer_act not in LAST_LAYER_ACTS:
            raise NotImplementedError(f"last_layer_act {last_layer_act!r}")
        fs, sn = feature_scale, spectral
        enc, dec = encoder_dropout, decoder_dropout
        self.last_layer_act = last_layer_act
        self.inc = InConv(input_channel, 64 // fs, sn)
        self.drop = _dropout(enc)
        self.down1 = Down(64 // fs, 128 // fs, enc, sn)
        self.down2 = Down(128 // fs, 256 // fs, enc, sn)
        self.down3 = Down(256 // fs, 512 // fs, enc, sn)
        self.down4 = Down(512 // fs, 512 // fs, enc, sn)
        self.self_atn = SelfAttn2d(512 // fs) if self_attention else None
        self.up1 = Up(1024 // fs, 256 // fs, dec, sn)
        self.up2 = Up(512 // fs, 128 // fs, dec, sn)
        self.up3 = Up(256 // fs, 64 // fs, dec, sn)
        self.up4 = Up(128 // fs, 64 // fs, dec, sn)
        self.outc = OutConv(64 // fs, num_classes)
        self.hidden_feature = None
        self.attention_map = None

    def forward(self, x):
        x1 = self.drop(self.inc(x))
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        self.hidden_feature = x5.detach()
        if self.self_atn is not None:
            x5, _, attention = self.self_atn(x5)
            self.attention_map = attention.detach()
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        y = self.up4(y, x1)
        return _last_act(self.outc(y), self.last_layer_act)

    def init_weights_(self, generator: torch.Generator):
        return init_unet_(self, generator)


class UNetv2(UNet):
    """Reference UNetv2: the UNet with a 1024 // fs wide bottleneck
    (``down4``, ``up1`` and the self-attention widen), no spectral norm
    and no head activation."""

    def __init__(self, input_channel: int = 1, num_classes: int = 4,
                 feature_scale: int = 1, encoder_dropout=None,
                 decoder_dropout=None, self_attention: bool = False):
        super().__init__(input_channel, num_classes, feature_scale,
                         encoder_dropout, decoder_dropout, self_attention)
        fs = feature_scale
        self.down4 = Down(512 // fs, 1024 // fs, encoder_dropout)
        if self_attention:
            self.self_atn = SelfAttn2d(1024 // fs)
        self.up1 = Up(1536 // fs, 256 // fs, decoder_dropout)


class DeeplySupervisedUNet(nn.Module):
    """Reference DeeplySupervisedUNet: a UNet of ``base_n_filters``
    channels whose ``up2`` and ``up3`` outputs feed 1x1 heads
    (``up2_conv1``, ``up3_conv1``), upsampled and added into the output.
    ``dropout`` is applied, as in the JAX package, to x3, x4 and x5 (a mask
    each) and on ``up1``-``up3``'s concatenations, not on ``up4``'s.
    ``forward(x, multi_out=True)`` returns (the head's output, the upsampled
    deep-supervision sum, their sum)."""

    def __init__(self, input_channel: int = 1, num_classes: int = 4,
                 base_n_filters: int = 64, dropout=None):
        super().__init__()
        b = base_n_filters
        self.inc = InConv(input_channel, b)
        self.down1 = Down(b, b * 2)
        self.down2 = Down(b * 2, b * 4)
        self.down3 = Down(b * 4, b * 8)
        self.down4 = Down(b * 8, b * 8)
        self.drop3, self.drop4, self.drop5 = (_dropout(dropout)
                                              for _ in range(3))
        self.up1 = Up(b * 16, b * 4, dropout)
        self.up2 = Up(b * 8, b * 2, dropout)
        self.up2_conv1 = OutConv(b * 2, num_classes)
        self.up3 = Up(b * 4, b, dropout)
        self.up3_conv1 = OutConv(b, num_classes)
        self.up4 = Up(b * 2, b)
        self.outc = OutConv(b, num_classes)

    def forward(self, x, multi_out: bool = False):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.drop3(self.down2(x2))
        x4 = self.drop4(self.down3(x3))
        x5 = self.drop5(self.down4(x4))
        y = self.up1(x5, x4)
        x_2 = self.up2(y, x3)
        x_3 = self.up3(x_2, x2)
        mixed = _upsample2x(self.up2_conv1(x_2)) + self.up3_conv1(x_3)
        mixed_up = _upsample2x(mixed)
        out = self.outc(self.up4(x_3, x1))
        final = out + mixed_up
        if multi_out:
            return out, mixed_up, final
        return final

    def init_weights_(self, generator: torch.Generator):
        return init_unet_(self, generator)


def _upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


class ZDecomposedConv3d(nn.Conv3d):
    """A 3x3x3 SAME convolution with bias (the JAX package's
    ``ZDecomposedConv3d(features)``, a TPU layout of the same
    convolution)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__(in_channels, features, 3, padding=1)


class PseudoConv3dModel(nn.Module):
    """The reference's small 3D demo model: Conv3d(1 -> 8, 3, pad 1) ->
    BN3d -> ReLU -> dropout -> Conv3d(8 -> classes, 3, pad 1).  Parameter
    names ``conv1``, ``bn1``, ``conv2`` follow the Flax module's."""

    def __init__(self, num_classes: int = 4, dropout: float = 0.1,
                 input_channel: int = 1):
        super().__init__()
        self.conv1 = ZDecomposedConv3d(input_channel, 8)
        self.bn1 = FrozenStatsBN3d(8)
        self.drop = EpisodeDropout(dropout)
        self.conv2 = ZDecomposedConv3d(8, num_classes)

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
    (fan_in, gain 2), except the self-attention's 1x1 convolutions, which
    keep Flax's default gain 1 (lecun normal, here not truncated); conv
    biases 0; a spectral ``u`` ~ N(0, 1) and ``sigma`` 1; BN weight ~ N(1,
    bn_weight_std), BN bias 0; the self-attention's ``gamma`` 0.  Draws on
    the generator's device and copies into the parameters."""
    lecun = {id(c) for m in model.modules() if isinstance(m, SelfAttn2d)
             for c in m.children()}

    def draw(shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            gain = 1.0 if id(m) in lecun else 2.0
            m.weight.copy_(draw(m.weight.shape)
                           * math.sqrt(gain / m.weight[0].numel()))
            if m.bias is not None:
                m.bias.zero_()
            if isinstance(m, SpectralConv2d):
                m.u.copy_(draw(m.u.shape))
                m.sigma.fill_(1.0)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.weight.copy_(1.0 + bn_weight_std * draw(m.weight.shape))
            m.bias.zero_()
            m.reset_running_stats()
        elif isinstance(m, SelfAttn2d):
            m.gamma.zero_()
    return model
