"""The reference's building-block zoo as torch ``nn.Module``s (port of
advchain_tpu/models/blocks.py, itself a rebuild of the reference's
unet_parts.py and custom_layers.py).

The blocks take NCHW (NCDHW for the 3D ones and the norms given a volume)
and each names its submodules, parameters and buffers as the Flax module
does (``down_conv``, ``conv.conv1``, ``conv.bn1``, ``conv_input``,
``fc1``, ``norm_1.0`` for Flax's ``norm_1_0``, ...), so
``models.convert.flax_blocks_to_torch_state`` carries any block's Flax
tree across.  A block's input channel counts are constructor arguments
(Flax infers them); a decoder block takes the low-resolution input's
channels and the skip's.

BatchNorm is the UNet's :class:`FrozenStatsBN` / :class:`FrozenStatsBN3d`
(the JAX package's TorchBatchNorm): batch statistics in training mode,
written back only under ``write_back``, the running ones in eval mode,
and the global batch's statistics inside a data group.  Dropout is
:class:`EpisodeDropout`; a rate of None is the identity.  ``spectral``
wraps the convolutions the reference wraps in spectral norm
(:class:`SpectralConv2d`): the double convolution of ``ConvDown``, both
residual convolutions of the ``Res*`` blocks, and ``ResConv``'s
``conv_input`` too.

Inside a spatially partitioned step's space group
(``ops.collectives.current_space``) every block acts on its rank's rows of
each level (``ops.collectives.Partition``: uneven, or empty on a small
level), as the UNet's layers do (``models/unet.py``): the convolutions,
strided and dilated ones among them, the pools and ``ResConvUp``'s
transposed convolution read the rows past their own that their windows
need; the upsamplings give the rows of the skip they join, and the skip's
pad or crop acts on global rows; the channel gates' means and the
instance statistics sum over the space group (``collectives.space_sum``);
``spatial_pyramid_pool`` takes each rank's maxima over its rows of each
bin, then the maximum over the group, and sends each output's gradient to
one rank; the 3D blocks split D.  A replicated output's gradient on each
rank is that rank's part, as in the train step, which weights every
rank's loss by its share of the elements.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from advchain_tpu_torch.models.unet import (FrozenStatsBN, FrozenStatsBN3d,
                                            SlabConv2d, SlabConv3d,
                                            _FrozenStats, _GlobalBatchNorm,
                                            _dropout, _empty_rows,
                                            apply_maybe_spectral,
                                            kaiming_conv_init, max_pool_2x2,
                                            pad_rows,
                                            upsample2x_align_corners,
                                            upsample_to_skip)
from advchain_tpu_torch.ops import collectives
from advchain_tpu_torch.ops.resize import interpolate

__all__ = [
    "ConvDown", "ResConvDown", "ResConv", "ResBilinearUp", "ResConvUp",
    "DilationConv", "OutConvRelu", "SELayer", "CSELayer", "ChannelSELayer",
    "SpatialSELayer", "ChannelSpatialSELayer", "SqeUp",
    "BatchInstanceNorm", "AdaptiveInstanceNorm", "AdaptiveBatchNorm",
    "bilinear_additive_upsampling", "spatial_pyramid_pool",
    "UnetConv3", "UnetUp3", "normal_init", "xavier_init", "kaiming_init",
    "DomainDoubleConv", "DomainInConv", "DomainPoolDown", "DomainUp",
    "UnetConv2", "Conv2DBatchNorm", "Conv2DBatchNormRelu",
]


# ------------------------------------------------------------ initializers
def _draw(shape, generator, device):
    return torch.randn(shape, generator=generator,
                       device=generator.device if device is None else device)


def normal_init(shape, generator: torch.Generator, device=None):
    """N(0, 0.02^2) (the reference's ``weights_init_normal``)."""
    return 0.02 * _draw(shape, generator, device)


def xavier_init(shape, generator: torch.Generator, device=None):
    """Flax's ``xavier_normal``: N(0, 2 / (fan_in + fan_out)) for a
    kernel laid out (O, I, *k), fan_in = I * prod(k), fan_out = O *
    prod(k)."""
    receptive = math.prod(shape[2:])
    fan_avg = 0.5 * (shape[0] + shape[1]) * receptive
    return _draw(shape, generator, device) * math.sqrt(1.0 / fan_avg)


kaiming_init = kaiming_conv_init


# ------------------------------------------------------------- conv blocks
class _ConvPair(nn.Module):
    """conv3 -> BN -> ReLU -> conv3 -> BN (-> ReLU with ``relu_out``): the
    JAX package's DoubleConv inside a block (``relu_out``) and the
    ``Res*`` blocks' residual branch, ``_ResBody``; ``spectral`` wraps
    both convolutions."""

    def __init__(self, in_ch: int, out_ch: int, spectral: bool = False,
                 relu_out: bool = True):
        super().__init__()
        self.conv1 = apply_maybe_spectral(in_ch, out_ch, 3, spectral,
                                          padding=1)
        self.bn1 = FrozenStatsBN(out_ch)
        self.conv2 = apply_maybe_spectral(out_ch, out_ch, 3, spectral,
                                          padding=1)
        self.bn2 = FrozenStatsBN(out_ch)
        self.relu_out = relu_out

    def forward(self, x):
        x = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(x) if self.relu_out else x


class ConvDown(nn.Module):
    """Strided 3x3 convolution (stride 2, the channels kept), then a double
    convolution, then dropout (unet_parts.py:254-277).  ``spectral`` wraps
    the double convolution only."""

    def __init__(self, in_ch: int, out_ch: int, dropout=None,
                 spectral: bool = False):
        super().__init__()
        self.down_conv = SlabConv2d(in_ch, in_ch, 3, stride=2, padding=1)
        self.conv = _ConvPair(in_ch, out_ch, spectral)
        self.drop = _dropout(dropout)

    def forward(self, x):
        return self.drop(self.conv(self.down_conv(x)))


class _Residual(nn.Module):
    """``relu(conv_input(x) + body(x))``, then dropout: the ``Res*``
    blocks' tail; ``spectral_input`` wraps ``conv_input`` too."""

    def __init__(self, in_ch: int, out_ch: int, dropout, spectral: bool,
                 spectral_input: bool = False):
        super().__init__()
        self.conv_input = apply_maybe_spectral(in_ch, out_ch, 1,
                                               spectral_input)
        self.conv = _ConvPair(in_ch, out_ch, spectral, relu_out=False)
        self.drop = _dropout(dropout)

    def residual(self, x):
        return self.drop(F.relu(self.conv_input(x) + self.conv(x)))


class ResConvDown(_Residual):
    """2x2 max pool, then the residual double convolution
    (unet_parts.py:279-321).  ``spectral`` wraps the residual branch only,
    not ``conv_input`` (the reference's quirk, :308-309)."""

    def __init__(self, in_ch: int, out_ch: int, dropout=None,
                 spectral: bool = False):
        super().__init__(in_ch, out_ch, dropout, spectral)

    def forward(self, x):
        return self.residual(max_pool_2x2(x))


class ResConv(_Residual):
    """The residual double convolution (unet_parts.py:323-365); with
    ``spectral`` the residual branch and ``conv_input`` (:351-352)."""

    def __init__(self, in_ch: int, out_ch: int, dropout=None,
                 spectral: bool = False):
        super().__init__(in_ch, out_ch, dropout, spectral, spectral)

    def forward(self, x):
        return self.residual(x)


class ResBilinearUp(_Residual):
    """Bilinear x2 (align_corners=True) and a 3x3 convolution of ``x1``,
    concatenated [up, x2], then the residual double convolution
    (unet_parts.py:367-415; ``spectral``: the residual branch only).
    ``forward(x1, x2)``: ``x1`` of ``in_ch`` channels, the skip ``x2`` of
    ``skip_ch``."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int, dropout=None,
                 spectral: bool = False):
        super().__init__(in_ch + skip_ch, out_ch, dropout, spectral)
        self.up_conv = SlabConv2d(in_ch, in_ch, 3, padding=1)

    def forward(self, x1, x2):
        up = self.up_conv(upsample2x_align_corners(x1, like=x2))
        return self.residual(torch.cat([up, x2], dim=1))


class SlabConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that a space group partitions on H:
    ``forward(x, like=None)`` gives the rows of ``like``'s level (else
    output row ``i`` goes to the rank holding input row ``floor(i * H /
    H_out)``), each from the input rows whose taps reach it (zeros past
    the level's ends).  Its kernel must span its stride (``dilation *
    (kernel - 1) >= stride - 1``), as ``ResConvUp``'s does."""

    def forward(self, x, like=None):
        sg = collectives.current_space()
        if sg is None:
            return super().forward(x)
        part = sg.level(x)
        (k, s, p, d), w = (self.kernel_size[0], self.stride[0],
                           self.padding[0], self.dilation[0]), self.weight
        span = d * (k - 1)
        n_out = (part.height - 1) * s - 2 * p + span + \
            self.output_padding[0] + 1
        target = part.resized(n_out) if like is None else sg.level(like)
        windows = [((a + p - span) // s, (a + e - 1 + p) // s + 1) if e
                   else (0, 0) for a, e in zip(target.offsets,
                                               target.extents)]
        xw = sg.fetch(x, part, windows)
        a, e = target.rows(sg.index)
        if not e:
            shape = (x.shape[0], w.shape[1] * self.groups, 0) + tuple(
                (i - 1) * t - 2 * q + r * (kk - 1) + op + 1
                for i, kk, t, q, r, op in zip(
                    x.shape[3:], self.kernel_size[1:], self.stride[1:],
                    self.padding[1:], self.dilation[1:],
                    self.output_padding[1:]))
            return sg.register(_empty_rows(xw, shape, w, self.bias), target)
        y = F.conv_transpose2d(xw, w, self.bias, self.stride,
                               (0,) + tuple(self.padding[1:]),
                               (0,) + tuple(self.output_padding[1:]),
                               self.groups, self.dilation)
        # y's row r is the global row r + window start * s - p
        return sg.register(y.narrow(2, a - windows[sg.index][0] * s + p, e),
                           target)


class ResConvUp(_Residual):
    """Transposed 4x4 convolution (stride 2, padding 1: x2) of ``x1``,
    concatenated [up, x2], then the residual double convolution
    (unet_parts.py:417-467; ``spectral``: the residual branch only).
    Flax's ``ConvTranspose(padding="SAME")`` is this convolution with its
    kernel flipped in both spatial axes, which ``flax_blocks_to_torch_
    state`` does."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int, dropout=None,
                 spectral: bool = False):
        super().__init__(in_ch + skip_ch, out_ch, dropout, spectral)
        self.up_deconv = SlabConvTranspose2d(in_ch, in_ch, 4, stride=2,
                                             padding=1)

    def forward(self, x1, x2):
        return self.residual(torch.cat([self.up_deconv(x1, like=x2), x2],
                                       dim=1))


class DilationConv(nn.Module):
    """Dilated convolution (no bias, 'same' padding) -> BN -> ReLU ->
    dropout (unet_parts.py:200-216)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 dilation: int = 1, dropout=None):
        super().__init__()
        self.conv = SlabConv2d(in_ch, out_ch, kernel_size,
                               padding=dilation * (kernel_size - 1) // 2,
                               dilation=dilation, bias=False)
        self.bn = FrozenStatsBN(out_ch)
        self.drop = _dropout(dropout)

    def forward(self, x):
        return self.drop(F.relu(self.bn(self.conv(x))))


class OutConvRelu(nn.Module):
    """1x1 head with ``activation`` "relu" or None (unet_parts.py:
    648-664)."""

    def __init__(self, in_ch: int, num_classes: int,
                 activation: Optional[str] = "relu"):
        super().__init__()
        self.conv = SlabConv2d(in_ch, num_classes, 1)
        self.activation = activation

    def forward(self, x):
        x = self.conv(x)
        return F.relu(x) if self.activation == "relu" else x


# --------------------------------------------------- SE / recalibration
def _spatial_mean(x):
    """Each sample's and channel's mean over the spatial axes, (N, C);
    inside a space group over the level's every row."""
    sg = collectives.current_space()
    if sg is None:
        return x.mean(dim=tuple(range(2, x.dim())))
    count = sg.level(x).height * math.prod(x.shape[3:])
    return collectives.space_sum(x.sum(dim=tuple(range(2, x.dim()))),
                                 sg.group) / count


def _instance_norm(x, weight, bias, eps):
    """``F.instance_norm``: each sample's and channel's statistics over the
    spatial axes, biased variance; inside a space group over the level's
    every row (two passes, each summed over the group)."""
    sg = collectives.current_space()
    if sg is None:
        return F.instance_norm(x, weight=weight, bias=bias, eps=eps)
    shape = x.shape[:2] + (1,) * (x.dim() - 2)
    dev = x - _spatial_mean(x).view(shape)
    y = dev * torch.rsqrt(_spatial_mean(dev * dev) + eps).view(shape)
    if weight is not None:
        y = y * weight.view((1, -1) + (1,) * (x.dim() - 2))
    if bias is not None:
        y = y + bias.view((1, -1) + (1,) * (x.dim() - 2))
    return y


class _ChannelGate(nn.Module):
    """``x * sigmoid(fc2(relu(fc1(mean_hw(x)))))``."""

    def __init__(self, channels: int, reduction: int, bias: bool):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction, bias=bias)
        self.fc2 = nn.Linear(channels // reduction, channels, bias=bias)

    def forward(self, x):
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(_spatial_mean(x)))))
        return x * y[:, :, None, None]


class SELayer(_ChannelGate):
    """Squeeze-and-excitation, reduction 16 (unet_parts.py:469-485)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__(channels, reduction, bias=True)


class ChannelSELayer(_ChannelGate):
    """SE without biases, reduction 2 (custom_layers.py:10-38)."""

    def __init__(self, channels: int, reduction_ratio: int = 2):
        super().__init__(channels, reduction_ratio, bias=False)


class CSELayer(nn.Module):
    """Spatial gate: ``x * sigmoid(1x1 conv(x))`` (unet_parts.py:
    487-498)."""

    def __init__(self, channels: int):
        super().__init__()
        self.spatial_conv = SlabConv2d(channels, 1, 1)

    def forward(self, x):
        return x * torch.sigmoid(self.spatial_conv(x))


class SpatialSELayer(nn.Module):
    """Spatial squeeze, channel excitation (custom_layers.py:41-65)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = SlabConv2d(channels, 1, 1)

    def forward(self, x):
        return x * torch.sigmoid(self.conv(x))


class ChannelSpatialSELayer(nn.Module):
    """The larger of cSE and sSE (custom_layers.py:68-84)."""

    def __init__(self, channels: int, reduction_ratio: int = 2):
        super().__init__()
        self.cSE = ChannelSELayer(channels, reduction_ratio)
        self.sSE = SpatialSELayer(channels)

    def forward(self, x):
        return torch.maximum(self.cSE(x), self.sSE(x))


class SqeUp(nn.Module):
    """Bilinear x2 of ``x1``, the skip ``x2`` padded to it, concatenated
    [x2, x1], SE-gated, a double convolution, plus its spatially gated
    self, then dropout (unet_parts.py:589-636)."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int, dropout=None):
        super().__init__()
        self.sqe = SELayer(in_ch + skip_ch)
        self.conv = _ConvPair(in_ch + skip_ch, out_ch)
        self.cqe = CSELayer(out_ch)
        self.drop = _dropout(dropout)

    def forward(self, x1, x2):
        x1, x2 = upsample_to_skip(x1, x2)
        feature = self.conv(self.sqe(torch.cat([x2, x1], dim=1)))
        return self.drop(feature + self.cqe(feature))


# ------------------------------------------------------------------- norms
class BatchInstanceNorm(_FrozenStats,
                        nn.modules.batchnorm._BatchNorm):
    """Gated mix of batch and instance norm (custom_layers.py:246-307):
    ``BN(x; weight * gate, bias) + IN(x) * (weight * (1 - gate))``, on 4-D
    or 5-D input.  The batch branch is the UNet's BatchNorm (batch
    statistics in training mode, written back under ``write_back`` with
    the unbiased variance, global inside a data group; the running ones in
    eval mode); the instance branch always normalises each sample by its
    own statistics.  ``weight``, ``bias`` and ``gate`` start at 1, 0 and
    1."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__(num_features, eps, momentum)
        self.gate = nn.Parameter(torch.ones(num_features))

    def _check_input_dim(self, x):
        if x.dim() not in (4, 5):
            raise ValueError(f"expected 4-D or 5-D input, got {x.dim()}-D")

    def forward(self, x):
        out_bn = self._normalize(x, self.weight * self.gate, self.bias)
        return out_bn + _instance_norm(x, self.weight * (1.0 - self.gate),
                                       None, self.eps)


class AdaptiveInstanceNorm(nn.Module):
    """AdaIN (custom_layers.py:174-204): instance norm with the affine
    ``weight`` and ``bias`` (C,) passed to ``forward``."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x, weight, bias):
        return _instance_norm(x, weight, bias, self.eps)


class AdaptiveBatchNorm(nn.Module):
    """AdaBN (custom_layers.py:209-243, implemented as documented): batch
    norm by the batch's statistics, always, with the affine ``weight`` and
    ``bias`` (C,) passed to ``forward``; inside a data group the global
    batch's statistics."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x, weight, bias):
        dg = collectives.current_data_group()
        if dg is None:
            return F.batch_norm(x, None, None, weight, bias, training=True,
                                eps=self.eps)
        return _GlobalBatchNorm.apply(x, weight, bias, self.eps, dg.group,
                                      dg.global_numel(x) // x.shape[1])[0]


# -------------------------------------------------------------------- misc
def bilinear_additive_upsampling(x, output_channel_num: int):
    """Bilinear x2 (align_corners=True), then each group of ``C /
    output_channel_num`` consecutive channels summed (custom_layers.py:
    87-118): channel ``o * split + s`` joins output channel ``o``."""
    in_ch = x.shape[1]
    assert in_ch > output_channel_num, (
        "the number of output channels should not be greater than the "
        "number of input channels")
    assert in_ch % output_channel_num == 0, (
        "input channels must be equally divided by output_channel_num")
    up = upsample2x_align_corners(x)
    n, _, h, w = up.shape
    return up.view(n, output_channel_num, in_ch // output_channel_num,
                   h, w).sum(2)


def spatial_pyramid_pool(x, out_bin_sizes: Sequence[int]):
    """Spatial pyramid max pooling (custom_layers.py:310-336): for each
    bin count ``b`` a max pool of ceil(H / b) x ceil(W / b) windows over
    the input padded with -inf by ``(width * b - size + 1) // 2`` on each
    side, flattened and concatenated: (N, C * sum(b^2)).  Each level
    flattens in NCHW order (c, row, column), the reference's; the JAX
    package pools NHWC and flattens (row, column, c), a TPU layout
    (ROADMAP §3).  Inside a space group the bins span the level's global
    H: each rank pools its rows of each bin, the maxima over the group are
    the (replicated) output, and each output's gradient, summed over the
    group, goes to the lowest rank holding its maximum, as the dense
    pool's goes to the first one."""
    n, c, h, w = x.shape
    sg = collectives.current_space()
    if sg is not None:
        part = sg.level(x)
        h = part.height
    feats = []
    for bins in out_bin_sizes:
        h_wid, w_wid = math.ceil(h / bins), math.ceil(w / bins)
        h_pad = (h_wid * bins - h + 1) // 2
        w_pad = (w_wid * bins - w + 1) // 2
        if sg is None:
            padded = F.pad(x, (w_pad, w_pad, h_pad, h_pad), value=-math.inf)
            pooled = F.max_pool2d(padded, (h_wid, w_wid))
        else:
            pooled = _slab_pyramid_level(x, sg, part, h_wid, h_pad,
                                         (w_wid, w_pad))
        feats.append(pooled.reshape(n, -1))
    return torch.cat(feats, dim=1)


def _slab_pyramid_level(x, sg, part, h_wid, h_pad, w_bins):
    """One pyramid level inside a space group: each row window ``i`` (the
    level's global rows ``i * h_wid - h_pad`` onwards) pooled over this
    rank's rows of it (-inf where it holds none), then the maximum over
    the group (:class:`_GroupMax`)."""
    w_wid, w_pad = w_bins
    o, e = part.rows(sg.index)
    padded = F.pad(x, (w_pad, w_pad), value=-math.inf)
    n_cols = padded.shape[3] // w_wid
    rows = []
    for i in range((part.height + 2 * h_pad) // h_wid):
        lo = max(i * h_wid - h_pad, o)
        hi = min((i + 1) * h_wid - h_pad, o + e)
        if hi > lo:
            rows.append(F.max_pool2d(padded.narrow(2, lo - o, hi - lo),
                                     (hi - lo, w_wid)))
        else:
            rows.append(x.new_full(x.shape[:2] + (1, n_cols), -math.inf))
    local = torch.cat(rows, dim=2) + x.sum() * 0  # tied to x on every rank
    return _GroupMax.apply(local, sg.group, sg.index)


class _GroupMax(torch.autograd.Function):
    """The maximum of every rank's ``t`` over ``group``; the backward sums
    the gradient over the group (each rank's cotangent of the replicated
    maximum is its part) and gives it to the lowest rank whose ``t``
    attains the maximum."""

    @staticmethod
    def forward(ctx, t, group, index):
        top = collectives.all_reduce(t, "max", group)
        n = torch.distributed.get_world_size(group)
        ranks = torch.where(t == top, torch.full_like(t, index),
                            torch.full_like(t, n))
        ctx.save_for_backward(collectives.all_reduce(ranks, "min", group)
                              == index)
        ctx.group = group
        return top

    @staticmethod
    def backward(ctx, g):
        mine, = ctx.saved_tensors
        total = collectives.all_reduce(g.contiguous(), group=ctx.group)
        return torch.where(mine, total, torch.zeros_like(total)), None, None


# ---------------------------------------------------------------- 3D bits
class UnetConv3(nn.Module):
    """(3x3x3 convolution -> BN -> ReLU) x 2 (unet_parts.py:702-726)."""

    def __init__(self, in_ch: int, out_ch: int, use_batchnorm: bool = True):
        super().__init__()
        self.conv1 = SlabConv3d(in_ch, out_ch, 3, padding=1)
        self.conv2 = SlabConv3d(out_ch, out_ch, 3, padding=1)
        if use_batchnorm:
            self.bn1 = FrozenStatsBN3d(out_ch)
            self.bn2 = FrozenStatsBN3d(out_ch)
        self.use_batchnorm = use_batchnorm

    def forward(self, x):
        for i in (1, 2):
            x = getattr(self, f"conv{i}")(x)
            if self.use_batchnorm:
                x = getattr(self, f"bn{i}")(x)
            x = F.relu(x)
        return x


class UnetUp3(nn.Module):
    """3D decoder block (unet_parts.py:667-699, no transposed
    convolution): ``x`` upsampled trilinearly by ``z_scale_factor`` on
    every axis (align_corners=False), the skip padded to it (floor before,
    ceil after), concatenated [skip, up], then :class:`UnetConv3`.
    ``forward(skip, x)``: ``x`` of ``in_ch`` channels, ``skip`` of
    ``skip_ch``."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int,
                 z_scale_factor: int = 1, use_batchnorm: bool = True):
        super().__init__()
        self.conv = UnetConv3(in_ch + skip_ch, out_ch, use_batchnorm)
        self.z_scale_factor = z_scale_factor

    def forward(self, skip, x):
        f = self.z_scale_factor
        sg = collectives.current_space()
        if sg is None:
            up = interpolate(x, scale_factor=(f, f, f), mode="trilinear",
                             align_corners=False)
            pads = []
            for axis in (4, 3, 2):
                off = up.shape[axis] - skip.shape[axis]
                pads += [off // 2, off - off // 2]
            return self.conv(torch.cat([F.pad(skip, pads), up], dim=1))
        # the skip's D planes padded on the global planes, then this rank's
        # planes of the upsampling on them
        size = tuple(int(math.floor(s * f)) for s in
                     (sg.level(x).height,) + tuple(x.shape[3:]))
        pads = []
        for axis in (4, 3):
            off = size[axis - 2] - skip.shape[axis]
            pads += [off // 2, off - off // 2]
        off = size[0] - sg.level(skip).height
        skip = pad_rows(skip, off // 2, off - off // 2, sg, pads)
        up = interpolate(x, size=size, mode="trilinear", align_corners=False,
                         sharded=True, like=skip)
        return self.conv(torch.cat([skip, up], dim=1))


# ------------------------------------------------- domain-specific blocks
class DomainDoubleConv(nn.Module):
    """Double convolution whose BatchNorms are banks, one per domain
    (unet_parts.py:48-86): ``forward(x, domain_id)`` normalises with
    member ``domain_id`` (a Python int) of ``norm_1`` and ``norm_2``.
    Every member exists, so a state dict is complete."""

    def __init__(self, in_ch: int, out_ch: int, num_domains: int = 1):
        super().__init__()
        self.conv_1 = SlabConv2d(in_ch, out_ch, 3, padding=1)
        self.norm_1 = nn.ModuleList(FrozenStatsBN(out_ch)
                                    for _ in range(num_domains))
        self.conv_2 = SlabConv2d(out_ch, out_ch, 3, padding=1)
        self.norm_2 = nn.ModuleList(FrozenStatsBN(out_ch)
                                    for _ in range(num_domains))

    def forward(self, x, domain_id: int):
        x = F.relu(self.norm_1[domain_id](self.conv_1(x)))
        return F.relu(self.norm_2[domain_id](self.conv_2(x)))


class DomainInConv(nn.Module):
    """``domain_inconv`` (unet_parts.py:237-252): the domain double
    convolution, then dropout."""

    def __init__(self, in_ch: int, out_ch: int, num_domains: int = 1,
                 dropout=None):
        super().__init__()
        self.conv = DomainDoubleConv(in_ch, out_ch, num_domains)
        self.drop = _dropout(dropout)

    def forward(self, x, domain_id: int):
        return self.drop(self.conv(x, domain_id))


class DomainPoolDown(nn.Module):
    """``domain_pool_down`` (unet_parts.py:218-235): 2x2 max pool, the
    domain double convolution, dropout."""

    def __init__(self, in_ch: int, out_ch: int, num_domains: int = 1,
                 dropout=None):
        super().__init__()
        self.conv_block = DomainDoubleConv(in_ch, out_ch, num_domains)
        self.drop = _dropout(dropout)

    def forward(self, x, domain_id: int):
        return self.drop(self.conv_block(max_pool_2x2(x), domain_id))


class DomainUp(nn.Module):
    """``domain_up`` (unet_parts.py:544-584): bilinear x2 of ``x1``, the
    skip ``x2`` padded to it, concatenated [x2, x1], dropout, the domain
    double convolution."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int,
                 num_domains: int = 1, dropout=None):
        super().__init__()
        self.drop = _dropout(dropout)
        self.conv = DomainDoubleConv(in_ch + skip_ch, out_ch, num_domains)

    def forward(self, x1, x2, domain_id: int):
        x1, x2 = upsample_to_skip(x1, x2)
        return self.conv(self.drop(torch.cat([x2, x1], dim=1)), domain_id)


class UnetConv2(nn.Module):
    """``unetConv2`` (unet_parts.py:123-158): ``n`` stacked convolution
    (padding 1) -> BN (with ``use_batchnorm``) -> ReLU."""

    def __init__(self, in_ch: int, out_ch: int, use_batchnorm: bool = True,
                 n: int = 2, kernel_size: int = 3, stride: int = 1):
        super().__init__()
        for i in range(1, n + 1):
            self.add_module(f"conv{i}", SlabConv2d(
                in_ch if i == 1 else out_ch, out_ch, kernel_size,
                stride=stride, padding=1))
            if use_batchnorm:
                self.add_module(f"bn{i}", FrozenStatsBN(out_ch))
        self.n, self.use_batchnorm = n, use_batchnorm

    def forward(self, x):
        for i in range(1, self.n + 1):
            x = getattr(self, f"conv{i}")(x)
            if self.use_batchnorm:
                x = getattr(self, f"bn{i}")(x)
            x = F.relu(x)
        return x


class Conv2DBatchNorm(nn.Module):
    """``conv2DBatchNorm`` (unet_parts.py:88-103)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv = SlabConv2d(in_ch, out_ch, kernel_size, stride=stride,
                               padding=padding)
        self.bn = FrozenStatsBN(out_ch)

    def forward(self, x):
        return self.bn(self.conv(x))


class Conv2DBatchNormRelu(nn.Module):
    """``conv2DBatchNormRelu`` (unet_parts.py:105-121)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        self.cb = Conv2DBatchNorm(in_ch, out_ch, kernel_size, stride,
                                  padding)

    def forward(self, x):
        return F.relu(self.cb(x))
