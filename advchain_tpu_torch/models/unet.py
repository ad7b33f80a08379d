"""The reference UNet family and the 3D demo model as torch ``nn.Module``s
(port of advchain_tpu/models/unet.py: UNet with DoubleConv / Down / Up /
OutConv and its options, UNetv2, DeeplySupervisedUNet, SelfAttn2d,
PseudoConv3dModel), and the 3D U-Net of Cicek et al. 2016
(:class:`UNet3D`), which the JAX package does not have.

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

Inside a spatially partitioned step's space group
(``ops.collectives.current_space``) each rank holds its rows of the
leading spatial axis of every activation (H, or D for PseudoConv3dModel):
equal slabs at the input, and on each inner level the rows of that
level's ``ops.collectives.Partition``, which may be uneven or, on a small
level, empty.  A convolution or pooling window reads the rows it needs
past its own (``SpaceGroup.fetch``: the neighbours' halos, or the gathered
level where some rank holds too few rows) and zero-pads the other axes
only, the rows past the level's ends being the padding; its output row
belongs to the rank holding its window's centre (a 2x2 pool's first row,
so an odd level drops its last row as the floor pool does).  The bilinear
x2 computes the rows of its skip's partition (or doubles each rank's rows)
from the global coordinate; ``pad_or_crop_to`` pads or crops global rows;
BatchNorm's statistics and dropout's mask span every rank and the level's
global height; the self-attention gathers every rank's keys and values.
A rank that holds no row of a level still takes part in every collective,
and its empty outputs carry zero gradients to the weights, so every rank's
backward runs the same collectives.

The JAX package computes PseudoConv3dModel's 3x3x3 convolutions as
``ZDecomposedConv3d``, three 2D convolutions over z-shifted plane stacks,
because XLA's 3D convolution is slow on the TPU; it is the same SAME
convolution, so the port's ``ZDecomposedConv3d`` is an ``nn.Conv3d``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from advchain_tpu_torch._trace import count, to_device, trace
from advchain_tpu_torch.kernels import batch_norm as bn_pair
from advchain_tpu_torch.kernels.conv3d_wgrad import (conv3d_same,
                                                     scratch_fits, takes_pair)
from advchain_tpu_torch.ops import collectives

__all__ = ["UNet", "UNetv2", "DeeplySupervisedUNet", "DoubleConv", "Down",
           "Up", "OutConv", "SelfAttn2d", "SpectralConv2d", "SlabConv2d",
           "SlabConv3d", "MaxPool2x2", "FrozenStatsBN",
           "FrozenStatsBN3d", "EpisodeDropout", "ZDecomposedConv3d",
           "PseudoConv3dModel", "DoubleConv3d", "UNet3D", "init_unet_",
           "max_pool_2x2",
           "upsample2x_align_corners", "upsample_to_skip", "pad_or_crop_to",
           "pad_rows",
           "apply_maybe_spectral", "kaiming_conv_init", "bn_scale_init"]

LAST_LAYER_ACTS = (None, "softmax", "sigmoid")


def kaiming_conv_init(shape, generator: torch.Generator, device=None):
    """torch's ``kaiming_normal_(mode='fan_in')``, the JAX package's
    ``kaiming_conv_init``: N(0, 2 / fan_in) for a kernel laid out (O, I,
    *k), fan_in = I * prod(k); drawn on ``device`` (the generator's)."""
    fan_in = math.prod(shape[1:])
    return torch.randn(shape, generator=generator,
                       device=generator.device if device is None
                       else device) * math.sqrt(2.0 / fan_in)


def bn_scale_init(shape, generator: torch.Generator, device=None):
    """The reference's BatchNorm weight init: N(1, 0.02)."""
    return 1.0 + 0.02 * torch.randn(
        shape, generator=generator,
        device=generator.device if device is None else device)


def _empty_rows(x, shape, *tensors):
    """Zeros of ``shape`` (no row on the leading spatial axis) wired to
    ``x`` and ``tensors`` with zero gradients: a rank that holds no row of
    a level still gives its weights a gradient and reaches, in its
    backward, every collective the other ranks' backward runs."""
    tie = sum(t.sum() * 0 for t in (x,) + tensors if t is not None)
    return x.new_zeros(shape) + tie


def _slab_window(x, sg, kernel: int, stride: int, padding: int,
                 dilation: int):
    """For a window op along the leading spatial axis of ``x`` (this
    rank's rows of its level): (the input rows this rank's output rows
    read, zeros past the level's ends; the output level's partition; this
    rank's output rows)."""
    part = sg.level(x)
    out = part.window(kernel, stride, padding, dilation)
    span = dilation * (kernel - 1) + 1
    windows = [(j * stride - padding, (j + e - 1) * stride - padding + span)
               if e else (0, 0) for j, e in zip(out.offsets, out.extents)]
    return sg.fetch(x, part, windows), out, out.extents[sg.index]


def _window_shape(x, kernel, stride, padding, dilation):
    """The output extents of a window op on the axes after the leading
    spatial one."""
    return tuple((s + 2 * p - d * (k - 1) - 1) // t + 1 for s, k, t, p, d in
                 zip(x.shape[3:], kernel, stride, padding, dilation))


def max_pool_2x2(x):
    """2x2 / 2 max pool (``nn.MaxPool2d(2)``: floor).  Inside a space group
    each output row belongs to the rank holding its window's first row,
    which reads the second from the next rank where the window straddles a
    seam."""
    sg = collectives.current_space()
    if sg is None:
        return F.max_pool2d(x, 2)
    xw, out, rows = _slab_window(x, sg, 2, 2, 0, 1)
    if rows:
        y = F.max_pool2d(xw, 2)
    else:
        y = _empty_rows(xw, x.shape[:2] + (0, x.shape[3] // 2))
    return sg.register(y, out)


class MaxPool2x2(nn.MaxPool2d):
    """``nn.MaxPool2d(2)`` through :func:`max_pool_2x2` (partitioned
    inside a space group)."""

    def __init__(self):
        super().__init__(2)

    def forward(self, x):
        return max_pool_2x2(x)


def pad_or_crop_to(skip, target_h: int, target_w: int):
    """Pad, or for a negative difference crop, ``skip`` (N, C, H, W)
    toward (target_h, target_w) as the reference's ``up`` does: ``d // 2``
    before and ``int(d / 2)`` after (so an odd positive difference leaves
    it one short, as in the JAX package's ``_pad_or_crop_to``).  Inside a
    space group ``target_h`` is the global height and the rows padded or
    cropped are the level's global first and last ones
    (:func:`pad_rows`)."""
    dw = target_w - skip.shape[3]
    sg = collectives.current_space()
    if sg is None:
        dh = target_h - skip.shape[2]
        return F.pad(skip, (dw // 2, int(dw / 2), dh // 2, int(dh / 2)))
    dh = target_h - sg.level(skip).height
    return pad_rows(skip, dh // 2, int(dh / 2), sg, (dw // 2, int(dw / 2)))


def pad_rows(x, before: int, after: int, sg, pads=()):
    """``x`` (this rank's rows of a level) with ``before`` / ``after`` zero
    rows added at the level's global ends (negative: rows cropped there),
    and ``F.pad``'s ``pads`` on the axes after the leading one: added rows
    go to the first and last rank, a cropped row leaves its owner,
    whichever rank that is."""
    part = sg.level(x)
    new = part.padded(before, after)
    o, e = part.rows(sg.index)
    start, size = new.rows(sg.index)
    lo = max(start, o + before)
    kept = max(0, min(start + size, o + e + before) - lo)
    piece = x.narrow(2, lo - o - before if kept else 0, kept)
    top = lo - start if kept else size
    pads = list(pads) + [0, 0] * (x.dim() - 3 - len(pads) // 2)
    return sg.register(F.pad(piece, pads + [top, size - top - kept]), new)


class _HaloConv:
    """A convolution whose leading spatial axis, inside a space group,
    reads the rows past its own that its windows need (the rows past the
    level's ends are its zero padding) and gives the rows of its output
    level (:func:`_slab_window`); the other axes keep their padding."""

    def _conv_forward(self, x, weight, bias):
        sg = collectives.current_space()
        if sg is None:
            return super()._conv_forward(x, weight, bias)
        xw, out, rows = _slab_window(x, sg, weight.shape[2], self.stride[0],
                                     self.padding[0], self.dilation[0])
        if not rows:
            shape = (x.shape[0], weight.shape[0], 0) + _window_shape(
                x, weight.shape[3:], self.stride[1:], self.padding[1:],
                self.dilation[1:])
            return sg.register(_empty_rows(xw, shape, weight, bias), out)
        conv = F.conv2d if x.dim() == 4 else F.conv3d
        return sg.register(conv(xw, weight, bias, self.stride,
                                (0,) + tuple(self.padding[1:]),
                                self.dilation, self.groups), out)


class SlabConv2d(_HaloConv, nn.Conv2d):
    """``nn.Conv2d`` (zero padding) that a space group partitions on H."""


class SlabConv3d(_HaloConv, nn.Conv3d):
    """``nn.Conv3d`` (zero padding) that a space group partitions on D."""


class _StatsWriter:
    """A module whose training forward may write statistics back: only
    while ``write_back`` is set (``SegmentationModel.apply_train`` and the
    adaptive-BN forward set it; the JAX package's mutable ``batch_stats``
    collection)."""

    write_back = False


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch normalisation over the global batch of a data
    group (``ops.collectives.data_group``), two-pass: the per-channel sums
    all-reduced give the global mean, then the squared deviations
    all-reduced give the biased variance.  The backward all-reduces the two
    per-channel sums of the cotangent (``dy`` and ``dy * xhat``) the input
    gradient needs; the weight and bias gradients stay this rank's own
    sums, which the step all-reduces with every other parameter gradient.
    Computes in f32 and returns the input's dtype; also returns the mean
    and biased variance for the running statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group, count):
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        mean = collectives.all_reduce(xf.sum(dims), group=group) / count
        dev = xf - mean.view(shape)
        var = collectives.all_reduce((dev * dev).sum(dims),
                                     group=group) / count
        invstd = torch.rsqrt(var + eps)
        xhat = dev * invstd.view(shape)
        y = xhat
        if weight is not None:
            y = y * weight.float().view(shape) + bias.float().view(shape)
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.group, ctx.count, ctx.dtype = group, count, x.dtype
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, invstd, weight = ctx.saved_tensors
        dims = [0] + list(range(2, xhat.dim()))
        shape = (1, -1) + (1,) * (xhat.dim() - 2)
        dy = dy.float()
        sum_dy = dy.sum(dims)
        sum_dy_xhat = (dy * xhat).sum(dims)
        dx = None
        if ctx.needs_input_grad[0]:
            both = collectives.all_reduce(torch.stack([sum_dy, sum_dy_xhat]),
                                          group=ctx.group) / ctx.count
            scale = invstd if weight is None else invstd * weight.float()
            dx = (scale.view(shape)
                  * (dy - both[0].view(shape) - xhat * both[1].view(shape))
                  ).to(ctx.dtype)
        dw = db = None
        if weight is not None:
            dw = sum_dy_xhat.to(weight.dtype)
            db = sum_dy.to(weight.dtype)
        return dx, dw, db, None, None, None


class _FrozenStats(_StatsWriter):
    """Training mode uses batch statistics without updating the running
    ones, unless ``write_back`` is set (the JAX package's TorchBatchNorm
    with a mutable ``batch_stats`` collection); eval mode uses the running
    ones.  Outside a data group a CUDA f32 4D contiguous input in training
    mode keeps ``F.batch_norm``'s forward and write-back and takes the
    port's deterministic backward pair (``kernels.batch_norm.takes_pair``);
    every other input keeps ``F.batch_norm``.  Inside a data group
    (``ops.collectives.data_group``) training mode normalises by the
    global batch's statistics (every rank's rows and, with a space group,
    slabs), and the write-back takes the unbiased variance over the global
    count."""

    def forward(self, x):
        return self._normalize(x, self.weight, self.bias)

    def _normalize(self, x, weight, bias):
        """The normalisation with this affine ``weight`` and ``bias`` (a
        subclass may derive them from its parameters)."""
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                weight, bias, training=False, eps=self.eps)
        dg = collectives.current_data_group()
        if dg is None:
            stats = ((self.running_mean, self.running_var, self.momentum)
                     if self.write_back else None)
            if bn_pair.takes_pair(x, weight, bias, stats):
                return bn_pair.batch_norm_train(x, weight, bias, self.eps,
                                                stats)
            if self.write_back:
                return F.batch_norm(x, self.running_mean, self.running_var,
                                    weight, bias, training=True,
                                    momentum=self.momentum, eps=self.eps)
            return F.batch_norm(x, None, None, weight, bias, training=True,
                                eps=self.eps)
        count = dg.global_numel(x) // x.shape[1]
        y, mean, var = _GlobalBatchNorm.apply(x, weight, bias, self.eps,
                                              dg.group, count)
        if self.write_back:
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(
                    m * mean.to(self.running_mean.dtype))
                self.running_var.mul_(1 - m).add_(
                    m * (var * (count / (count - 1))).to(
                        self.running_var.dtype))
        return y


class FrozenStatsBN(_FrozenStats, nn.BatchNorm2d):
    """BatchNorm2d with frozen running statistics."""


class FrozenStatsBN3d(_FrozenStats, nn.BatchNorm3d):
    """BatchNorm3d with frozen running statistics."""


def _l2_normalize(x, eps):
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralConv2d(_StatsWriter, SlabConv2d):
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
    forward of the episode; inside a data group it is the global batch's
    mask (every row, and the level's every row), of which the rank keeps
    its part."""

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
            # inside a data group: the global batch's mask, this rank's rows
            # and its rows of the level
            dg = collectives.current_data_group()
            shape, part = tuple(x.shape), None
            if dg is not None:
                shape = (dg.n_global,) + shape[1:]
                if dg.space is not None:
                    part = dg.space.level(x)
                    shape = shape[:2] + (part.height,) + shape[3:]
            mask = torch.rand(shape, generator=gen,
                              device=x.device) >= self.p
            if dg is not None:
                mask = dg.rows(mask)
                if part is not None:
                    mask = dg.space.take(mask, part)
            self._mask = mask
        keep = 1.0 - self.p
        return torch.where(mask, x / keep, torch.zeros_like(x))


def _dropout(p) -> EpisodeDropout:
    return EpisodeDropout(0.0 if p is None else p)


def apply_maybe_spectral(in_ch: int, out_ch: int, kernel_size,
                         spectral: bool = False, **kwargs) -> nn.Conv2d:
    """A :class:`SpectralConv2d` with ``spectral`` (the reference's
    ``if_SN`` branches; the JAX package's ``apply_maybe_spectral``), else
    a :class:`SlabConv2d`; ``kwargs`` go to the convolution."""
    conv = SpectralConv2d if spectral else SlabConv2d
    return conv(in_ch, out_ch, kernel_size, **kwargs)


class DoubleConv(nn.Module):
    """(3x3 conv -> BN -> ReLU) x 2; ``spectral``: both convolutions under
    spectral norm (the reference's ``if_SN``)."""

    def __init__(self, in_ch: int, out_ch: int, spectral: bool = False):
        super().__init__()
        self.conv = nn.Sequential(
            apply_maybe_spectral(in_ch, out_ch, 3, spectral, padding=1),
            FrozenStatsBN(out_ch), nn.ReLU(inplace=True),
            apply_maybe_spectral(out_ch, out_ch, 3, spectral, padding=1),
            FrozenStatsBN(out_ch), nn.ReLU(inplace=True))

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
        self.mpconv = nn.Sequential(MaxPool2x2(),
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
        x, skip = upsample_to_skip(x, skip)
        return self.conv(self.drop(torch.cat([skip, x], dim=1)))


class OutConv(nn.Module):
    """1x1 conv head."""

    def __init__(self, in_ch: int, num_classes: int):
        super().__init__()
        self.conv = SlabConv2d(in_ch, num_classes, 1)

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
    after it to f32.

    Inside a space group the queries stay on the rank's rows and the keys
    and values of every rank's rows are gathered in rank order (row slabs
    concatenated are the global row-major order of HW; uneven or empty
    slabs padded on the wire), so the softmax runs over every key, as the
    dense block's does; the gather's backward sums the gathered gradient
    over the group and keeps this rank's part.  The attention map is then
    this rank's query rows, (N, hw, HW).
    ``gamma`` is replicated: the step sums its gradient over the ranks."""

    def __init__(self, in_dim: int, factor: int = 8):
        super().__init__()
        self.query_conv = SlabConv2d(in_dim, in_dim // factor, 1)
        self.key_conv = SlabConv2d(in_dim, in_dim // factor, 1)
        self.value_conv = SlabConv2d(in_dim, in_dim, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        n, c, h, w = x.shape
        q = self.query_conv(x).flatten(2).transpose(1, 2).float()
        k = self.key_conv(x).flatten(2)
        v = self.value_conv(x).flatten(2)
        sg = collectives.current_space()
        if sg is not None:  # one gather of every rank's keys and values
            kv = collectives.gather_slabs(
                torch.cat([k, v], 1), sg.group,
                extents=[e * w for e in sg.level(x).extents])
            k, v = kv.split([k.shape[1], c], dim=1)
        attention = torch.softmax(torch.matmul(q, k.float()), dim=-1)
        out = torch.matmul(attention, v.transpose(1, 2).float())
        out = out.transpose(1, 2).reshape(n, c, h, w)
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
        out = self.outc(self.up4(x_3, x1))
        # the heads' upsamplings give the rows of the levels they join
        mixed = (upsample2x_align_corners(self.up2_conv1(x_2), like=x_3)
                 + self.up3_conv1(x_3))
        mixed_up = upsample2x_align_corners(mixed, like=out)
        final = out + mixed_up
        if multi_out:
            return out, mixed_up, final
        return final

    def init_weights_(self, generator: torch.Generator):
        return init_unet_(self, generator)


def upsample2x_align_corners(x, like=None):
    """Bilinear x2 with align_corners=True (``nn.Upsample(scale_factor=2,
    mode='bilinear', align_corners=True)``).  Inside a space group this
    rank's rows of the global upsampling, on the level of ``like`` (a
    tensor of twice ``x``'s global height whose rows it joins) or, without
    ``like``, with each rank's rows doubled (:func:`_slab_upsample2x`);
    outside one ``like`` is not read."""
    sg = collectives.current_space()
    if sg is None:
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=True)
    part = sg.level(x)
    target = part.resized(2 * part.height) if like is None \
        else sg.level(like)
    return _slab_upsample2x(x, sg, part, target)


def upsample_to_skip(x, skip):
    """(``x`` upsampled x2, ``skip`` padded or cropped to it), the decoder
    blocks' first step; inside a space group the skip's global rows are
    padded or cropped first and the upsampling gives the rows of the
    result."""
    sg = collectives.current_space()
    if sg is None:
        x = upsample2x_align_corners(x)
        return x, pad_or_crop_to(skip, x.shape[2], x.shape[3])
    skip = pad_or_crop_to(skip, 2 * sg.level(x).height, 2 * x.shape[3])
    return upsample2x_align_corners(x, like=skip), skip


def _source_rows(rows_in: int, out_rows, acc):
    """The two input rows and the second's weight of each output row of
    the bilinear x2 (align_corners=True) of ``rows_in`` rows: PyTorch's
    source index ``i * (H - 1) / (2H - 1)`` and weights in the input's
    accumulation type ``acc``."""
    scale = acc(rows_in - 1) / acc(2 * rows_in - 1)
    src = scale * np.asarray(out_rows).astype(acc)
    lo = src.astype(np.int64)  # src >= 0: truncation is the floor
    return lo, lo + (lo < rows_in - 1), src - lo.astype(acc)


def _slab_upsample2x(x, sg, part, target):
    """The rows of ``target`` (a partition of 2H rows) of the bilinear x2
    (align_corners=True) of a tensor (N, C, h, W) whose H rows are split
    as ``part``: each output row ``i`` of the global H blends the two
    input rows at ``i * (H - 1) / (2H - 1)`` (:func:`_source_rows`), read
    from this rank's rows and the rows past them that it needs; W is
    upsampled locally (``F.interpolate`` with H unchanged leaves each row
    as it is)."""
    n, c, _, w = x.shape
    acc = np.float64 if x.dtype == torch.float64 else np.float32
    windows = []
    for o, e in zip(target.offsets, target.extents):
        lo, hi, _ = _source_rows(part.height, [o, o + e - 1], acc)
        windows.append((int(lo[0]), int(hi[1]) + 1) if e else (0, 0))
    xw = sg.fetch(x, part, windows)
    o, e = target.rows(sg.index)
    if not e:
        return sg.register(_empty_rows(xw, (n, c, 0, 2 * w)), target)
    xw = F.interpolate(xw, size=(xw.shape[2], 2 * w), mode="bilinear",
                       align_corners=True)
    lo, hi, lam1 = _source_rows(part.height, np.arange(o, o + e), acc)
    first = windows[sg.index][0]
    r0 = xw.index_select(2, to_device(lo - first, device=x.device))
    r1 = xw.index_select(2, to_device(hi - first, device=x.device))
    lam0 = to_device(acc(1) - lam1, x.dtype, x.device).view(1, 1, -1, 1)
    lam1 = to_device(lam1, x.dtype, x.device).view(1, 1, -1, 1)
    return sg.register(lam0 * r0 + lam1 * r1, target)


class ZDecomposedConv3d(SlabConv3d):
    """A 3x3x3 SAME convolution with bias (the JAX package's
    ``ZDecomposedConv3d(features)``, a TPU layout of the same
    convolution); a space group partitions it on D.  Outside a space
    group, in f32, a layer that the width rule gives to the port's
    deterministic kernel (``kernels.conv3d_wgrad.takes_pair`` and
    ``scratch_fits``: few channels) takes its weight and bias gradients
    from it (``Conv3dSame``); every other f32 call of that kind keeps
    cuDNN's and counts ``conv3d_wgrad.cudnn``; the slab call and other
    dtypes keep cuDNN's too."""

    def __init__(self, in_channels: int, features: int):
        super().__init__(in_channels, features, 3, padding=1)

    def _conv_forward(self, x, weight, bias):
        if (collectives.current_space() is None
                and x.dtype == weight.dtype == torch.float32
                and self.kernel_size == (3, 3, 3) and self.padding == (1, 1, 1)
                and self.stride == self.dilation == (1, 1, 1)):
            cout, cin = weight.shape[:2]
            if takes_pair(cin, cout) and scratch_fits(
                    x.shape[0], cin, cout, x.shape[2], x.shape[4]):
                return conv3d_same(x, weight, bias)
            count("conv3d_wgrad.cudnn")
        return super()._conv_forward(x, weight, bias)


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


class DoubleConv3d(nn.Module):
    """(3x3x3 SAME conv -> BN3d -> ReLU) x 2, the 3D U-Net's level:
    ``in_ch -> mid_ch -> out_ch``."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = ZDecomposedConv3d(in_ch, mid_ch)
        self.bn1 = FrozenStatsBN3d(mid_ch)
        self.conv2 = ZDecomposedConv3d(mid_ch, out_ch)
        self.bn2 = FrozenStatsBN3d(out_ch)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class UNet3D(nn.Module):
    """The 3D U-Net of Cicek et al. 2016 (arXiv:1606.06650, Fig. 2) with
    SAME padding, so the logits lie on the input's grid.  Analysis level
    ``l`` (0-3) is a :class:`DoubleConv3d` to ``b * 2**l`` then ``b *
    2**(l + 1)`` channels (``b = base_filters``; 32 is the paper's, a 512
    channel bottom), the upper three each followed by a 2x2x2 max pool.
    Synthesis level ``l`` (2-0) is a 2x2x2 stride-2 up-convolution that
    keeps its channels, the concatenation ``[skip, up]`` and a
    :class:`DoubleConv3d` to ``b * 2**(l + 1)`` twice; a 1x1x1 head gives
    the classes.  D, H and W must be divisible by 8.  The space-partitioned
    step is not implemented for it."""

    LEVELS = 4

    def __init__(self, input_channel: int = 1, num_classes: int = 4,
                 base_filters: int = 32):
        super().__init__()
        b = base_filters
        widths = [b * 2 ** (l + 1) for l in range(self.LEVELS)]
        self.encoder = nn.ModuleList(
            DoubleConv3d(input_channel if l == 0 else widths[l - 1],
                         b * 2 ** l, widths[l]) for l in range(self.LEVELS))
        below = widths[1:][::-1]  # the channels arriving from the level below
        self.upconv = nn.ModuleList(nn.ConvTranspose3d(c, c, 2, stride=2)
                                    for c in below)
        self.decoder = nn.ModuleList(
            DoubleConv3d(c + widths[l], widths[l], widths[l])
            for c, l in zip(below, range(self.LEVELS - 2, -1, -1)))
        self.head = nn.Conv3d(widths[0], num_classes, 1)

    def forward(self, x):
        if collectives.current_space() is not None:
            raise NotImplementedError("UNet3D has no space-partitioned path")
        scale = 2 ** (self.LEVELS - 1)
        if x.dim() != 5 or any(s % scale for s in x.shape[2:]):
            raise ValueError(f"UNet3D takes (N, C, D, H, W) with D, H and W "
                             f"divisible by {scale}, got {tuple(x.shape)}")
        skips = []
        with trace("advchain.model.encoder"):
            for l, level in enumerate(self.encoder):
                if l:
                    x = F.max_pool3d(x, 2, 2)
                x = level(x)
                skips.append(x)
        with trace("advchain.model.decoder"):
            x = skips.pop()
            for up, level in zip(self.upconv, self.decoder):
                x = level(torch.cat([skips.pop(), up(x)], dim=1))
            return self.head(x)

    def init_weights_(self, generator: torch.Generator):
        """The JAX package's UNet init, the up-convolutions included."""
        return init_unet_(self, generator)


@torch.no_grad()
def init_unet_(model: nn.Module, generator: torch.Generator,
               bn_weight_std: float = 0.02) -> nn.Module:
    """The JAX package's init, in place: conv kernels ~ kaiming normal
    (fan_in, gain 2; a 3D up-convolution's fan_in as torch's
    ``kaiming_normal_`` counts it, its output channels times its taps),
    except the self-attention's 1x1 convolutions, which keep Flax's
    default gain 1 (lecun normal, here not truncated); conv
    biases 0; a spectral ``u`` ~ N(0, 1) and ``sigma`` 1; BN weight ~ N(1,
    bn_weight_std), BN bias 0; the self-attention's ``gamma`` 0.  Draws on
    the generator's device and copies into the parameters."""
    lecun = {id(c) for m in model.modules() if isinstance(m, SelfAttn2d)
             for c in m.children()}

    def draw(shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
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
