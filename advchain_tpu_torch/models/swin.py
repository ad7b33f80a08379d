"""Swin-Unet (Cao et al., "Swin-Unet: Unet-like Pure Transformer for
Medical Image Segmentation", arXiv:2105.05537) as a torch module, which the
JAX package does not have.  The published code is
github.com/HuCaoFighting/Swin-Unet,
``networks/swin_transformer_unet_skip_expand_decoder_sys.py``
(``SwinTransformerSys``); module and parameter names follow it
(``patch_embed.proj``, ``layers.{i}.blocks.{j}.attn.qkv``,
``layers_up.{k}.upsample.expand``, ``concat_back_dim.{k}``, ``up.expand``,
``output``), so its state dicts load but for the
``relative_position_index`` and ``attn_mask`` buffers, which this module
keeps in the cache of device constants instead.

The forward (tokens are (B, H*W, C), row-major):

- a 1-channel input is repeated to 3 channels (the published
  ``SwinUnet.forward``); the patch embedding is a 4x4 stride-4 Conv2d to
  ``embed_dim`` and a LayerNorm;
- encoder stage i (C = embed_dim * 2**i, resolution R = img_size / 4 / 2**i)
  keeps its input as the skip, runs ``depths[i]`` blocks, and but for the
  last stage merges patches: the 2x2 neighbours concatenated (x[0::2,0::2],
  x[1::2,0::2], x[0::2,1::2], x[1::2,1::2]), LayerNorm(4C), a bias-free
  Linear 4C -> 2C; a LayerNorm after the last stage;
- a block is ``x + attn(LN1(x))``, then ``x + fc2(GELU(fc1(LN2(x))))``.
  The attention runs in w x w windows, w = min(window_size, R); every
  second block of a stage with R > window_size shifts them by
  ``window_size // 2`` (a cyclic roll, and a -100 mask between tokens of
  different regions of the rolled image).  Each head adds a learned
  relative-position bias ``table[index]`` to ``q k^T / sqrt(d)``;
- the decoder expands patches (a bias-free Linear C -> 2C, each token's
  channels spread over 2x2 tokens, LayerNorm(C / 2)), concatenates
  ``[x, skip]``, projects 2C -> C (``concat_back_dim``), runs the stage's
  blocks; then LayerNorm, a 4x expand to the input grid and a bias-free
  1x1 convolution to the classes.

The attention is one ``F.scaled_dot_product_attention`` a block, f32, with
the bias and the shift mask added into one float mask.  Inside a spatially
partitioned step's space group the module raises ``NotImplementedError``:
its windows would need halos across the row partition.  Nothing here keeps
batch statistics, so a data-parallel step needs nothing of it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from advchain_tpu_torch._consts import device_const
from advchain_tpu_torch._trace import count, to_device, trace
from advchain_tpu_torch.ops import collectives

PATCH = 4
SHIFT_MASK = -100.0


def stage_windows(resolution: int, window_size: int):
    """(w, shift) of a stage at ``resolution``: the window clamped to the
    resolution, and no shift where one window covers it."""
    if resolution <= window_size:
        return resolution, 0
    return window_size, window_size // 2


@device_const
def relative_position_index(w: int, device) -> torch.Tensor:
    """(w*w, w*w) int64: row ``(dy + w - 1) * (2w - 1) + dx + w - 1`` of the
    (2w-1)^2-row bias table for the offset (dy, dx) between two tokens of a
    window (the published ``relative_position_index``)."""
    ys, xs = torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")
    coords = torch.stack([ys.flatten(), xs.flatten()])
    rel = coords[:, :, None] - coords[:, None, :] + (w - 1)
    return to_device(rel[0] * (2 * w - 1) + rel[1], device=device)


@device_const
def shift_mask(resolution: int, w: int, shift: int, device) -> torch.Tensor:
    """(windows, w*w, w*w) f32: 0 between two tokens of a window of the
    rolled image that lie in the same region of it, -100 otherwise (the
    published ``attn_mask``)."""
    region = torch.zeros(resolution, resolution)
    cuts = (slice(0, -w), slice(-w, -shift), slice(-shift, None))
    for i, rows in enumerate(cuts):
        for j, cols in enumerate(cuts):
            region[rows, cols] = 3 * i + j
    ids = window_partition(region[None, :, :, None], w).flatten(1)
    mask = (ids[:, None, :] != ids[:, :, None]).float() * SHIFT_MASK
    return to_device(mask, device=device)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/w * W/w, w, w, C), windows row-major inside
    each image."""
    b, h, wd, c = x.shape
    x = x.view(b, h // w, w, wd // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w, w, c)


def window_reverse(windows: torch.Tensor, w: int, h: int,
                   wd: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`."""
    c = windows.shape[-1]
    x = windows.view(-1, h // w, wd // w, w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, wd, c)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside w x w windows with a learned
    relative-position bias per head."""

    def __init__(self, dim: int, window: int, num_heads: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.window, self.num_heads = window, num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """``x`` (windows, w*w, C), windows image-major; ``mask`` (windows
        of one image, w*w, w*w) or None."""
        b, n, c = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).view(b, n, 3, h, c // h).permute(
            2, 0, 3, 1, 4).unbind(0)
        with trace("advchain.model.window_attn"):
            count("swin.window_attn")
            index = relative_position_index(self.window, x.device)
            # contiguous: the fused kernels take no mask whose last
            # dimension is strided, and PyTorch gives such calls to its
            # unfused math backend
            bias = self.relative_position_bias_table[index].permute(
                2, 0, 1).contiguous()
            if mask is None:
                bias = bias.expand(b, -1, -1, -1)
            else:
                bias = (bias.unsqueeze(0) + mask.unsqueeze(1)).repeat(
                    b // mask.shape[0], 1, 1, 1)
            y = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        return self.proj(y.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """Pre-LayerNorm (shifted-)window attention and MLP, each residual."""

    def __init__(self, dim: int, resolution: int, num_heads: int,
                 window_size: int, shifted: bool, mlp_ratio: float,
                 qkv_bias: bool):
        super().__init__()
        self.resolution = resolution
        self.window, shift = stage_windows(resolution, window_size)
        self.shift = shift if shifted else 0
        if resolution % self.window:
            raise ValueError(f"a {resolution}-token stage does not split "
                             f"into {self.window}-token windows")
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, self.window, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        b, _, c = x.shape
        r, w, s = self.resolution, self.window, self.shift
        y = self.norm1(x).view(b, r, r, c)
        if s:
            y = torch.roll(y, shifts=(-s, -s), dims=(1, 2))
        mask = shift_mask(r, w, s, x.device) if s else None
        y = self.attn(window_partition(y, w).view(-1, w * w, c), mask)
        y = window_reverse(y.view(-1, w, w, c), w, r, r)
        if s:
            y = torch.roll(y, shifts=(s, s), dims=(1, 2))
        x = x + y.reshape(b, r * r, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 neighbours to one token: C -> 4C -> LayerNorm -> 2C."""

    def __init__(self, resolution: int, dim: int):
        super().__init__()
        self.resolution = resolution
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, _, c = x.shape
        r = self.resolution
        x = x.view(b, r, r, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1).view(b, -1, 4 * c)
        return self.reduction(self.norm(x))


class PatchExpand(nn.Module):
    """One token to s x s: a bias-free Linear C -> s*s*C/``shrink``, each
    token's channels ``(p1 p2 c)`` spread over its s x s tokens, then a
    LayerNorm of the C / ``shrink`` channels (s = 2, shrink 2: the
    published ``PatchExpand``; s = 4, shrink 1: ``FinalPatchExpand_X4``)."""

    def __init__(self, resolution: int, dim: int, scale: int = 2,
                 shrink: int = 2):
        super().__init__()
        self.resolution, self.scale = resolution, scale
        self.out = dim // shrink
        self.expand = nn.Linear(dim, scale * scale * self.out, bias=False)
        self.norm = nn.LayerNorm(self.out)

    def forward(self, x):
        b = x.shape[0]
        r, s, c = self.resolution, self.scale, self.out
        x = self.expand(x).view(b, r, r, s, s, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, r * s * r * s, c)
        return self.norm(x)


class SwinStage(nn.Module):
    """A stage's blocks (every second one shifted), then ``downsample``
    (the encoder's merging) or ``upsample`` (the decoder's expanding)."""

    def __init__(self, dim: int, resolution: int, depth: int, num_heads: int,
                 window_size: int, mlp_ratio: float, qkv_bias: bool,
                 downsample: bool = False,
                 upsample: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, resolution, num_heads, window_size, j % 2 == 1,
                      mlp_ratio, qkv_bias)
            for j in range(depth))
        self.downsample = PatchMerging(resolution, dim) if downsample \
            else None
        self.upsample = PatchExpand(resolution, dim) if upsample else None

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        for resample in (self.downsample, self.upsample):
            if resample is not None:
                x = resample(x)
        return x


class PatchEmbed(nn.Module):
    def __init__(self, in_chans: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, dim, PATCH, stride=PATCH)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        return self.norm(self.proj(x).flatten(2).transpose(1, 2))


class SwinUNet(nn.Module):
    """Swin-Unet (see the module's docstring) for square ``img_size``
    inputs, which the 4x4 patches and three mergings must divide into
    windows.  The defaults are the published Swin-T encoder of
    ``swin_tiny_patch4_window7_224_lite.yaml`` with 4 classes; 27.17 M
    parameters.  There is no stochastic depth (the published training's
    ``drop_path_rate`` of 0.1-0.2): every pass of a train step sees one
    network."""

    def __init__(self, img_size: int = 224, in_chans: int = 3,
                 num_classes: int = 4, embed_dim: int = 96,
                 depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True):
        super().__init__()
        self.img_size, self.in_chans = img_size, in_chans
        stages = len(depths)
        res = [img_size // PATCH // 2 ** i for i in range(stages)]
        dims = [embed_dim * 2 ** i for i in range(stages)]
        common = dict(window_size=window_size, mlp_ratio=mlp_ratio,
                      qkv_bias=qkv_bias)
        self.patch_embed = PatchEmbed(in_chans, embed_dim)
        self.layers = nn.ModuleList(
            SwinStage(dims[i], res[i], depths[i], num_heads[i],
                      downsample=i < stages - 1,
                      **common) for i in range(stages))
        self.norm = nn.LayerNorm(dims[-1])
        up = [PatchExpand(res[-1], dims[-1])]
        back = [nn.Identity()]
        for k in range(1, stages):
            i = stages - 1 - k
            back.append(nn.Linear(2 * dims[i], dims[i]))
            up.append(SwinStage(dims[i], res[i], depths[i], num_heads[i],
                                upsample=k < stages - 1,
                                **common))
        self.layers_up = nn.ModuleList(up)
        self.concat_back_dim = nn.ModuleList(back)
        self.norm_up = nn.LayerNorm(embed_dim)
        self.up = PatchExpand(res[0], embed_dim, scale=PATCH, shrink=1)
        self.output = nn.Conv2d(embed_dim, num_classes, 1, bias=False)

    def forward(self, x):
        if collectives.current_space() is not None:
            raise NotImplementedError("SwinUNet has no space-partitioned "
                                      "path")
        size = (self.img_size, self.img_size)
        if x.dim() != 4 or tuple(x.shape[2:]) != size:
            raise ValueError(f"SwinUNet({self.img_size}) takes (N, C, "
                             f"{size[0]}, {size[1]}), got {tuple(x.shape)}")
        if x.shape[1] == 1:
            x = x.repeat(1, self.in_chans, 1, 1)
        with trace("advchain.model.encoder"):
            x = self.patch_embed(x)
            skips = []
            for layer in self.layers:
                skips.append(x)
                x = layer(x)
            x = self.norm(x)
        with trace("advchain.model.decoder"):
            for k, (up, back) in enumerate(zip(self.layers_up,
                                               self.concat_back_dim)):
                if k:
                    x = back(torch.cat([x, skips[-1 - k]], -1))
                x = up(x)
            x = self.up(self.norm_up(x))
            b, _, c = x.shape
            x = x.transpose(1, 2).reshape(b, c, *size)
            return self.output(x)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        """The published init, in place: Linear weights and the
        relative-position tables ~ N(0, 0.02) truncated to +-2 (every draw
        lies far inside), Linear biases 0, LayerNorm weight 1 and bias 0;
        the two convolutions keep torch's default, U(+-1/sqrt(fan_in)) for
        weights and biases.  Draws on the generator's device and copies
        into the parameters."""
        def draw(shape):
            return torch.randn(shape, generator=generator,
                               device=generator.device)

        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_((0.02 * draw(m.weight.shape)).clamp_(-2, 2))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, WindowAttention):
                t = m.relative_position_bias_table
                t.copy_((0.02 * draw(t.shape)).clamp_(-2, 2))
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    if p is not None:
                        p.copy_((2 * torch.rand(
                            p.shape, generator=generator,
                            device=generator.device) - 1) * bound)
        return self
