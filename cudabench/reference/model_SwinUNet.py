"""Plain PyTorch version of Swin-Unet (Cao, Wang, Chen, Jiang, Zhang, Tian
and Wang, "Swin-Unet: Unet-like Pure Transformer for Medical Image
Segmentation", arXiv:2105.05537), after its published code
(github.com/HuCaoFighting/Swin-Unet,
``networks/swin_transformer_unet_skip_expand_decoder_sys.py``,
``SwinTransformerSys`` with ``final_upsample="expand_first"``, and
``networks/vision_transformer.py``'s repeat of a 1-channel input).

Patch embedding (4x4 stride-4 convolution, LayerNorm); four encoder
stages of Swin blocks, the first three followed by patch merging; a
LayerNorm; a patch expanding, then three decoder stages (the
concatenation ``[x, skip]``, a Linear 2C -> C, Swin blocks, a patch
expanding but for the last); a LayerNorm, a 4x expand, a 1x1 convolution.
A Swin block is ``x + proj(attn(LN1(x)))`` in w x w windows, every second
block of a stage wider than one window on windows rolled by half a window
with the published -100 region mask, then ``x + fc2(GELU(fc1(LN2(x))))``.
The attention is written out: ``softmax(q k^T / sqrt(d) + bias + mask)
v`` with matmul, add and softmax.

Departures: none in the mathematics.  Drop path (stochastic depth) is
refused: every pass of the step has to see one network.  LayerNorm eps is
torch's default, 1e-5, as published.  Parameter names are those of the
measured program's module (which are the published ones)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

PATCH = 4


def _args(args):
    return (int(args.get("img_size", 224)), int(args.get("in_chans", 3)),
            int(args.get("num_classes", 4)), int(args.get("embed_dim", 96)),
            [int(d) for d in args.get("depths", (2, 2, 2, 2))],
            [int(h) for h in args.get("num_heads", (3, 6, 12, 24))],
            int(args.get("window_size", 7)),
            float(args.get("mlp_ratio", 4.0)),
            bool(args.get("qkv_bias", True)))


def _stages(args):
    """[(C, resolution, depth, heads, window, shift of the odd blocks)] of
    the encoder's stages, the first first."""
    img, _, _, embed, depths, heads, window, _, _ = _args(args)
    out = []
    for i, (d, h) in enumerate(zip(depths, heads)):
        r = img // PATCH // 2 ** i
        w, s = (r, 0) if r <= window else (window, window // 2)
        out.append((embed * 2 ** i, r, d, h, w, s))
    return out


def _block_spec(prefix, c, h, w, mlp, qkv_bias):
    hid = int(c * mlp)
    spec = [(f"{prefix}.norm1.weight", (c,), "bn_weight"),
            (f"{prefix}.norm1.bias", (c,), "bn_bias"),
            (f"{prefix}.attn.relative_position_bias_table",
             ((2 * w - 1) ** 2, h), "table"),
            (f"{prefix}.attn.qkv.weight", (3 * c, c), "conv_weight")]
    if qkv_bias:
        spec.append((f"{prefix}.attn.qkv.bias", (3 * c,), "conv_bias"))
    return spec + [
        (f"{prefix}.attn.proj.weight", (c, c), "conv_weight"),
        (f"{prefix}.attn.proj.bias", (c,), "conv_bias"),
        (f"{prefix}.norm2.weight", (c,), "bn_weight"),
        (f"{prefix}.norm2.bias", (c,), "bn_bias"),
        (f"{prefix}.mlp.fc1.weight", (hid, c), "conv_weight"),
        (f"{prefix}.mlp.fc1.bias", (hid,), "conv_bias"),
        (f"{prefix}.mlp.fc2.weight", (c, hid), "conv_weight"),
        (f"{prefix}.mlp.fc2.bias", (c,), "conv_bias")]


def _norm_spec(prefix, c):
    return [(f"{prefix}.weight", (c,), "bn_weight"),
            (f"{prefix}.bias", (c,), "bn_bias")]


def param_spec(args):
    """[(name, shape, kind)]: Linear and convolution weights are
    ``conv_weight`` (kaiming normal on fan-in, ``numel // shape[0]``),
    LayerNorm weights ``bn_weight`` (1 + std N(0, 1)); biases,
    LayerNorm biases and the relative-position tables are zeros."""
    _, cin, classes, embed, _, _, _, mlp, qkv_bias = _args(args)
    stages = _stages(args)
    n = len(stages)
    spec = [("patch_embed.proj.weight", (embed, cin, PATCH, PATCH),
             "conv_weight"),
            ("patch_embed.proj.bias", (embed,), "conv_bias")]
    spec += _norm_spec("patch_embed.norm", embed)
    for i, (c, _, depth, h, w, _) in enumerate(stages):
        for j in range(depth):
            spec += _block_spec(f"layers.{i}.blocks.{j}", c, h, w, mlp,
                                qkv_bias)
        if i < n - 1:
            spec += _norm_spec(f"layers.{i}.downsample.norm", 4 * c)
            spec.append((f"layers.{i}.downsample.reduction.weight",
                         (2 * c, 4 * c), "conv_weight"))
    top = stages[-1][0]
    spec += _norm_spec("norm", top)
    spec += [("layers_up.0.expand.weight", (2 * top, top), "conv_weight")]
    spec += _norm_spec("layers_up.0.norm", top // 2)
    for k in range(1, n):
        c, _, depth, h, w, _ = stages[n - 1 - k]
        for j in range(depth):
            spec += _block_spec(f"layers_up.{k}.blocks.{j}", c, h, w, mlp,
                                qkv_bias)
        if k < n - 1:
            spec.append((f"layers_up.{k}.upsample.expand.weight",
                         (2 * c, c), "conv_weight"))
            spec += _norm_spec(f"layers_up.{k}.upsample.norm", c // 2)
    for k in range(1, n):
        c = stages[n - 1 - k][0]
        spec += [(f"concat_back_dim.{k}.weight", (c, 2 * c), "conv_weight"),
                 (f"concat_back_dim.{k}.bias", (c,), "conv_bias")]
    spec += _norm_spec("norm_up", embed)
    spec += [("up.expand.weight", (PATCH * PATCH * embed, embed),
              "conv_weight")]
    spec += _norm_spec("up.norm", embed)
    spec += [("output.weight", (classes, embed, 1, 1), "conv_weight")]
    return spec


def conv_layers(args, spatial):
    """[(cin, cout, taps, output positions per sample)] of every product
    with weights or of two activations in one forward at input size
    ``spatial`` (H, W), in the forward's order, the patch embedding first
    (16 taps).  Every Linear counts 1 tap at its tokens; each attention
    counts its two products, ``q k^T`` as (C, w*w, 1, T) and ``attn v`` as
    (w*w, C, 1, T) at the stage's T tokens (every head's keys over the
    window), the 1x1 head as (C, classes, 1, H*W).  ``costs.py`` counts
    each layer's backward as a data gradient and a weight gradient of its
    forward's size; an attention product's backward is two data gradients,
    which the train passes count right but a PGD pass (data gradients
    alone) counts one short, and the recomputation inside the fused
    attention's backward is not counted."""
    _, cin, classes, embed, _, _, _, mlp, _ = _args(args)
    stages = _stages(args)
    n = len(stages)
    t0 = (spatial[0] // PATCH) * (spatial[1] // PATCH)
    tokens = [t0 // 4 ** i for i in range(n)]

    def blocks(c, depth, w, t):
        hid = int(c * mlp)
        return depth * [(c, 3 * c, 1, t), (c, w * w, 1, t), (w * w, c, 1, t),
                        (c, c, 1, t), (c, hid, 1, t), (hid, c, 1, t)]

    out = [(cin, embed, PATCH * PATCH, t0)]
    for i, (c, _, depth, _, w, _) in enumerate(stages):
        out += blocks(c, depth, w, tokens[i])
        if i < n - 1:
            out.append((4 * c, 2 * c, 1, tokens[i + 1]))
    top = stages[-1][0]
    out.append((top, 2 * top, 1, tokens[-1]))
    for k in range(1, n):
        c, _, depth, _, w, _ = stages[n - 1 - k]
        t = tokens[n - 1 - k]
        out.append((2 * c, c, 1, t))
        out += blocks(c, depth, w, t)
        if k < n - 1:
            out.append((c, 2 * c, 1, t))
    out.append((embed, PATCH * PATCH * embed, 1, t0))
    out.append((embed, classes, 1, spatial[0] * spatial[1]))
    return out


def _partition(x, w):
    """(B, H, W, C) -> (B * H/w * W/w, w*w, C)."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def _merge(x, w, h, wd):
    """The inverse of :func:`_partition`."""
    c = x.shape[-1]
    x = x.reshape(-1, h // w, wd // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, wd, c)


def _relative_index(w, device):
    """The published ``relative_position_index``."""
    coords = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel.contiguous()
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1).to(device)


def _region_mask(r, w, s, device):
    """The published ``attn_mask``: (windows, w*w, w*w), -100 between
    tokens of different regions of the rolled image."""
    img = torch.zeros(1, r, r, 1)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -s), slice(-s, None)):
        for ws in (slice(0, -w), slice(-w, -s), slice(-s, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = _partition(img, w).squeeze(-1)
    mask = win.unsqueeze(1) - win.unsqueeze(2)
    mask = mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)
    return mask.to(device)


def _ln(p, name, x):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], 1e-5)


def _attention(p, name, x, heads, w, mask):
    bw, n, c = x.shape
    d = c // heads
    qkv = F.linear(x, p[f"{name}.qkv.weight"], p.get(f"{name}.qkv.bias"))
    qkv = qkv.reshape(bw, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * d ** -0.5, qkv[1], qkv[2]
    attn = q @ k.transpose(-2, -1)
    table = p[f"{name}.relative_position_bias_table"]
    bias = table[_relative_index(w, x.device).reshape(-1)].reshape(
        n, n, heads).permute(2, 0, 1)
    attn = attn + bias.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(bw // nw, nw, heads, n, n) \
            + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.reshape(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    y = (attn @ v).transpose(1, 2).reshape(bw, n, c)
    return F.linear(y, p[f"{name}.proj.weight"], p[f"{name}.proj.bias"])


def _block(p, name, x, r, heads, w, s):
    b, _, c = x.shape
    y = _ln(p, f"{name}.norm1", x).reshape(b, r, r, c)
    if s:
        y = torch.roll(y, shifts=(-s, -s), dims=(1, 2))
    mask = _region_mask(r, w, s, x.device) if s else None
    y = _attention(p, f"{name}.attn", _partition(y, w), heads, w, mask)
    y = _merge(y, w, r, r)
    if s:
        y = torch.roll(y, shifts=(s, s), dims=(1, 2))
    x = x + y.reshape(b, r * r, c)
    y = _ln(p, f"{name}.norm2", x)
    y = F.gelu(F.linear(y, p[f"{name}.mlp.fc1.weight"],
                        p[f"{name}.mlp.fc1.bias"]))
    return x + F.linear(y, p[f"{name}.mlp.fc2.weight"],
                        p[f"{name}.mlp.fc2.bias"])


def _stage(p, name, x, r, depth, heads, w, s):
    for j in range(depth):
        x = _block(p, f"{name}.blocks.{j}", x, r, heads, w, s if j % 2 else 0)
    return x


def _expand(p, name, x, r, scale):
    """Linear, then ``b h w (p1 p2 c) -> b (h p1) (w p2) c``, LayerNorm."""
    b = x.shape[0]
    x = F.linear(x, p[f"{name}.expand.weight"])
    c = x.shape[-1] // (scale * scale)
    x = x.reshape(b, r, r, scale, scale, c).permute(0, 1, 3, 2, 4, 5)
    return _ln(p, f"{name}.norm", x.reshape(b, r * scale * r * scale, c))


def forward(p, x, args, bn, dropout=None):
    """Logits of ``x`` (N, C, H, W) under parameters ``p``; ``bn`` and
    ``dropout`` are unused (the network has neither)."""
    del bn, dropout
    img, cin, _, _, _, _, _, _, _ = _args(args)
    if tuple(x.shape[2:]) != (img, img):
        raise ValueError(f"the reference Swin-Unet takes {img}x{img}")
    if x.shape[1] == 1:
        x = x.repeat(1, cin, 1, 1)
    stages = _stages(args)
    n = len(stages)
    x = F.conv2d(x, p["patch_embed.proj.weight"], p["patch_embed.proj.bias"],
                 stride=PATCH)
    b = x.shape[0]
    x = _ln(p, "patch_embed.norm", x.flatten(2).transpose(1, 2))
    skips = []
    for i, (c, r, depth, heads, w, s) in enumerate(stages):
        skips.append(x)
        x = _stage(p, f"layers.{i}", x, r, depth, heads, w, s)
        if i < n - 1:
            y = x.reshape(b, r, r, c)
            y = torch.cat([y[:, 0::2, 0::2], y[:, 1::2, 0::2],
                           y[:, 0::2, 1::2], y[:, 1::2, 1::2]], -1)
            y = _ln(p, f"layers.{i}.downsample.norm",
                    y.reshape(b, -1, 4 * c))
            x = F.linear(y, p[f"layers.{i}.downsample.reduction.weight"])
    x = _ln(p, "norm", x)
    x = _expand(p, "layers_up.0", x, stages[-1][1], 2)
    for k in range(1, n):
        c, r, depth, heads, w, s = stages[n - 1 - k]
        x = torch.cat([x, skips[n - 1 - k]], -1)
        x = F.linear(x, p[f"concat_back_dim.{k}.weight"],
                     p[f"concat_back_dim.{k}.bias"])
        x = _stage(p, f"layers_up.{k}", x, r, depth, heads, w, s)
        if k < n - 1:
            x = _expand(p, f"layers_up.{k}.upsample", x, r, 2)
    x = _ln(p, "norm_up", x)
    r0 = stages[0][1]
    x = _expand(p, "up", x, r0, PATCH)
    x = x.reshape(b, PATCH * r0, PATCH * r0, -1).permute(0, 3, 1, 2)
    return F.conv2d(x, p["output.weight"])
