"""Everything the benchmark makes from ``--seed``: the sub-seeds, the
model's weights (on the device, in a few large draws), and the pool of
batches (a frozen copy of the repository's synthetic cardiac image and
volume, with per-row noise drawn from the seed, and random labels)."""

from __future__ import annotations

import math

import numpy as np
import torch

from cudabench.reference.step import model_module

# what each sub-seed seeds
SUBSEEDS = ("weights", "data", "chain", "wrapper")


def subseeds(seed: int) -> dict:
    """Independent 63-bit seeds of each use, from any whole ``seed``."""
    words = np.random.SeedSequence(int(seed) % 2 ** 128).generate_state(
        2 * len(SUBSEEDS), np.uint32)
    return {name: (int(words[2 * i]) << 31 | int(words[2 * i + 1]) >> 1)
            for i, name in enumerate(SUBSEEDS)}


def make_weights(config, seed: int, device) -> dict:
    """The model's parameters by name: convolution kernels ~ kaiming normal
    (fan in, gain 2), biases 0, BatchNorm weights ``1 + std * N(0, 1)``
    (``config['model']['init']['bn_weight_std']``) and biases 0.  One
    normal draw on the device covers every random leaf."""
    m = config["model"]
    spec = model_module(m["name"]).param_spec(m["args"])
    std = float(m.get("init", {}).get("bn_weight_std", 0.0))
    random = [s for s in spec if s[2] in ("conv_weight", "bn_weight")]
    total = sum(math.prod(shape) for _, shape, _ in random)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        if kind == "conv_weight":
            fan_in = n // shape[0]
            out[name] = z[at:at + n].view(shape) * math.sqrt(2.0 / fan_in)
            at += n
        elif kind == "bn_weight":
            out[name] = 1.0 + std * z[at:at + n].view(shape)
            at += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def _base_image(shape, device):
    """The repository's synthetic cardiac slice (two Gaussian blobs) or
    volume (one ellipsoid), float64 on the device."""
    axes = [torch.arange(s, dtype=torch.float64, device=device)
            for s in shape]
    grids = torch.meshgrid(*axes, indexing="ij")
    if len(shape) == 2:
        ii, jj = grids
        h, w = shape
        return (torch.exp(-(((ii - h / 2) / 30.0) ** 2
                            + ((jj - w / 2) / 24.0) ** 2))
                + 0.3 * torch.exp(-(((ii - 0.3125 * h) / 15.0) ** 2
                                    + ((jj - 0.625 * w) / 12.0) ** 2)))
    ii, jj, kk = grids
    d, h, w = shape
    return torch.exp(-(((ii - d / 2) / (d / 3)) ** 2
                       + ((jj - h / 2) / (h / 4)) ** 2
                       + ((kk - w / 2) / (w / 4)) ** 2))


def make_pool(config, batch: int, pool: int, seed: int, device):
    """``pool`` batches of (images (pool, N, C, *S) f32, labels (pool, N,
    *S) int64): the base image plus ``0.05 * U(0, 1)`` noise on every
    pixel of every row, and labels uniform over the classes."""
    img = config["image"]
    shape = tuple(img["shape"])
    gen = torch.Generator(device=device).manual_seed(seed)
    base = _base_image(shape, device).to(torch.float32)
    noise = torch.rand((pool, batch, img["channels"]) + shape,
                       generator=gen, device=device)
    images = base + 0.05 * noise
    classes = int(config["model"]["args"].get("num_classes", 4))
    labels = torch.randint(0, classes, (pool, batch) + shape, generator=gen,
                           device=device)
    return images, labels
