"""Convolution primitives with torch semantics on NCHW tensors (port of
advchain_tpu/ops/conv.py, 2D and 3D).  The convolutions go to cuDNN through
``torch.nn.functional``; the Gaussian smoothing keeps the JAX package's
separable tap accumulation so its arithmetic matches term for term."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["conv_same", "conv_transpose", "depthwise_conv",
           "effective_gaussian_ks", "gaussian_kernel_1d", "gaussian_smooth"]


def _conv_fns(x):
    if x.dim() == 4:
        return F.conv2d, F.conv_transpose2d
    if x.dim() == 5:
        return F.conv3d, F.conv_transpose3d
    raise ValueError(f"only 2/3 spatial dims supported, got {x.dim() - 2}")


def conv_same(x, weight, groups: int = 1):
    """Cross-correlation with 'padding = k // 2' (odd kernels).
    x: (N, C_in, *S); weight: (C_out, C_in / groups, *K)."""
    pad = tuple((k - 1) // 2 for k in weight.shape[2:])
    return _conv_fns(x)[0](x, weight, padding=pad, groups=groups)


def conv_transpose(x, weight, stride, padding):
    """``conv_transpose{2,3}d`` (groups=1); weight (C_in, C_out, *K)."""
    return _conv_fns(x)[1](x, weight, stride=stride, padding=padding)


def depthwise_conv(x, kernel):
    """Depthwise 'padding = k // 2' convolution: the same ``kernel`` (*K,
    or any shape that broadcasts to (C, 1, *K)) on every channel."""
    ndim = x.dim() - 2
    c = x.shape[1]
    w = torch.broadcast_to(kernel, (c, 1) + tuple(kernel.shape[-ndim:]))
    return conv_same(x, w.contiguous(), groups=c)


@functools.lru_cache(maxsize=32)
def _gaussian_kernel_1d_np(kernel_size: int, sigma: float) -> np.ndarray:
    mean = (kernel_size - 1) / 2.0
    xs = np.arange(kernel_size, dtype=np.float64)
    k = np.exp(-((xs - mean) ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_kernel_1d(kernel_size: int, sigma: float, device=None):
    """The normalised 1-D Gaussian (f32, computed in float64) on
    ``device`` (None: the CPU)."""
    return torch.from_numpy(_gaussian_kernel_1d_np(kernel_size,
                                                   sigma).copy()).to(device)


def effective_gaussian_ks(kernel_size: int, sigma: float,
                          spatial_dims: int) -> int:
    """The reference grows the kernel for scipy parity: 2D grows when
    ks < 2*int(4*sigma+0.5)+1, 3D when ks <= that bound."""
    bound = 2 * int(4 * sigma + 0.5) + 1
    if spatial_dims == 2:
        return bound if kernel_size < bound else kernel_size
    return bound if kernel_size <= bound else kernel_size


def _axis_smooth(x, taps, axis: int):
    """Zero-padded SAME tap accumulation of 1-D kernel ``taps`` (python
    floats) along ``axis``."""
    ks = len(taps)
    r = (ks - 1) // 2
    pads = [0, 0] * x.dim()
    # F.pad lists the last axis first
    pads[2 * (x.dim() - 1 - axis)] = r
    pads[2 * (x.dim() - 1 - axis) + 1] = ks - 1 - r
    xp = F.pad(x, pads)
    size = x.shape[axis]
    out = None
    for i, k in enumerate(taps):
        term = k * xp.narrow(axis, i, size)
        out = term if out is None else out + term
    return out


def gaussian_smooth(x, sigma: float = 1.0, kernel_size: int = 5,
                    iters: int = 1):
    """Depthwise Gaussian smoothing of (N, C, *S): one separable pass per
    spatial axis with per-axis normalisation (equal to the reference's dense
    product kernel)."""
    ndim = x.dim() - 2
    ks = effective_gaussian_ks(kernel_size, sigma, ndim)
    taps = [float(v) for v in _gaussian_kernel_1d_np(ks, sigma)]
    out = x
    for _ in range(iters):
        for axis in range(ndim):
            out = _axis_smooth(out, taps, 2 + axis)
    return out
