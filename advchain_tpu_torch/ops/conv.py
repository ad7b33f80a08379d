"""Convolution primitives with torch semantics on NCHW tensors (port of
advchain_tpu/ops/conv.py, 2D and 3D).  The convolutions go to cuDNN through
``torch.nn.functional``; the Gaussian smoothing keeps the JAX package's
separable tap accumulation so its arithmetic matches term for term.

Inside a spatially partitioned step's space group
(``ops.collectives.current_space``) ``conv_same`` reads ``(k - 1) // 2``
planes of the leading spatial axis past its rows
(``SpaceGroup.fetch``: the neighbours' halos, or the gathered level where a
rank holds fewer rows) and pads only the other axes, and
``gaussian_smooth(..., sharded=True)`` does the same for each pass along
that axis: the rows past the level's two ends are SAME padding's zeros, so
each slab equals the dense op's rows."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from advchain_tpu_torch._trace import to_device

from . import collectives

__all__ = ["conv_same", "conv_transpose", "depthwise_conv",
           "effective_gaussian_ks", "gaussian_kernel_1d", "gaussian_smooth",
           "slab_gaussian_smooth"]


def _conv_fns(x):
    if x.dim() == 4:
        return F.conv2d, F.conv_transpose2d
    if x.dim() == 5:
        return F.conv3d, F.conv_transpose3d
    raise ValueError(f"only 2/3 spatial dims supported, got {x.dim() - 2}")


def conv_same(x, weight, groups: int = 1):
    """Cross-correlation with 'padding = k // 2' (odd kernels).
    x: (N, C_in, *S); weight: (C_out, C_in / groups, *K).  Inside a space
    group ``x`` is this rank's slab, and so is the result."""
    pad = tuple((k - 1) // 2 for k in weight.shape[2:])
    sg = collectives.current_space()
    if sg is not None:  # the leading axis's padding comes from the halo
        x = _halo_rows(x, sg, pad[0])
        pad = (0,) + pad[1:]
    return _conv_fns(x)[0](x, weight, padding=pad, groups=groups)


def _halo_rows(x, sg, halo: int):
    """This rank's rows of the level ``x`` lies on and ``halo`` rows past
    each end (zeros past the level's)."""
    part = sg.level(x)
    return sg.fetch(x, part, [(o - halo, o + e + halo) if e else (0, 0)
                              for o, e in zip(part.offsets, part.extents)])


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
    return to_device(_gaussian_kernel_1d_np(kernel_size, sigma).copy(),
                     device=device)


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
                    iters: int = 1, sharded: bool = False):
    """Depthwise Gaussian smoothing of (N, C, *S): one separable pass per
    spatial axis with per-axis normalisation (equal to the reference's dense
    product kernel).  ``sharded``: ``x`` is this rank's slab of a field
    sharded over the running step's space group (:func:`slab_gaussian_
    smooth`); outside a space group the flag does nothing."""
    sg = collectives.current_space() if sharded else None
    if sg is not None:
        return slab_gaussian_smooth(x, sg.group, sigma, kernel_size, iters)
    ndim = x.dim() - 2
    ks = effective_gaussian_ks(kernel_size, sigma, ndim)
    taps = [float(v) for v in _gaussian_kernel_1d_np(ks, sigma)]
    out = x
    for _ in range(iters):
        for axis in range(ndim):
            out = _axis_smooth(out, taps, 2 + axis)
    return out


def slab_gaussian_smooth(x, group, sigma: float = 1.0, kernel_size: int = 5,
                         iters: int = 1):
    """:func:`gaussian_smooth` on this rank's slab of a field whose leading
    spatial axis is split over ``group``'s ranks in order: each pass along
    that axis reads ``(k_eff - 1) // 2`` halo planes from the neighbours
    (:func:`collectives.exchange_halo`, zeros past the two ends; each slab
    must hold that many planes), the other axes pass locally.  Equal to the
    dense op's rows bit for bit: the same taps in the same order."""
    ndim = x.dim() - 2
    ks = effective_gaussian_ks(kernel_size, sigma, ndim)
    halo = (ks - 1) // 2
    taps = [float(v) for v in _gaussian_kernel_1d_np(ks, sigma)]
    d_loc = x.shape[2]
    out = x
    for _ in range(iters):
        xp = collectives.exchange_halo(out, halo, 2, group)
        acc = None
        for i, k in enumerate(taps):  # the dense op's SAME taps, in order
            term = k * xp.narrow(2, i, d_loc)
            acc = term if acc is None else acc + term
        out = acc
        for axis in range(3, 2 + ndim):
            out = _axis_smooth(out, taps, axis)
    return out
