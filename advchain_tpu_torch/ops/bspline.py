"""B-spline kernels and airlab-style control-point grid geometry, 2D and 3D
(port of advchain_tpu/ops/bspline.py).

The integer geometry is computed once on the host; the field itself is a
transposed convolution, a border crop, a linear resize and ``exp``.  The
kernel is the outer product of per-axis iterated box filters, which equals
the reference's iterated all-ones convolution, so the strided transposed
convolution and its crop are one small matrix product per axis
(``A_y . cp . A_x^T`` in 2D): f32 sums in full precision, with no
convolution algorithm to choose and no reduced-precision path.  Quirks
kept: the 2D kernel pads iteration i by ``i * spacing`` and the 3D kernel
pads every iteration by ``spacing - 1``; the control grid carries a +2
border and asymmetric crops; the 3D field is resized to ``floor(size *
scale)`` (torch ``Upsample(scale_factor=...)``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from advchain_tpu_torch._consts import device_const
from advchain_tpu_torch._trace import to_device

from .grid_sample import clip
from .resize import interpolate

__all__ = ["bspline_kernel", "BSplineFieldSpec", "make_bspline_field_spec",
           "evaluate_bspline_field", "clip_bias"]


@functools.lru_cache(maxsize=64)
def _bspline_kernel_1d(spacing: int, order: int,
                       per_iter_padding: Tuple[int, ...]) -> np.ndarray:
    k = np.ones(spacing, dtype=np.float64)
    box = np.ones(spacing, dtype=np.float64)
    for i in range(order):
        k = np.convolve(np.pad(k, per_iter_padding[i]), box,
                        mode="valid") / spacing
    return k


def _axis_kernels(spacing, order: int, spatial_dims: int):
    """The float64 1-D factors of the N-D kernel, one per axis: in 2D
    iteration i pads by ``i * spacing``, in 3D every iteration pads by
    ``spacing - 1``."""
    axes = []
    for s in spacing:
        if spatial_dims == 2:
            pads = tuple(i * s for i in range(1, order + 1))
        else:
            pads = (s - 1,) * order
        axes.append(_bspline_kernel_1d(s, order, pads))
    return axes


def bspline_kernel(spacing, order: int = 3,
                   spatial_dims: int = 2) -> np.ndarray:
    """N-D B-spline interpolation kernel: the outer product of
    :func:`_axis_kernels`."""
    spacing = tuple(int(s) for s in spacing)
    if len(spacing) != spatial_dims or spatial_dims not in (2, 3):
        raise ValueError(f"spacing {spacing} does not fit spatial_dims="
                         f"{spatial_dims}")
    axes = _axis_kernels(spacing, order, spatial_dims)
    k = axes[0]
    for a in axes[1:]:
        k = np.multiply.outer(k, a)
    return k.astype(np.float32)


@dataclass(frozen=True)
class BSplineFieldSpec:
    """Static geometry of a control-point bias field."""
    spatial_dims: int
    image_size: Tuple[int, ...]
    cp_grid: Tuple[int, ...]      # control-point grid incl. the +2 border
    stride: Tuple[int, ...]       # control_point_spacing // downscale
    padding: Tuple[int, ...]      # conv-transpose padding = (k - 1) // 2
    crop_start: Tuple[int, ...]
    crop_end: Tuple[int, ...]
    kernel_size: Tuple[int, ...]
    order: int
    downscale: int


def make_bspline_field_spec(image_size, control_point_spacing,
                            downscale: int, order: int = 3
                            ) -> BSplineFieldSpec:
    image_size = tuple(int(s) for s in image_size)
    dims = len(image_size)
    stride = np.array([int(s) // int(downscale)
                       for s in control_point_spacing])
    img = np.array(image_size, dtype=np.float64)
    cp_grid = np.ceil(img / float(downscale) / stride).astype(int)
    inner = stride * cp_grid - (stride - 1)
    cp_grid = cp_grid + 2
    diff = inner - img / float(downscale)
    diff_floor = np.floor(np.abs(diff) / 2) * np.sign(diff)
    crop_start = diff_floor + np.remainder(diff, 2) * np.sign(diff)
    crop_end = diff_floor
    kernel = bspline_kernel(stride.tolist(), order=order, spatial_dims=dims)
    padding = tuple((np.array(kernel.shape) - 1) // 2)
    conv_out = ((cp_grid - 1) * stride + np.array(kernel.shape)
                - 2 * np.array(padding))
    field = (conv_out - (stride + crop_start.astype(int))
             - (stride + crop_end.astype(int)))
    target = np.ceil(img / float(downscale)).astype(int)
    if np.any(field > target):
        raise ValueError(
            f"inconsistent B-spline geometry: cropped field {tuple(field)} "
            f"exceeds image/downscale {tuple(target)} for "
            f"control_point_spacing="
            f"{tuple(int(s) for s in control_point_spacing)}, "
            f"downscale={downscale}, order={order}, image={image_size}")
    return BSplineFieldSpec(
        spatial_dims=dims, image_size=image_size,
        cp_grid=tuple(int(v) for v in cp_grid),
        stride=tuple(int(v) for v in stride),
        padding=tuple(int(v) for v in padding),
        crop_start=tuple(int(v) for v in crop_start.astype(int)),
        crop_end=tuple(int(v) for v in crop_end.astype(int)),
        kernel_size=tuple(kernel.shape), order=int(order),
        downscale=int(downscale))


@device_const
def _axis_matrices(spec: BSplineFieldSpec, dtype: torch.dtype,
                   device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Per spatial axis, the matrix A (cropped length, control points) of
    the transposed convolution by that axis's 1-D B-spline factor, with the
    crop folded into its rows: ``A[o, i] = k[o + start + padding - i *
    stride]`` where the index lies in the kernel (conv_transpose's
    definition), ``start = stride + crop_start``.  Built in float64 and
    cast to ``dtype`` on ``device`` once: a copy to the card each call
    would wait for the work queued before it."""
    mats = []
    for k, cp, s, pad, cs, ce in zip(
            _axis_kernels(spec.stride, spec.order, spec.spatial_dims),
            spec.cp_grid, spec.stride, spec.padding, spec.crop_start,
            spec.crop_end):
        ks = k.shape[0]
        full = (cp - 1) * s + ks - 2 * pad
        start, stop = s + cs, full - (s + ce)
        tap = (np.arange(start, stop)[:, None] + pad
               - np.arange(cp)[None, :] * s)
        inside = (tap >= 0) & (tap < ks)
        mats.append(to_device(
            np.where(inside, k[np.clip(tap, 0, ks - 1)], 0.0), dtype, device))
    return tuple(mats)


def _transposed_conv_cropped(cpoints, spec: BSplineFieldSpec):
    """The transposed convolution by the separable B-spline kernel and the
    border crop: one matrix product along each spatial axis, in the
    control points' dtype (the matrices are cast from float64)."""
    field = cpoints
    for axis, a in enumerate(_axis_matrices(spec, cpoints.dtype,
                                            cpoints.device)):
        field = torch.movedim(
            torch.tensordot(a, field, dims=([1], [2 + axis])), 0, 2 + axis)
    return field


def evaluate_bspline_field(cpoints, spec: BSplineFieldSpec,
                           log_space: bool = True):
    """Control points (N, 1, *cp_grid) -> bias field (N, 1, *image_size):
    transposed conv by the B-spline kernel and border crop (one matrix
    product per axis), linear resize (align_corners=False), then ``exp``
    (log space) or ``1 + field``.  Inside a space group the control points
    are replicated and the field is this rank's slab of the leading spatial
    axis (the slab's rows of the resize)."""
    field = _transposed_conv_cropped(cpoints, spec)
    cur = field.shape[2:]
    # the axes that grow are resized (the cropped field is never larger);
    # 3D to floor(size * scale), as torch's Upsample(scale_factor=...)
    if spec.spatial_dims == 2:
        size, mode = spec.image_size, "bilinear"
    else:
        size = tuple(int(math.floor(c * (t / c)))
                     for t, c in zip(spec.image_size, cur))
        mode = "trilinear"
    field = interpolate(field, size=size, mode=mode, align_corners=False)
    if log_space:
        return torch.exp(field)
    return 1.0 + field


def clip_bias(bias_field, magnitude: float):
    """Clamp the bias field into [1 - magnitude, 1 + magnitude]."""
    if magnitude < 0:
        raise ValueError(f"magnitude must be >= 0, got {magnitude}")
    return 1.0 + clip(bias_field - 1.0, -magnitude, magnitude)
