"""The port's B-spline bias field against the same spec evaluated in float64.

``evaluate_bspline_field`` computes the transposed convolution by the
separable B-spline kernel and its border crop as one f32 matrix product
per axis.  The reference here is that transposed convolution by its
definition, in numpy float64 with the full N-D kernel (each control point
adds its kernel-weighted copy at stride ``stride``, then the padding and
the crop are cut off), followed by the port's own resize and ``exp`` on
float64 tensors.  The f32 field must be within 2e-6 of it, relative: a
reduced-precision product (TF32 keeps about three decimal digits) would
miss by ~1e-3.
"""

import numpy as np
import pytest
import torch

from advchain_tpu_torch.ops import bspline as tbs
from advchain_tpu_torch.ops.resize import interpolate
import torch_threads  # noqa: F401  (one intra-op thread a process)

# (image, control_point_spacing, downscale): tests/test_torch_ops.py's and
# tests/test_torch_ops3d.py's specs, and the 2D headline's and 3D volume
# episode's bias fields
SPECS = [((64, 64), (32, 32), 2), ((64, 48), (16, 24), 2),
         ((192, 192), (48, 48), 2), ((8, 32, 32), (4, 16, 16), 4),
         ((12, 48, 40), (6, 24, 20), 4), ((12, 32, 32), (8, 16, 16), 2),
         ((12, 192, 192), (6, 96, 96), 4)]


def _kernel_f64(spec):
    dims = spec.spatial_dims
    k = None
    for s in spec.stride:
        pads = (tuple(i * s for i in range(1, spec.order + 1)) if dims == 2
                else (s - 1,) * spec.order)
        a = tbs._bspline_kernel_1d(s, spec.order, pads)
        k = a if k is None else np.multiply.outer(k, a)
    return k


def _field_f64(cp, spec, log_space):
    """Transposed convolution (stride, padding) by the N-D kernel, crop,
    then the port's resize and exp, all in float64."""
    kernel = _kernel_f64(spec)
    n = cp.shape[0]
    grid = cp.shape[2:]
    full = tuple((g - 1) * s + k
                 for g, s, k in zip(grid, spec.stride, kernel.shape))
    out = np.zeros((n,) + full)
    for idx in np.ndindex(*grid):
        region = tuple(slice(i * s, i * s + k)
                       for i, s, k in zip(idx, spec.stride, kernel.shape))
        out[(slice(None),) + region] += (cp[(slice(None), 0) + idx]
                                         .reshape((n,) + (1,) * len(grid))
                                         * kernel)
    crop = tuple(slice(p + s + cs, f - p - (s + ce))
                 for p, s, cs, ce, f in zip(spec.padding, spec.stride,
                                            spec.crop_start, spec.crop_end,
                                            full))
    field = torch.from_numpy(out[(slice(None),) + crop][:, None])
    cur = field.shape[2:]
    if spec.spatial_dims == 2:
        if any(t > c for t, c in zip(spec.image_size, cur)):
            field = interpolate(field, size=spec.image_size, mode="bilinear",
                                align_corners=False)
    else:
        factors = tuple(t / c for t, c in zip(spec.image_size, cur))
        if any(f > 1 for f in factors):
            size = tuple(int(np.floor(c * f)) for c, f in zip(cur, factors))
            field = interpolate(field, size=size, mode="trilinear",
                                align_corners=False)
    return (torch.exp(field) if log_space else 1.0 + field).numpy()


@pytest.mark.parametrize("log_space", [True, False])
@pytest.mark.parametrize("image,spacing,downscale", SPECS)
def test_field_matches_float64(image, spacing, downscale, log_space):
    spec = tbs.make_bspline_field_spec(image, spacing, downscale)
    cp = np.random.RandomState(5).uniform(-0.3, 0.3,
                                          (2, 1) + spec.cp_grid)
    ref = _field_f64(cp, spec, log_space)
    field = tbs.evaluate_bspline_field(
        torch.from_numpy(cp.astype(np.float32)), spec, log_space).numpy()
    assert field.shape == ref.shape
    rel = np.abs(field - ref) / np.abs(ref)
    assert rel.max() <= 2e-6, rel.max()


def test_field_gradient_matches_finite_differences():
    """The matrix products carry the control points' gradient (the bias
    transform's PGD step): autograd through them against finite
    differences, in float64."""
    spec = tbs.make_bspline_field_spec((32, 24), (16, 12), 2)
    cp = torch.from_numpy(np.random.RandomState(6).uniform(
        -0.3, 0.3, (1, 1) + spec.cp_grid)).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda c: tbs.evaluate_bspline_field(c, spec, True), (cp,))
