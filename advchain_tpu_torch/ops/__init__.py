"""Numeric primitives on PyTorch tensors (2D and 3D); the samplers' gather
and scatter run in :mod:`advchain_tpu_torch.kernels`."""

from .grid_sample import grid_sample, grid_sample_2d, grid_sample_3d, \
    stencil_warp_2d, stencil_warp_3d
from .affine import affine_grid, affine_grid_2d, affine_grid_3d, \
    make_batch_eye, invert_affine_matrix
from .resize import interpolate, interp_matrix
from .conv import conv_same, conv_transpose, depthwise_conv, \
    gaussian_kernel_1d, gaussian_smooth
from .bspline import bspline_kernel, BSplineFieldSpec, \
    make_bspline_field_spec, evaluate_bspline_field, clip_bias
from .integrate import base_grid, compose_flow, exponentiate_flow, \
    jacobian_determinant_2d
from .norms import renorm_l2, rescale_intensity, unit_normalize

__all__ = [
    "grid_sample", "grid_sample_2d", "grid_sample_3d", "stencil_warp_2d",
    "stencil_warp_3d",
    "affine_grid", "affine_grid_2d", "affine_grid_3d", "make_batch_eye",
    "invert_affine_matrix",
    "interpolate", "interp_matrix",
    "conv_same", "conv_transpose", "depthwise_conv", "gaussian_kernel_1d",
    "gaussian_smooth",
    "bspline_kernel", "BSplineFieldSpec", "make_bspline_field_spec",
    "evaluate_bspline_field", "clip_bias",
    "base_grid", "compose_flow", "exponentiate_flow",
    "jacobian_determinant_2d",
    "unit_normalize", "rescale_intensity", "renorm_l2",
]
