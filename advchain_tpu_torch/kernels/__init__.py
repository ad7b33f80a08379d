"""Hand-written Hopper kernels (CUDA C++ for sm_90a) with their plain
PyTorch twins; built from ``csrc/`` on first use, never at import."""

from advchain_tpu_torch.kernels.band_sample import (band_sample_bwd_plain,
                                                    band_sample_fwd_plain)
from advchain_tpu_torch.kernels.batch_norm import (BatchNormTrain,
                                                   batch_norm_bwd_plain)
# the module's own name stays the package's attribute: its wrapper
# function, conv3d_wgrad.conv3d_wgrad, is not re-exported here
from advchain_tpu_torch.kernels.conv3d_wgrad import (Conv3dSame,
                                                     conv3d_wgrad_plain)
from advchain_tpu_torch.kernels.plane_sample import (
    CornerSample, PlaneGridSample, corner_sample_bwd,
    corner_sample_bwd_plain, corner_sample_fwd, corner_sample_fwd_plain,
    plane_grid_sample_bwd, plane_grid_sample_bwd_plain,
    plane_grid_sample_fwd, plane_grid_sample_fwd_plain,
    plane_sample_bwd_plain, plane_sample_fwd_plain)
from advchain_tpu_torch.kernels.stencil_warp import (StencilWarp,
                                                     stencil_warp_bwd,
                                                     stencil_warp_bwd_plain,
                                                     stencil_warp_fwd,
                                                     stencil_warp_fwd_plain)
from advchain_tpu_torch.kernels.zband_sample import (
    ZBandGridSample, zband_grid_sample_bwd, zband_grid_sample_bwd_plain,
    zband_grid_sample_fwd, zband_grid_sample_fwd_plain,
    zband_sample_bwd_plain, zband_sample_fwd_plain)

__all__ = ["band_sample_fwd_plain", "band_sample_bwd_plain",
           "zband_sample_fwd_plain", "zband_sample_bwd_plain",
           "ZBandGridSample", "zband_grid_sample_fwd", "zband_grid_sample_bwd",
           "zband_grid_sample_fwd_plain", "zband_grid_sample_bwd_plain",
           "StencilWarp", "stencil_warp_fwd", "stencil_warp_bwd",
           "stencil_warp_fwd_plain", "stencil_warp_bwd_plain",
           "CornerSample", "corner_sample_fwd", "corner_sample_bwd",
           "corner_sample_fwd_plain", "corner_sample_bwd_plain",
           "plane_sample_fwd_plain", "plane_sample_bwd_plain",
           "PlaneGridSample", "plane_grid_sample_fwd", "plane_grid_sample_bwd",
           "plane_grid_sample_fwd_plain", "plane_grid_sample_bwd_plain",
           "Conv3dSame", "conv3d_wgrad_plain", "BatchNormTrain",
           "batch_norm_bwd_plain"]
