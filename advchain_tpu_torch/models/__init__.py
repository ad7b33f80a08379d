"""The UNet family and the 3D demo model as torch modules, their solver
wrapper, weight conversion from the JAX package's Flax pytrees and the
reference checkpoint loader."""

from advchain_tpu_torch.models.unet import (UNet, UNetv2,
                                            DeeplySupervisedUNet,
                                            DoubleConv, Down, Up, OutConv,
                                            SelfAttn2d, SpectralConv2d,
                                            ZDecomposedConv3d,
                                            PseudoConv3dModel)
from advchain_tpu_torch.models.norm import TorchBatchNorm
from advchain_tpu_torch.models.wrapper import SegmentationModel
from advchain_tpu_torch.models.convert import (flax_dsv_unet_to_torch_state,
                                               flax_pseudo3d_to_torch_state,
                                               flax_unet_to_torch_state,
                                               flax_unetv2_to_torch_state,
                                               get_unet_model)

__all__ = ["UNet", "UNetv2", "DeeplySupervisedUNet", "DoubleConv", "Down",
           "Up", "OutConv", "SelfAttn2d", "SpectralConv2d",
           "ZDecomposedConv3d", "PseudoConv3dModel", "TorchBatchNorm",
           "SegmentationModel", "get_unet_model",
           "flax_unet_to_torch_state", "flax_unetv2_to_torch_state",
           "flax_dsv_unet_to_torch_state", "flax_pseudo3d_to_torch_state"]
