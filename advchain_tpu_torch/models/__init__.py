"""The UNet and the 3D demo model as torch modules, their solver wrapper,
and weight conversion from the JAX package's Flax pytrees."""

from advchain_tpu_torch.models.unet import (UNet, DoubleConv, Down, Up,
                                            OutConv, PseudoConv3dModel)
from advchain_tpu_torch.models.wrapper import SegmentationModel
from advchain_tpu_torch.models.convert import (flax_pseudo3d_to_torch_state,
                                               flax_unet_to_torch_state)

__all__ = ["UNet", "DoubleConv", "Down", "Up", "OutConv",
           "PseudoConv3dModel", "SegmentationModel",
           "flax_unet_to_torch_state", "flax_pseudo3d_to_torch_state"]
