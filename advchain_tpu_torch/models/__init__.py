"""The UNet as a torch module, its solver wrapper, and weight conversion
from the JAX package's Flax pytrees."""

from advchain_tpu_torch.models.unet import (UNet, DoubleConv, Down, Up,
                                            OutConv)
from advchain_tpu_torch.models.wrapper import SegmentationModel
from advchain_tpu_torch.models.convert import flax_unet_to_torch_state

__all__ = ["UNet", "DoubleConv", "Down", "Up", "OutConv",
           "SegmentationModel", "flax_unet_to_torch_state"]
