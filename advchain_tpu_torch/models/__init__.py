"""The UNet family, the reference's building blocks, the 3D demo model,
the 3D U-Net and Swin-Unet as torch modules, their solver wrapper, weight
conversion from the JAX package's Flax pytrees and the reference
checkpoint loader."""

from advchain_tpu_torch.models.unet import (UNet, UNetv2,
                                            DeeplySupervisedUNet,
                                            DoubleConv, Down, Up, OutConv,
                                            SelfAttn2d, SpectralConv2d,
                                            ZDecomposedConv3d,
                                            PseudoConv3dModel, UNet3D)
from advchain_tpu_torch.models.swin import SwinUNet
from advchain_tpu_torch.models.norm import TorchBatchNorm
from advchain_tpu_torch.models.wrapper import SegmentationModel
from advchain_tpu_torch.models.blocks import (
    ConvDown, ResConvDown, ResConv, ResBilinearUp, ResConvUp, DilationConv,
    OutConvRelu, SELayer, CSELayer, ChannelSELayer, SpatialSELayer,
    ChannelSpatialSELayer, SqeUp, BatchInstanceNorm, AdaptiveInstanceNorm,
    AdaptiveBatchNorm, bilinear_additive_upsampling, spatial_pyramid_pool,
    UnetConv3, UnetUp3, normal_init, xavier_init, kaiming_init,
    DomainDoubleConv, DomainInConv, DomainPoolDown, DomainUp,
    UnetConv2, Conv2DBatchNorm, Conv2DBatchNormRelu)
from advchain_tpu_torch.models.convert import (flax_blocks_to_torch_state,
                                               flax_dsv_unet_to_torch_state,
                                               flax_pseudo3d_to_torch_state,
                                               flax_unet_to_torch_state,
                                               flax_unetv2_to_torch_state,
                                               get_unet_model)

__all__ = ["UNet", "UNetv2", "DeeplySupervisedUNet", "DoubleConv", "Down",
           "Up", "OutConv", "SelfAttn2d", "SpectralConv2d",
           "ZDecomposedConv3d", "PseudoConv3dModel", "UNet3D", "SwinUNet",
           "TorchBatchNorm",
           "SegmentationModel", "get_unet_model",
           "flax_unet_to_torch_state", "flax_unetv2_to_torch_state",
           "flax_dsv_unet_to_torch_state", "flax_pseudo3d_to_torch_state",
           "flax_blocks_to_torch_state",
           "ConvDown", "ResConvDown", "ResConv", "ResBilinearUp",
           "ResConvUp", "DilationConv", "OutConvRelu", "SELayer",
           "CSELayer", "ChannelSELayer", "SpatialSELayer",
           "ChannelSpatialSELayer", "SqeUp", "BatchInstanceNorm",
           "AdaptiveInstanceNorm", "AdaptiveBatchNorm",
           "bilinear_additive_upsampling", "spatial_pyramid_pool",
           "UnetConv3", "UnetUp3", "normal_init", "xavier_init",
           "kaiming_init", "DomainDoubleConv", "DomainInConv",
           "DomainPoolDown", "DomainUp", "UnetConv2", "Conv2DBatchNorm",
           "Conv2DBatchNormRelu"]
