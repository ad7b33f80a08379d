"""Weights carried across from the JAX package, and the reference
checkpoint loader.

Flax pytrees (as numpy arrays) of the UNet family and PseudoConv3dModel
become this port's ``state_dict`` (for the UNet the inverse of
advchain_tpu/models/convert.py::torch_unet_state_to_flax):

    flax                                torch
    inc/{conv1,bn1,conv2,bn2}           inc.conv.conv.{0,1,3,4}
    downK/conv/{conv1,bn1,conv2,bn2}    downK.mpconv.1.conv.{0,1,3,4}
    upK/conv/{conv1,bn1,conv2,bn2}      upK.conv.conv.{0,1,3,4}
    outc/conv, up2_conv1/conv, ...      outc.conv, up2_conv1.conv, ...
    self_atn/{query,key,value}_conv     self_atn.{query,key,value}_conv
    self_atn/gamma                      self_atn.gamma
    <block>/convN_sn/convN/kernel/u     <conv>.u  (batch_stats)
    <block>/convN_sn/convN/kernel/sigma <conv>.sigma

    PseudoConv3dModel: conv1, bn1, conv2 keep their names.

Conv kernels transpose (kH, kW, I, O) -> (O, I, kH, kW) and
(kD, kH, kW, I, O) -> (O, I, kD, kH, kW); the spectral ``u`` (1, O)
carries across unchanged.  UNetv2 and DeeplySupervisedUNet share the
UNet's layout (the latter adds its two heads).

Any block of ``models.blocks`` (:func:`flax_blocks_to_torch_state`): the
port's blocks carry Flax's names, so each Flax path becomes the dotted
torch name, but for a bank member ``norm_1_{d}`` -> ``norm_1.{d}``.  A
leaf's kind follows from its node: ``kernel`` of rank 2 is a Dense
(I, O) -> ``weight`` (O, I); of rank 4 or 5 a convolution as above, but
``up_deconv``, Flax's ``ConvTranspose(padding="SAME")``, whose kernel
flips in both spatial axes and lays out (I, O, kH, kW) for
``ConvTranspose2d(stride=2, padding=1)``; ``scale`` / ``bias`` (and
``BatchInstanceNorm``'s ``gate``) with ``mean`` / ``var`` are a norm; a
spectral convolution's ``<conv>_sn/<conv>/kernel/u`` and ``/sigma`` are
its buffers.

The reference's ``.pth`` files use the port's own names, so
:func:`get_unet_model` loads them with ``load_state_dict``; the JAX
package's ``torch_unet_state_to_flax`` has no counterpart here.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np
import torch

from advchain_tpu_torch import resolve_device
from advchain_tpu_torch.models.unet import UNet
from advchain_tpu_torch.models.wrapper import SegmentationModel

__all__ = ["flax_unet_to_torch_state", "flax_unetv2_to_torch_state",
           "flax_dsv_unet_to_torch_state", "flax_pseudo3d_to_torch_state",
           "flax_blocks_to_torch_state", "get_unet_model"]

# the UNet family's 1x1 heads
_HEADS = ("outc", "up2_conv1", "up3_conv1")
# the blocks' transposed convolutions (ResConvUp's)
_TRANSPOSED = ("up_deconv",)
# a domain bank member: Flax's norm_1_0 is the port's norm_1.0
_BANK = re.compile(r"^(norm_[12])_(\d+)$")
# get_unet_model's architectures: feature_scale of each
_ARCHS = {"UNet_16": 4, "UNet_64": 1}


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32))


def _conv(out: Dict[str, torch.Tensor], prefix: str, p) -> None:
    k = np.asarray(p["kernel"])
    spatial = tuple(range(k.ndim - 2))
    out[prefix + ".weight"] = _t(np.transpose(k, (k.ndim - 1, k.ndim - 2)
                                              + spatial))
    if "bias" in p:
        out[prefix + ".bias"] = _t(p["bias"])


def _bn(out: Dict[str, torch.Tensor], prefix: str, p, s) -> None:
    out[prefix + ".weight"] = _t(p["scale"])
    out[prefix + ".bias"] = _t(p["bias"])
    if "gate" in p:  # BatchInstanceNorm
        out[prefix + ".gate"] = _t(p["gate"])
    out[prefix + ".running_mean"] = _t(s["mean"])
    out[prefix + ".running_var"] = _t(s["var"])
    out[prefix + ".num_batches_tracked"] = torch.tensor(0)


def _spectral(out, prefix: str, conv: str, s) -> None:
    """Flax's SpectralNorm statistics of ``conv``, if it has them."""
    sn = s.get(conv + "_sn")
    if sn is not None:
        out[f"{prefix}.u"] = _t(sn[conv + "/kernel/u"])
        out[f"{prefix}.sigma"] = _t(sn[conv + "/kernel/sigma"])


def _double_conv(out, prefix, p, s) -> None:
    for conv, bn, i in (("conv1", "bn1", 0), ("conv2", "bn2", 3)):
        _conv(out, f"{prefix}.{i}", p[conv])
        _spectral(out, f"{prefix}.{i}", conv, s)
        _bn(out, f"{prefix}.{i + 1}", p[bn], s[bn])


def flax_unet_to_torch_state(params, batch_stats) -> Dict[str, torch.Tensor]:
    """(params, batch_stats) of the JAX package's UNet (any options),
    UNetv2 or DeeplySupervisedUNet -> a state dict for the port's module of
    the same class."""
    out: Dict[str, torch.Tensor] = {}
    _double_conv(out, "inc.conv.conv", params["inc"], batch_stats["inc"])
    for k in range(1, 5):
        _double_conv(out, f"down{k}.mpconv.1.conv", params[f"down{k}"]["conv"],
                     batch_stats[f"down{k}"]["conv"])
    for k in range(1, 5):
        _double_conv(out, f"up{k}.conv.conv", params[f"up{k}"]["conv"],
                     batch_stats[f"up{k}"]["conv"])
    for head in _HEADS:
        if head in params:
            _conv(out, f"{head}.conv", params[head]["conv"])
    if "self_atn" in params:
        atn = params["self_atn"]
        for conv in ("query_conv", "key_conv", "value_conv"):
            _conv(out, f"self_atn.{conv}", atn[conv])
        out["self_atn.gamma"] = _t(atn["gamma"])
    return out


flax_unetv2_to_torch_state = flax_unet_to_torch_state
flax_dsv_unet_to_torch_state = flax_unet_to_torch_state


def flax_pseudo3d_to_torch_state(params, batch_stats
                                 ) -> Dict[str, torch.Tensor]:
    """(params, batch_stats) of the JAX package's PseudoConv3dModel -> a
    state dict for
    :class:`advchain_tpu_torch.models.unet.PseudoConv3dModel`."""
    out: Dict[str, torch.Tensor] = {}
    _conv(out, "conv1", params["conv1"])
    _bn(out, "bn1", params["bn1"], batch_stats["bn1"])
    _conv(out, "conv2", params["conv2"])
    return out


def flax_blocks_to_torch_state(params, batch_stats=None
                               ) -> Dict[str, torch.Tensor]:
    """(params, batch_stats) of any block of the JAX package's
    ``models/blocks.py`` -> a state dict for the port's block of the same
    class (``advchain_tpu_torch.models.blocks``)."""
    out: Dict[str, torch.Tensor] = {}
    _block(out, "", params, batch_stats or {})
    return {k.lstrip("."): v for k, v in out.items()}


def _block(out, prefix: str, p, s) -> None:
    name = prefix.rsplit(".", 1)[-1]
    if "kernel" in p:
        k = np.asarray(p["kernel"])
        if k.ndim == 2:  # Dense
            out[prefix + ".weight"] = _t(k.T)
            if "bias" in p:
                out[prefix + ".bias"] = _t(p["bias"])
        elif name in _TRANSPOSED:
            out[prefix + ".weight"] = _t(
                np.flip(k, (0, 1)).transpose(2, 3, 0, 1))
            out[prefix + ".bias"] = _t(p["bias"])
        else:
            _conv(out, prefix, p)
        return
    if "scale" in p:
        _bn(out, prefix, p, s)
        return
    for key, sub in p.items():
        bank = _BANK.match(key)
        child = f"{bank[1]}.{bank[2]}" if bank else key
        child = f"{prefix}.{child}" if prefix else child
        _block(out, child, sub, s.get(key, {}))
        _spectral(out, child, key, s)


def get_unet_model(model_path: str, num_classes: int = 2, device=None,
                   model_arch: str = "UNet_16",
                   compute_dtype=None) -> SegmentationModel:
    """Load a trained reference checkpoint (``UNet_16`` or ``UNet_64``,
    one input channel) into the port's UNet on ``device`` (None means the
    GPU) and wrap it; ``compute_dtype`` as :class:`SegmentationModel`'s."""
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"{model_path} does not exist")
    if model_arch not in _ARCHS:
        raise NotImplementedError(model_arch)
    dev = resolve_device(device)
    module = UNet(input_channel=1, num_classes=num_classes,
                  feature_scale=_ARCHS[model_arch])
    module.load_state_dict(torch.load(model_path, map_location="cpu"))
    return SegmentationModel(module.to(dev), compute_dtype=compute_dtype)
