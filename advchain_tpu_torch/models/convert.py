"""Weights carried across from the JAX package: its Flax UNet and
PseudoConv3dModel pytrees, as numpy arrays, become this port's
``state_dict`` (for the UNet the inverse of
advchain_tpu/models/convert.py::torch_unet_state_to_flax).

    flax                                torch
    inc/{conv1,bn1,conv2,bn2}           inc.conv.conv.{0,1,3,4}
    downK/conv/{conv1,bn1,conv2,bn2}    downK.mpconv.1.conv.{0,1,3,4}
    upK/conv/{conv1,bn1,conv2,bn2}      upK.conv.conv.{0,1,3,4}
    outc/conv                           outc.conv

    PseudoConv3dModel: conv1, bn1, conv2 keep their names.

Conv kernels transpose (kH, kW, I, O) -> (O, I, kH, kW) and
(kD, kH, kW, I, O) -> (O, I, kD, kH, kW).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["flax_unet_to_torch_state", "flax_pseudo3d_to_torch_state"]


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
    out[prefix + ".running_mean"] = _t(s["mean"])
    out[prefix + ".running_var"] = _t(s["var"])
    out[prefix + ".num_batches_tracked"] = torch.tensor(0)


def _double_conv(out, prefix, p, s) -> None:
    _conv(out, prefix + ".0", p["conv1"])
    _bn(out, prefix + ".1", p["bn1"], s["bn1"])
    _conv(out, prefix + ".3", p["conv2"])
    _bn(out, prefix + ".4", p["bn2"], s["bn2"])


def flax_unet_to_torch_state(params, batch_stats) -> Dict[str, torch.Tensor]:
    """(params, batch_stats) of the JAX package's UNet -> a state dict for
    :class:`advchain_tpu_torch.models.unet.UNet`."""
    out: Dict[str, torch.Tensor] = {}
    _double_conv(out, "inc.conv.conv", params["inc"], batch_stats["inc"])
    for k in range(1, 5):
        _double_conv(out, f"down{k}.mpconv.1.conv", params[f"down{k}"]["conv"],
                     batch_stats[f"down{k}"]["conv"])
    for k in range(1, 5):
        _double_conv(out, f"up{k}.conv.conv", params[f"up{k}"]["conv"],
                     batch_stats[f"up{k}"]["conv"])
    _conv(out, "outc.conv", params["outc"]["conv"])
    return out


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
