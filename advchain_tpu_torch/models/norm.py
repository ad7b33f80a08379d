"""TorchBatchNorm (port of advchain_tpu/models/norm.py): the JAX package's
BatchNorm with torch semantics and "which statistics normalise" decoupled
from "whether the running statistics update" is the port's
:class:`~advchain_tpu_torch.models.unet.FrozenStatsBN`: batch statistics in
training mode, written back only under ``write_back``; the running ones in
eval mode."""

from advchain_tpu_torch.models.unet import FrozenStatsBN

__all__ = ["TorchBatchNorm"]

TorchBatchNorm = FrozenStatsBN
