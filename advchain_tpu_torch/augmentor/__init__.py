"""Adversarial transforms and the compose solver on PyTorch tensors."""

from advchain_tpu_torch.augmentor.base import AdvTransformBase
from advchain_tpu_torch.augmentor.noise import AdvNoise
from advchain_tpu_torch.augmentor.bias import AdvBias
from advchain_tpu_torch.augmentor.affine import AdvAffine
from advchain_tpu_torch.augmentor.morph import AdvMorph
from advchain_tpu_torch.augmentor.compose import \
    ComposeAdversarialTransformSolver

__all__ = ["AdvTransformBase", "AdvNoise", "AdvBias", "AdvAffine",
           "AdvMorph", "ComposeAdversarialTransformSolver"]
