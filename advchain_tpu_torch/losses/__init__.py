"""Consistency divergences and the supervised cross-entropy on PyTorch
tensors."""

from advchain_tpu_torch.losses.consistency import (
    calc_segmentation_consistency, calc_segmentation_kl_consistency,
    calc_segmentation_mse_consistency, contour_loss, cross_entropy,
    cross_entropy_2d, kl_divergence, one_hot)

__all__ = ["calc_segmentation_consistency",
           "calc_segmentation_mse_consistency",
           "calc_segmentation_kl_consistency", "contour_loss",
           "kl_divergence", "one_hot", "cross_entropy", "cross_entropy_2d"]
