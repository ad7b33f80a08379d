"""Segmentation consistency divergences (mse / kl / contour), 2D and 3D,
and the supervised cross-entropy (port of advchain_tpu/losses/
consistency.py).

Reference quirks kept: the mse divergence divides torch's ``MSELoss(mean)``
once more by ``numel / C``; the Sobel filters are tiled across input AND
output channels (a full convolution, not a depthwise one); the 3D Sobel
filters are the reference's effective ones (its gy equals gx, and gz
differentiates along the last axis); the kl ``is_gt`` path clamps the
one-hot reference to [1e-8, 1 - 1e-8].

Inside a data-parallel step's data group (``ops.collectives.data_group``)
every loss is the mean over this rank's rows (and, in a spatially
partitioned step, its slab), which the step weights by the rank's share of
the global batch's elements.  The one exception is the mse quirk's divisor
``numel / C``, which counts the global batch, as the JAX package's GSPMD
step does.  Inside a space group the contour loss's Sobel filters read a
halo of one plane from the neighbours (``ops.conv.conv_same``), so each
slab's filtered values are the dense ones.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from advchain_tpu_torch._consts import device_const
from advchain_tpu_torch._trace import to_device
from advchain_tpu_torch.ops import collectives
from advchain_tpu_torch.ops.conv import conv_same

__all__ = ["calc_segmentation_consistency",
           "calc_segmentation_mse_consistency",
           "calc_segmentation_kl_consistency", "contour_loss",
           "kl_divergence", "one_hot", "cross_entropy_2d", "cross_entropy"]


@functools.lru_cache(maxsize=8)
def _sobel_kernels_2d(object_classes: int):
    x_f = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32)
    y_f = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], np.float32)
    tile = (object_classes, object_classes, 1, 1)
    return (np.tile(x_f.reshape(1, 1, 3, 3), tile),
            np.tile(y_f.reshape(1, 1, 3, 3), tile))


@functools.lru_cache(maxsize=8)
def _sobel_kernels_3d(object_classes: int):
    """Effective 3D kernels after the reference's gy/gz bugs:
    gx[i,j,k] = s[i]*d[j]*s[k]; gy = gx; gz[i,j,k] = s[i]*s[j]*d[k]."""
    smooth = np.array([1, 2, 1], np.float64)
    diff = np.array([1, 0, -1], np.float64)
    tile = (object_classes, object_classes, 1, 1, 1)
    gx = np.einsum("i,j,k->ijk", smooth, diff, smooth)
    gz = np.einsum("i,j,k->ijk", smooth, smooth, diff)
    gx_w = np.tile(gx.reshape(1, 1, 3, 3, 3).astype(np.float32), tile)
    gz_w = np.tile(gz.reshape(1, 1, 3, 3, 3).astype(np.float32), tile)
    return gx_w, gx_w, gz_w


@device_const
def _sobel_kernels(object_classes: int, ndim: int, dtype, device):
    """The Sobel kernels of ``ndim`` spatial axes on ``device``, cached
    there (``_consts``)."""
    build = _sobel_kernels_2d if ndim == 2 else _sobel_kernels_3d
    return tuple(to_device(k, dtype, device) for k in build(object_classes))


def one_hot(labels, depth: int):
    """Integer labelmap (N, *spatial) -> one-hot (N, depth, *spatial)."""
    oh = F.one_hot(labels.long(), depth).to(torch.float32)
    return torch.movedim(oh, -1, 1)


def kl_divergence(reference, pred, mask=None, is_gt: bool = False):
    """DKL(P || Q): mean over batch and space of sum_c mask * (p log p -
    p log q)."""
    if mask is None:
        mask = torch.ones_like(pred)
    if not is_gt:
        p = torch.softmax(reference, dim=1)
        log_p = torch.log_softmax(reference, dim=1)
    else:
        p = torch.where(reference == 0, torch.full_like(reference, 1e-8),
                        torch.full_like(reference, 1 - 1e-8))
        log_p = torch.log(p)
    log_q = torch.log_softmax(pred, dim=1)
    plogp = torch.sum(mask * (p * log_p), dim=1)
    plogq = torch.sum(mask * (p * log_q), dim=1)
    return torch.mean(plogp - plogq)


def contour_loss(input, target, ignore_background: bool = True,
                 one_hot_target: bool = True, mask=None):
    """Sobel-gradient MSE across object boundaries.  input: probs
    (N, C, *S) with 2 or 3 spatial axes; target: labelmap (N, *S) if
    ``one_hot_target`` else probs (N, C, *S)."""
    num_classes = input.shape[1]
    if input.dim() not in (4, 5):
        raise ValueError(f"contour_loss takes 2D or 3D inputs, got "
                         f"{tuple(input.shape)}")
    if one_hot_target:
        target = one_hot(target, num_classes).reshape(input.shape)
    if target.shape != input.shape:
        raise ValueError(f"pred size {tuple(input.shape)} must match target "
                         f"size {tuple(target.shape)}")
    if mask is None:
        mask = torch.ones_like(input)
    if ignore_background:
        object_classes = num_classes - 1
        target = target[:, 1:]
        input = input[:, 1:]
    else:
        object_classes = num_classes
    m = mask[:, :object_classes]
    kernels = _sobel_kernels(object_classes, input.dim() - 2, input.dtype,
                             input.device)
    total = 0.0
    for k in kernels:
        total = total + torch.mean((conv_same(input, k) * m
                                    - conv_same(target, k) * m) ** 2)
    return total / len(kernels)


def calc_segmentation_consistency(output, reference,
                                  divergence_types=("kl", "contour"),
                                  divergence_weights=(1.0, 0.5),
                                  class_weights=None, scales=(0,),
                                  mask=None, is_gt: bool = False):
    """Weighted multi-scale divergence between two prediction tensors."""
    if class_weights is not None:
        raise NotImplementedError("class_weights")
    if output.dim() not in (4, 5) or reference.dim() != output.dim():
        raise ValueError(f"only 2D or 3D segmentation is supported, got "
                         f"{tuple(output.shape)} and "
                         f"{tuple(reference.shape)}")
    pool = F.avg_pool2d if output.dim() == 4 else F.avg_pool3d
    num_classes = reference.shape[1]
    if mask is None:
        mask = torch.ones_like(output)
    dist = 0.0
    for scale in scales:
        if scale > 0:
            k = 2 ** scale
            ref_s = pool(reference, k)
            out_s = pool(output, k)
            # the reference keeps the mask at full resolution, which cannot
            # broadcast against pooled outputs; pool it alongside
            mask_s = pool(mask, k)
        else:
            ref_s, out_s, mask_s = reference, output, mask
        for divergence_type, d_weight in zip(divergence_types,
                                             divergence_weights):
            if divergence_type == "kl":
                loss = kl_divergence(pred=out_s, reference=ref_s,
                                     mask=mask_s, is_gt=is_gt)
            elif divergence_type == "mse":
                target_pred = ref_s if is_gt else torch.softmax(ref_s, dim=1)
                input_pred = torch.softmax(out_s, dim=1)
                loss = torch.mean((target_pred * mask_s
                                   - input_pred * mask_s) ** 2)
                loss = loss / (collectives.global_numel(out_s)
                               / num_classes)
            elif divergence_type == "contour":
                target_pred = ref_s if is_gt else torch.softmax(ref_s, dim=1)
                input_pred = torch.softmax(out_s, dim=1)
                loss = 0.0
                for i in range(1, num_classes):
                    loss = loss + contour_loss(
                        input=input_pred[:, i:i + 1],
                        target=target_pred[:, i:i + 1],
                        ignore_background=False, mask=mask_s,
                        one_hot_target=False)
                if num_classes > 1:
                    loss = loss / (num_classes - 1)
            else:
                raise NotImplementedError(
                    f"divergence type {divergence_type!r}")
            dist = dist + 2 ** scale * (d_weight * loss)
    return dist / (1.0 * len(scales))


def calc_segmentation_mse_consistency(input, target):
    return calc_segmentation_consistency(
        output=input, reference=target, divergence_types=["mse"],
        divergence_weights=[1.0], class_weights=None, mask=None)


def calc_segmentation_kl_consistency(input, target):
    return calc_segmentation_consistency(
        output=input, reference=target, divergence_types=["kl"],
        divergence_weights=[1.0], class_weights=None, mask=None)


def cross_entropy_2d(input, target, weight=None, size_average: bool = True):
    """Cross-entropy of 2D logits (N, C, H, W) against a hard labelmap
    (N, H, W) or soft probabilities (N, C, H, W) (reference
    loss.py:274-327).  ``weight`` (C,) is renormalised to sum to C;
    ``size_average`` divides the sum by N*H*W."""
    n, c, h, w = input.shape
    log_p = torch.log_softmax(input, dim=1)
    if weight is not None:
        weight = torch.as_tensor(np.asarray(weight, np.float64),
                                 dtype=torch.float64)
        weight = to_device(weight / weight.sum() * c, input.dtype,
                           input.device)
    if target.dim() == 3:
        t = target.long()
        picked = torch.gather(log_p, 1, t[:, None])[:, 0]
        if weight is not None:
            picked = picked * weight[t]
        loss = -picked.sum()
    elif target.dim() == 4:
        plogq = target * log_p
        if weight is not None:
            plogq = plogq * weight.reshape(1, c, 1, 1)
        loss = -plogq.sum()
    else:
        raise NotImplementedError("target must be 3-D labels or 4-D probs")
    return loss / (n * h * w) if size_average else loss


def cross_entropy(input, target, weight=None, size_average: bool = True):
    """Cross-entropy of logits (N, C, *S) against hard labels (N, *S) or
    soft probabilities (N, C, *S) for any spatial rank: the spatial axes
    are flattened and handed to :func:`cross_entropy_2d`."""
    n, c = input.shape[:2]
    s = math.prod(input.shape[2:])
    if target.dim() == input.dim() - 1:
        target = target.reshape(n, s, 1)
    elif target.dim() == input.dim():
        target = target.reshape(n, c, s, 1)
    else:
        raise NotImplementedError(
            f"target rank {target.dim()} does not match logits rank "
            f"{input.dim()}")
    return cross_entropy_2d(input.reshape(n, c, s, 1), target,
                            weight=weight, size_average=size_average)
