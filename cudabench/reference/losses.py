"""Plain PyTorch losses of upstream advchain's training step: the
supervised cross-entropy and the consistency divergences (mse, contour)
between the warped-back adversarial prediction and the clean one.

Upstream's quirks are kept, as the configuration's algorithm states them:
the mse divergence is ``MSELoss(mean)`` divided once more by ``numel / C``;
the contour loss runs Sobel filters on each foreground class's
probability, masked, and averages over the filters and the classes; the
3D Sobel filters are upstream's effective ones (gy equals gx, gz
differentiates along the last axis)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits, labels):
    """Mean cross-entropy of logits (N, C, *S) against integer labels
    (N, *S)."""
    return F.cross_entropy(logits, labels.long())


def _sobel(dims: int, device, dtype):
    smooth = torch.tensor([1.0, 2.0, 1.0], dtype=torch.float64)
    diff = torch.tensor([1.0, 0.0, -1.0], dtype=torch.float64)
    if dims == 2:
        gx = torch.outer(smooth, diff)
        gy = torch.outer(diff, smooth)
        kernels = (gx, gy)
    else:
        gx = torch.einsum("i,j,k->ijk", smooth, diff, smooth)
        gz = torch.einsum("i,j,k->ijk", smooth, smooth, diff)
        kernels = (gx, gx, gz)
    return [k.to(dtype).to(device)[None, None] for k in kernels]


def _contour(prob, ref, mask):
    """Sobel-gradient mse of one class's probabilities, masked."""
    dims = prob.dim() - 2
    conv = F.conv2d if dims == 2 else F.conv3d
    kernels = _sobel(dims, prob.device, prob.dtype)
    total = 0.0
    for k in kernels:
        a = conv(prob, k, padding=1) * mask
        b = conv(ref, k, padding=1) * mask
        total = total + torch.mean((a - b) ** 2)
    return total / len(kernels)


def consistency(pred, ref, mask, types, weights):
    """The weighted divergence between logits ``pred`` and ``ref`` under a
    one-channel validity ``mask``: upstream's
    ``calc_segmentation_consistency`` at scale 0."""
    c = ref.shape[1]
    p = torch.softmax(pred, dim=1)
    q = torch.softmax(ref, dim=1)
    dist = 0.0
    for kind, w in zip(types, weights):
        if kind == "mse":
            loss = torch.mean((q * mask - p * mask) ** 2)
            loss = loss / (pred.numel() / c)
        elif kind == "contour":
            loss = 0.0
            for i in range(1, c):
                loss = loss + _contour(p[:, i:i + 1], q[:, i:i + 1], mask)
            loss = loss / (c - 1)
        else:
            raise NotImplementedError(f"divergence {kind!r}")
        dist = dist + w * loss
    return dist
