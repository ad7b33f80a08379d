"""Batch-vector normalisation (port of advchain_tpu/ops/norms.py,
``unit_normalize``)."""

from __future__ import annotations

import torch

__all__ = ["unit_normalize"]


def unit_normalize(d, p_type: str = "l2"):
    """Normalise each batch element (axis 0) of ``d`` as one flat vector.

    'l2': d / (||d||_2 + 1e-20); 'l1': d / ||d||_1 (no eps);
    'infinity': d / (1e-20 + max(d)) — the reference takes max, NOT
    max(|d|), and that quirk is kept.
    """
    n = d.shape[0]
    flat = d.reshape(n, -1)
    if p_type == "l2":
        flat = flat / (torch.linalg.vector_norm(flat, dim=1, keepdim=True)
                       + 1e-20)
    elif p_type == "l1":
        flat = flat / torch.sum(torch.abs(flat), dim=1, keepdim=True)
    elif p_type == "infinity":
        flat = flat / (1e-20 + torch.amax(flat, dim=1, keepdim=True))
    else:
        raise ValueError(f"unknown p_type {p_type!r}")
    return flat.reshape(d.shape)

