"""Batch-vector normalisation, intensity rescaling and the l2 renorm
projection (port of advchain_tpu/ops/norms.py).

``unit_normalize(..., sharded=True)`` (l2 only) marks a tensor that is this
rank's slab of a field sharded over a spatially partitioned step's space
group: each sample's norm then reduces over the group.  That reduction
carries no gradient, so it refuses an input that requires one (the solver
calls it on the noise's updates and projections, which are detached).
Outside a space group the flag does nothing."""

from __future__ import annotations

import torch

from . import collectives

__all__ = ["unit_normalize", "rescale_intensity", "renorm_l2"]


def _l2(flat, sharded: bool):
    """Each row's l2 norm, over the space group when ``sharded``."""
    sg = collectives.current_space() if sharded else None
    if sg is None:
        return torch.linalg.vector_norm(flat, dim=1, keepdim=True)
    if flat.requires_grad and torch.is_grad_enabled():
        raise ValueError("unit_normalize(sharded=True) reduces over the "
                         "space group without a gradient: detach the input")
    return torch.sqrt(collectives.all_reduce(
        torch.sum(flat * flat, dim=1, keepdim=True), "sum", sg.group))


def unit_normalize(d, p_type: str = "l2", sharded: bool = False):
    """Normalise each batch element (axis 0) of ``d`` as one flat vector.

    'l2': d / (||d||_2 + 1e-20); 'l1': d / ||d||_1 (no eps);
    'infinity': d / (1e-20 + max(d)) — the reference takes max, NOT
    max(|d|), and that quirk is kept.  ``sharded`` takes 'l2' only.
    """
    if sharded and p_type != "l2":
        raise ValueError(f"sharded normalises the l2 norm only, got "
                         f"{p_type!r}")
    n = d.shape[0]
    flat = d.reshape(n, -1)
    if p_type == "l2":
        flat = flat / (_l2(flat, sharded) + 1e-20)
    elif p_type == "l1":
        flat = flat / torch.sum(torch.abs(flat), dim=1, keepdim=True)
    elif p_type == "infinity":
        flat = flat / (1e-20 + torch.amax(flat, dim=1, keepdim=True))
    else:
        raise ValueError(f"unknown p_type {p_type!r}")
    return flat.reshape(d.shape)


def rescale_intensity(data, new_min: float = 0.0, new_max: float = 1.0,
                      eps: float = 1e-20, per_channel: bool = True):
    """Min-max rescale per (N, C) slice, or per sample with
    ``per_channel=False`` (the solver's variant)."""
    shape = data.shape
    lead = shape[0] * shape[1] if per_channel else shape[0]
    flat = data.reshape(lead, -1)
    old_max = torch.amax(flat, dim=1, keepdim=True)
    old_min = torch.amin(flat, dim=1, keepdim=True)
    new = (flat - old_min + eps) / (old_max - old_min + eps) \
        * (new_max - new_min) + new_min
    return new.reshape(shape)


def renorm_l2(param, maxnorm: float):
    """``Tensor.renorm(p=2, dim=0, maxnorm)``: scale each batch row so its
    l2 norm is at most ``maxnorm`` (``maxnorm / (norm + 1e-7)``)."""
    n = param.shape[0]
    flat = param.reshape(n, -1)
    norms = torch.linalg.vector_norm(flat, dim=1, keepdim=True)
    scale = torch.where(norms > maxnorm, maxnorm / (norms + 1e-7),
                        torch.ones_like(norms))
    return (flat * scale).reshape(param.shape)
