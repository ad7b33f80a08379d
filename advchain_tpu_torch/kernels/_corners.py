"""What the corner samplers share: the plain PyTorch twins of the band (2D)
and z-band (3D) samplers, written once for d spatial axes, the weighted
gather and its transpose at precomputed flat taps (which the flat-index
corner and plane samplers also use), and the wrappers' argument checks,
for the corner contract below and for the grid contract of the grid-level
pairs (``img`` (N, C, *S), ``grid`` (N, P, d) normalised, a padding mode,
``align_corners`` and a mode).

Contract: ``img`` (N, C, *S) with d = len(S) spatial axes, ``idx`` a tuple
of d (N, P) int32 base corners (the first spatial axis first), ``w``
(N, 2^d, P) with corner k's offset along axis a equal to bit (d - 1 - a)
of k (2D: (0,0) (0,1) (1,0) (1,1); 3D: (dz, dy, dx) binary order);
``out[n,c,p] = sum_k w[n,k,p] * img[n, c, idx + offset_k]``, where a tap
outside the image reads zero and receives no gradient.
"""

from __future__ import annotations

import torch

PADDING_MODES = ("zeros", "border", "reflection")
# the grid kernels' padding codes: PADDING_MODES and "edge", border padding
# whose slope at an exact lower bound is a runtime ``lower_slope`` (the 3D
# flow compositions: the edge-padded stencil's one-sided slope, 1, or the
# sampler's clip, 0.5, as the JAX package's dispatch picks)
KERNEL_PADDING = PADDING_MODES + ("edge",)
MODES = ("bilinear", "nearest")


def corners(idx, sizes):
    """Flat source index (N, 2^d, P) int64 and tap validity (N, 2^d, P)."""
    dims = len(sizes)
    flat, valid = 0, True
    for axis, (base, size) in enumerate(zip(idx, sizes)):
        bit = dims - 1 - axis
        coord = torch.stack([base + ((k >> bit) & 1)
                             for k in range(2 ** dims)], dim=1).long()
        valid = valid & (coord >= 0) & (coord < size)
        flat = flat * size + coord
    return torch.where(valid, flat, torch.zeros_like(flat)), valid


def _gather_corners(img, flat, valid):
    """vals (N, K, C, P) = img at the taps, zero where invalid."""
    n, c = img.shape[:2]
    k, p = flat.shape[1:]
    idx = flat.reshape(n, 1, k * p).expand(n, c, k * p)
    vals = torch.gather(img.reshape(n, c, -1), 2, idx)
    vals = vals.reshape(n, c, k, p).transpose(1, 2)
    return torch.where(valid[:, :, None, :], vals, torch.zeros_like(vals))


def fwd_plain(img, idx, w):
    """Gather the corners, then sum k = 0..2^d-1 in order, as the kernels
    do (any device, any float dtype)."""
    return fwd_taps(img, *corners(idx, img.shape[2:]), w)


def bwd_plain(g, img, idx, w):
    """``d_w[n,k,p] = sum_c g * v_k`` and ``d_img`` += ``w_k * g`` at each
    valid tap (a deterministic scatter)."""
    return bwd_taps(g, img, *corners(idx, img.shape[2:]), w)


def fwd_taps(img, flat, valid, w):
    """``out[n,c,p] = sum_k w[n,k,p] * img[n,c].flatten()[flat[n,k,p]]``
    over the valid taps, summed k = 0..K-1 in order, each product rounded
    on its own (the kernels' order)."""
    v = _gather_corners(img, flat, valid)
    out = w[:, 0, None] * v[:, 0]
    for k in range(1, w.shape[1]):
        out = out + w[:, k, None] * v[:, k]
    return out


def bwd_taps(g, img, flat, valid, w):
    """The transpose of :func:`fwd_taps`: ``(d_img, d_w)``."""
    n, c = img.shape[:2]
    k, p = flat.shape[1:]
    v = _gather_corners(img, flat, valid)
    d_w = (g[:, None] * v).sum(dim=2)
    contrib = w[:, :, None, :] * g[:, None]  # (N, K, C, P)
    contrib = torch.where(valid[:, :, None, :], contrib,
                          torch.zeros_like(contrib))
    d_img = torch.zeros(n, c, img[0, 0].numel(), dtype=img.dtype,
                        device=img.device)
    d_img.scatter_add_(2, flat.reshape(n, 1, k * p).expand(n, c, k * p),
                       contrib.transpose(1, 2).reshape(n, c, k * p))
    return d_img.reshape(img.shape), d_w


def check(name: str, img, idx, w, g=None, taps=None) -> bool:
    """Validate a sampler call with ``len(idx)`` index arrays against an
    image of as many axes after (N, C), and ``taps`` weights per point
    (default 2^d).  False: CPU tensors, which take the plain twin; True:
    CUDA tensors the kernel takes; anything else raises."""
    dims = len(idx)
    taps = 2 ** dims if taps is None else taps
    if img.dim() != dims + 2:
        raise ValueError(f"{name}: img must have {dims} spatial axes, got "
                         f"{tuple(img.shape)}")
    n, c = img.shape[:2]
    shape = tuple(idx[0].shape)
    if len(shape) != 2 or shape[0] != n or \
            any(tuple(t.shape) != shape for t in idx):
        raise ValueError(f"{name}: indices must be (N, P) with N={n}, got "
                         f"{[tuple(t.shape) for t in idx]}")
    p = shape[1]
    if tuple(w.shape) != (n, taps, p):
        raise ValueError(f"{name}: w must be {(n, taps, p)}, got "
                         f"{tuple(w.shape)}")
    if g is not None and tuple(g.shape) != (n, c, p):
        raise ValueError(f"{name}: g must be {(n, c, p)}, got "
                         f"{tuple(g.shape)}")
    floats = [img, w] + ([g] if g is not None else [])
    tensors = floats + list(idx)
    if any(t.device != img.device for t in tensors):
        raise ValueError(f"{name} tensors must share one device")
    if img.device.type == "cpu":
        return False
    if img.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not "
                         f"{img.device.type}")
    if any(t.dtype != torch.float32 for t in floats) or \
            any(t.dtype != torch.int32 for t in idx):
        raise TypeError(f"the CUDA {name} takes f32 img/w/g and int32 "
                        f"indices")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"the CUDA {name} takes contiguous tensors")
    if img.numel() >= 2 ** 31 or w.numel() >= 2 ** 31:
        raise ValueError(f"{name} sizes must stay below 2^31 elements")
    return True


def check_grid(name: str, img, grid, padding_mode, mode, g=None,
               lower_slope=None) -> bool:
    """Validate a grid-contract call with d = ``grid.shape[2]`` spatial
    axes (``lower_slope``: a one-element tensor on the image's device).
    False: CPU tensors, which take the plain twin; True: CUDA tensors the
    kernel takes; anything else raises."""
    if padding_mode not in KERNEL_PADDING:
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    if mode not in MODES:
        raise ValueError(f"{name}: mode must be one of {MODES}, got "
                         f"{mode!r}")
    dims = img.dim() - 2
    if grid.dim() != 3 or grid.shape[0] != img.shape[0] \
            or grid.shape[2] != dims:
        raise ValueError(f"{name} takes img (N, C, *{dims} axes) and grid "
                         f"(N, P, {dims}), got {tuple(img.shape)} and "
                         f"{tuple(grid.shape)}")
    n, c = img.shape[:2]
    if g is not None and tuple(g.shape) != (n, c, grid.shape[1]):
        raise ValueError(f"{name}: g must be {(n, c, grid.shape[1])}, got "
                         f"{tuple(g.shape)}")
    if lower_slope is not None and lower_slope.numel() < 1:
        raise ValueError(f"{name}: lower_slope must hold one value")
    tensors = [t for t in (img, grid, g, lower_slope) if t is not None]
    if any(t.device != img.device for t in tensors):
        raise ValueError(f"{name} tensors must share one device")
    if img.device.type == "cpu":
        return False
    if img.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not "
                         f"{img.device.type}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"the CUDA {name} takes f32 tensors")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"the CUDA {name} takes contiguous tensors")
    if max(t.numel() for t in tensors) >= 2 ** 31:
        raise ValueError(f"{name} sizes must stay below 2^31 elements")
    return True


def grid_flags(padding_mode, align_corners, mode):
    """The kernels' integer options: padding index, align, nearest."""
    return (KERNEL_PADDING.index(padding_mode), int(bool(align_corners)),
            int(mode == "nearest"))
