"""Resize matching ``torch.nn.functional.interpolate`` (port of
advchain_tpu/ops/resize.py): linear modes resample each spatial axis with a
dense (out, in) interpolation matrix, so the result is exactly torch's
separable linear resampling; nearest gathers each axis at the JAX package's
float64 source index.  Inside a spatially partitioned step's space group
the input is a field replicated over the group and the result is this
rank's slab of the output (the slab's rows of the leading axis's matrix or
index), with no collective; with ``sharded=True`` the input is this rank's
rows of a level split over the group, and the result its rows of the
output level (the input rows each needs fetched past its own,
``SpaceGroup.fetch``)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from advchain_tpu_torch._consts import device_const
from advchain_tpu_torch._trace import to_device

from . import collectives

__all__ = ["interpolate", "interp_matrix"]


@functools.lru_cache(maxsize=128)
def _interp_matrix_np(in_size: int, out_size: int,
                      align_corners: bool) -> np.ndarray:
    """Dense 1-D linear interpolation matrix W (out, in): y = W @ x, with
    torch's ``area_pixel_compute_source_index``."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    if out_size == 1:
        if align_corners:
            w[0, 0] = 1.0
        else:
            src = max(0.0, 0.5 * in_size / out_size - 0.5)
            lo = int(np.floor(src))
            hi = min(lo + 1, in_size - 1)
            w[0, lo] += 1.0 - (src - lo)
            w[0, hi] += src - lo
        return w.astype(np.float32)
    for i in range(out_size):
        if align_corners:
            src = i * (in_size - 1) / (out_size - 1)
        else:
            src = max((i + 0.5) * in_size / out_size - 0.5, 0.0)
        lo = min(int(np.floor(src)), in_size - 1)
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        w[i, lo] += 1.0 - frac
        w[i, hi] += frac
    return w.astype(np.float32)


@device_const
def interp_matrix(in_size: int, out_size: int, align_corners: bool,
                  device=None):
    """The f32 (out, in) linear interpolation matrix on ``device``, cached
    there (``_consts``), so shared: write into it nothing in place."""
    return to_device(_interp_matrix_np(in_size, out_size, align_corners),
                     device=device)


@functools.lru_cache(maxsize=128)
def _nearest_idx_np(in_size: int, out_size: int) -> np.ndarray:
    """torch's legacy 'nearest' index ``floor(i * in / out)``, computed in
    float64 as the JAX package does (``F.interpolate``'s f32 scale can pick
    another source row)."""
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


@device_const
def _nearest_idx(in_size: int, out_size: int, device):
    """:func:`_nearest_idx_np` on ``device``, cached there."""
    return to_device(_nearest_idx_np(in_size, out_size), device=device)


def _axis_matrix(in_size: int, out_size: int, mode: str,
                 align_corners: bool) -> np.ndarray:
    """The (out, in) matrix of one axis's resize: linear weights, or
    nearest's one-hot rows."""
    if mode == "nearest":
        w = np.zeros((out_size, in_size), np.float32)
        w[np.arange(out_size), _nearest_idx_np(in_size, out_size)] = 1.0
        return w
    return _interp_matrix_np(in_size, out_size, align_corners)


@device_const
def _device_axis_matrix(in_size: int, out_size: int, mode: str,
                        align_corners: bool, device):
    """:func:`_axis_matrix` on ``device``, cached there."""
    return to_device(_axis_matrix(in_size, out_size, mode, align_corners),
                     device=device)


def _slab_rows(x, sg, part, out_size: int, mode: str, align_corners: bool,
               like):
    """The leading axis of a sharded resize: this rank's rows of the
    output level (``like``'s, or ``part.resized``), each from the input
    rows its matrix row reads."""
    if mode not in ("nearest", "linear", "bilinear", "trilinear"):
        raise NotImplementedError(f"mode={mode!r}")
    target = part.resized(out_size) if like is None else sg.level(like)
    mat = _axis_matrix(part.height, out_size, mode, align_corners)
    windows = []
    for a, e in zip(target.offsets, target.extents):
        cols = np.nonzero(mat[a:a + e].any(0))[0]
        windows.append((int(cols[0]), int(cols[-1]) + 1) if e else (0, 0))
    xw = sg.fetch(x, part, windows)
    a, e = target.rows(sg.index)
    lo, hi = windows[sg.index]
    w = _device_axis_matrix(part.height, out_size, mode, align_corners,
                            x.device)[a:a + e, lo:hi].contiguous().to(x.dtype)
    out = torch.movedim(torch.tensordot(xw, w, dims=([2], [1])), -1, 2)
    return sg.register(out, target)


def interpolate(x, size=None, scale_factor=None, mode: str = "bilinear",
                align_corners: bool = False, sharded: bool = False,
                like=None):
    """Resize (N, C, *spatial) along every spatial axis: 'linear' /
    'bilinear' / 'trilinear' (each per-axis linear) or 'nearest' (a gather
    per axis).  ``size`` is the target spatial shape, or ``scale_factor``
    (scalar or per axis) gives it with torch's ``floor(in * factor)``
    rule.  Axes whose size is unchanged are left alone.  Inside a space
    group ``x`` is the whole field on every rank and the result is this
    rank's slab of the leading spatial axis; with ``sharded`` ``x`` is
    this rank's rows of a level, ``size`` is global, and the result is
    this rank's rows of the output on the level of ``like`` (else output
    row ``i`` goes to the rank holding input row ``floor(i * in / out)``);
    outside a space group both are not read."""
    sg = collectives.current_space()
    spatial = x.shape[2:]
    if sharded and sg is not None:
        part = sg.level(x)
        spatial = (part.height,) + tuple(spatial[1:])
    ndim = len(spatial)
    if size is None:
        if scale_factor is None:
            raise ValueError("need size or scale_factor")
        if np.isscalar(scale_factor):
            scale_factor = (scale_factor,) * ndim
        size = tuple(int(np.floor(s * f))
                     for s, f in zip(spatial, scale_factor))
    else:
        size = tuple(int(s) for s in size)
    if len(size) != ndim:
        raise ValueError(f"size {size} rank mismatch with input "
                         f"{tuple(x.shape)}")
    if sharded and sg is not None:
        x = _slab_rows(x, sg, part, size[0], mode, align_corners, like)
        spatial, sg = (size[0],) + tuple(spatial[1:]), None
    if mode == "nearest":
        out = x
        for axis, (ins, outs) in enumerate(zip(spatial, size)):
            if ins != outs or (axis == 0 and sg is not None):
                idx = _nearest_idx(ins, outs, x.device)
                if axis == 0 and sg is not None:
                    idx = sg.slab(idx, 0)
                out = torch.index_select(out, 2 + axis, idx)
        return out
    if mode not in ("linear", "bilinear", "trilinear"):
        raise NotImplementedError(f"mode={mode!r}")
    out = x
    for axis, (ins, outs) in enumerate(zip(spatial, size)):
        if axis == 0 and sg is not None:
            if ins == outs:
                out = sg.slab(out, 2)
                continue
            w = sg.slab(interp_matrix(ins, outs, align_corners, x.device),
                        0).to(x.dtype)
        elif ins == outs:
            continue
        else:
            w = interp_matrix(ins, outs, align_corners, x.device).to(x.dtype)
        out = torch.movedim(
            torch.tensordot(out, w, dims=([2 + axis], [1])), -1, 2 + axis)
    return out
