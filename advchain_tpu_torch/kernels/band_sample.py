"""Bilinear corner sampler: the CUDA kernel pair, their plain twins, and the
autograd wrapper.

Replaces advchain_tpu/kernels/gather_matmul.py::band_gather (:839) and
::band_scatter (:923), wired there by ``_weighted_band_sample`` (:1407) with
``_wbs_fwd`` / ``_wbs_bwd``.  The kernels live in ``csrc/band_sample.cu``
(which carries the design and bound note) and are built by ``_build`` on
first use.

Contract: ``img`` (N, C, H, W), ``yidx``/``xidx`` (N, P) int32 base corners,
``w`` (N, 4, P) in corner order (0,0) (0,1) (1,0) (1,1);
``out[n,c,p] = sum_k w[n,k,p] * img[n, c, y+dy_k, x+dx_k]``, where a tap
outside the image reads zero and receives no gradient.

Dispatch: a CPU tensor takes the plain twin; a CUDA tensor launches the
kernel or raises.  ``FWD_LAUNCHES`` / ``BWD_LAUNCHES`` count kernel launches
(and nothing else), so a run can show it went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from advchain_tpu_torch.kernels import _build

__all__ = ["BandSample", "band_sample_fwd",
           "band_sample_bwd", "band_sample_fwd_plain",
           "band_sample_bwd_plain", "reset_launch_counts"]

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


def reset_launch_counts() -> None:
    global FWD_LAUNCHES, BWD_LAUNCHES
    FWD_LAUNCHES = 0
    BWD_LAUNCHES = 0


# ------------------------------------------------------------ plain twins
def _corners(yidx, xidx, h: int, w: int):
    """Flat source index (N, 4, P) int64 and tap validity (N, 4, P)."""
    ys = torch.stack([yidx, yidx, yidx + 1, yidx + 1], dim=1).long()
    xs = torch.stack([xidx, xidx + 1, xidx, xidx + 1], dim=1).long()
    valid = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    flat = torch.where(valid, ys * w + xs, torch.zeros_like(ys))
    return flat, valid


def _gather_corners(img, flat, valid):
    """vals (N, 4, C, P) = img at the four taps, zero where invalid."""
    n, c, h, w = img.shape
    p = flat.shape[2]
    idx = flat.reshape(n, 1, 4 * p).expand(n, c, 4 * p)
    vals = torch.gather(img.reshape(n, c, h * w), 2, idx)
    vals = vals.reshape(n, c, 4, p).transpose(1, 2)
    return torch.where(valid[:, :, None, :], vals, torch.zeros_like(vals))


def band_sample_fwd_plain(img, yidx, xidx, w):
    """Plain PyTorch forward (any device, any float dtype): gather the four
    corners, then sum k = 0..3 in order, as the kernel does."""
    flat, valid = _corners(yidx, xidx, img.shape[2], img.shape[3])
    v = _gather_corners(img, flat, valid)
    out = w[:, 0, None] * v[:, 0]
    for k in range(1, 4):
        out = out + w[:, k, None] * v[:, k]
    return out


def band_sample_bwd_plain(g, img, yidx, xidx, w):
    """Plain PyTorch backward: ``d_w[n,k,p] = sum_c g * v_k`` and
    ``d_img`` += ``w_k * g`` at each valid tap (deterministic scatter)."""
    n, c, h, wd = img.shape
    p = yidx.shape[1]
    flat, valid = _corners(yidx, xidx, h, wd)
    v = _gather_corners(img, flat, valid)
    d_w = (g[:, None] * v).sum(dim=2)
    contrib = w[:, :, None, :] * g[:, None]  # (N, 4, C, P)
    contrib = torch.where(valid[:, :, None, :], contrib,
                          torch.zeros_like(contrib))
    idx = flat.reshape(n, 1, 4 * p).expand(n, c, 4 * p)
    d_img = torch.zeros(n, c, h * wd, dtype=img.dtype, device=img.device)
    d_img.scatter_add_(2, idx, contrib.transpose(1, 2).reshape(n, c, 4 * p))
    return d_img.reshape(n, c, h, wd), d_w


# ---------------------------------------------------------------- kernels
@functools.cache
def _lib():
    lib = _build.load("band_sample")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.advchain_band_sample_fwd.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.advchain_band_sample_fwd.restype = i32
    lib.advchain_band_sample_bwd.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
    lib.advchain_band_sample_bwd.restype = i32
    return lib


def _check(img, yidx, xidx, w, g=None):
    if img.dim() != 4:
        raise ValueError(f"img must be (N, C, H, W), got {tuple(img.shape)}")
    n, c = img.shape[:2]
    if yidx.dim() != 2 or yidx.shape[0] != n or xidx.shape != yidx.shape:
        raise ValueError(f"yidx/xidx must be (N, P) with N={n}, got "
                         f"{tuple(yidx.shape)} and {tuple(xidx.shape)}")
    p = yidx.shape[1]
    if tuple(w.shape) != (n, 4, p):
        raise ValueError(f"w must be {(n, 4, p)}, got {tuple(w.shape)}")
    if g is not None and tuple(g.shape) != (n, c, p):
        raise ValueError(f"g must be {(n, c, p)}, got {tuple(g.shape)}")
    tensors = [img, yidx, xidx, w] + ([g] if g is not None else [])
    if any(t.device != img.device for t in tensors):
        raise ValueError("band_sample tensors must share one device")
    if img.device.type == "cpu":
        return False
    if img.device.type != "cuda":
        raise ValueError(f"band_sample runs on cuda or cpu, not "
                         f"{img.device.type}")
    floats = [img, w] + ([g] if g is not None else [])
    if any(t.dtype != torch.float32 for t in floats) or \
            yidx.dtype != torch.int32 or xidx.dtype != torch.int32:
        raise TypeError("the CUDA band_sample takes f32 img/w/g and int32 "
                        "indices")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA band_sample takes contiguous tensors")
    if img.numel() >= 2 ** 31 or n * 4 * p >= 2 ** 31:
        raise ValueError("band_sample sizes must stay below 2^31 elements")
    return True


def band_sample_fwd(img, yidx, xidx, w):
    """Forward: ``out`` (N, C, P).  CPU tensors take the plain twin."""
    global FWD_LAUNCHES
    if not _check(img, yidx, xidx, w):
        return band_sample_fwd_plain(img, yidx, xidx, w)
    (n, c, h, wd), p = img.shape, yidx.shape[1]
    out = torch.empty(n, c, p, dtype=img.dtype, device=img.device)
    with torch.cuda.device(img.device):
        err = _lib().advchain_band_sample_fwd(
            img.data_ptr(), yidx.data_ptr(), xidx.data_ptr(), w.data_ptr(),
            out.data_ptr(), n, c, h, wd, p,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"band_sample_fwd launch failed: CUDA error {err}")
    FWD_LAUNCHES += 1
    return out


def band_sample_bwd(g, img, yidx, xidx, w):
    """Backward: ``(d_img (N, C, H, W), d_w (N, 4, P))`` in one launch.
    CPU tensors take the plain twin."""
    global BWD_LAUNCHES
    if not _check(img, yidx, xidx, w, g):
        return band_sample_bwd_plain(g, img, yidx, xidx, w)
    (n, c, h, wd), p = img.shape, yidx.shape[1]
    d_img = torch.zeros_like(img)
    d_w = torch.empty_like(w)
    with torch.cuda.device(img.device):
        err = _lib().advchain_band_sample_bwd(
            g.data_ptr(), img.data_ptr(), yidx.data_ptr(), xidx.data_ptr(),
            w.data_ptr(), d_img.data_ptr(), d_w.data_ptr(), n, c, h, wd, p,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"band_sample_bwd launch failed: CUDA error {err}")
    BWD_LAUNCHES += 1
    return d_img, d_w


class BandSample(torch.autograd.Function):
    """``out = band_sample_fwd(img, yidx, xidx, w)`` with gradients to
    ``img`` and ``w`` from one ``band_sample_bwd`` launch (the JAX
    ``_weighted_band_sample`` custom VJP).  The indices get no gradient."""

    @staticmethod
    def forward(ctx, img, yidx, xidx, w):
        ctx.save_for_backward(img, yidx, xidx, w)
        return band_sample_fwd(img, yidx, xidx, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        img, yidx, xidx, w = ctx.saved_tensors
        d_img, d_w = band_sample_bwd(g.contiguous(), img, yidx, xidx, w)
        return d_img, None, None, d_w
