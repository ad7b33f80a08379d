"""The weight and bias gradients of a 3x3x3 SAME Conv3d (stride 1, padding
1, no dilation, one group): the CUDA kernel pair, its plain twin, and the
autograd function that sends ``ZDecomposedConv3d``'s backward to them.

Not a port of a Pallas kernel: it replaces cuDNN's weight gradient of
PseudoConv3dModel's convolutions (``wgrad2d_grouped_direct_kernel`` at the
3D cell's shapes), which the JAX package leaves to
``lax.conv_general_dilated`` (advchain_tpu/models/unet.py:328-353).  The
kernels live in ``csrc/conv3d_wgrad.cu`` (which carries the design and
bound note) and are built by ``_build`` on first use.

Contract: ``x`` (N, Cin, D, H, W) and ``dy`` (N, Cout, D, H, W), f32;
``dW[co, ci, kz, ky, kx] = sum dy[n, co, z, y, x] * x[n, ci, z+kz-1,
y+ky-1, x+kx-1]`` with zero outside the volume, ``db[co] = sum dy[n, co]``.
The kernel sums in a fixed order with no float atomics, so two runs give
the same bits.

Dispatch: a CPU tensor takes the plain twin; a CUDA tensor launches the
kernels or raises.  ``LAUNCHES`` counts calls that launch the pair (the
partial sums and their reduction) and nothing else, as does the program
counter ``conv3d_wgrad.pair`` (``_trace.count``).

Width rule (:func:`takes_pair`, read by ``ZDecomposedConv3d``): the pair
wins where cuDNN's weight gradient is pathological, at few channels; its
time grows with ``Cin * Cout``, where cuDNN's implicit GEMM does well.  A
layer takes the pair where ``Cin * Cout <= PAIR_PRODUCTS`` and one block a
plane keeps the scratch within ``SCRATCH_CAP`` (:func:`scratch_fits`);
every other layer keeps cuDNN's.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from advchain_tpu_torch._trace import count
from advchain_tpu_torch.kernels import _build
from advchain_tpu_torch.kernels._autograd import grad_node, will_run

__all__ = ["Conv3dSame", "conv3d_same", "conv3d_wgrad",
           "conv3d_wgrad_plain", "reset_launch_counts", "takes_pair",
           "scratch_fits"]

LAUNCHES = 0
# csrc/conv3d_wgrad.cu's kWarps: the warps of a block, each walking its own
# run of output rows
WARPS = 4
# the scratch a call aims to stay under (bytes): the segments' partial sums
SCRATCH_BYTES = 2 << 20
# the width rule, from dW + db timed against cuDNN's on an H100
# (scripts/conv3d_width_table.py): the pair is 20-200x faster up to 512
# Cin * Cout products and 2x at 1024, the two tie at 2048 and 4096, and
# cuDNN is 1.8-4.7x faster from 8192 on; where the pair won, its least
# scratch was at most 21 MB
PAIR_PRODUCTS = 1024
SCRATCH_CAP = 16 * SCRATCH_BYTES


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0


# ------------------------------------------------------------- plain twin
def conv3d_wgrad_plain(x, dy):
    """Plain PyTorch ``(dW, db)`` (any device, any float dtype): the
    27-tap sum of products of ``dy`` with the zero-padded ``x`` shifted by
    each tap."""
    d, h, w = x.shape[2:]
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    taps = [torch.einsum("nodhw,nidhw->oi", dy,
                         xp[:, :, kz:kz + d, ky:ky + h, kx:kx + w])
            for kz in range(3) for ky in range(3) for kx in range(3)]
    dw = torch.stack(taps, dim=-1).reshape(dy.shape[1], x.shape[1], 3, 3, 3)
    return dw, dy.sum(dim=(0, 2, 3, 4))


# ---------------------------------------------------------------- kernels
@functools.cache
def _lib():
    lib = _build.load("conv3d_wgrad")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.advchain_conv3d_wgrad.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.advchain_conv3d_wgrad.restype = i32
    lib.advchain_conv3d_wgrad_scratch.argtypes = [i32] * 7
    lib.advchain_conv3d_wgrad_scratch.restype = ctypes.c_int64
    return lib


def plane_scratch_bytes(n, cin, cout, d, w) -> int:
    """The scratch of one block a plane down H: the least a call needs."""
    return n * d * math.ceil(w / 32) * (cout * cin * 27 + cout) * 4


def rows_per_warp(n, cin, cout, d, h, w) -> int:
    """The output rows a warp walks: about 96 rows a block of ``WARPS``
    warps (24 a warp, the fastest run length at the 3D cell's shapes on an
    H100), fewer blocks down H where the segments' partial sums would pass
    ``SCRATCH_BYTES`` (never fewer than one a plane)."""
    per_block = plane_scratch_bytes(n, cin, cout, d, w)
    row_blocks = max(1, min(round(h / 96), SCRATCH_BYTES // per_block))
    return math.ceil(h / (WARPS * row_blocks))


def takes_pair(cin: int, cout: int) -> bool:
    """Whether a 3x3x3 f32 layer of these widths takes the pair's weight
    gradient rather than cuDNN's (the width rule)."""
    return cin * cout <= PAIR_PRODUCTS


def scratch_fits(n, cin, cout, d, w) -> bool:
    """Whether the least scratch a call needs stays within
    ``SCRATCH_CAP``: a safeguard only.  At every timed shape that
    :func:`takes_pair` admits, the least scratch is at most 21 MB, within
    the cap; it refuses the pair to a narrow layer on a volume far larger
    than any timed one, whose N * D * ceil(W / 32) segments of partial sums
    would pass it."""
    return plane_scratch_bytes(n, cin, cout, d, w) <= SCRATCH_CAP


def _check(x, dy) -> bool:
    """Validate a call.  False: CPU tensors, which take the plain twin;
    True: CUDA tensors the kernel takes; anything else raises."""
    if x.dim() != 5 or dy.dim() != 5:
        raise ValueError(f"conv3d_wgrad takes x (N, Cin, D, H, W) and dy "
                         f"(N, Cout, D, H, W), got {tuple(x.shape)} and "
                         f"{tuple(dy.shape)}")
    if x.shape[0] != dy.shape[0] or x.shape[2:] != dy.shape[2:]:
        raise ValueError(f"conv3d_wgrad: dy must be (N, Cout) + "
                         f"{tuple(x.shape[2:])} with N = {x.shape[0]}, got "
                         f"{tuple(dy.shape)}")
    if x.device != dy.device:
        raise ValueError("conv3d_wgrad tensors must share one device")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_wgrad runs on cuda or cpu, not "
                         f"{x.device.type}")
    if x.dtype != torch.float32 or dy.dtype != torch.float32:
        raise TypeError("the CUDA conv3d_wgrad takes f32 tensors")
    if not x.is_contiguous() or not dy.is_contiguous():
        raise ValueError("the CUDA conv3d_wgrad takes contiguous tensors")
    if x.numel() >= 2 ** 31 or dy.numel() >= 2 ** 31:
        raise ValueError("conv3d_wgrad sizes must stay below 2^31 elements")
    return True


def conv3d_wgrad(x, dy):
    """``(dW (Cout, Cin, 3, 3, 3), db (Cout,))`` in two launches: the
    partial sums of runs of :func:`rows_per_warp` rows into a scratch
    buffer, then their reduction in a fixed order.  CPU tensors take the
    plain twin."""
    global LAUNCHES
    if not _check(x, dy):
        return conv3d_wgrad_plain(x, dy)
    n, cin, d, h, w = x.shape
    cout = dy.shape[1]
    dw = torch.empty(cout, cin, 3, 3, 3, dtype=x.dtype, device=x.device)
    db = torch.empty(cout, dtype=x.dtype, device=x.device)
    if x.numel() == 0 or dy.numel() == 0:
        return dw.zero_(), db.zero_()
    rows = rows_per_warp(n, cin, cout, d, h, w)
    lib = _lib()
    partial = torch.empty(
        lib.advchain_conv3d_wgrad_scratch(n, cin, cout, d, h, w, rows),
        dtype=x.dtype, device=x.device)
    _build.launch(lib.advchain_conv3d_wgrad, x.device, "conv3d_wgrad",
                  x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                  dw.data_ptr(), db.data_ptr(), n, cin, cout, d, h, w, rows)
    LAUNCHES += 1
    count("conv3d_wgrad.pair")
    return dw, db


# --------------------------------------------------------------- autograd
class Conv3dSame(torch.autograd.Function):
    """``F.conv3d(x, weight, bias, padding=1)`` for a 3x3x3 ``weight``,
    with the data gradient from ``torch.nn.grad.conv3d_input`` and the
    weight and bias gradients from :func:`conv3d_wgrad`, each only where
    the running backward uses it: ``needs_input_grad`` is true for a
    parameter that ``torch.autograd.grad`` does not ask for, so the weight
    and bias nodes are kept at forward time and asked whether the engine
    will run them.  A backward that builds a graph (``create_graph=True``,
    for a double backward) takes the library's differentiable
    ``convolution_backward`` instead.  Saves ``(x, weight)``, as the
    convolution's own node does."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.nodes = (grad_node(weight), grad_node(bias))
        return F.conv3d(x, weight, bias, padding=1)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        need_w = need_w and will_run(ctx.nodes[0])
        need_b = need_b and will_run(ctx.nodes[1])
        if torch.is_grad_enabled():
            return torch.ops.aten.convolution_backward(
                dy, x, weight, [weight.shape[0]], [1] * 3, [1] * 3, [1] * 3,
                False, [0] * 3, 1, [need_x, need_w, need_b])
        dx = (torch.nn.grad.conv3d_input(x.shape, weight, dy, padding=1)
              if need_x else None)
        dw = db = None
        if need_w or need_b:
            dw, db = conv3d_wgrad(x.contiguous(), dy.contiguous())
        return dx, dw if need_w else None, db if need_b else None


def conv3d_same(x, weight, bias=None):
    """A 3x3x3 SAME convolution whose weight gradient is the kernel's."""
    return Conv3dSame.apply(x, weight, bias)
