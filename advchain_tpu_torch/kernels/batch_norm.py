"""Training-mode batch normalisation of an NCHW f32 tensor: the library's
forward, the CUDA kernel pair of its backward, the backward's plain twin,
the autograd function and the route that sends the 2D models' training
BatchNorm to it.

Not a port of a Pallas kernel: the pair replaces cuDNN's NCHW per-channel
backward (``bn_bw_1C11_kernel_new``) under
``models/unet.py::_FrozenStats._normalize``; the JAX package leaves
BatchNorm to Flax and XLA.  The kernels live in ``csrc/batch_norm.cu``
(which carries the design and bound note) and are built by ``_build`` on
first use.

The forward stays the one ``F.batch_norm`` runs
(``torch._batch_norm_impl_index``, which picks cuDNN's
``bn_fw_tr_1C11_kernel_NCHW`` on the card and writes the running
statistics back), and the backward reads the mean and invstd it saved.
The saved mean's rounding is carried into every gradient upstream of the
layer: the backward's ``dx`` sums over a channel to ``M (true mean -
saved mean)`` times its slope, not to 0, and the first convolution's
weight gradient takes that sum times the image's mean.  A forward whose
statistics round otherwise moves the norm of UNet_16's first weight
gradient by up to 3e-3 of itself, as far as float32 lies from float64
there; the library's statistics keep the port's gradients where the
library's own backward puts them.

Contract: ``x`` (N, C, S) viewed from a contiguous NCHW f32 tensor, S =
H * W, M = N * S values a channel, ``mean`` and ``invstd`` the forward's
saved statistics.  The backward gives ``dx = w invstd (dy - sum(dy) / M -
xhat sum(dy xhat) / M)``, ``dw = sum(dy xhat)``, ``db = sum(dy)``, ``xhat
= (x - mean) invstd``, each only where the running backward uses it
(``_autograd.will_run``); ``w`` may be absent.  A backward that builds a
graph (``create_graph=True``) takes the differentiable plain formula.
Every sum is taken in a fixed order with no float atomics, so two runs
give the same bits.  The function saves ``x`` (the input, not the output:
the ``nn.ReLU(inplace=True)`` after it writes the output in place).

Dispatch: a CPU tensor takes the plain twin; a CUDA tensor launches the
kernels or raises.  The program counter ``batchnorm.pair``
(``_trace.count``) counts each call that launches them.

Route (:func:`takes_pair`, read by ``_FrozenStats._normalize`` in training
mode outside a data group): a CUDA f32 4D contiguous NCHW input, f32
affine parameters and running statistics, a numeric momentum where the
running statistics are written back.  Every other input keeps
``F.batch_norm``: eval mode, the bf16 compute mode, 5D volumes, a data or
space group (``_GlobalBatchNorm``), CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
import numbers

import torch

from advchain_tpu_torch._trace import count
from advchain_tpu_torch.kernels import _build
from advchain_tpu_torch.kernels._autograd import grad_node, will_run

__all__ = ["BatchNormTrain", "batch_norm_train", "batch_norm_bwd",
           "batch_norm_bwd_plain", "takes_pair", "fits_pair"]

# csrc/batch_norm.cu's kThreads: the threads of a block
THREADS = 256
# the kernel's limits: a grid's channel axis and int32 element offsets
MAX_CHANNELS = 65535
MAX_NUMEL = 2 ** 31
_DIMS = (0, 2, 3)
_SHAPE = (1, -1, 1, 1)


# ------------------------------------------------------------- plain twin
def batch_norm_bwd_plain(x, dy, mean, invstd, weight, needs=(True,) * 3):
    """Plain PyTorch ``(dx, dw, db)`` of the contract from the saved
    ``mean`` and ``invstd`` (differentiable in every argument), None where
    ``needs`` says so."""
    m_count = x.numel() // x.shape[1]
    xc = x - mean.view(_SHAPE)
    sum_dy = dy.sum(_DIMS)
    sum_dy_xc = (dy * xc).sum(_DIMS)
    dx = None
    if needs[0]:
        scale = invstd if weight is None else weight * invstd
        slope = invstd * invstd * sum_dy_xc / m_count
        dx = scale.view(_SHAPE) * ((dy - (sum_dy / m_count).view(_SHAPE))
                                   - xc * slope.view(_SHAPE))
    return (dx, sum_dy_xc * invstd if needs[1] else None,
            sum_dy if needs[2] else None)


# ---------------------------------------------------------------- kernels
@functools.cache
def _lib():
    lib = _build.load("batch_norm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.advchain_batch_norm_bwd.argtypes = [ptr] * 9 + [i32] * 5 + [ptr]
    lib.advchain_batch_norm_bwd.restype = i32
    lib.advchain_batch_norm_resident.argtypes = [i32]
    lib.advchain_batch_norm_resident.restype = i32
    return lib


@functools.cache
def _resident(device_index: int, vec: int) -> int:
    """The blocks the card holds at once for the pair's two kernels."""
    with torch.cuda.device(device_index):
        blocks = _lib().advchain_batch_norm_resident(vec)
    if blocks <= 0:
        raise RuntimeError("batch_norm: the occupancy query failed")
    return blocks


def chunks_for(resident: int, n: int, c: int, s: int, vec: int) -> int:
    """The row chunks a channel is cut into: as many as keep the grid of
    ``chunks * c`` blocks within one resident wave (at least one), and no
    more than give every thread a vector."""
    return max(1, min(resident // c, math.ceil(n * s // vec / THREADS)))


def _vec(s: int, *tensors) -> int:
    """4 (16-byte loads) where S and every pointer allow it, else 1."""
    if s % 4 or any(t.data_ptr() % 16 for t in tensors if t is not None):
        return 1
    return 4


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fits(x, *per_channel) -> bool:
    """Whether ``x`` is an f32 4D contiguous NCHW tensor within the
    kernels' sizes (2 or more values a channel, at most MAX_CHANNELS
    channels, fewer than MAX_NUMEL values) and each per-channel tensor
    given is f32, contiguous, of C entries and on its device."""
    if not (x.dtype == torch.float32 and x.dim() == 4
            and x.is_contiguous()):
        return False
    n, c, h, w = x.shape
    if n * h * w < 2 or x.numel() >= MAX_NUMEL or c > MAX_CHANNELS:
        return False
    return all(t is None or (t.device == x.device
                             and t.dtype == torch.float32
                             and t.shape == (c,) and t.is_contiguous())
               for t in per_channel)


def _check(x, *per_channel) -> bool:
    """Validate a call.  False: CPU tensors, which take the plain twin;
    True: CUDA tensors the kernels take; anything else raises."""
    if x.dim() != 4:
        raise ValueError(f"batch_norm takes x (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm runs on cuda or cpu, not "
                         f"{x.device.type}")
    if not _fits(x, *per_channel):
        raise ValueError(
            f"the CUDA batch_norm takes a contiguous f32 x (N, C, H, W) "
            f"with 2 or more values a channel, at most {MAX_CHANNELS} "
            f"channels and fewer than 2^31 values, and contiguous f32 (C,) "
            f"tensors on its device; got x {x.dtype} {tuple(x.shape)}, "
            f"per-channel " + ", ".join(
                "None" if t is None else f"{t.dtype} {tuple(t.shape)} on "
                f"{t.device}" for t in per_channel))
    return True


def batch_norm_bwd(x, dy, mean, invstd, weight, needs=(True,) * 3):
    """``(dx, dw, db)`` in two launches (the partial sums of ``dy`` and
    ``dy * (x - mean)``, then their fold and ``dx``), None where ``needs``
    says so.  CPU tensors take the plain twin."""
    if dy.shape != x.shape or dy.device != x.device:
        raise ValueError(f"batch_norm: dy must be {tuple(x.shape)} on "
                         f"{x.device}, got {tuple(dy.shape)} on {dy.device}")
    if not _check(x, mean, invstd, weight):
        return batch_norm_bwd_plain(x, dy, mean, invstd, weight, needs)
    if dy.dtype != torch.float32 or not dy.is_contiguous():
        raise ValueError("the CUDA batch_norm takes a contiguous f32 dy")
    n, c, h, w = x.shape
    s = h * w
    dx = torch.empty_like(x) if needs[0] else None
    dw = torch.empty_like(mean) if needs[1] else None
    db = torch.empty_like(mean) if needs[2] else None
    vec = _vec(s, x, dy, dx)
    chunks = chunks_for(_resident(x.device.index, vec), n, c, s, vec)
    partial = torch.empty(c * chunks * 2, dtype=x.dtype, device=x.device)
    _build.launch(_lib().advchain_batch_norm_bwd, x.device, "batch_norm",
                  x.data_ptr(), dy.data_ptr(), mean.data_ptr(),
                  invstd.data_ptr(), _ptr(weight), _ptr(dx), _ptr(dw),
                  _ptr(db), partial.data_ptr(), n, c, s, chunks, vec)
    count("batchnorm.pair")
    return dx, dw, db


# --------------------------------------------------------------- autograd
def _bwd_graph(x, dy, weight, eps, needs):
    """The backward as differentiable plain operations, the statistics
    recomputed from ``x`` so that a double backward sees their
    dependence on it."""
    mean = x.mean(_DIMS)
    xc = x - mean.view(_SHAPE)
    invstd = 1 / torch.sqrt((xc * xc).mean(_DIMS) + eps)
    return batch_norm_bwd_plain(x, dy, mean, invstd, weight, needs)


class BatchNormTrain(torch.autograd.Function):
    """Training-mode batch normalisation: ``F.batch_norm``'s forward, the
    running statistics updated where ``stats`` is given, and the pair's
    backward (the contract above)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, stats):
        running_mean, running_var, momentum = (
            (None, None, 0.0) if stats is None else stats)
        y, mean, invstd, _, _ = torch._batch_norm_impl_index(
            x, weight, bias, running_mean, running_var, True, momentum, eps,
            torch.backends.cudnn.enabled)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.eps = eps
        ctx.nodes = (grad_node(weight), grad_node(bias))
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        needs = (need_x, need_w and will_run(ctx.nodes[0]),
                 need_b and will_run(ctx.nodes[1]))
        if torch.is_grad_enabled():
            grads = _bwd_graph(x, dy, weight, ctx.eps, needs)
        else:
            grads = batch_norm_bwd(x, dy.contiguous(), mean, invstd, weight,
                                   needs)
        return (*grads, None, None)


def batch_norm_train(x, weight, bias, eps, stats=None):
    """Training-mode batch normalisation of ``x`` with the pair's
    backward, the running statistics ``stats`` (running mean, running
    variance, momentum) updated where given."""
    return BatchNormTrain.apply(x, weight, bias, eps, stats)


def fits_pair(x, weight, bias, stats=None) -> bool:
    """Whether the tensors fit the route's contract, wherever they lie: an
    f32 4D contiguous NCHW ``x`` within the kernels' sizes, f32
    contiguous per-channel parameters on its device and, where the running
    statistics are written back, both of them and a numeric momentum."""
    if stats is None:
        return _fits(x, weight, bias)
    *running, momentum = stats
    return (all(t is not None for t in running)
            and isinstance(momentum, numbers.Real)
            and not isinstance(momentum, bool)
            and _fits(x, weight, bias, *running))


def takes_pair(x, weight, bias, stats=None) -> bool:
    """Whether a training-mode normalisation outside a data group takes
    the pair: a CUDA input that :func:`fits_pair`.  Decided by what the
    tensors show, never by an error caught."""
    return x.is_cuda and fits_pair(x, weight, bias, stats)
