"""MyRandAugment — RandAugment with parameter capture and replay (port of
advchain_tpu/utils/rand_augment.py).

Capability parity with reference common/my_rand_augment.py:92-194 (a
torchvision fork whose point is *reproducible paired augmentation*: the op
sequence, magnitudes and randomness are captured on the first call and
re-applied with ``reuse_param=True``), with torchvision's RandAugment
magnitude space and op set on float NCHW images in [0, 1].  Every op runs
on the input's device.  The geometric ops (shear, translate, rotate) sample
through :func:`advchain_tpu_torch.ops.grid_sample.grid_sample_2d` with
zeros padding and align_corners=True: on a CUDA tensor that is one launch
of the band grid forward kernel, in nearest or bilinear mode.  Op selection
stays on the host (``np.random.RandomState``), so one seed draws the same
op sequence and magnitudes as the JAX package.

Documented divergence from the reference: its replay branch restores only
the *last* op and magnitude (my_rand_augment.py:169-193), so its replay is
faithful for num_ops=1 only; here the FULL op sequence is captured and
replayed (the documented intent).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from advchain_tpu_torch.ops.conv import depthwise_conv
from advchain_tpu_torch.ops.grid_sample import grid_sample_2d

__all__ = ["MyRandAugment", "apply_op"]

GEOMETRIC_OPS = ("ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate")


def _pixel_map(op_name: str, magnitude: float, h: int, w: int):
    """The geometric op's inverse map (x, y) -> (x_src, y_src) in pixels, in
    the JAX package's op order; it takes tensors and numpy arrays alike."""
    if op_name == "ShearX":
        # torchvision shears about center=[0,0] with tan(shear) = magnitude
        return lambda x, y: (x + magnitude * y, y)
    if op_name == "ShearY":
        return lambda x, y: (x, y + magnitude * x)
    if op_name == "TranslateX":
        t = float(int(magnitude))
        return lambda x, y: (x - t, y)
    if op_name == "TranslateY":
        t = float(int(magnitude))
        return lambda x, y: (x, y - t)
    if op_name == "Rotate":
        ang = math.radians(magnitude)
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        cos, sin = math.cos(ang), math.sin(ang)

        def rot(x, y):
            dx, dy = x - cx, y - cy
            return cx + cos * dx - sin * dy, cy + sin * dx + cos * dy

        return rot
    raise ValueError(f"{op_name} is not a geometric op")


def _affine_pixel_warp(img, pixel_map, interp="nearest", fill=None):
    """Warp NCHW by a pixel-space inverse map (x_src, y_src) = f(x, y).

    ``fill`` (scalar or per-channel sequence, image scale) sets the value
    of out-of-view pixels, matching torchvision's ``fill=`` on the
    geometric functional ops (reference my_rand_augment.py:27-90,164-167),
    by the shift-to-zero-background trick: subtract fill, sample with zeros
    padding, add it back.  The (H, W, 2) grid is built once and broadcast
    over the batch."""
    n, c, h, w = img.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=img.device),
        torch.arange(w, dtype=torch.float32, device=img.device),
        indexing="ij")
    sx, sy = pixel_map(xs, ys)
    # divide by a tensor: CUDA divides by a Python scalar as a product
    # with its reciprocal, an ulp off the CPU's (and JAX's) quotient, and a
    # nearest tap on a half-integer follows that ulp
    gx = 2.0 * sx / torch.full_like(sx, float(max(w - 1, 1))) - 1.0
    gy = 2.0 * sy / torch.full_like(sy, float(max(h - 1, 1))) - 1.0
    grid = torch.stack([gx, gy], dim=-1)[None].expand(n, h, w, 2)
    fv = None
    if fill is not None:
        fv = torch.as_tensor(fill, dtype=torch.float32,
                             device=img.device).reshape(1, -1, 1, 1)
        if fv.shape[1] not in (1, c):
            raise ValueError(f"fill must be scalar or {c}-channel, got "
                             f"{fv.shape[1]} values")
        img = img - fv
    out = grid_sample_2d(img, grid, mode=interp, padding_mode="zeros",
                         align_corners=True)
    if fv is not None:
        out = out + fv
    return out


def _blend(img1, img2, ratio):
    return torch.clamp(ratio * img1 + (1.0 - ratio) * img2, 0.0, 1.0)


def _grayscale(img):
    if img.shape[1] == 3:
        r, g, b = img[:, 0:1], img[:, 1:2], img[:, 2:3]
        return 0.2989 * r + 0.587 * g + 0.114 * b
    return torch.mean(img, dim=1, keepdim=True)


def _equalize(img):
    """torchvision's ``_scale_channel`` on every (N, C) row at once: a
    256-bin int64 histogram per row, ``step = (size - count of the last
    nonzero bin) // 255``, ``lut = (cumsum + step // 2) // step`` shifted
    right one bin with ``lut[0] = 0``; identity where ``step == 0``."""
    q = torch.clamp(torch.floor(img * 255.0), 0, 255).to(torch.int64)
    flat = q.reshape(img.shape[0] * img.shape[1], -1)
    hist = torch.zeros(flat.shape[0], 256, dtype=torch.int64,
                       device=img.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat))
    bins = torch.arange(256, device=img.device)
    last = torch.argmax(torch.where(hist > 0, bins, -1), dim=1, keepdim=True)
    step = (flat.shape[1] - torch.gather(hist, 1, last)) // 255
    lut = torch.clamp((torch.cumsum(hist, dim=1) + step // 2)
                      // torch.clamp(step, min=1), 0, 255)
    lut = torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]], dim=1)
    out = torch.where(step == 0, flat, torch.gather(lut, 1, flat))
    return out.reshape(img.shape).to(torch.float32) / 255.0


def apply_op(img, op_name: str, magnitude: float, interp: str = "nearest",
             fill=None):
    """Apply one RandAugment op to a float NCHW image in [0, 1].

    ``fill`` affects only the geometric ops (shear/translate/rotate), as in
    torchvision (reference my_rand_augment.py:27-90)."""
    h, w = img.shape[2], img.shape[3]
    if op_name == "Identity":
        return img
    if op_name in GEOMETRIC_OPS:
        return _affine_pixel_warp(img, _pixel_map(op_name, magnitude, h, w),
                                  interp, fill)
    if op_name == "Brightness":
        return _blend(img, torch.zeros_like(img), 1.0 + magnitude)
    if op_name == "Color":
        return _blend(img, _grayscale(img), 1.0 + magnitude)
    if op_name == "Contrast":
        mean = torch.mean(_grayscale(img), dim=(2, 3), keepdim=True)
        return _blend(img, mean, 1.0 + magnitude)
    if op_name == "Sharpness":
        k = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]],
                         dtype=torch.float32, device=img.device) / 13.0
        smooth = depthwise_conv(img, k)
        # torchvision keeps the 1-px border unchanged
        mask = torch.zeros((1, 1, h, w), device=img.device)
        mask[:, :, 1:-1, 1:-1] = 1.0
        smooth = img * (1 - mask) + smooth * mask
        return _blend(img, smooth, 1.0 + magnitude)
    if op_name == "Posterize":
        shift = 8 - int(magnitude)
        q = torch.floor(img * 255.0).to(torch.int32)
        return ((q >> shift) << shift).to(torch.float32) / 255.0
    if op_name == "Solarize":
        thresh = magnitude / 255.0
        return torch.where(img >= thresh, 1.0 - img, img)
    if op_name == "AutoContrast":
        lo = torch.amin(img, dim=(2, 3), keepdim=True)
        hi = torch.amax(img, dim=(2, 3), keepdim=True)
        scale = torch.where(hi > lo, 1.0 / (hi - lo + 1e-12),
                            torch.ones_like(hi))
        return torch.where(hi > lo, (img - lo) * scale, img)
    if op_name == "Equalize":
        return _equalize(img)
    if op_name == "Invert":
        return 1.0 - img
    raise ValueError(f"The provided operator {op_name} is not recognized.")


class MyRandAugment:
    """RandAugment with capture/replay (reference my_rand_augment.py:92)."""

    def __init__(self, num_ops: int = 2, magnitude: int = 9,
                 num_magnitude_bins: int = 31,
                 interpolation: str = "nearest", fill=None, seed=None):
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.num_magnitude_bins = num_magnitude_bins
        self.interpolation = interpolation
        self.fill = fill
        self._rng = np.random.RandomState(seed)
        # captured state for replay
        self.op_sequence: Optional[List[Tuple[str, float]]] = None
        self.op_name = None
        self.magnitude_state = None

    def _augmentation_space(self, num_bins: int, image_size):
        h, w = image_size
        lin = np.linspace
        return {
            "Identity": (np.array(0.0), False),
            "ShearX": (lin(0.0, 0.3, num_bins), True),
            "ShearY": (lin(0.0, 0.3, num_bins), True),
            "TranslateX": (lin(0.0, 150.0 / 331.0 * w, num_bins), True),
            "TranslateY": (lin(0.0, 150.0 / 331.0 * h, num_bins), True),
            "Rotate": (lin(0.0, 30.0, num_bins), True),
            "Brightness": (lin(0.0, 0.9, num_bins), True),
            "Color": (lin(0.0, 0.9, num_bins), True),
            "Contrast": (lin(0.0, 0.9, num_bins), True),
            "Sharpness": (lin(0.0, 0.9, num_bins), True),
            "Posterize": (8 - (np.arange(num_bins) / ((num_bins - 1) / 4))
                          .round(), False),
            "Solarize": (lin(255.0, 0.0, num_bins), False),
            "AutoContrast": (np.array(0.0), False),
            "Equalize": (np.array(0.0), False),
        }

    def forward(self, img, reuse_param: bool = False, interpolation=None):
        interp = interpolation or self.interpolation
        h, w = img.shape[2], img.shape[3]
        if reuse_param and self.op_sequence is not None:
            seq = self.op_sequence
        else:
            space = self._augmentation_space(self.num_magnitude_bins, (h, w))
            names = list(space.keys())
            seq = []
            for _ in range(self.num_ops):
                op_name = names[int(self._rng.randint(len(names)))]
                magnitudes, signed = space[op_name]
                magnitude = (float(magnitudes[self.magnitude])
                             if magnitudes.ndim > 0 else 0.0)
                if signed and self._rng.randint(2):
                    magnitude *= -1.0
                seq.append((op_name, magnitude))
            self.op_sequence = seq
            self.op_name = seq[-1][0]
            self.magnitude_state = seq[-1][1]
        for op_name, magnitude in seq:
            img = apply_op(img, op_name, magnitude, interp=interp,
                           fill=self.fill)
        return img

    __call__ = forward
