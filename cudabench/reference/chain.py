"""Plain PyTorch version of upstream advchain's adversarial transform chain
and its solver (``ComposeAdversarialTransformSolver``): noise, bias field,
affine and diffeomorphic morph, in 2D and 3D, with their PGD updates,
projections and the warp-back of the prediction.

Everything here is ``torch`` and ``torch.nn.functional``: ``F.grid_sample``
(align_corners=True) for every warp and every flow composition,
``F.affine_grid``, ``F.conv_transpose`` by the dense B-spline kernel for
the bias field, dense depthwise Gaussian convolutions, ``F.interpolate``.

Each transform's initial parameters are drawn from the caller's generator
in the chain's order, with the calls the measured program makes
(``randn`` for the noise, ``rand`` for the others), so that both sides
start the episode from the same draws; everything after the draw is worked
out here again."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

GEOMETRIC = ("affine", "morph")


def unit_normalize(d):
    """Each sample scaled to unit l2 norm (``d / (||d|| + 1e-20)``)."""
    n = d.shape[0]
    flat = d.reshape(n, -1)
    norm = torch.sqrt(torch.sum(flat * flat, dim=1, keepdim=True))
    return (flat / (norm + 1e-20)).reshape(d.shape)


def sample(x, grid_cf, padding):
    """Bilinear / trilinear sampling of ``x`` at a channel-first grid (N, d,
    *S) in [-1, 1], align_corners=True."""
    grid = torch.movedim(grid_cf, 1, -1)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode=padding,
                         align_corners=True)


def identity_grid(n, spatial, device, dtype=torch.float32):
    """(N, d, *S) identity grid; channel 0 (x) runs along the last axis."""
    axes = [torch.linspace(-1.0, 1.0, s, dtype=dtype, device=device)
            for s in spatial]
    mesh = torch.meshgrid(*axes, indexing="ij")
    d = len(spatial)
    grid = torch.stack([mesh[d - 1 - i] for i in range(d)], dim=0)[None]
    return grid.expand((n, d) + tuple(spatial))


# ------------------------------------------------------------------ noise
class Noise:
    name = "noise"

    def __init__(self, cfg, data_size, pi):
        self.eps, self.xi, self.pi = cfg["epsilon"], cfg["xi"], pi
        self.size = tuple(data_size)

    def draw(self, gen):
        return unit_normalize(torch.randn(self.size, generator=gen,
                                          device=gen.device))

    def prepare(self, p):
        return unit_normalize(p) if self.pi else p

    def aux(self, p, training):
        return None

    def apply(self, aux, p, x, training):
        return x + (self.xi if (self.pi and training) else self.eps) * p

    def update(self, p, g):
        g = unit_normalize(g)
        return g if self.pi else p + g

    def project(self, p):
        return unit_normalize(p)


# ------------------------------------------------------------------- bias
def _bspline_1d(spacing, order, dims):
    """Upstream's iterated box filter along one axis, in float64: in 2D
    iteration i pads by ``i * spacing``, in 3D by ``spacing - 1``."""
    k = np.ones(spacing)
    for i in range(1, order + 1):
        pad = i * spacing if dims == 2 else spacing - 1
        k = np.convolve(np.pad(k, pad), np.ones(spacing), "valid") / spacing
    return k


class Bias:
    name = "bias"

    def __init__(self, cfg, data_size, pi):
        if cfg["init_mode"] != "random" or cfg["space"] != "log":
            raise NotImplementedError("the reference's bias field draws "
                                      "'random' control points in log space")
        self.pi, self.xi = pi, 1e-6
        self.mag = cfg["epsilon"]
        self.size = tuple(data_size)
        image = np.array(data_size[2:], dtype=np.float64)
        self.dims = len(image)
        down = int(cfg["downscale"])
        order = int(cfg["interpolation_order"])
        stride = np.array([int(s) // down for s in
                           cfg["control_point_spacing"]])
        cp = np.ceil(image / down / stride).astype(int)
        inner = stride * cp - (stride - 1)
        cp = cp + 2
        diff = inner - image / down
        dfloor = np.floor(np.abs(diff) / 2) * np.sign(diff)
        crop_start = (dfloor
                      + np.remainder(diff, 2) * np.sign(diff)).astype(int)
        crop_end = dfloor.astype(int)
        axes = [_bspline_1d(int(s), order, self.dims) for s in stride]
        kernel = axes[0]
        for a in axes[1:]:
            kernel = np.multiply.outer(kernel, a)
        self.kernel = kernel.astype(np.float32)
        self.stride = tuple(int(s) for s in stride)
        self.pad = tuple((np.array(kernel.shape) - 1) // 2)
        self.lo_crop = tuple(int(s + c) for s, c in zip(stride, crop_start))
        self.hi_crop = tuple(int(s + c) for s, c in zip(stride, crop_end))
        self.cp_shape = (self.size[0], 1) + tuple(int(c) for c in cp)
        self.image = tuple(int(s) for s in image)
        self.low = math.log(1.0 - self.mag)
        self.high = math.log(1.0 + self.mag)
        self._k = {}

    def draw(self, gen):
        u = torch.rand(self.cp_shape, generator=gen, device=gen.device)
        return u * (self.high - self.low) + self.low

    def prepare(self, p):
        return unit_normalize(p) if self.pi else p

    def field(self, cp):
        k = self._k.get((cp.device, cp.dtype))
        if k is None:
            k = self._k[cp.device, cp.dtype] = torch.as_tensor(
                self.kernel, dtype=cp.dtype, device=cp.device)[None, None]
        conv_t = F.conv_transpose2d if self.dims == 2 else F.conv_transpose3d
        f = conv_t(cp, k, stride=self.stride, padding=self.pad)
        f = f[(slice(None), slice(None)) + tuple(
            slice(lo, f.shape[2 + i] - hi) for i, (lo, hi) in
            enumerate(zip(self.lo_crop, self.hi_crop)))]
        if self.dims == 2:
            size, mode = self.image, "bilinear"
        else:
            size = tuple(int(math.floor(c * (t / c)))
                         for t, c in zip(self.image, f.shape[2:]))
            mode = "trilinear"
        if tuple(f.shape[2:]) != tuple(size):
            f = F.interpolate(f, size=size, mode=mode, align_corners=False)
        f = torch.exp(f)
        return 1.0 + torch.clamp(f - 1.0, -self.mag, self.mag)

    def aux(self, p, training):
        return self.field((self.xi if (self.pi and training) else 1.0) * p)

    def apply(self, aux, p, x, training):
        return aux * x

    def update(self, p, g):
        g = unit_normalize(g)
        return g if self.pi else p + g

    def project(self, p):
        return torch.clamp(p, self.low, self.high)


# ----------------------------------------------------------------- affine
class Affine:
    name = "affine"

    def __init__(self, cfg, data_size, pi):
        self.pi, self.xi, self.cfg = pi, 1e-6, cfg
        self.size = tuple(data_size)
        self.dims = len(data_size) - 2

    def draw(self, gen):
        k = 5 if self.dims == 2 else 9
        return 2.0 * torch.rand((self.size[0], k), generator=gen,
                                device=gen.device) - 1.0

    def prepare(self, p):
        return torch.sign(p) if self.pi else p

    def matrix(self, p):
        c = self.cfg
        t = torch.clamp(p, -1.0, 1.0)
        if self.dims == 2:
            rot, sx, sy, tx, ty = t.unbind(1)
            a = rot * c["rot"] * math.pi
            cx, cy = 1.0 + sx * c["scale_x"], 1.0 + sy * c["scale_y"]
            r0 = torch.stack([cx * torch.cos(a), -cy * torch.sin(a),
                              tx * c["shift_x"]], -1)
            r1 = torch.stack([cx * torch.sin(a), cy * torch.cos(a),
                              ty * c["shift_y"]], -1)
            return torch.stack([r0, r1], 1)
        rx, ry, rz, sx, sy, sz, tx, ty, tz = t.unbind(1)
        phi, th, ps = (rx * c["rot_x"] * math.pi, ry * c["rot_y"] * math.pi,
                       rz * c["rot_z"] * math.pi)
        cf, sf, ct, st, cp, sp = (torch.cos(phi), torch.sin(phi),
                                  torch.cos(th), torch.sin(th),
                                  torch.cos(ps), torch.sin(ps))
        rot = torch.stack([
            torch.stack([ct * cp, -cf * sp + sf * st * cp,
                         sf * sp + cf * st * cp], -1),
            torch.stack([ct * sp, cf * cp + sf * st * sp,
                         -sf * cp + cf * st * sp], -1),
            torch.stack([-st, sf * ct, cf * ct], -1)], 1)
        scale = torch.diag_embed(torch.stack(
            [1.0 + sx * c["scale_x"], 1.0 + sy * c["scale_y"],
             1.0 + sz * c["scale_z"]], -1))
        shift = torch.stack([tx * c["shift_x"], ty * c["shift_y"],
                             tz * c["shift_z"]], -1)
        return torch.cat([rot @ scale, shift[:, :, None]], 2)

    def aux(self, p, training):
        m = self.matrix(self.xi * p if (self.pi and training) else p)
        d = self.dims
        last = torch.zeros(m.shape[0], 1, d + 1, dtype=m.dtype,
                           device=m.device)
        last[:, 0, d] = 1.0
        inv = torch.linalg.inv(torch.cat([m, last], 1))[:, :d]
        return m, inv

    def _warp(self, x, theta):
        grid = F.affine_grid(theta, list(x.shape), align_corners=True)
        return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    def apply(self, aux, p, x, training):
        return self._warp(x, aux[0])

    def inverse(self, aux, p, x, training):
        return self._warp(x, aux[1])

    def update(self, p, g):
        g = torch.sign(g)
        return g if self.pi else p + g

    def project(self, p):
        return p


# ------------------------------------------------------------------ morph
def _gaussian(x, sigma=1.0, ks=5):
    """Upstream's depthwise Gaussian smoothing (zero padding); the kernel
    grows to ``2 * int(4 * sigma + 0.5) + 1`` taps as upstream's does."""
    dims = x.dim() - 2
    bound = 2 * int(4 * sigma + 0.5) + 1
    ks = bound if (ks < bound if dims == 2 else ks <= bound) else ks
    t = np.arange(ks) - (ks - 1) / 2.0
    g = np.exp(-t ** 2 / (2.0 * sigma ** 2))
    g = g / g.sum()
    k = g
    for _ in range(dims - 1):
        k = np.multiply.outer(k, g)
    c = x.shape[1]
    w = torch.as_tensor(k, dtype=x.dtype, device=x.device)
    w = w[None, None].expand((c, 1) + w.shape).contiguous()
    conv = F.conv2d if dims == 2 else F.conv3d
    return conv(x, w, padding=(ks - 1) // 2, groups=c)


class Morph:
    name = "morph"
    steps = 8

    def __init__(self, cfg, data_size, pi):
        self.pi, self.xi, self.eps = pi, 0.5, cfg["epsilon"]
        self.size = tuple(data_size)
        self.dims = len(data_size) - 2
        self.vec = tuple(int(v) for v in cfg["vector_size"])

    def draw(self, gen):
        shape = (self.size[0], self.dims) + self.vec
        return unit_normalize(2.0 * torch.rand(shape, generator=gen,
                                               device=gen.device) - 1.0)

    def prepare(self, p):
        return unit_normalize(p) if self.pi else p

    def _step_count(self, duv):
        if self.dims == 2:
            return self.steps
        norm = float(torch.linalg.vector_norm(duv.detach().reshape(-1)))
        need = math.ceil(math.log2(max(norm, 1e-30) / 0.5))
        return min(max(self.steps, need), self.steps + 8)

    def deformation(self, duv):
        """Velocity -> smoothed deformation grid (N, d, *S) in [-1, 1]:
        smooth, upsample, scaling and squaring, clamp, smooth the offsets,
        clamp."""
        n = duv.shape[0]
        image = self.size[2:]
        duv = _gaussian(duv)
        duv = F.interpolate(duv, size=image, mode="bilinear" if self.dims ==
                            2 else "trilinear", align_corners=False)
        grid = identity_grid(n, image, duv.device, duv.dtype)
        steps = self._step_count(duv)
        phi0 = grid + duv / (2.0 ** steps)
        phi = phi0
        for _ in range(steps):
            phi = sample(phi, phi, "border")
        composed = torch.clamp(phi - phi0 + grid, -1.0, 1.0)
        composed = _gaussian(composed - grid) + grid
        return torch.clamp(composed, -1.0, 1.0)

    def aux(self, p, training):
        s = self.xi if (self.pi and training) else self.eps
        return self.deformation(s * p), self.deformation(-s * p)

    def apply(self, aux, p, x, training):
        return sample(x, aux[0], "zeros")

    def inverse(self, aux, p, x, training):
        return sample(x, aux[1], "zeros")

    def update(self, p, g):
        g = unit_normalize(g)
        return g if self.pi else p + g

    def project(self, p):
        return unit_normalize(p)


TRANSFORMS = {"noise": Noise, "bias": Bias, "affine": Affine, "morph": Morph}


def build_chain(chain_cfg, data_size, power_iteration):
    """The chain's transforms from the configuration's list of
    ``{"name", "config"}``; ``power_iteration`` True / False / "smart"
    (the noise alone)."""
    out = []
    for entry in chain_cfg:
        name = entry["name"]
        pi = (name == "noise") if power_iteration == "smart" \
            else bool(power_iteration)
        out.append(TRANSFORMS[name](entry["config"], data_size, pi))
    return out


def warped_dist(chain, params, x, init_out, training, net, detach_input,
                types, weights):
    """Chain -> network -> warp-back of the prediction with the validity
    mask -> divergence; returns (divergence, adversarial image)."""
    auxs = [t.aux(p, training) for t, p in zip(chain, params)]
    adv = x
    for t, p, a in zip(chain, params, auxs):
        adv = t.apply(a, p, adv, training)
    out = net(adv.detach() if detach_input else adv)
    geo = [(t, p, a) for t, p, a in zip(chain, params, auxs)
           if t.name in GEOMETRIC]
    if not geo:
        return losses_consistency(out, init_out, None, types, weights), adv
    ones = torch.ones((x.shape[0], 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    fwd = ones
    for t, p, a in geo:
        fwd = t.apply(a, p, fwd, training)
    both = torch.cat([out, fwd], 1)
    for t, p, a in reversed(geo):
        both = t.inverse(a, p, both, training)
    c = out.shape[1]
    warped = both[:, :c]
    m = both[:, c:c + 1]
    mask = torch.where(m != 0, torch.ones_like(m), m)
    return losses_consistency(warped, init_out, mask, types, weights), adv


def losses_consistency(pred, ref, mask, types, weights):
    from .losses import consistency
    if mask is None:
        mask = torch.ones_like(pred[:, :1])
    return consistency(pred, ref, mask, types, weights)


def episode(chain, params, x, init_out, net, n_iter, types, weights):
    """``n_iter`` PGD steps on every transform (a non-finite divergence
    keeps the parameters), then the projection; returns the detached
    parameters."""
    params = [t.prepare(p) for t, p in zip(chain, params)]
    if n_iter > 0:
        for _ in range(n_iter):
            opt = [p.detach().requires_grad_(True) for p in params]
            dist, _ = warped_dist(chain, opt, x, init_out, True, net, False,
                                  types, weights)
            grads = torch.autograd.grad(dist, opt)
            ok = torch.isfinite(dist.detach())
            params = [torch.where(ok, t.update(p.detach(), g), p.detach())
                      for t, p, g in zip(chain, opt, grads)]
        params = [t.project(p) for t, p in zip(chain, params)]
    return [p.detach() for p in params]
