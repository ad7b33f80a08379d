"""The plane grid pair's plain versions (the CPU path of
advchain_tpu_torch.kernels.plane_sample's grid contract, the 3D trilinear
route under ``ADVCHAIN_ZBAND=0``) against the route it replaced and against
the JAX package.

The plain forward is ``_coords.plane_weights`` followed by one flat plane
forward per z tap; the plain backward is the closed-form chain rule the
CUDA backward computes.  They are held against the route before the pair
(``plane_weights`` with autograd over the fold, and autograd through two
calls of the flat plane sum ``plane_sample_fwd_plain``), against JAX's ``_grid_sample_3d_pallas_packed`` (the packed
formulation, its Pallas ``plane_gather`` / ``plane_scatter`` in interpret
mode on the CPU), and, through ``compose_flow``, against JAX's default
stencil-or-sampler dispatch at grids with entries exactly on +-1.  Grids
carry 5% exact +-1 entries and entries past the volume; one volume has a
single plane, so both z taps collapse onto it.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advchain_tpu.kernels import gather_matmul as gm

from advchain_tpu_torch.kernels import _coords
from advchain_tpu_torch.kernels import plane_sample as ps
from advchain_tpu_torch.kernels import zband_sample as zs
from advchain_tpu_torch.kernels.plane_sample import (
    PlaneGridSample, plane_grid_sample_bwd, plane_grid_sample_bwd_plain,
    plane_grid_sample_fwd, plane_grid_sample_fwd_plain,
    plane_sample_fwd_plain)

from test_torch_corner import _spy_jax, jax_env  # noqa: F401
from test_torch_dispatch3d import (_flows, _jax_compose, _port_compose,
                                   _within)
import torch_threads  # noqa: F401  (one intra-op thread a process)

tgs = importlib.import_module("advchain_tpu_torch.ops.grid_sample")

# (D, H, W) volumes; the last has one plane, so both z taps collapse
VOLUMES = [(4, 5, 6), (5, 7, 9), (1, 6, 8)]
# padding modes with the edge padding's slope at an exact lower bound
PADDINGS = [("zeros", None), ("border", None), ("reflection", None),
            ("edge", 1.0), ("edge", 0.5)]


def _case(seed, volume, c=2, n=2, p=60, spread=1.3):
    """img (N, C, D, H, W), grid (N, P, 3) and cotangent (N, C, P) from a
    numpy seed: coordinates spread over ``spread`` times the volume, 5% of
    them exactly +-1."""
    r = np.random.RandomState(seed)
    img = r.randn(n, c, *volume).astype(np.float32)
    grid = (r.rand(n, p, 3) * 2 - 1) * spread
    ones = r.rand(n, p, 3) < 0.05
    grid = np.where(ones, np.sign(r.rand(n, p, 3) - 0.5), grid)
    cot = r.randn(n, c, p).astype(np.float32)
    return img, grid.astype(np.float32), cot


def _replaced_route(img, grid, cot, padding, align, slope):
    """The route before the pair: ``plane_weights`` (autograd over the
    fold) and autograd through one ``plane_sample_fwd_plain`` per z tap,
    summed."""
    n, c, d, h, w = img.shape
    p = grid.shape[1]
    x = img.clone().requires_grad_(True)
    gr = grid.clone().requires_grad_(True)
    zidx, yxidx, wts = _coords.plane_weights(
        gr.reshape(n, p, 1, 1, 3), d, h, w, padding, align, slope)
    flat = x.reshape(n, c, d, h * w)
    offsets = (0, 1, w, w + 1)
    out = (plane_sample_fwd_plain(flat, zidx[0], yxidx, wts[0], offsets)
           + plane_sample_fwd_plain(flat, zidx[1], yxidx, wts[1], offsets))
    out.backward(cot)
    return out.detach(), x.grad, gr.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding,slope", PADDINGS)
@pytest.mark.parametrize("volume", VOLUMES)
def test_plain_pair_matches_the_route_it_replaces(volume, padding, slope,
                                                  align, dtype):
    """Forward and d_img bit for bit (the same computation); d_grid within
    1e-6 of its largest entry in float32 (autograd sums the raw taps in
    another order) and 1e-6 absolute in float64."""
    img, grid, cot = (torch.from_numpy(a).to(dtype)
                      for a in _case(1, volume))
    s = None if slope is None else torch.tensor([slope], dtype=dtype)
    ref_out, ref_img, ref_grid = _replaced_route(img, grid, cot, padding,
                                                 align, s)
    out = plane_grid_sample_fwd_plain(img, grid, padding, align)
    d_img, d_grid = plane_grid_sample_bwd_plain(cot, img, grid, padding,
                                                align, s)
    assert torch.equal(out, ref_out)
    assert torch.equal(d_img, ref_img)
    scale = float(ref_grid.abs().max()) if dtype == torch.float32 else 1.0
    assert float((d_grid - ref_grid).abs().max()) <= 1e-6 * scale


def _jax_packed(img, grid, cot, padding, align, jax_env, monkeypatch):
    """JAX's packed formulation called by name, its plane kernels in
    interpret mode; output and VJP, (N, C, P) and (N, P, 3)."""
    jax_env(ADVCHAIN_ZBAND="0")
    planes = _spy_jax(monkeypatch, "plane_gather")
    n, p = grid.shape[:2]

    def f(x, g):
        return gm._grid_sample_3d_pallas_packed(
            x, g.reshape(n, p, 1, 1, 3), padding_mode=padding,
            align_corners=align).reshape(n, -1, p)

    out, vjp = jax.vjp(f, jnp.asarray(img), jnp.asarray(grid))
    d_img, d_grid = vjp(jnp.asarray(cot))
    assert planes, "JAX did not trace its plane kernels"
    return np.asarray(out), np.asarray(d_img), np.asarray(d_grid)


def _port_pair(img, grid, cot, padding, align):
    x = torch.from_numpy(img).requires_grad_(True)
    g = torch.from_numpy(grid).requires_grad_(True)
    out = PlaneGridSample.apply(x, g, padding, align)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), x.grad.numpy(), g.grad.numpy()


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
def test_plain_pair_matches_jax_packed(padding, align, jax_env,
                                       monkeypatch):
    """Output within 1e-5, d_img and d_grid within 1e-4 of JAX's packed
    route (the tolerances of test_torch_plane.py's route tests)."""
    img, grid, cot = _case(2, (4, 5, 6))
    ref = _jax_packed(img, grid, cot, padding, align, jax_env, monkeypatch)
    ours = _port_pair(img, grid, cot, padding, align)
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours[1], ref[1], atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours[2], ref[2], atol=1e-4, rtol=0)


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
def test_plain_pair_at_exact_bounds_matches_jax_packed(padding, jax_env,
                                                       monkeypatch):
    """Whole faces of the grid exactly on -1 and +1 on each axis, a point
    on a corner of the volume and one past it on every axis."""
    img, grid, cot = _case(3, (4, 5, 6), p=64, spread=1.0)
    g = grid.reshape(2, 4, 4, 4, 3)
    for axis, sl in ((2, np.s_[:, 0]), (1, np.s_[:, :, 0]),
                     (0, np.s_[:, :, :, 0])):
        g[sl + (axis,)] = -1.0
    for axis, sl in ((2, np.s_[:, -1]), (1, np.s_[:, :, -1]),
                     (0, np.s_[:, :, :, -1])):
        g[sl + (axis,)] = 1.0
    g[:, 1, 1, 1] = (1.0, -1.0, 1.0)
    g[:, 2, 2, 2] = (1.3, -1.2, 1.1)
    grid = g.reshape(2, 64, 3)
    ref = _jax_packed(img, grid, cot, padding, True, jax_env, monkeypatch)
    ours = _port_pair(img, grid, cot, padding, True)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("seed,disp", [(0, 0.8), (3, 3.0), (4, 3.0)])
def test_composition_on_the_plane_route_matches_the_default_dispatch(
        seed, disp, monkeypatch):
    """``compose_flow`` with ``ADVCHAIN_ZBAND=0`` (its same-shape 3D
    compositions on the plane pair with ``edge`` padding and the device
    predicate's slope) against JAX's default dispatch, flow2 within 0.8 or
    up to 3 voxels off the identity with 5% exact +-1 entries: output and
    both gradients within 1e-6 of their largest entries, the entries on
    -1 included."""
    monkeypatch.setenv("ADVCHAIN_ZBAND", "0")
    calls = []
    real = ps.plane_grid_sample_bwd_plain

    def spy(*args, **kwargs):
        calls.append(args[5] if len(args) > 5 else kwargs.get("lower_slope"))
        return real(*args, **kwargs)

    monkeypatch.setattr(ps, "plane_grid_sample_bwd_plain", spy)
    f1, f2, cot = _flows(seed, disp)
    ref = _jax_compose(f1, f2, cot, monkeypatch)
    ours = _port_compose(f1, f2, cot)
    for a, b in zip(ours, ref):
        _within(a, b, 1e-6)
    assert len(calls) == 1 and float(calls[0][0]) == (1.0 if disp < 1
                                                      else 0.5)
    if disp > 1:
        lower = f2 == -1
        assert np.abs(ref[2][lower]).max() > 1e-3 * np.abs(ref[2]).max()


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection",
                                     "edge"])
def test_plain_pair_gradcheck_float64(padding):
    """The plain pair through ``PlaneGridSample`` in float64: the closed
    form against finite differences, away from floor boundaries and clip
    bounds (random coordinates in [-0.9, 0.9], past the volume for zeros
    padding)."""
    r = np.random.RandomState(4)
    spread = 1.2 if padding == "zeros" else 0.9
    img = torch.from_numpy(r.randn(1, 2, 3, 4, 5)).requires_grad_(True)
    grid = torch.from_numpy((r.rand(1, 24, 3) * 2 - 1) * spread)
    grid.requires_grad_(True)
    for align in (True, False):
        assert torch.autograd.gradcheck(
            lambda a, b: PlaneGridSample.apply(a, b, padding, align),
            (img, grid))


def test_grid_sample_3d_takes_the_plain_pair_on_cpu(monkeypatch):
    """With ``ADVCHAIN_ZBAND=0``, grid_sample_3d on CPU tensors reaches the
    plain pair once each way, and neither the flat corner pair, the z-band
    pair nor the library's grid_sample."""
    monkeypatch.setenv("ADVCHAIN_ZBAND", "0")
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(ps, name, wrapped)

    def refuse(*args, **kwargs):
        raise AssertionError("the plane route took another sampler")

    spy("plane_grid_sample_fwd_plain", ps.plane_grid_sample_fwd_plain)
    spy("plane_grid_sample_bwd_plain", ps.plane_grid_sample_bwd_plain)
    for module, name in ((ps, "corner_sample_fwd"),
                         (ps, "corner_sample_bwd"),
                         (zs, "zband_grid_sample_fwd"),
                         (zs, "zband_grid_sample_bwd"),
                         (torch.nn.functional, "grid_sample")):
        monkeypatch.setattr(module, name, refuse)
    img, grid, _ = _case(5, (4, 6, 8))
    x = torch.from_numpy(img).requires_grad_(True)
    g = torch.from_numpy(grid).reshape(2, 3, 4, 5, 3).requires_grad_(True)
    out = tgs.grid_sample_3d(x, g, padding_mode="border")
    out.sum().backward()
    assert calls == ["plane_grid_sample_fwd_plain",
                     "plane_grid_sample_bwd_plain"]
    assert g.grad.shape == g.shape and bool(g.grad.abs().sum() > 0)


def test_launch_counters_stay_zero_on_cpu(monkeypatch):
    monkeypatch.setenv("ADVCHAIN_ZBAND", "0")
    ps.reset_launch_counts()
    img, grid, cot = (torch.from_numpy(a) for a in _case(6, (4, 6, 8)))
    plane_grid_sample_fwd(img, grid)
    plane_grid_sample_bwd(cot, img, grid)
    x = img.clone().requires_grad_(True)
    tgs.grid_sample_3d(x, grid.reshape(2, 3, 4, 5, 3)).sum().backward()
    assert ps.LAUNCHES["plane_grid"] == {"fwd": 0, "bwd": 0}
    assert ps.LAUNCHES["plane"] == {"fwd": 0, "bwd": 0}


def test_wrappers_reject_bad_arguments():
    img, grid, cot = (torch.from_numpy(a) for a in _case(7, (4, 6, 8)))
    with pytest.raises(ValueError):
        plane_grid_sample_fwd(img, grid, padding_mode="wrap")
    with pytest.raises(ValueError):
        plane_grid_sample_fwd(img, grid[..., :2])
    with pytest.raises(ValueError):
        plane_grid_sample_fwd(img[:, :, 0], grid)
    with pytest.raises(ValueError):
        plane_grid_sample_bwd(cot[:, :1], img, grid)
    with pytest.raises(ValueError):
        plane_grid_sample_bwd(cot, img, grid, "edge", True,
                              torch.zeros(0))
