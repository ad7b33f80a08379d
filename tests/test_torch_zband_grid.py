"""The z-band grid pair's plain versions (the CPU path of
advchain_tpu_torch.kernels.zband_sample's grid contract) against autograd
through the corner fold and against the JAX package.

The plain backward is the closed-form chain rule the CUDA backward
computes; it is held against autograd through ``corner_weights_3d`` and
the corner sum ``zband_sample_fwd_plain`` (the route before the fused
pair), and the whole sample
against JAX's ``grid_sample_3d_pallas`` / ``grid_sample_3d_pallas_nearest``,
which run the Pallas z-band kernels in interpret mode on the CPU with the
scatter's exact f32 tier (``ADVCHAIN_SCATTER_SPLIT=3``).  Grids carry
exact +-1 entries, integer and half-integer pixel coordinates (floor
boundaries and nearest's ties) and entries past the volume; one case has a
volume axis of size 1 (every +1 tap collapses).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advchain_tpu.kernels import gather_matmul as gm

from advchain_tpu_torch.kernels import zband_sample as zs
from advchain_tpu_torch.kernels.zband_sample import (
    ZBandGridSample, zband_grid_sample_bwd, zband_grid_sample_bwd_plain,
    zband_grid_sample_fwd, zband_grid_sample_fwd_plain,
    zband_sample_fwd_plain)
from advchain_tpu_torch.ops.grid_sample import (corner_weights_3d,
                                                grid_sample_3d)
import torch_threads  # noqa: F401  (one intra-op thread a process)

PADDINGS = ["zeros", "border", "reflection"]
# (D, H, W) volumes; the last has one plane, so every +1 z tap collapses
VOLUMES = [(4, 6, 8), (5, 7, 9), (1, 6, 8)]


def _case(seed, volume, c=3, n=2, out=(3, 4, 5), align=True):
    """img (N, C, D, H, W), grid (N, P, 3) and cotangent (N, C, P) from a
    numpy seed.  A quarter of the coordinates sit on whole or half pixels
    (exact for align_corners at these sizes where S - 1 is a power of two),
    5% on exactly +-1, and the rest spread over 1.3 times the volume."""
    r = np.random.RandomState(seed)
    p = int(np.prod(out))
    img = r.randn(n, c, *volume).astype(np.float32)
    grid = ((r.rand(n, p, 3) * 2 - 1) * 1.3).astype(np.float32)
    for axis, size in enumerate(reversed(volume)):  # channel 0 indexes W
        pix = r.randint(-2, 2 * size + 1, size=(n, p)) / 2.0
        span = (size - 1) if align else size
        on_pix = (2.0 * pix / max(span, 1) - 1.0).astype(np.float32)
        pick = r.rand(n, p) < 0.25
        grid[..., axis] = np.where(pick, on_pix, grid[..., axis])
    ones = r.rand(n, p, 3) < 0.05
    grid = np.where(ones, np.sign(r.rand(n, p, 3) - 0.5), grid)
    cot = r.randn(n, c, p).astype(np.float32)
    return img, grid.astype(np.float32), cot


def _autograd_through_fold(img, grid, cot, padding, align):
    """The route before the fused pair: ``corner_weights_3d`` (autograd
    over the fold) and autograd through the corner sum
    ``zband_sample_fwd_plain``."""
    n, p = grid.shape[:2]
    d, h, w = img.shape[2:]
    x = img.clone().requires_grad_(True)
    gr = grid.clone().requires_grad_(True)
    zidx, yidx, xidx, wts = corner_weights_3d(
        gr.reshape(n, p, 1, 1, 3), d, h, w, padding, align)
    out = zband_sample_fwd_plain(x, zidx, yidx, xidx, wts)
    out.backward(cot)
    return out.detach(), x.grad, gr.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("volume", VOLUMES)
def test_closed_form_backward_matches_autograd_through_the_fold(
        volume, padding, align, dtype):
    """float32: d_grid within 1e-6 of its largest entry (autograd
    accumulates the eight raw taps in another order); float64: within 1e-6
    absolute.  Forward and d_img are the same computation on both sides."""
    img, grid, cot = (torch.from_numpy(a).to(dtype)
                      for a in _case(1, volume, c=1 + 2 * (volume[0] > 4),
                                     align=align))
    ref_out, ref_img, ref_grid = _autograd_through_fold(img, grid, cot,
                                                        padding, align)
    out = zband_grid_sample_fwd_plain(img, grid, padding, align)
    d_img, d_grid = zband_grid_sample_bwd_plain(cot, img, grid, padding,
                                                align)
    assert torch.equal(out, ref_out)
    assert torch.equal(d_img, ref_img)
    scale = float(ref_grid.abs().max()) if dtype == torch.float32 else 1.0
    assert float((d_grid - ref_grid).abs().max()) <= 1e-6 * scale


def _jax_vjp(img, grid, cot, padding, align, mode, monkeypatch):
    """JAX's Pallas 3D sample (interpret mode), its output and VJP, with
    the scatter's exact f32 tier (read at trace time)."""
    n, p = grid.shape[:2]
    fn = (gm.grid_sample_3d_pallas if mode == "bilinear"
          else gm.grid_sample_3d_pallas_nearest)

    def f(x, g):
        return fn(x, g.reshape(n, p, 1, 1, 3), padding_mode=padding,
                  align_corners=align).reshape(n, -1, p)

    with monkeypatch.context() as m:
        m.setenv("ADVCHAIN_SCATTER_SPLIT", "3")
        jax.clear_caches()
        out, vjp = jax.vjp(f, jnp.asarray(img), jnp.asarray(grid))
        d_img, d_grid = vjp(jnp.asarray(cot))
    jax.clear_caches()
    return np.asarray(out), np.asarray(d_img), np.asarray(d_grid)


def _port_vjp(img, grid, cot, padding, align, mode):
    x = torch.from_numpy(img).requires_grad_(True)
    g = torch.from_numpy(grid).requires_grad_(True)
    out = ZBandGridSample.apply(x, g, padding, align, mode)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), x.grad.numpy(), g.grad.numpy()


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("volume", VOLUMES[1:])
def test_fused_pair_matches_jax_pallas(volume, padding, align, monkeypatch):
    """Output, d_img and d_grid within 1e-5 of JAX's interpreted Pallas
    route (d_grid relative to its largest entry: JAX differentiates the
    fold by autodiff, in another order)."""
    img, grid, cot = _case(2, volume, align=align)
    ref = _jax_vjp(img, grid, cot, padding, align, "bilinear", monkeypatch)
    ours = _port_vjp(img, grid, cot, padding, align, "bilinear")
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours[1], ref[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours[2], ref[2],
                               atol=1e-5 * np.abs(ref[2]).max(), rtol=0)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", PADDINGS)
def test_nearest_matches_jax_pallas(padding, align, monkeypatch):
    """Nearest sampling on half-pixel coordinates (ties round half to
    even) and past the volume: output and d_img against JAX, and a zero
    d_grid on both sides."""
    img, grid, cot = _case(3, (5, 7, 9), align=align)
    ref = _jax_vjp(img, grid, cot, padding, align, "nearest", monkeypatch)
    ours = _port_vjp(img, grid, cot, padding, align, "nearest")
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours[1], ref[1], atol=1e-5, rtol=0)
    assert not np.any(ours[2]) and not np.any(ref[2])


def test_nearest_rounds_half_to_even_in_3d():
    # W=5, align_corners: x pixel coordinates 0.5, 1.5, 2.5, 3.5 (every
    # unnormalization step exact) round to 0, 2, 2, 4
    img = torch.arange(5.0).reshape(1, 1, 1, 1, 5)
    xs = torch.tensor([0.5, 1.5, 2.5, 3.5]) / 2 - 1
    grid = torch.stack([xs, torch.zeros(4), torch.zeros(4)], -1)[None]
    out = zband_grid_sample_fwd_plain(img, grid, mode="nearest")
    assert out.flatten().tolist() == [0.0, 2.0, 2.0, 4.0]


@pytest.mark.parametrize("padding", PADDINGS)
def test_plain_pair_gradcheck_float64(padding):
    """The plain pair through ``ZBandGridSample`` in float64: the closed
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
            lambda a, b: ZBandGridSample.apply(a, b, padding, align,
                                               "bilinear"), (img, grid))


def test_grid_sample_3d_takes_the_plain_pair_on_cpu(monkeypatch):
    """On CPU tensors grid_sample_3d reaches the plain pair once each way
    and never the library's grid_sample."""
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(zs, name, wrapped)

    def refuse(*args, **kwargs):
        raise AssertionError("the port called torch's grid_sample")

    spy("zband_grid_sample_fwd_plain", zs.zband_grid_sample_fwd_plain)
    spy("zband_grid_sample_bwd_plain", zs.zband_grid_sample_bwd_plain)
    monkeypatch.setattr(torch.nn.functional, "grid_sample", refuse)
    img, grid, _ = _case(5, (4, 6, 8))
    x = torch.from_numpy(img).requires_grad_(True)
    g = torch.from_numpy(grid).reshape(2, 3, 4, 5, 3).requires_grad_(True)
    out = grid_sample_3d(x, g, padding_mode="border")
    out.sum().backward()
    assert calls == ["zband_grid_sample_fwd_plain",
                     "zband_grid_sample_bwd_plain"]
    assert g.grad.shape == g.shape and bool(g.grad.abs().sum() > 0)


def test_launch_counters_stay_zero_on_cpu():
    zs.reset_launch_counts()
    img, grid, cot = (torch.from_numpy(a) for a in _case(6, (4, 6, 8)))
    for mode in ("bilinear", "nearest"):
        zband_grid_sample_fwd(img, grid, mode=mode)
        zband_grid_sample_bwd(cot, img, grid, mode=mode)
        x = img.clone().requires_grad_(True)
        grid_sample_3d(x, grid.reshape(2, 3, 4, 5, 3), mode=mode).sum() \
            .backward()
    assert (zs.GRID_FWD_LAUNCHES, zs.GRID_BWD_LAUNCHES,
            zs.FWD_LAUNCHES, zs.BWD_LAUNCHES) == (0, 0, 0, 0)


def test_wrappers_reject_bad_arguments():
    img, grid, cot = (torch.from_numpy(a) for a in _case(7, (4, 6, 8)))
    with pytest.raises(ValueError):
        zband_grid_sample_fwd(img, grid, padding_mode="wrap")
    with pytest.raises(ValueError):
        zband_grid_sample_fwd(img, grid, mode="bicubic")
    with pytest.raises(ValueError):
        zband_grid_sample_fwd(img, grid[..., :2])
    with pytest.raises(ValueError):
        zband_grid_sample_bwd(cot[:, :1], img, grid)
