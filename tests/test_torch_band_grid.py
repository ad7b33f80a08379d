"""The band grid pair's plain versions (the CPU path of
advchain_tpu_torch.kernels.band_sample's grid contract, the default 2D
route) against the host-side fold they replace and against the JAX package.

For each mode, padding and ``align_corners``, on three grids (a
near-identity warp, a 30-degree rotation that runs past the border, and the
near-identity warp with 5% of its entries on exactly +-1):

- the plain forward equals ``corner_weights`` (or ``nearest_weights``)
  followed by the corner sum ``band_sample_fwd_plain``, bit for bit: it is
  the definition the CUDA forward repeats;
- the plain backward (the closed form the CUDA backward computes) is
  within 1e-6 of autograd through the fold and that corner sum;
- the whole sample (output, ``d_img``, ``d_grid``) is within 1e-5 of JAX's
  ``grid_sample_2d_pallas`` / ``grid_sample_2d_pallas_nearest``, which run
  the Pallas band kernels in interpret mode on the CPU with the scatter's
  exact f32 tier (``ADVCHAIN_SCATTER_SPLIT=3``).
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advchain_tpu.kernels import gather_matmul as gm

from advchain_tpu_torch.kernels import _coords
from advchain_tpu_torch.kernels import band_sample as bs
from advchain_tpu_torch.kernels.band_sample import (
    BandGridSample, band_grid_sample_bwd, band_grid_sample_bwd_plain,
    band_grid_sample_fwd, band_grid_sample_fwd_plain, band_sample_fwd_plain)
from advchain_tpu_torch.ops.grid_sample import grid_sample_2d
import torch_threads  # noqa: F401  (one intra-op thread a process)

MODES = ["bilinear", "nearest"]
PADDINGS = ["zeros", "border", "reflection"]
GRIDS = ["near_identity", "rot30", "near_pm1"]
IMAGE = (10, 12)  # H, W
N, C = 2, 3


def _case(kind, align, seed=0):
    """img (N, C, H, W), grid (N, H, W, 2) and cotangent (N, C, H, W) from a
    numpy seed.  The near-identity grid moves each point by up to 1.5 px;
    the rotation turns the image by 30 degrees and scales it by 1.25, so
    its corners run past the border; ``near_pm1`` sets 5% of the
    near-identity entries to exactly +-1."""
    r = np.random.RandomState(seed)
    h, w = IMAGE
    img = r.randn(N, C, h, w).astype(np.float32)
    cot = r.randn(N, C, h, w).astype(np.float32)
    span = (lambda s: s - 1) if align else (lambda s: s)
    xs = np.linspace(-1, 1, w) * (w - 1) / span(w)
    ys = np.linspace(-1, 1, h) * (h - 1) / span(h)
    base = np.stack(np.meshgrid(xs, ys, indexing="xy"), -1)  # (H, W, 2)
    base = np.broadcast_to(base, (N, h, w, 2))
    if kind == "rot30":
        a = math.radians(30.0)
        rot = 1.25 * np.array([[math.cos(a), -math.sin(a)],
                               [math.sin(a), math.cos(a)]])
        grid = base @ rot.T
    else:
        px = np.array([2.0 / span(w), 2.0 / span(h)])
        grid = base + r.uniform(-1.5, 1.5, base.shape) * px
        if kind == "near_pm1":
            pick = r.rand(*grid.shape) < 0.05
            grid = np.where(pick, np.sign(r.rand(*grid.shape) - 0.5), grid)
    return img, grid.astype(np.float32), cot


def _flat(grid):
    return grid.reshape(grid.shape[0], -1, 2)


def _through_the_fold(img, grid, cot, padding, align, mode):
    """The route before the grid pair: ``corner_weights`` (autograd over
    the fold) or ``nearest_weights``, and autograd through the corner sum
    ``band_sample_fwd_plain``."""
    h, w = img.shape[2:]
    x = img.clone().requires_grad_(True)
    gr = grid.clone().requires_grad_(True)
    if mode == "nearest":
        (yidx, xidx), wts = _coords.nearest_weights(gr, (h, w), padding,
                                                    align)
    else:
        yidx, xidx, wts = _coords.corner_weights(gr, h, w, padding, align)
    out = band_sample_fwd_plain(x, yidx, xidx, wts)
    out.backward(cot.reshape(out.shape))
    grad = gr.grad if gr.grad is not None else torch.zeros_like(gr)
    return out.detach(), x.grad, grad.reshape(grid.shape[0], -1, 2)


@pytest.mark.parametrize("kind", GRIDS)
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("mode", MODES)
def test_plain_forward_is_the_fold_and_the_band_twin(mode, padding, align,
                                                     kind):
    img, grid, _ = (torch.from_numpy(a) for a in _case(kind, align))
    h, w = IMAGE
    if mode == "nearest":
        (yidx, xidx), wts = _coords.nearest_weights(grid, (h, w), padding,
                                                    align)
    else:
        yidx, xidx, wts = _coords.corner_weights(grid, h, w, padding, align)
    ref = bs.band_sample_fwd_plain(img, yidx, xidx, wts)
    out = band_grid_sample_fwd_plain(img, _flat(grid), padding, align, mode)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("kind", GRIDS)
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("mode", MODES)
def test_closed_form_backward_matches_autograd_through_the_fold(
        mode, padding, align, kind):
    """``d_img`` equal (the same corner-level twin on both sides);
    ``d_grid`` within 1e-6 of its largest entry (autograd accumulates the
    four raw taps in another order), and zero in nearest mode."""
    img, grid, cot = (torch.from_numpy(a) for a in _case(kind, align))
    ref_out, ref_img, ref_grid = _through_the_fold(img, grid, cot, padding,
                                                   align, mode)
    g = cot.reshape(N, C, -1)
    d_img, d_grid = band_grid_sample_bwd_plain(g, img, _flat(grid), padding,
                                               align, mode)
    assert torch.equal(d_img, ref_img)
    scale = max(float(ref_grid.abs().max()), 1.0)
    assert float((d_grid - ref_grid).abs().max()) <= 1e-6 * scale
    if mode == "nearest":
        assert not bool(d_grid.any())


def _jax_vjp(img, grid, cot, padding, align, mode, monkeypatch):
    """JAX's Pallas 2D sample (interpret mode), its output and VJP, with the
    scatter's exact f32 tier (read at trace time)."""
    fn = (gm.grid_sample_2d_pallas if mode == "bilinear"
          else gm.grid_sample_2d_pallas_nearest)

    def f(x, g):
        return fn(x, g, padding_mode=padding, align_corners=align)

    with monkeypatch.context() as m:
        m.setenv("ADVCHAIN_SCATTER_SPLIT", "3")
        jax.clear_caches()
        out, vjp = jax.vjp(f, jnp.asarray(img), jnp.asarray(grid))
        d_img, d_grid = vjp(jnp.asarray(cot))
    jax.clear_caches()
    return np.asarray(out), np.asarray(d_img), np.asarray(d_grid)


@pytest.mark.parametrize("kind", GRIDS)
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("mode", MODES)
def test_grid_pair_matches_jax_pallas(mode, padding, align, kind,
                                      monkeypatch):
    """Output, d_img and d_grid through ``BandGridSample`` within 1e-5 of
    JAX's interpreted Pallas route (d_grid relative to its largest entry:
    JAX differentiates the fold by autodiff, in another order)."""
    img, grid, cot = _case(kind, align)
    ref = _jax_vjp(img, grid, cot, padding, align, mode, monkeypatch)
    x = torch.from_numpy(img).requires_grad_(True)
    gr = torch.from_numpy(grid).requires_grad_(True)
    out = BandGridSample.apply(x, gr.reshape(N, -1, 2), padding, align, mode)
    out.backward(torch.from_numpy(cot).reshape(out.shape))
    np.testing.assert_allclose(out.detach().numpy().reshape(ref[0].shape),
                               ref[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(x.grad.numpy(), ref[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(gr.grad.numpy(), ref[2],
                               atol=1e-5 * max(np.abs(ref[2]).max(), 1.0),
                               rtol=0)


def test_nearest_rounds_half_to_even_in_2d():
    # W=5, align_corners: x pixel coordinates 0.5, 1.5, 2.5, 3.5 (every
    # unnormalization step exact) round to 0, 2, 2, 4
    img = torch.arange(5.0).reshape(1, 1, 1, 5)
    xs = torch.tensor([0.5, 1.5, 2.5, 3.5]) / 2 - 1
    grid = torch.stack([xs, torch.zeros(4)], -1)[None]
    out = band_grid_sample_fwd_plain(img, grid, mode="nearest")
    assert out.flatten().tolist() == [0.0, 2.0, 2.0, 4.0]


@pytest.mark.parametrize("padding", PADDINGS)
def test_plain_pair_gradcheck_float64(padding):
    """The plain pair through ``BandGridSample`` in float64: the closed
    form against finite differences, away from floor boundaries and clip
    bounds."""
    r = np.random.RandomState(4)
    spread = 1.2 if padding == "zeros" else 0.9
    img = torch.from_numpy(r.randn(1, 2, 5, 6)).requires_grad_(True)
    grid = torch.from_numpy((r.rand(1, 24, 2) * 2 - 1) * spread)
    grid.requires_grad_(True)
    for align in (True, False):
        assert torch.autograd.gradcheck(
            lambda a, b: BandGridSample.apply(a, b, padding, align,
                                              "bilinear"), (img, grid))


def test_grid_sample_2d_takes_the_grid_pair_without_the_fold(monkeypatch):
    """On CPU tensors grid_sample_2d reaches the plain pair once each way,
    calls no host-side fold of its own, and never the library's
    grid_sample; ``ADVCHAIN_BAND_KERNEL=0`` keeps the legacy corner route,
    with the same output and gradients."""
    ops_gs = importlib.import_module("advchain_tpu_torch.ops.grid_sample")
    calls = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    def refuse(*args, **kwargs):
        raise AssertionError("the port called torch's grid_sample")

    spy(bs, "band_grid_sample_fwd_plain")
    spy(bs, "band_grid_sample_bwd_plain")
    spy(ops_gs, "corner_weights")
    monkeypatch.setattr(torch.nn.functional, "grid_sample", refuse)
    img, grid, cot = _case("near_pm1", True, 5)
    results = []
    for switch in ("1", "0"):
        monkeypatch.setenv("ADVCHAIN_BAND_KERNEL", switch)
        calls.clear()
        x = torch.from_numpy(img).requires_grad_(True)
        g = torch.from_numpy(grid).requires_grad_(True)
        out = grid_sample_2d(x, g, padding_mode="border")
        out.backward(torch.from_numpy(cot))
        results.append((out.detach(), x.grad, g.grad, list(calls)))
    assert results[0][3] == ["band_grid_sample_fwd_plain",
                             "band_grid_sample_bwd_plain"]
    assert results[1][3] == ["corner_weights"]
    assert torch.equal(results[0][0], results[1][0])
    for i in (1, 2):  # d_img, d_grid: scatters and sums in another order
        assert float((results[0][i] - results[1][i]).abs().max()) <= \
            1e-6 * max(float(results[1][i].abs().max()), 1.0)


def test_launch_counters_stay_zero_on_cpu():
    bs.reset_launch_counts()
    img, grid, cot = (torch.from_numpy(a) for a in _case("rot30", True, 6))
    g = cot.reshape(N, C, -1)
    for mode in MODES:
        band_grid_sample_fwd(img, _flat(grid), mode=mode)
        band_grid_sample_bwd(g, img, _flat(grid), mode=mode)
        x = img.clone().requires_grad_(True)
        grid_sample_2d(x, grid, mode=mode).sum().backward()
    assert (bs.GRID_FWD_LAUNCHES, bs.GRID_BWD_LAUNCHES,
            bs.FWD_LAUNCHES, bs.BWD_LAUNCHES) == (0, 0, 0, 0)


def test_wrappers_reject_bad_arguments():
    img, grid, cot = (torch.from_numpy(a) for a in _case("rot30", True, 7))
    flat = _flat(grid)
    with pytest.raises(ValueError):
        band_grid_sample_fwd(img, flat, padding_mode="wrap")
    with pytest.raises(ValueError):
        band_grid_sample_fwd(img, flat, mode="bicubic")
    with pytest.raises(ValueError):
        band_grid_sample_fwd(img, torch.cat([flat, flat[..., :1]], -1))
    with pytest.raises(ValueError):
        band_grid_sample_bwd(cot.reshape(N, C, -1)[:, :1], img, flat)
