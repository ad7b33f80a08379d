"""The port's band-sample twins and 2D sampler against the JAX package.

The twins (the CPU path of advchain_tpu_torch.kernels.band_sample) are held
against ``_weighted_band_sample``, which runs the Pallas ``band_gather`` /
``band_scatter`` kernels in interpret mode on the CPU; ``grid_sample_2d``
is held against the JAX ``grid_sample_2d`` on its Pallas route.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advchain_tpu.kernels import gather_matmul as gm
import torch_threads  # noqa: F401  (one intra-op thread a process)

# the JAX ops package re-exports a function named grid_sample, which
# shadows the submodule under attribute lookup
jgs = importlib.import_module("advchain_tpu.ops.grid_sample")

from advchain_tpu_torch.kernels.band_sample import (band_sample_bwd_plain,
                                                    band_sample_fwd_plain)
from advchain_tpu_torch.ops.grid_sample import corner_weights, grid_sample_2d


def _band_inputs(seed, n=2, c=3, h=13, w=17, p=150):
    r = np.random.RandomState(seed)
    img = r.randn(n, c, h, w).astype(np.float32)
    # base corners on the whole image, the last row/column included (their
    # +1 taps fall off the image and must read zero)
    y = r.randint(0, h, size=(n, p)).astype(np.int32)
    x = r.randint(0, w, size=(n, p)).astype(np.int32)
    wts = r.rand(n, 4, p).astype(np.float32)
    g = r.randn(n, c, p).astype(np.float32)
    return img, y, x, wts, g


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
def test_twin_fwd_matches_pallas_band_gather(seed):
    img, y, x, wts, _ = _band_inputs(seed)
    h, w = img.shape[2:]
    ref = gm._weighted_band_sample(jnp.asarray(img),
                                   (jnp.asarray(y), jnp.asarray(x),
                                    jnp.asarray(wts)), h, w)
    out = band_sample_fwd_plain(*_t(img, y, x, wts))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_twin_bwd_matches_pallas_band_scatter(seed, monkeypatch):
    img, y, x, wts, g = _band_inputs(seed)
    h, w = img.shape[2:]

    def f(im, ww):
        return gm._weighted_band_sample(im, (jnp.asarray(y), jnp.asarray(x),
                                             ww), h, w)

    # the scatter's exact f32 tier (its default 2-term tier rounds ~1e-5 of
    # the accumulated magnitude); the tier is read at trace time
    with monkeypatch.context() as m:
        m.setenv("ADVCHAIN_SCATTER_SPLIT", "3")
        jax.clear_caches()
        _, vjp = jax.vjp(f, jnp.asarray(img), jnp.asarray(wts))
        ref_img, ref_w = vjp(jnp.asarray(g))
    jax.clear_caches()
    d_img, d_w = band_sample_bwd_plain(*_t(g, img, y, x, wts))
    np.testing.assert_allclose(d_img.numpy(), np.asarray(ref_img), atol=1e-5)
    np.testing.assert_allclose(d_w.numpy(), np.asarray(ref_w), atol=1e-5)


def _grid_case(seed, n=2, c=3, h=12, w=14, ho=9, wo=11, spread=1.3):
    r = np.random.RandomState(seed)
    img = r.randn(n, c, h, w).astype(np.float32)
    grid = ((r.rand(n, ho, wo, 2) * 2 - 1) * spread).astype(np.float32)
    cot = r.randn(n, c, ho, wo).astype(np.float32)
    return img, grid, cot


def _jax_sample_and_grads(img, grid, cot, padding, align):
    def f(x, g):
        with jgs.force_impl("pallas"):
            out = jgs.grid_sample_2d(x, g, padding_mode=padding,
                                     align_corners=align)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, out), (gx, gg) = jax.value_and_grad(f, argnums=(0, 1),
                                            has_aux=True)(
        jnp.asarray(img), jnp.asarray(grid))
    return np.asarray(out), np.asarray(gx), np.asarray(gg)


def _torch_sample_and_grads(img, grid, cot, padding, align):
    x = torch.from_numpy(img).requires_grad_(True)
    g = torch.from_numpy(grid).requires_grad_(True)
    out = grid_sample_2d(x, g, padding_mode=padding, align_corners=align)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), x.grad.numpy(), g.grad.numpy()


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
def test_grid_sample_2d_matches_jax(padding, align):
    img, grid, cot = _grid_case(5)
    ref = _jax_sample_and_grads(img, grid, cot, padding, align)
    ours = _torch_sample_and_grads(img, grid, cot, padding, align)
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-5)
    np.testing.assert_allclose(ours[1], ref[1], atol=1e-4)
    np.testing.assert_allclose(ours[2], ref[2], atol=1e-4)


@pytest.mark.parametrize("padding", ["border", "zeros", "reflection"])
def test_grid_sample_2d_clamp_edge_matches_jax(padding):
    """Grid entries exactly on +-1 (base-grid corners, morph's clip to
    +-1): the port's clips must pass jnp.clip's half subgradient there."""
    img, grid, cot = _grid_case(6, ho=6, wo=6, spread=1.0)
    grid[:, 0, :, 1] = -1.0
    grid[:, -1, :, 1] = 1.0
    grid[:, :, 0, 0] = -1.0
    grid[:, :, -1, 0] = 1.0
    grid[:, 2, 2] = (1.0, -1.0)
    ref = _jax_sample_and_grads(img, grid, cot, padding, True)
    ours = _torch_sample_and_grads(img, grid, cot, padding, True)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_clamp_edge_subgradient_is_half():
    from advchain_tpu_torch.ops.grid_sample import clip
    x = torch.tensor([0.0, 0.5, 1.0, 1.5], requires_grad=True)
    clip(x, 0.0, 1.0).sum().backward()
    expected = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(
        jnp.asarray([0.0, 0.5, 1.0, 1.5]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(expected))


def test_corner_weights_are_contiguous_kernel_inputs():
    _, grid, _ = _grid_case(7)
    for t in corner_weights(torch.from_numpy(grid), 12, 14, "border"):
        assert t.is_contiguous()


def test_grid_sample_2d_rejects_nearest():
    """Nearest sampling is ported (tests/test_torch_kernels3d.py holds it
    against JAX); what it rejects is the grid gradient, which is zero as
    the sample is piecewise constant.  Unknown modes still raise."""
    img, grid, _ = _grid_case(8)
    x = torch.from_numpy(img).requires_grad_(True)
    g = torch.from_numpy(grid).requires_grad_(True)
    grid_sample_2d(x, g, mode="nearest").sum().backward()
    assert g.grad is None or not torch.any(g.grad)
    assert torch.any(x.grad)
    with pytest.raises(NotImplementedError):
        grid_sample_2d(torch.from_numpy(img), g, mode="bicubic")
