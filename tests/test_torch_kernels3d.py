"""The port's z-band twins, 3D sampler and nearest sampling against the JAX
package.

The twins (the CPU path of advchain_tpu_torch.kernels.zband_sample) are
held against ``_weighted_zband_sample``, which runs the Pallas
``zband_gather`` / ``zband_scatter`` kernels in interpret mode on the CPU;
``grid_sample_3d`` is held against the JAX ``grid_sample_3d`` on its Pallas
route and on its XLA route, and nearest sampling (2D and 3D) against the
JAX nearest wrappers.
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

from advchain_tpu_torch.kernels.zband_sample import (zband_sample_bwd_plain,
                                                     zband_sample_fwd_plain)
from advchain_tpu_torch.ops.grid_sample import (corner_weights_3d,
                                                grid_sample, grid_sample_2d,
                                                grid_sample_3d)


def _zband_inputs(seed, n=2, c=3, d=5, h=7, w=9, p=160):
    r = np.random.RandomState(seed)
    img = r.randn(n, c, d, h, w).astype(np.float32)
    # base corners on the whole volume, the last plane/row/column included
    # (their +1 taps fall off the volume and must read zero)
    z = r.randint(0, d, size=(n, p)).astype(np.int32)
    y = r.randint(0, h, size=(n, p)).astype(np.int32)
    x = r.randint(0, w, size=(n, p)).astype(np.int32)
    z[:, :8], y[:, 8:16], x[:, 16:24] = d - 1, h - 1, w - 1
    z[:, 24:32] = d - 1
    y[:, 24:32] = h - 1
    x[:, 24:32] = w - 1
    wts = r.rand(n, 8, p).astype(np.float32)
    g = r.randn(n, c, p).astype(np.float32)
    return img, z, y, x, wts, g


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
def test_twin_fwd_matches_pallas_zband_gather(seed):
    img, z, y, x, wts, _ = _zband_inputs(seed)
    d, h, w = img.shape[2:]
    ref = gm._weighted_zband_sample(
        jnp.asarray(img), tuple(jnp.asarray(a) for a in (z, y, x, wts)),
        d, h, w)
    out = zband_sample_fwd_plain(*_t(img, z, y, x, wts))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_twin_bwd_matches_pallas_zband_scatter(seed, monkeypatch):
    img, z, y, x, wts, g = _zband_inputs(seed)
    d, h, w = img.shape[2:]
    idx = tuple(jnp.asarray(a) for a in (z, y, x))

    def f(im, ww):
        return gm._weighted_zband_sample(im, idx + (ww,), d, h, w)

    # the scatter's exact f32 tier (its default 2-term tier rounds ~1e-5 of
    # the accumulated magnitude); the tier is read at trace time
    with monkeypatch.context() as m:
        m.setenv("ADVCHAIN_SCATTER_SPLIT", "3")
        jax.clear_caches()
        _, vjp = jax.vjp(f, jnp.asarray(img), jnp.asarray(wts))
        ref_img, ref_w = vjp(jnp.asarray(g))
    jax.clear_caches()
    d_img, d_w = zband_sample_bwd_plain(*_t(g, img, z, y, x, wts))
    np.testing.assert_allclose(d_img.numpy(), np.asarray(ref_img), atol=1e-5)
    np.testing.assert_allclose(d_w.numpy(), np.asarray(ref_w), atol=1e-5)


def _grid_case(seed, n=2, c=2, d=5, h=6, w=7, do=4, ho=5, wo=6,
               spread=1.3):
    r = np.random.RandomState(seed)
    img = r.randn(n, c, d, h, w).astype(np.float32)
    grid = ((r.rand(n, do, ho, wo, 3) * 2 - 1) * spread).astype(np.float32)
    cot = r.randn(n, c, do, ho, wo).astype(np.float32)
    return img, grid, cot


def _jax_sample_and_grads(img, grid, cot, padding, align, impl,
                          mode="bilinear"):
    def f(x, g):
        with jgs.force_impl(impl):
            out = jgs.grid_sample(x, g, mode=mode, padding_mode=padding,
                                  align_corners=align)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, out), (gx, gg) = jax.jit(jax.value_and_grad(f, argnums=(0, 1),
                                                    has_aux=True))(
        jnp.asarray(img), jnp.asarray(grid))
    return np.asarray(out), np.asarray(gx), np.asarray(gg)


def _torch_sample_and_grads(img, grid, cot, padding, align,
                            mode="bilinear"):
    x = torch.from_numpy(img).requires_grad_(True)
    g = torch.from_numpy(grid).requires_grad_(True)
    out = grid_sample(x, g, mode=mode, padding_mode=padding,
                      align_corners=align)
    (out * torch.from_numpy(cot)).sum().backward()
    grid_grad = g.grad if g.grad is not None else torch.zeros_like(g)
    return out.detach().numpy(), x.grad.numpy(), grid_grad.numpy()


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
def test_grid_sample_3d_matches_jax(padding, align, impl):
    img, grid, cot = _grid_case(5)
    ref = _jax_sample_and_grads(img, grid, cot, padding, align, impl)
    ours = _torch_sample_and_grads(img, grid, cot, padding, align)
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-5)
    np.testing.assert_allclose(ours[1], ref[1], atol=1e-4)
    np.testing.assert_allclose(ours[2], ref[2], atol=1e-4)


@pytest.mark.parametrize("padding", ["border", "zeros", "reflection"])
def test_grid_sample_3d_clamp_edge_matches_jax(padding):
    """Grid entries exactly on +-1 (base-grid corners, morph's clip to
    +-1) and past the volume: the folded weights and the clips' half
    subgradient must match the Pallas route's."""
    img, grid, cot = _grid_case(6, do=4, ho=4, wo=4, spread=1.0)
    grid[:, 0, :, :, 2] = -1.0
    grid[:, -1, :, :, 2] = 1.0
    grid[:, :, 0, :, 1] = -1.0
    grid[:, :, -1, :, 1] = 1.0
    grid[:, :, :, 0, 0] = -1.0
    grid[:, :, :, -1, 0] = 1.0
    grid[:, 1, 1, 1] = (1.0, -1.0, 1.0)
    grid[:, 2, 2, 2] = (1.3, -1.2, 1.1)
    ref = _jax_sample_and_grads(img, grid, cot, padding, True, "pallas")
    ours = _torch_sample_and_grads(img, grid, cot, padding, True)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=1e-4)


def _halfway_grid(r, n, out_shape, sizes):
    """Grid coordinates that land exactly half-way between voxels (and a
    few past the volume), for align_corners=True."""
    chans = []
    for size in reversed(sizes):  # channel 0 indexes the last axis
        pix = r.randint(-2, 2 * size + 1, size=(n,) + out_shape) / 2.0
        chans.append((2.0 * pix / (size - 1) - 1.0).astype(np.float32))
    return np.stack(chans, axis=-1)


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("dims", [2, 3])
def test_nearest_matches_jax(dims, padding, monkeypatch):
    r = np.random.RandomState(7 + dims)
    sizes = (5, 6, 7)[3 - dims:]
    out_shape = (3, 4, 5)[3 - dims:]
    img = r.randn(2, 3, *sizes).astype(np.float32)
    grid = _halfway_grid(r, 2, out_shape, sizes)
    cot = r.randn(2, 3, *out_shape).astype(np.float32)
    # the scatter's exact f32 tier, so the image gradient compares at 1e-5
    with monkeypatch.context() as m:
        m.setenv("ADVCHAIN_SCATTER_SPLIT", "3")
        jax.clear_caches()
        ref = _jax_sample_and_grads(img, grid, cot, padding, True, "pallas",
                                    mode="nearest")
    jax.clear_caches()
    ours = _torch_sample_and_grads(img, grid, cot, padding, True,
                                   mode="nearest")
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-6)
    np.testing.assert_allclose(ours[1], ref[1], atol=1e-5)
    assert not np.any(ours[2]) and not np.any(ref[2])


def test_nearest_rounds_half_to_even():
    img = torch.arange(5.0).reshape(1, 1, 1, 5)
    # pixel coordinates 0.5, 1.5, 2.5, 3.5 (align_corners=True, W=5; every
    # step of the unnormalization is exact)
    xs = torch.tensor([0.5, 1.5, 2.5, 3.5]) / 2 - 1
    grid = torch.stack([xs, torch.zeros(4)], dim=-1).reshape(1, 1, 4, 2)
    out = grid_sample_2d(img, grid, mode="nearest")
    assert out.flatten().tolist() == [0.0, 2.0, 2.0, 4.0]


def test_corner_weights_3d_are_contiguous_kernel_inputs():
    _, grid, _ = _grid_case(7)
    out = corner_weights_3d(torch.from_numpy(grid), 5, 6, 7, "border")
    assert all(t.is_contiguous() for t in out)
    assert out[3].shape == (2, 8, 4 * 5 * 6)


def test_grid_sample_3d_rejects_unknown_mode():
    img, grid, _ = _grid_case(8)
    with pytest.raises(NotImplementedError):
        grid_sample_3d(torch.from_numpy(img), torch.from_numpy(grid),
                       mode="bicubic")
