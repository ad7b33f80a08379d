"""The port's euler integration and the 2D Jacobian determinant against
the JAX package's (advchain_tpu/ops/integrate.py:240-279), on identical
numpy inputs.  The JAX side runs with ADVCHAIN_STENCIL=0 (its
compositions on the sampler), the port with JAX's base grid, as in
tests/test_torch_stencil.py: the two packages' linspaces differ in ulps
(ROADMAP queue 3), which repeated compositions amplify."""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from advchain_tpu import ops as jops
from advchain_tpu.ops import integrate as jint

from advchain_tpu_torch import ops as tops
from advchain_tpu_torch.ops import integrate as tint
import torch_threads  # noqa: F401  (one intra-op thread a process)


@pytest.fixture(autouse=True)
def _jax_dispatch_and_grid(monkeypatch):
    monkeypatch.setenv("ADVCHAIN_STENCIL", "0")

    def grid(batch_size, spatial_shape, dtype=torch.float32, device=None):
        g = np.array(jint.base_grid(batch_size, spatial_shape))
        return torch.from_numpy(g).to(dtype=dtype, device=device)
    monkeypatch.setattr(tint, "base_grid", grid)


def _velocity(shape, seed, amp):
    r = np.random.RandomState(seed)
    return r.uniform(-amp, amp, shape).astype(np.float32)


@pytest.mark.parametrize("nb_steps", [1, 4, 8])
def test_euler_2d(nb_steps):
    """nb_steps compositions of the interval flow; the exponentiate_flow
    budget: max 1e-4, mean 1e-5."""
    duv = _velocity((2, 2, 16, 20), 21, 0.2)
    ours = tint.exponentiate_flow(torch.from_numpy(duv), nb_steps=nb_steps,
                                  method="euler").numpy()
    ref = np.asarray(jint.exponentiate_flow(jnp.asarray(duv),
                                            nb_steps=nb_steps,
                                            method="euler"))
    d = np.abs(ours - ref)
    assert d.max() <= 1e-4 and d.mean() <= 1e-5, (d.max(), d.mean())
    assert np.abs(ref).max() > 1e-3  # the flow moved


@pytest.mark.parametrize("nb_steps", [1, 3])
def test_euler_3d(nb_steps):
    """int(2 ** nb_steps) compositions in 3D (adaptive is ignored)."""
    duv = _velocity((1, 3, 6, 8, 10), 22, 0.1)
    ours = tint.exponentiate_flow(torch.from_numpy(duv), nb_steps=nb_steps,
                                  method="euler", adaptive=True).numpy()
    ref = np.asarray(jint.exponentiate_flow(jnp.asarray(duv),
                                            nb_steps=nb_steps,
                                            method="euler", adaptive=True))
    d = np.abs(ours - ref)
    assert d.max() <= 1e-4 and d.mean() <= 1e-5, (d.max(), d.mean())


def test_euler_gradient():
    """The velocity's gradient through the euler loop (the compositions'
    backward kernels' plain versions), 1e-4 of its largest entry."""
    import jax
    duv = _velocity((2, 2, 16, 20), 23, 0.2)
    cot = np.random.RandomState(24).randn(*duv.shape).astype(np.float32)
    v = torch.from_numpy(duv).requires_grad_(True)
    (tint.exponentiate_flow(v, nb_steps=4, method="euler")
     * torch.from_numpy(cot)).sum().backward()
    ref = jax.grad(lambda u: jnp.sum(jint.exponentiate_flow(
        u, nb_steps=4, method="euler") * cot))(jnp.asarray(duv))
    ref = np.asarray(ref)
    assert np.abs(v.grad.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_unknown_method_raises():
    with pytest.raises(NotImplementedError):
        tint.exponentiate_flow(torch.zeros(1, 2, 4, 4), method="rk4")


@pytest.mark.parametrize("shape", [(2, 2, 16, 20), (1, 2, 3, 5)])
def test_jacobian_determinant_2d(shape):
    disp = _velocity(shape, 25, 0.3)
    ours = tops.jacobian_determinant_2d(torch.from_numpy(disp))
    ref = jops.jacobian_determinant_2d(jnp.asarray(disp))
    assert tuple(ours.shape) == (shape[0], 1) + shape[2:]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_jacobian_of_identity_and_bad_shape():
    torch.testing.assert_close(
        tops.jacobian_determinant_2d(torch.zeros(1, 2, 6, 7)),
        torch.ones(1, 1, 6, 7))
    with pytest.raises(ValueError):
        tops.jacobian_determinant_2d(torch.zeros(1, 3, 6, 7))


@pytest.mark.parametrize("dims", [2, 3])
def test_sampler_compositions_match_jax_sampler_route(dims):
    """Inside ``sampler_compositions`` a same-shape composition samples on
    the sampler with border padding: forward and both gradients against
    JAX's composition with ADVCHAIN_STENCIL=0, on flows whose border
    entries sit exactly on -1 (the sampler's half slope there), within
    1e-5 of the largest entry; outside it the port's stencil passes the
    whole slope at those entries (JAX's default dispatch)."""
    import jax
    shape = (2, dims) + ((12, 10) if dims == 2 else (6, 8, 10))
    r = np.random.RandomState(30 + dims)
    base = np.array(jint.base_grid(2, shape[2:]))
    f1 = (base + 0.3 * r.uniform(-1, 1, shape)).astype(np.float32)
    f2 = np.clip(base + 0.1 * r.uniform(-1, 1, shape), -1, 1).astype(
        np.float32)
    f2[:, 0, ..., 0] = -1.0  # exactly on the lower bound
    ct = r.randn(*shape).astype(np.float32)

    def ours(ctx):
        a = torch.from_numpy(f1).requires_grad_(True)
        b = torch.from_numpy(f2).requires_grad_(True)
        with ctx:
            y = tint.compose_flow(a, b)
        (y * torch.from_numpy(ct)).sum().backward()
        return [y.detach().numpy(), a.grad.numpy(), b.grad.numpy()]

    jax.clear_caches()
    y = jint.compose_flow(jnp.asarray(f1), jnp.asarray(f2))
    grads = jax.grad(lambda a, b: jnp.sum(jint.compose_flow(a, b) * ct),
                     argnums=(0, 1))(jnp.asarray(f1), jnp.asarray(f2))
    refs = [np.asarray(y)] + [np.asarray(g) for g in grads]
    for got, ref in zip(ours(tint.sampler_compositions()), refs):
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    stencil = ours(contextlib.nullcontext())
    assert np.abs(stencil[2] - refs[2]).max() > 1e-3 * np.abs(refs[2]).max()


def _stencil3d_inputs(c, layout, seed):
    """An image (2, C, 5, 6, 7), a grid within 1 voxel of the identity
    (R = 1) whose entries at both ends of every axis sit exactly on -1
    and +1, in ``layout``, and a cotangent."""
    r = np.random.RandomState(seed)
    d, h, w = 5, 6, 7
    img = r.randn(2, c, d, h, w).astype(np.float32)
    base = np.array(jint.base_grid(2, (d, h, w)))  # (2, 3, D, H, W)
    scale = 2.0 / (np.array([w, h, d]) - 1.0)[None, :, None, None, None]
    grid = np.clip(base + 0.9 * scale * r.uniform(-1, 1, base.shape),
                   -1, 1).astype(np.float32)
    # exact bounds at both ends of every axis
    grid[:, 0, :, :, 0], grid[:, 0, :, :, -1] = -1.0, 1.0
    grid[:, 1, :, 0], grid[:, 1, :, -1] = -1.0, 1.0
    grid[:, 2, 0], grid[:, 2, -1] = -1.0, 1.0
    if layout == "last":
        grid = np.ascontiguousarray(np.moveaxis(grid, 1, -1))
    ct = r.randn(*img.shape).astype(np.float32)
    return img, grid, ct


@pytest.mark.parametrize("layout", ["last", "first"])
@pytest.mark.parametrize("c", [1, 3])
def test_stencil_warp_3d_matches_jax(c, layout):
    """``ops.stencil_warp_3d`` (the z-band grid pair, ``edge`` padding)
    against JAX's (R = 1) and its custom VJP: the forward within 1e-6 and
    ``d_img`` / ``d_grid`` within 1e-5 of their largest entries, both
    grid layouts, displacements under one voxel with entries exactly on
    the bounds (the whole one-sided slope at -1, none at +1)."""
    import jax
    from advchain_tpu.ops.grid_sample import stencil_warp_3d as jwarp
    img, grid, ct = _stencil3d_inputs(c, layout, 40 + c)
    y = jwarp(jnp.asarray(img), jnp.asarray(grid), 1, layout)
    grads = jax.grad(lambda a, g: jnp.sum(jwarp(a, g, 1, layout) * ct),
                     argnums=(0, 1))(jnp.asarray(img), jnp.asarray(grid))
    a = torch.from_numpy(img).requires_grad_(True)
    g = torch.from_numpy(grid).requires_grad_(True)
    out = tops.stencil_warp_3d(a, g, 1, layout)
    (out * torch.from_numpy(ct)).sum().backward()
    for got, ref, tol in ((out.detach(), y, 1e-6), (a.grad, grads[0], 1e-5),
                          (g.grad, grads[1], 1e-5)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()


def test_stencil_warp_3d_past_its_radius_stays_exact():
    """Past R voxels JAX's stencil taps give out (its caller keeps every
    sample within R); the port samples exactly: a shift of 2.5 voxels
    along W equals ``grid_sample_3d`` with border padding, where JAX's
    R = 1 stencil does not."""
    from advchain_tpu.ops.grid_sample import stencil_warp_3d as jwarp
    img, _, _ = _stencil3d_inputs(2, "last", 50)
    grid = np.array(jint.base_grid(2, img.shape[2:]))
    grid[:, 0] += 2.5 * 2.0 / (img.shape[4] - 1)
    grid = np.ascontiguousarray(np.moveaxis(np.clip(grid, -1, 1), 1, -1))
    ours = tops.stencil_warp_3d(torch.from_numpy(img),
                                torch.from_numpy(grid), 1)
    sampled = tops.grid_sample_3d(torch.from_numpy(img),
                                  torch.from_numpy(grid),
                                  padding_mode="border")
    assert torch.allclose(ours, sampled, atol=1e-6)
    theirs = np.asarray(jwarp(jnp.asarray(img), jnp.asarray(grid), 1))
    assert np.abs(theirs - sampled.numpy()).max() > 0.1


def test_stencil_warp_3d_refuses_a_layout():
    with pytest.raises(ValueError, match="grid_layout"):
        tops.stencil_warp_3d(torch.zeros(1, 1, 2, 2, 2),
                             torch.zeros(1, 2, 2, 2, 3), 1, "middle")
