"""3D flow composition and exponentiation against the JAX package's DEFAULT
dispatch (``ADVCHAIN_STENCIL`` unset), at grids with entries exactly on
+-1.

JAX sends a 3D composition whose largest displacement is under one voxel
to its XLA stencil (``stencil_warp_3d``, R=1, edge-padded frame) and the
others to the sampler, under a ``lax.cond`` (advchain_tpu/ops/integrate.py:
126-153).  The two agree except in the grid gradient at entries exactly on
-1, where the stencil passes the whole one-sided slope and the sampler's
``jnp.clip`` half of it.  The port computes the same predicate on the
device (``kernels.stencil_warp.dispatch_slope``) and samples every
same-shape 3D composition with the z-band grid pair and
``padding_mode="edge"``, border padding whose slope at the lower bound is
the predicate's: so it matches JAX on both sides of the predicate, exact
+-1 entries included.  JAX reads its switches at trace time, so every JAX
call here runs after ``jax.clear_caches()``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advchain_tpu.ops import integrate as jint

from advchain_tpu_torch.ops import integrate as tint

SHAPE = (4, 7, 6)  # D, H, W: a shape no other test traces


def _voxel(shape):
    return np.array([2.0 / (s - 1) for s in reversed(shape)]).reshape(
        1, 3, 1, 1, 1)


def _flows(seed, disp, shape=SHAPE, n=2):
    """flow1 (up to 2 voxels off the identity) and flow2 (up to ``disp``
    voxels off it) with about 5% of flow2's entries set exactly to +-1:
    for a sub-voxel ``disp`` only entries that stay within 0.9 voxel of
    their own voxel (so JAX's stencil predicate holds), otherwise any."""
    r = np.random.RandomState(seed)
    base = np.asarray(jint.base_grid(n, shape))
    vox = _voxel(shape)
    f1 = base + r.uniform(-1, 1, base.shape) * 2.0 * vox
    f2 = base + r.uniform(-1, 1, base.shape) * disp * vox
    bound = np.where(f2 >= 0, 1.0, -1.0)
    near = np.abs(bound - base) < 0.9 * vox
    pick = r.rand(*f2.shape) < (0.05 / near.mean() if disp < 1 else 0.05)
    if disp < 1:
        pick &= near
    f2 = np.where(pick, bound, f2)
    cot = r.randn(*f1.shape)
    return (f1.astype(np.float32), f2.astype(np.float32),
            cot.astype(np.float32))


def _jax_compose(f1, f2, cot, monkeypatch):
    monkeypatch.delenv("ADVCHAIN_STENCIL", raising=False)
    jax.clear_caches()

    def loss(a, b):
        out = jint.compose_flow(a, b)
        return jnp.sum(out * cot), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                         has_aux=True)(jnp.asarray(f1),
                                                       jnp.asarray(f2))
    jax.clear_caches()
    return np.asarray(out), np.asarray(grads[0]), np.asarray(grads[1])


def _port_compose(f1, f2, cot):
    a = torch.from_numpy(f1).requires_grad_(True)
    b = torch.from_numpy(f2).requires_grad_(True)
    out = tint.compose_flow(a, b)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), a.grad.numpy(), b.grad.numpy()


def _within(ours, ref, rel):
    """Within ``rel`` of the reference's largest entry."""
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compose_flow_3d_sub_voxel_matches_the_default_dispatch(
        seed, monkeypatch):
    """Sub-voxel flow2 with exact +-1 entries: JAX takes its stencil;
    output and both gradients within 1e-6 of their largest entries."""
    f1, f2, cot = _flows(seed, 0.8)
    u = np.abs(f2 - np.asarray(jint.base_grid(2, SHAPE))) / _voxel(SHAPE)
    assert u.max() < 1 - 1e-3  # JAX's stencil predicate (R=1)
    on_bound = np.abs(f2) == 1
    assert 0.02 < on_bound.mean() < 0.1
    assert (f2 == -1).any() and (f2 == 1).any()
    ref = _jax_compose(f1, f2, cot, monkeypatch)
    ours = _port_compose(f1, f2, cot)
    for a, b in zip(ours, ref):
        _within(a, b, 1e-6)


@pytest.mark.parametrize("seed", [3, 4])
def test_compose_flow_3d_past_a_voxel_matches_the_default_dispatch(
        seed, monkeypatch):
    """Flow2 up to 3 voxels off the identity with 5% exact +-1 entries: JAX
    takes its sampler, and the port's predicate hands the z-band backward
    the sampler's half slope.  Output and both gradients within 1e-6 of
    their largest entries, the entries exactly on -1 included (where the
    stencil's slope would be twice JAX's)."""
    f1, f2, cot = _flows(seed, 3.0)
    u = np.abs(f2 - np.asarray(jint.base_grid(2, SHAPE))) / _voxel(SHAPE)
    assert u.max() > 1
    lower = f2 == -1
    assert 0.01 < lower.mean() < 0.05
    ref = _jax_compose(f1, f2, cot, monkeypatch)
    ours = _port_compose(f1, f2, cot)
    for a, b in zip(ours, ref):
        _within(a, b, 1e-6)
    assert np.abs(ref[2][lower]).max() > 1e-3 * np.abs(ref[2]).max()


def test_dispatch_slope_takes_jax_predicate():
    """The predicate the port computes on the device, here on its plain
    twin: JAX's ``dpx`` (the largest displacement in voxels) and the slope
    on each side of R - 1e-3 = 0.999."""
    from advchain_tpu_torch.kernels.stencil_warp import dispatch_slope
    base = np.asarray(jint.base_grid(2, SHAPE))
    for voxels, slope in ((0.998, 1.0), (0.9995, 0.5), (3.0, 0.5)):
        flow = base.copy()
        flow[1, 2, 2, 3, 4] += voxels * _voxel(SHAPE)[0, 2, 0, 0, 0]
        out = dispatch_slope(torch.from_numpy(flow.astype(np.float32)), 1)
        np.testing.assert_allclose(float(out[1]), voxels, rtol=1e-5)
        assert float(out[0]) == slope


def _exponentiate_pair(duv, monkeypatch):
    """(field, gradient of sum(field**2)) for JAX's default dispatch and for
    the port, adaptive squarings from 4."""
    monkeypatch.delenv("ADVCHAIN_STENCIL", raising=False)
    jax.clear_caches()

    def f(v):
        return jint.exponentiate_flow(v, nb_steps=4, adaptive=True)

    ref = (np.asarray(jax.jit(f)(jnp.asarray(duv))),
           np.asarray(jax.grad(lambda v: jnp.sum(f(v) ** 2))(
               jnp.asarray(duv))))
    jax.clear_caches()
    x = torch.from_numpy(duv).requires_grad_(True)
    field = tint.exponentiate_flow(x, nb_steps=4, adaptive=True)
    (field ** 2).sum().backward()
    return ref, (field.detach().numpy(), x.grad.numpy())


@pytest.mark.parametrize("norm", [0.3, 9.0, 40.0])
def test_exponentiate_flow_3d_matches_the_default_dispatch(norm,
                                                          monkeypatch):
    """Whole-batch norms 0.3 / 9 / 40 (4, 5 and 7 squarings; the early ones
    sub-voxel, the last past a voxel at the larger norms): field within
    2e-5 and the gradient of sum(field**2) within 2e-5 of max(1, its
    largest entry), as against ``ADVCHAIN_STENCIL=0`` (f32 rounding over
    the squarings)."""
    r = np.random.RandomState(8)
    duv = r.uniform(-1, 1, (2, 3, 4, 6, 5))
    duv = (duv * norm / np.linalg.norm(duv)).astype(np.float32)
    (ref_f, ref_g), (f, g) = _exponentiate_pair(duv, monkeypatch)
    np.testing.assert_allclose(f, ref_f, rtol=0, atol=2e-5)
    np.testing.assert_allclose(g, ref_g, rtol=0,
                               atol=2e-5 * max(1.0, np.abs(ref_g).max()))


def test_exponentiate_flow_3d_with_pinned_borders(monkeypatch):
    """A quarter of the border entries of a norm-0.3 velocity set to 0, so
    the base grid's exact +-1 entries survive every squaring (all
    sub-voxel: JAX takes its stencil throughout).  Field within 2e-5; the
    gradient within 5e-5 absolute: at an entry on +1 a rounding of the
    composed value decides between the slope inside the border and 0."""
    r = np.random.RandomState(8)
    shape = (4, 6, 5)
    duv = r.uniform(-1, 1, (2, 3) + shape)
    duv = duv * 0.3 / np.linalg.norm(duv)
    base = np.asarray(jint.base_grid(2, shape))
    pinned = (np.abs(base) == 1) & (r.rand(*duv.shape) < 0.25)
    duv = np.where(pinned, 0.0, duv).astype(np.float32)
    assert pinned.mean() > 0.05
    (ref_f, ref_g), (f, g) = _exponentiate_pair(duv, monkeypatch)
    np.testing.assert_allclose(f, ref_f, rtol=0, atol=2e-5)
    np.testing.assert_allclose(g, ref_g, rtol=0, atol=5e-5)


def test_exponentiate_flow_3d_with_pinned_borders_past_a_voxel(monkeypatch):
    """A quarter of the border entries of a norm-40 velocity set to 0, so
    exact +-1 entries survive every squaring, the last of which pass a
    voxel (JAX's sampler there, its stencil before): the case whose
    gradient the whole lower-bound slope moved by 7.4e-2 of its 2.48
    maximum.  Field within 2e-5 and the gradient within 2e-5 of max(1, its
    largest entry), as the unpinned norm-40 case."""
    r = np.random.RandomState(8)
    shape = (4, 6, 5)
    duv = r.uniform(-1, 1, (2, 3) + shape)
    duv = duv * 40.0 / np.linalg.norm(duv)
    base = np.asarray(jint.base_grid(2, shape))
    pinned = (np.abs(base) == 1) & (r.rand(*duv.shape) < 0.25)
    duv = np.where(pinned, 0.0, duv).astype(np.float32)
    assert pinned.mean() > 0.05
    (ref_f, ref_g), (f, g) = _exponentiate_pair(duv, monkeypatch)
    assert tint.ADAPTIVE_STEPS[-1] == 7
    np.testing.assert_allclose(f, ref_f, rtol=0, atol=2e-5)
    np.testing.assert_allclose(g, ref_g, rtol=0,
                               atol=2e-5 * max(1.0, np.abs(ref_g).max()))
