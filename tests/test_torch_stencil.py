"""The port's 2D stencil warp (``ops.grid_sample.stencil_warp_2d`` on the
``stencil_warp`` kernel pair's plain twins) against the JAX package's
``stencil_warp_2d`` on identical numpy inputs, and flow composition and
scaling and squaring against JAX's default dispatch (ADVCHAIN_STENCIL=1:
the stencil under 2 px of displacement, the sampler otherwise).

JAX forms compared: ``xla`` (the custom VJP with its analytic XLA
backward), ``xla_autodiff`` (autodiff of ``_stencil_warp_2d_xla_fn``, what
JAX's default ``compose_flow`` differentiates) and ``pallas`` (the
kernels/stencil.py Pallas kernels in interpret mode, under
ADVCHAIN_STENCIL_IMPL=pallas; each test shows the kernels were called,
since the Pallas path silently falls back to XLA where
``_stencil_pallas_ok`` fails: H=16 leaves the 2R row margin it needs).

Tolerances: outputs 1e-5 absolute (the port's sum is the XLA form's
separable order); image and flow gradients 1e-4 of their largest entry
(channel sums and the Pallas kernels' tap order reassociate f32).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advchain_tpu.ops import integrate as jint

from advchain_tpu_torch.kernels import stencil_warp as tsw
from advchain_tpu_torch.ops import integrate as tint
from advchain_tpu_torch.ops.grid_sample import grid_sample_2d, stencil_warp_2d
import torch_threads  # noqa: F401  (one intra-op thread a process)

jgs = importlib.import_module("advchain_tpu.ops.grid_sample")
jstencil = importlib.import_module("advchain_tpu.kernels.stencil")

N, C, H, W = 2, 3, 16, 20
FORMS = ["xla", "xla_autodiff", "pallas"]


def _flow(seed, disp_px, n=N, h=H, w=W):
    """Base grid plus a uniform displacement of up to ``disp_px`` pixels
    per axis (channel-first, channel 0 along W)."""
    r = np.random.RandomState(seed)
    base = np.asarray(jint.base_grid(n, (h, w)))
    scale = np.array([2.0 / (w - 1), 2.0 / (h - 1)]).reshape(1, 2, 1, 1)
    return (base + r.uniform(-1, 1, base.shape) * disp_px
            * scale).astype(np.float32)


def _inputs(seed, flow):
    r = np.random.RandomState(seed)
    n, _, h, w = flow.shape
    img = r.randn(n, C, h, w).astype(np.float32)
    cot = r.randn(n, C, h, w).astype(np.float32)
    return img, cot


@pytest.fixture
def pallas_calls(monkeypatch):
    """Count calls of the JAX Pallas stencil kernels' wrappers."""
    calls = {"fwd": 0, "bwd": 0}
    for kind in ("fwd", "bwd"):
        name = f"stencil_{kind}_2d_pallas"
        real = getattr(jstencil, name)

        def counted(*a, _real=real, _kind=kind, **k):
            calls[_kind] += 1
            return _real(*a, **k)

        monkeypatch.setattr(jstencil, name, counted)
    return calls


def _jax_stencil(form, img, flow, cot, radius, monkeypatch):
    """JAX output and (d_img, d_flow) for one of FORMS."""
    monkeypatch.setenv("ADVCHAIN_STENCIL_IMPL",
                       "pallas" if form == "pallas" else "xla")
    fn = (jgs._stencil_warp_2d_xla_fn if form == "xla_autodiff"
          else jgs.stencil_warp_2d)
    out, vjp = jax.vjp(lambda i, f: fn(i, f, radius, "first"),
                       jnp.asarray(img), jnp.asarray(flow))
    return [np.asarray(a) for a in (out, *vjp(jnp.asarray(cot)))]


def _port_stencil(img, flow, cot):
    ti = torch.from_numpy(img).requires_grad_(True)
    tf = torch.from_numpy(flow).requires_grad_(True)
    out = stencil_warp_2d(ti, tf, grid_layout="first")
    out.backward(torch.from_numpy(cot))
    return [t.detach().numpy() for t in (out, ti.grad, tf.grad)]


def _assert_match(ours, ref):
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-5, rtol=0)
    for a, b in zip(ours[1:], ref[1:]):
        scale = float(np.abs(b).max())
        assert float(np.abs(a - b).max()) <= 1e-4 * scale, \
            (float(np.abs(a - b).max()), scale)


def _compare(form, radius, flow, seed, monkeypatch, pallas_calls):
    img, cot = _inputs(seed, flow)
    ref = _jax_stencil(form, img, flow, cot, radius, monkeypatch)
    if form == "pallas":
        assert pallas_calls == {"fwd": 1, "bwd": 1}, pallas_calls
    _assert_match(_port_stencil(img, flow, cot), ref)


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("form", FORMS)
def test_near_identity_matches_jax(form, radius, monkeypatch, pallas_calls):
    """Every sample within R pixels of its own pixel (0.9 R of
    displacement per axis)."""
    _compare(form, radius, _flow(radius, 0.9 * radius), 10 + radius,
             monkeypatch, pallas_calls)


@pytest.mark.parametrize("form", FORMS)
def test_exact_bounds_subgradient_matches_jax(form, monkeypatch,
                                              pallas_calls):
    """Border rows and columns exactly on +-1, and entries one pixel in
    from the border set to exactly +-1 (a sample still within R = 2): the
    stencil's grid gradient there is the one-sided slope (all of
    ``v1 - v0`` at -1, none at +1), where the sampler's clip passes half
    at -1."""
    flow = _flow(3, 0.8)
    base = np.asarray(jint.base_grid(N, (H, W)))
    edge = np.zeros((H, W), bool)
    edge[[0, -1], :] = edge[:, [0, -1]] = True
    flow[:, :, edge] = base[:, :, edge]
    r = np.random.RandomState(4)
    for ch, axis in ((0, 3), (1, 2)):  # x along W, y along H
        for idx, val in ((1, -1.0), (-2, 1.0)):
            sl = [slice(None)] * 4
            sl[1], sl[axis] = ch, idx
            pick = r.rand(*flow[tuple(sl)].shape) < 0.5
            flow[tuple(sl)] = np.where(pick, np.float32(val),
                                       flow[tuple(sl)])
    _compare(form, 2, flow, 5, monkeypatch, pallas_calls)


def test_exact_lower_bound_passes_the_whole_slope():
    """At x = -1 the stencil passes the whole slope; the sampler's
    ``jnp.clip`` semantics pass half of it (ROADMAP queue 3)."""
    flow = np.asarray(jint.base_grid(N, (H, W))).copy()
    img, cot = _inputs(6, flow)
    ours = _port_stencil(img, flow, cot)[2]
    tf = torch.from_numpy(flow).requires_grad_(True)
    out = grid_sample_2d(torch.from_numpy(img), torch.movedim(tf, 1, -1),
                         padding_mode="border")
    out.backward(torch.from_numpy(cot))
    col0 = np.s_[:, 0, 1:-1, 0]  # x on -1, y interior
    np.testing.assert_allclose(tf.grad.numpy()[col0], 0.5 * ours[col0],
                               atol=1e-5, rtol=1e-5)
    assert np.abs(ours[col0]).max() > 0.1


@pytest.mark.parametrize("disp_px", [3.0, 7.0])
def test_past_radius_and_border_matches_jax_sampler(disp_px):
    """Displacements past R = 2 and samples past the image border: the
    clamped taps are exact bilinear with border padding, so the port's
    stencil equals JAX ``grid_sample_2d(..., "border",
    align_corners=True)``."""
    flow = _flow(7, disp_px)
    flow[:, :, :3] *= 1.25  # rows sampled well past the border
    assert np.abs(flow).max() > 1.1
    img, cot = _inputs(8, flow)
    out, vjp = jax.vjp(
        lambda i, f: jgs.grid_sample_2d(i, jnp.moveaxis(f, 1, -1),
                                        mode="bilinear",
                                        padding_mode="border",
                                        align_corners=True),
        jnp.asarray(img), jnp.asarray(flow))
    ref = [np.asarray(a) for a in (out, *vjp(jnp.asarray(cot)))]
    _assert_match(_port_stencil(img, flow, cot), ref)


def test_grid_layouts_agree():
    flow = _flow(9, 1.5)
    img, _ = _inputs(9, flow)
    t_img, t_flow = torch.from_numpy(img), torch.from_numpy(flow)
    first = stencil_warp_2d(t_img, t_flow, grid_layout="first")
    last = stencil_warp_2d(t_img, torch.movedim(t_flow, 1, -1))
    assert torch.equal(first, last)


def test_twins_are_the_launch_free_cpu_path():
    """CPU tensors take the twins: the launch counters stay put."""
    flow = _flow(11, 1.0)
    img, cot = _inputs(11, flow)
    before = (tsw.FWD_LAUNCHES, tsw.BWD_LAUNCHES)
    out = tsw.stencil_warp_fwd(torch.from_numpy(img), torch.from_numpy(flow))
    d_img, d_flow = tsw.stencil_warp_bwd(torch.from_numpy(cot),
                                         torch.from_numpy(img),
                                         torch.from_numpy(flow))
    assert (tsw.FWD_LAUNCHES, tsw.BWD_LAUNCHES) == before
    assert out.shape == d_img.shape == img.shape
    assert d_flow.shape == flow.shape


@pytest.mark.parametrize("disp2", [0.8, 3.0])
def test_compose_flow_matches_jax_default_dispatch(disp2):
    """JAX takes its stencil for the 0.8 px ``flow2`` and its sampler for
    the 3 px one; the port takes the stencil for both."""
    f1, f2 = _flow(12, 3.0), _flow(13, disp2)
    img, cot = _inputs(14, f1)
    cot = cot[:, :2]
    out, vjp = jax.vjp(jint.compose_flow, jnp.asarray(f1), jnp.asarray(f2))
    ref = [np.asarray(a) for a in (out, *vjp(jnp.asarray(cot)))]
    t1 = torch.from_numpy(f1).requires_grad_(True)
    t2 = torch.from_numpy(f2).requires_grad_(True)
    mine = tint.compose_flow(t1, t2)
    mine.backward(torch.from_numpy(cot))
    _assert_match([t.detach().numpy() for t in (mine, t1.grad, t2.grad)], ref)


def _with_exact_bounds(flow, seed, radius_px=None):
    """``flow`` with about 5% of its entries set exactly to +-1 (the bound
    on the entry's side of 0); with ``radius_px``, only entries whose base
    lies within 0.9 ``radius_px`` of that bound, so every sample stays
    within the radius."""
    r = np.random.RandomState(seed)
    n, _, h, w = flow.shape
    base = np.asarray(jint.base_grid(n, (h, w)))
    bound = np.where(flow >= 0, 1.0, -1.0)
    pick = r.rand(*flow.shape) < 0.05
    if radius_px is not None:
        px = np.array([2.0 / (w - 1), 2.0 / (h - 1)]).reshape(1, 2, 1, 1)
        near = np.abs(bound - base) < 0.9 * radius_px * px
        pick = (r.rand(*flow.shape) < 0.05 / near.mean()) & near
    return np.where(pick, bound, flow).astype(np.float32)


@pytest.mark.parametrize("disp2", [0.8, 3.0])
def test_compose_flow_with_exact_bounds_matches_jax_default_dispatch(disp2):
    """``flow2`` with 5% of its entries exactly on +-1: JAX takes its
    stencil at 0.8 px (the whole one-sided slope at -1) and its sampler at
    3 px (``jnp.clip``'s half); the port's predicate hands the stencil
    kernel the same slope, so the grid gradient matches at the entries on
    -1 too."""
    f1 = _flow(17, 3.0)
    f2 = _with_exact_bounds(_flow(18, disp2), 19,
                            radius_px=2 if disp2 < 2 else None)
    lower = f2 == -1
    assert 0.01 < lower.mean() < 0.05
    _, cot = _inputs(20, f1)
    cot = cot[:, :2]
    out, vjp = jax.vjp(jint.compose_flow, jnp.asarray(f1), jnp.asarray(f2))
    ref = [np.asarray(a) for a in (out, *vjp(jnp.asarray(cot)))]
    t1 = torch.from_numpy(f1).requires_grad_(True)
    t2 = torch.from_numpy(f2).requires_grad_(True)
    mine = tint.compose_flow(t1, t2)
    mine.backward(torch.from_numpy(cot))
    _assert_match([t.detach().numpy() for t in (mine, t1.grad, t2.grad)], ref)
    assert np.abs(ref[2][lower]).max() > 1e-2 * np.abs(ref[2]).max()


def test_dispatch_slope_takes_jax_predicate():
    """The port's predicate (here its plain twin): JAX's ``dpx``, the
    largest displacement in pixels, and the slope on each side of
    R - 1e-3 = 1.999."""
    base = np.asarray(jint.base_grid(N, (H, W)))
    for px, slope in ((1.998, 1.0), (1.9995, 0.5), (3.0, 0.5)):
        flow = base.copy()
        flow[1, 0, 5, 7] += px * 2.0 / (W - 1)
        out = tsw.dispatch_slope(torch.from_numpy(flow.astype(np.float32)),
                                 2)
        np.testing.assert_allclose(float(out[1]), px, rtol=1e-5)
        assert float(out[0]) == slope


@pytest.mark.parametrize("grad", ["flow2", "flow1_only", "no_grad"])
def test_compose_flow_takes_the_predicate_only_for_a_grid_gradient(
        grad, monkeypatch):
    """The slope is read by the grid's gradient alone: a composition whose
    ``flow2`` takes no gradient (under ``no_grad``, or only ``flow1``
    differentiated) computes no predicate, with the same output and
    ``flow1`` gradient as one that does."""
    calls = []

    def counted(flow, radius):
        calls.append(radius)
        return tsw.dispatch_slope(flow, radius)

    monkeypatch.setattr(tint, "dispatch_slope", counted)
    f1 = _with_exact_bounds(_flow(21, 3.0), 22)
    f2 = _with_exact_bounds(_flow(23, 3.0), 24)
    _, cot = _inputs(25, f1)
    t1 = torch.from_numpy(f1).requires_grad_(True)
    t2 = torch.from_numpy(f2).requires_grad_(True)
    ref = tint.compose_flow(t1, t2)
    ref.backward(torch.from_numpy(cot[:, :2]))
    assert calls == [2]
    calls.clear()
    u1 = torch.from_numpy(f1).requires_grad_(grad == "flow1_only")
    u2 = torch.from_numpy(f2).requires_grad_(grad == "flow2")
    with torch.set_grad_enabled(grad != "no_grad"):
        out = tint.compose_flow(u1, u2)
    assert calls == ([2] if grad == "flow2" else [])
    assert torch.equal(out.detach(), ref.detach())
    if grad != "no_grad":
        out.backward(torch.from_numpy(cot[:, :2]))
        done = u2 if grad == "flow2" else u1
        assert torch.equal(done.grad, (t2 if grad == "flow2" else t1).grad)


@pytest.fixture
def jax_base_grid(monkeypatch):
    """Give the port JAX's base grid.  ``jnp.linspace`` differs from the
    port's correctly rounded one in ulps (ROADMAP queue 3), which moves
    pixel coordinates across integers, where floor() picks the other tap
    and the grid gradient jumps to the other side's slope; with one base
    grid the comparison isolates the compositions."""
    def grid(batch_size, spatial_shape, dtype=torch.float32, device=None):
        g = np.array(jint.base_grid(batch_size, spatial_shape))
        return torch.from_numpy(g).to(dtype=dtype, device=device)
    monkeypatch.setattr(tint, "base_grid", grid)


def _exponentiate(duv, nb_steps, cot):
    """(field, d_duv) of sum(exponentiate_flow(duv) * cot) in both."""
    out, vjp = jax.vjp(lambda v: jint.exponentiate_flow(v, nb_steps=nb_steps),
                       jnp.asarray(duv))
    ref = [np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])]
    tv = torch.from_numpy(duv).requires_grad_(True)
    mine = tint.exponentiate_flow(tv, nb_steps=nb_steps)
    mine.backward(torch.from_numpy(cot))
    return [mine.detach().numpy(), tv.grad.numpy()], ref


@pytest.mark.parametrize("nb_steps", [1, 4, 8])
def test_exponentiate_flow_matches_jax_default_dispatch(nb_steps,
                                                       jax_base_grid):
    """Velocity of +-0.2 on (2, 2, 16, 20): the early squarings are
    sub-pixel (JAX's stencil), the late ones wider (JAX's sampler).  Each
    squaring doubles an f32 difference, so 1 and 4 squarings are held to
    the file's tolerances (field 1e-5, gradient 1e-4 of its max) and 8 to
    field 1e-4 and gradient 1e-3 of its max (measured 1.3e-5 and 9.8e-5:
    256-fold amplification of XLA's and PyTorch's f32 rounding)."""
    r = np.random.RandomState(15)
    duv = r.uniform(-0.2, 0.2, (N, 2, H, W)).astype(np.float32)
    cot = r.randn(N, 2, H, W).astype(np.float32)
    ours, ref = _exponentiate(duv, nb_steps, cot)
    tol = 10.0 if nb_steps == 8 else 1.0
    assert float(np.abs(ours[0] - ref[0]).max()) <= tol * 1e-5
    scale = float(np.abs(ref[1]).max())
    assert float(np.abs(ours[1] - ref[1]).max()) <= tol * 1e-4 * scale


def test_exponentiate_tiny_velocity_sits_on_the_bounds(jax_base_grid):
    """A velocity of 1e-6 leaves ``grid + duv / 2^8`` on the base grid in
    f32, so every squaring samples exactly on +-1 at the border: JAX's
    default dispatch takes its stencil there, and the port's gradient must
    carry the stencil's one-sided slope, not the sampler's half.  Tolerances
    of 8 squarings as above (measured 1.3e-5 and 9.6e-5)."""
    r = np.random.RandomState(16)
    duv = (1e-6 * r.uniform(-1, 1, (N, 2, H, W))).astype(np.float32)
    cot = r.randn(N, 2, H, W).astype(np.float32)
    phi0 = np.asarray(jint.base_grid(N, (H, W))) + duv / 2.0 ** 8
    assert np.abs(phi0).max() == 1.0
    ours, ref = _exponentiate(duv, 8, cot)
    assert float(np.abs(ours[0] - ref[0]).max()) <= 1e-4
    scale = float(np.abs(ref[1]).max())
    assert float(np.abs(ours[1] - ref[1]).max()) <= 1e-3 * scale


def test_exponentiate_with_pinned_borders_past_the_radius(jax_base_grid):
    """A velocity of up to 10 px whose component along each axis is 0 on
    the border rows or columns that axis meets, so the border stays exactly
    on +-1 through all 8 squarings; the last ones pass 2 px, where JAX's
    default dispatch takes its sampler (half the slope at -1; the whole
    slope there puts the gradient 0.63 of its maximum off), and the early
    ones its stencil.  Tolerances of 8 squarings as above (measured 1.3e-5
    and 1.7e-5)."""
    r = np.random.RandomState(21)
    px = np.array([2.0 / (W - 1), 2.0 / (H - 1)]).reshape(1, 2, 1, 1)
    duv = r.uniform(-10.0, 10.0, (N, 2, H, W)) * px
    base = np.asarray(jint.base_grid(N, (H, W)))
    duv = np.where(np.abs(base) == 1, 0.0, duv).astype(np.float32)
    cot = r.randn(N, 2, H, W).astype(np.float32)
    ours, ref = _exponentiate(duv, 8, cot)
    assert float(np.abs(ours[0] - ref[0]).max()) <= 1e-4
    scale = float(np.abs(ref[1]).max())
    assert float(np.abs(ours[1] - ref[1]).max()) <= 1e-3 * scale
