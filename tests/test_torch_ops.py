"""The port's 2D ops and losses against the JAX package on identical numpy
inputs.  Flow composition and exponentiation are compared with the JAX
side built with ADVCHAIN_STENCIL=0 (read at trace time), which pins its
compositions to the sampler; the port's 2D compositions take its stencil
kernels, which are the same exact bilinear sampling with border padding
(tests/test_torch_stencil.py holds them against JAX's default
dispatch)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from advchain_tpu.losses import consistency as jloss
from advchain_tpu.ops import affine as jaff
from advchain_tpu.ops import bspline as jbs
from advchain_tpu.ops import conv as jconv
from advchain_tpu.ops import integrate as jint
from advchain_tpu.ops import norms as jnorms
from advchain_tpu.ops import resize as jres

from advchain_tpu_torch.losses import consistency as tloss
from advchain_tpu_torch.ops import affine as taff
from advchain_tpu_torch.ops import bspline as tbs
from advchain_tpu_torch.ops import conv as tconv
from advchain_tpu_torch.ops import integrate as tint
from advchain_tpu_torch.ops import norms as tnorms
from advchain_tpu_torch.ops import resize as tres
import torch_threads  # noqa: F401  (one intra-op thread a process)


def _close(ours, ref, atol=1e-5):
    np.testing.assert_allclose(np.asarray(ours.detach() if
                                          torch.is_tensor(ours) else ours),
                               np.asarray(ref), atol=atol, rtol=0)


def _theta(seed, n=2):
    r = np.random.RandomState(seed)
    ang = r.uniform(-0.5, 0.5, n)
    sc = r.uniform(0.8, 1.2, (n, 2))
    sh = r.uniform(-0.1, 0.1, (n, 2))
    th = np.stack([
        np.stack([sc[:, 0] * np.cos(ang), -sc[:, 1] * np.sin(ang),
                  sh[:, 0]], -1),
        np.stack([sc[:, 0] * np.sin(ang), sc[:, 1] * np.cos(ang),
                  sh[:, 1]], -1)], 1)
    return th.astype(np.float32)


@pytest.mark.parametrize("align", [True, False])
def test_affine_grid(align):
    th = _theta(0)
    size = (2, 1, 12, 10)
    _close(taff.affine_grid(torch.from_numpy(th), size, align),
           jaff.affine_grid(jnp.asarray(th), size, align))


def test_invert_affine_matrix():
    th = _theta(1)
    _close(taff.invert_affine_matrix(torch.from_numpy(th)),
           jaff.invert_affine_matrix(jnp.asarray(th)))


@pytest.mark.parametrize("sigma,ks", [(1.0, 5), (2.0, 9)])
def test_gaussian_smooth(sigma, ks):
    x = np.random.RandomState(2).randn(2, 2, 12, 16).astype(np.float32)
    _close(tconv.gaussian_smooth(torch.from_numpy(x), sigma, ks),
           jconv.gaussian_smooth(jnp.asarray(x), sigma, ks))


def test_conv_transpose_and_conv_same():
    r = np.random.RandomState(3)
    x = r.randn(2, 2, 6, 7).astype(np.float32)
    wt = r.randn(2, 3, 5, 5).astype(np.float32)
    _close(tconv.conv_transpose(torch.from_numpy(x), torch.from_numpy(wt),
                                (2, 2), (1, 1)),
           jconv.conv_transpose(jnp.asarray(x), jnp.asarray(wt), 2, 1))
    ws = r.randn(3, 2, 3, 3).astype(np.float32)
    _close(tconv.conv_same(torch.from_numpy(x), torch.from_numpy(ws)),
           jconv.conv_same(jnp.asarray(x), jnp.asarray(ws)))


@pytest.mark.parametrize("size,align", [((20, 24), False), ((20, 24), True),
                                        ((5, 3), False)])
def test_interpolate(size, align):
    x = np.random.RandomState(4).randn(2, 2, 8, 6).astype(np.float32)
    _close(tres.interpolate(torch.from_numpy(x), size=size,
                            align_corners=align),
           jres.interpolate(jnp.asarray(x), size=size, align_corners=align))


@pytest.mark.parametrize("size,scale", [((7, 5), None), ((5, 12), None),
                                        ((100, 100), None), (None, 0.5),
                                        (None, 1.5), ((9, 7), None)])
def test_interpolate_nearest(size, scale):
    """JAX's float64 ``floor(i * in / out)`` index, equal: 7->5 and 5->12
    per axis, 192->100, and both scale factors."""
    shape = (192, 192) if size == (100, 100) else (7, 5)
    if size == (5, 12):
        shape = (5, 5)
    x = np.random.RandomState(5).randn(2, 3, *shape).astype(np.float32)
    ours = tres.interpolate(torch.from_numpy(x), size=size,
                            scale_factor=scale, mode="nearest")
    ref = np.asarray(jres.interpolate(jnp.asarray(x), size=size,
                                      scale_factor=scale, mode="nearest"))
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_depthwise_conv_and_gaussian_kernel_1d():
    r = np.random.RandomState(6)
    x = r.randn(2, 3, 12, 11).astype(np.float32)
    k = r.randn(5, 3).astype(np.float32)
    _close(tconv.depthwise_conv(torch.from_numpy(x), torch.from_numpy(k)),
           jconv.depthwise_conv(jnp.asarray(x), jnp.asarray(k)), atol=1e-6)
    for ks, sigma in ((5, 1.0), (9, 2.0), (4, 0.7)):
        np.testing.assert_array_equal(
            tconv.gaussian_kernel_1d(ks, sigma).numpy(),
            np.asarray(jconv.gaussian_kernel_1d(ks, sigma)))


def test_ops_exports_every_name_of_jax():
    import advchain_tpu.ops as jops
    import advchain_tpu_torch.ops as tops
    assert set(jops.__all__) <= set(tops.__all__)
    for name in tops.__all__:
        assert hasattr(tops, name)


@pytest.mark.parametrize("image,spacing,log_space", [
    ((64, 64), (32, 32), True), ((64, 48), (16, 24), False),
    ((192, 192), (48, 48), True)])
def test_bspline_field(image, spacing, log_space):
    tspec = tbs.make_bspline_field_spec(image, spacing, 2)
    jspec = jbs.make_bspline_field_spec(image, spacing, 2)
    assert tspec.cp_grid == jspec.cp_grid
    cp = np.random.RandomState(5).uniform(
        -0.3, 0.3, (2, 1) + tspec.cp_grid).astype(np.float32)
    field = tbs.evaluate_bspline_field(torch.from_numpy(cp), tspec, log_space)
    ref = jbs.evaluate_bspline_field(jnp.asarray(cp), jspec, log_space)
    _close(field, ref)
    _close(tbs.clip_bias(field, 0.3), jbs.clip_bias(ref, 0.3))


def _flow(seed, n=2, h=16, w=20, disp_px=3.0):
    r = np.random.RandomState(seed)
    base = np.asarray(jint.base_grid(n, (h, w)))
    scale = np.array([2.0 / (w - 1), 2.0 / (h - 1)]).reshape(1, 2, 1, 1)
    return (base + r.uniform(-1, 1, base.shape) * disp_px
            * scale).astype(np.float32)


def test_base_grid():
    _close(tint.base_grid(2, (7, 9)), jint.base_grid(2, (7, 9)), atol=1e-6)


def test_compose_flow(monkeypatch):
    monkeypatch.setenv("ADVCHAIN_STENCIL", "0")
    f1, f2 = _flow(6), _flow(7, disp_px=0.8)
    _close(tint.compose_flow(torch.from_numpy(f1), torch.from_numpy(f2)),
           jint.compose_flow(jnp.asarray(f1), jnp.asarray(f2)))


def _exponentiate_pair(nb_steps):
    duv = np.random.RandomState(8).uniform(-0.2, 0.2,
                                           (2, 2, 16, 20)).astype(np.float32)
    return (tint.exponentiate_flow(torch.from_numpy(duv),
                                   nb_steps=nb_steps).numpy(),
            np.asarray(jint.exponentiate_flow(jnp.asarray(duv),
                                              nb_steps=nb_steps)))


@pytest.mark.parametrize("nb_steps", [1, 4])
def test_exponentiate_flow(monkeypatch, nb_steps):
    monkeypatch.setenv("ADVCHAIN_STENCIL", "0")
    _close(*_exponentiate_pair(nb_steps))


def test_exponentiate_flow_eight_squarings(monkeypatch):
    """DIVERGENCE (ROADMAP queue 3): each squaring doubles an f32 rounding
    difference, so 8 squarings amplify ulp-level differences (the JAX
    base grid's linspace, XLA's fused arithmetic) 256-fold: max 5.1e-5 on
    this input, where the JAX package's own XLA and Pallas routes differ by
    1.7e-5.  The bulk stays at the 1e-5 bar."""
    monkeypatch.setenv("ADVCHAIN_STENCIL", "0")
    ours, ref = _exponentiate_pair(8)
    dev = np.abs(ours - ref)
    assert dev.mean() < 1e-5 and dev.max() < 1e-4, (dev.mean(), dev.max())


@pytest.mark.parametrize("p_type", ["l2", "l1", "infinity"])
def test_unit_normalize(p_type):
    d = np.random.RandomState(9).randn(3, 2, 5, 5).astype(np.float32)
    _close(tnorms.unit_normalize(torch.from_numpy(d), p_type),
           jnorms.unit_normalize(jnp.asarray(d), p_type))


def _preds(seed, n=2, c=4, h=16, w=16):
    r = np.random.RandomState(seed)
    out = (r.randn(n, c, h, w) * 3).astype(np.float32)
    ref = (r.randn(n, c, h, w) * 3).astype(np.float32)
    mask = (r.rand(n, 1, h, w) > 0.2).astype(np.float32)
    return out, ref, mask


@pytest.mark.parametrize("types", [("mse", "contour"), ("kl",),
                                   ("mse", "kl", "contour")])
@pytest.mark.parametrize("masked", [False, True])
def test_calc_segmentation_consistency(types, masked):
    out, ref, mask = _preds(10)
    weights = [1.0, 0.5, 0.25][:len(types)]
    kw = dict(divergence_types=list(types), divergence_weights=weights)
    tm = torch.from_numpy(mask) if masked else None
    jm = jnp.asarray(mask) if masked else None
    _close(tloss.calc_segmentation_consistency(
        torch.from_numpy(out), torch.from_numpy(ref), mask=tm, **kw),
        jloss.calc_segmentation_consistency(
            jnp.asarray(out), jnp.asarray(ref), mask=jm, **kw))


def test_contour_loss_one_hot_target():
    out, _, _ = _preds(11)
    labels = np.random.RandomState(12).randint(0, 4, (2, 16, 16))
    probs = torch.softmax(torch.from_numpy(out), 1)
    _close(tloss.contour_loss(probs, torch.from_numpy(labels)),
           jloss.contour_loss(jnp.asarray(probs.numpy()),
                              jnp.asarray(labels)))
