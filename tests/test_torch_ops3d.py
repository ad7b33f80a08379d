"""The port's 3D ops and losses against the JAX package on identical numpy
inputs.  Flow composition and exponentiation are compared with the JAX
side built with ADVCHAIN_STENCIL=0 (read at trace time), which pins its
compositions to the sampler, as the port's are."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advchain_tpu.losses import consistency as jloss
from advchain_tpu.ops import affine as jaff
from advchain_tpu.ops import bspline as jbs
from advchain_tpu.ops import conv as jconv
from advchain_tpu.ops import integrate as jint
from advchain_tpu.ops import resize as jres

from advchain_tpu_torch.losses import consistency as tloss
from advchain_tpu_torch.ops import affine as taff
from advchain_tpu_torch.ops import bspline as tbs
from advchain_tpu_torch.ops import conv as tconv
from advchain_tpu_torch.ops import integrate as tint
from advchain_tpu_torch.ops import resize as tres
import torch_threads  # noqa: F401  (one intra-op thread a process)


def _close(ours, ref, atol=1e-5):
    np.testing.assert_allclose(np.asarray(ours.detach() if
                                          torch.is_tensor(ours) else ours),
                               np.asarray(ref), atol=atol, rtol=0)


def _theta3(seed, n=2):
    r = np.random.RandomState(seed)
    th = np.eye(4)[None, :3].repeat(n, 0)
    th = th + r.uniform(-0.2, 0.2, th.shape)
    return th.astype(np.float32)


@pytest.mark.parametrize("align", [True, False])
def test_affine_grid_3d(align):
    th = _theta3(0)
    size = (2, 1, 5, 7, 6)
    _close(taff.affine_grid(torch.from_numpy(th), size, align),
           jaff.affine_grid(jnp.asarray(th), size, align))


def test_invert_affine_matrix_3d():
    th = _theta3(1)
    _close(taff.invert_affine_matrix(torch.from_numpy(th)),
           jaff.invert_affine_matrix(jnp.asarray(th)))
    eye = taff.make_batch_eye(2, 3)
    assert eye.shape == (2, 4, 4) and torch.equal(eye[1], torch.eye(4))


@pytest.mark.parametrize("sigma,ks", [(1.0, 9), (1.0, 5), (0.5, 5),
                                      (1.0, 11)])
def test_gaussian_smooth_3d(sigma, ks):
    """ks at the 3D bound (``ks <= 2*int(4*sigma+0.5)+1`` grows; 2D grows
    only below it), below it, and above it."""
    assert tconv.effective_gaussian_ks(ks, sigma, 3) == \
        jconv.effective_gaussian_ks(ks, sigma, 3)
    x = np.random.RandomState(2).randn(2, 3, 6, 8, 7).astype(np.float32)
    _close(tconv.gaussian_smooth(torch.from_numpy(x), sigma, ks),
           jax.jit(lambda v: jconv.gaussian_smooth(v, sigma, ks))(
               jnp.asarray(x)))


def test_conv_transpose_and_conv_same_3d():
    r = np.random.RandomState(3)
    x = r.randn(2, 2, 4, 5, 6).astype(np.float32)
    wt = r.randn(2, 3, 3, 5, 5).astype(np.float32)
    _close(tconv.conv_transpose(torch.from_numpy(x), torch.from_numpy(wt),
                                (1, 2, 2), (1, 1, 1)),
           jconv.conv_transpose(jnp.asarray(x), jnp.asarray(wt), (1, 2, 2),
                                1), atol=1e-4)
    ws = r.randn(3, 2, 3, 3, 3).astype(np.float32)
    _close(tconv.conv_same(torch.from_numpy(x), torch.from_numpy(ws)),
           jconv.conv_same(jnp.asarray(x), jnp.asarray(ws)), atol=1e-4)


@pytest.mark.parametrize("size,align", [((9, 12, 10), False),
                                        ((9, 12, 10), True),
                                        ((3, 5, 2), False)])
def test_interpolate_trilinear(size, align):
    x = np.random.RandomState(4).randn(2, 2, 4, 6, 5).astype(np.float32)
    _close(tres.interpolate(torch.from_numpy(x), size=size,
                            mode="trilinear", align_corners=align),
           jres.interpolate(jnp.asarray(x), size=size, mode="trilinear",
                            align_corners=align))


@pytest.mark.parametrize("size,scale", [((7, 5, 12), None),
                                        ((12, 7, 5), None),
                                        (None, 0.5), (None, 1.5)])
def test_interpolate_nearest_3d(size, scale):
    """Equal to JAX's: 7->5 and 5->12 in-plane, 12->7 along D, and both
    scale factors."""
    shape = (12, 7, 5) if size == (7, 5, 12) else (7, 12, 5)
    if size is None:
        shape = (12, 7, 5)
    x = np.random.RandomState(5).randn(2, 2, *shape).astype(np.float32)
    ours = tres.interpolate(torch.from_numpy(x), size=size,
                            scale_factor=scale, mode="nearest")
    ref = np.asarray(jres.interpolate(jnp.asarray(x), size=size,
                                      scale_factor=scale, mode="nearest"))
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_depthwise_conv_3d():
    """Within 1e-6 of the largest output: the 45-tap sums reassociate."""
    r = np.random.RandomState(7)
    x = r.randn(2, 2, 6, 9, 8).astype(np.float32)
    k = r.randn(3, 5, 3).astype(np.float32)
    ours = tconv.depthwise_conv(torch.from_numpy(x), torch.from_numpy(k))
    ref = np.asarray(jconv.depthwise_conv(jnp.asarray(x), jnp.asarray(k)))
    assert np.abs(ours.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("image,spacing,downscale,log_space", [
    ((8, 32, 32), (4, 16, 16), 4, True),
    ((12, 48, 40), (6, 24, 20), 4, True),
    ((12, 32, 32), (8, 16, 16), 2, False)])
def test_bspline_field_3d(image, spacing, downscale, log_space):
    """The 3D kernel pads every iteration by spacing - 1, and the field is
    resized to floor(size * scale)."""
    np.testing.assert_allclose(tbs.bspline_kernel(spacing[:3], 3, 3),
                               jbs.bspline_kernel(spacing[:3], 3, 3))
    tspec = tbs.make_bspline_field_spec(image, spacing, downscale)
    jspec = jbs.make_bspline_field_spec(image, spacing, downscale)
    assert vars(tspec) == vars(jspec)
    cp = np.random.RandomState(5).uniform(
        -0.3, 0.3, (2, 1) + tspec.cp_grid).astype(np.float32)
    field = tbs.evaluate_bspline_field(torch.from_numpy(cp), tspec, log_space)
    ref = jbs.evaluate_bspline_field(jnp.asarray(cp), jspec, log_space)
    assert field.shape == ref.shape
    _close(field, ref)


def _flow3(seed, n=2, shape=(5, 8, 9), disp_px=2.0):
    r = np.random.RandomState(seed)
    base = np.asarray(jint.base_grid(n, shape))
    scale = np.array([2.0 / (s - 1) for s in reversed(shape)]).reshape(
        1, 3, 1, 1, 1)
    return (base + r.uniform(-1, 1, base.shape) * disp_px
            * scale).astype(np.float32)


def test_compose_flow_3d(monkeypatch):
    monkeypatch.setenv("ADVCHAIN_STENCIL", "0")
    f1, f2 = _flow3(6), _flow3(7, disp_px=0.8)
    _close(tint.compose_flow(torch.from_numpy(f1), torch.from_numpy(f2)),
           jint.compose_flow(jnp.asarray(f1), jnp.asarray(f2)))


def _jax_step_count(duv, nb_steps):
    """JAX's adaptive step count, by its own formula
    (integrate.py:229-232)."""
    norm = jnp.linalg.norm(jnp.asarray(duv).reshape(-1))
    needed = jnp.ceil(jnp.log2(jnp.maximum(norm, 1e-30) / 0.5))
    n = jnp.maximum(jnp.int32(nb_steps), needed.astype(jnp.int32))
    return int(jnp.minimum(n, jnp.int32(nb_steps + 8)))


@pytest.mark.parametrize("norm,steps", [(0.3, 4), (9.0, 5), (40.0, 7),
                                        (1e5, 12)])
def test_adaptive_exponentiate_flow(monkeypatch, norm, steps):
    """Whole-batch norms on both sides of the step thresholds (with
    nb_steps=4: 0.3 keeps 4, 9 needs ceil(log2 18) = 5, 40 needs
    ceil(log2 80) = 7, 1e5 clamps at 4 + 8).  The step count must equal
    JAX's, and so must the field."""
    monkeypatch.setenv("ADVCHAIN_STENCIL", "0")
    r = np.random.RandomState(8)
    duv = r.uniform(-1, 1, (2, 3, 4, 6, 5))
    duv = (duv * norm / np.linalg.norm(duv)).astype(np.float32)
    assert _jax_step_count(duv, 4) == steps
    assert tint.adaptive_step_count(torch.from_numpy(duv), 4) == steps
    ours = tint.exponentiate_flow(torch.from_numpy(duv), nb_steps=4,
                                  adaptive=True)
    assert tint.ADAPTIVE_STEPS[-1] == steps
    ref = jax.jit(lambda v: jint.exponentiate_flow(
        v, nb_steps=4, adaptive=True))(jnp.asarray(duv))
    dev = np.abs(ours.numpy() - np.asarray(ref))
    assert dev.mean() < 1e-5 and dev.max() < 1e-4, (dev.mean(), dev.max())


def _preds3(seed, n=2, c=4, shape=(4, 8, 8)):
    r = np.random.RandomState(seed)
    out = (r.randn(n, c, *shape) * 3).astype(np.float32)
    ref = (r.randn(n, c, *shape) * 3).astype(np.float32)
    mask = (r.rand(n, 1, *shape) > 0.2).astype(np.float32)
    return out, ref, mask


@pytest.mark.parametrize("types", [("mse",), ("kl",), ("contour",),
                                   ("mse", "kl", "contour")])
@pytest.mark.parametrize("masked", [False, True])
def test_calc_segmentation_consistency_3d(types, masked):
    out, ref, mask = _preds3(10)
    weights = [1.0, 0.5, 0.25][:len(types)]
    kw = dict(divergence_types=list(types), divergence_weights=weights)
    tm = torch.from_numpy(mask) if masked else None
    jm = jnp.asarray(mask) if masked else None
    _close(tloss.calc_segmentation_consistency(
        torch.from_numpy(out), torch.from_numpy(ref), mask=tm, **kw),
        jloss.calc_segmentation_consistency(
            jnp.asarray(out), jnp.asarray(ref), mask=jm, **kw))


def test_contour_loss_3d_effective_kernels():
    """The reference's 3D Sobel bugs: gy equals gx, gz differentiates
    along the last axis; a one-hot labelmap target."""
    out, _, _ = _preds3(11)
    labels = np.random.RandomState(12).randint(0, 4, (2, 4, 8, 8))
    probs = torch.softmax(torch.from_numpy(out), 1)
    _close(tloss.contour_loss(probs, torch.from_numpy(labels)),
           jloss.contour_loss(jnp.asarray(probs.numpy()),
                              jnp.asarray(labels)))
    gx, gy, gz = tloss._sobel_kernels_3d(1)
    assert np.array_equal(gx, gy) and not np.array_equal(gx, gz)
