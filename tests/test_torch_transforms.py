"""The port's four transforms against the JAX package's, with identical
injected parameters: apply / inverse / update / project / prepare_train
and the precomputed paths the solver uses.  Morph outputs use the sparse
criterion of tests/test_reference_e2e.py (its 8 self-compositions amplify
rounding); the JAX side is built with ADVCHAIN_STENCIL=0."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advchain_tpu import augmentor as jaug
from advchain_tpu_torch import augmentor as taug
import torch_threads  # noqa: F401  (one intra-op thread a process)

N, H, W = 2, 32, 32
SIZE = [N, 1, H, W]
CONFIGS = {
    "noise": {"epsilon": 1.0, "xi": 1e-6, "data_size": SIZE},
    "bias": {"epsilon": 0.3, "control_point_spacing": [16, 16],
             "downscale": 2, "data_size": SIZE, "interpolation_order": 3,
             "init_mode": "random", "space": "log"},
    "affine": {"rot": 30.0 / 180.0, "scale_x": 0.2, "scale_y": 0.2,
               "shift_x": 0.1, "shift_y": 0.1, "data_size": SIZE},
    "morph": {"epsilon": 1.5, "data_size": SIZE, "vector_size": [2, 2]},
}
CLASSES = {"noise": "AdvNoise", "bias": "AdvBias", "affine": "AdvAffine",
           "morph": "AdvMorph"}


@pytest.fixture(autouse=True)
def _sampler_compositions(monkeypatch):
    monkeypatch.setenv("ADVCHAIN_STENCIL", "0")


def _pair(name, **kw):
    cfg = CONFIGS[name]
    return (getattr(taug, CLASSES[name])(config_dict=dict(cfg), **kw),
            getattr(jaug, CLASSES[name])(config_dict=dict(cfg), **kw))


def _params(name, seed, tr):
    """A parameter draw in the JAX package's layout (numpy, seeded)."""
    r = np.random.RandomState(seed)
    if name == "noise":
        p = r.randn(*SIZE)
        return (p / np.linalg.norm(p.reshape(N, -1), axis=1).reshape(
            N, 1, 1, 1)).astype(np.float32)
    if name == "bias":
        return r.uniform(tr.low, tr.high, tr.cp_grid).astype(np.float32)
    if name == "affine":
        return r.uniform(-1, 1, (N, 5)).astype(np.float32)
    p = r.uniform(-1, 1, (N, 2, 2, 2))
    return (p / np.linalg.norm(p.reshape(N, -1), axis=1).reshape(
        N, 1, 1, 1)).astype(np.float32)


def _image(seed=0, c=1):
    r = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                         indexing="ij")
    img = np.exp(-(yy ** 2 + xx ** 2) * 3)[None, None]
    return (img + 0.1 * r.rand(N, c, H, W)).astype(np.float32)


def _check(name, ours, ref, atol=1e-5):
    ours = ours.detach().numpy()
    ref = np.asarray(ref)
    if name == "morph":
        d = np.abs(ours - ref)
        assert d.mean() < 1e-4 and (d > 1e-3).mean() < 0.01, \
            (d.mean(), (d > 1e-3).mean())
    else:
        np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("name", ["noise", "bias", "affine", "morph"])
def test_apply_and_inverse(name, training):
    t, j = _pair(name)
    t.power_iteration = j.power_iteration = training
    p = _params(name, 1, j)
    x = _image()
    tp, jp = torch.from_numpy(p), jnp.asarray(p)
    _check(name, t.apply(tp, torch.from_numpy(x), training=training),
           j.apply(jp, jnp.asarray(x), training=training))
    _check(name, t.inverse(tp, torch.from_numpy(x), training=training),
           j.inverse(jp, jnp.asarray(x), training=training))
    aux_t = t.precompute(tp, training)
    aux_j = j.precompute(jp, training)
    _check(name, t.apply_precomputed(aux_t, tp, torch.from_numpy(x),
                                     training),
           j.apply_precomputed(aux_j, jp, jnp.asarray(x), training))
    _check(name, t.inverse_precomputed(aux_t, tp, torch.from_numpy(x),
                                       training),
           j.inverse_precomputed(aux_j, jp, jnp.asarray(x), training))


@pytest.mark.parametrize("power_iteration", [False, True])
@pytest.mark.parametrize("name", ["noise", "bias", "affine", "morph"])
def test_update_project_prepare(name, power_iteration):
    t, j = _pair(name)
    t.power_iteration = j.power_iteration = power_iteration
    p = _params(name, 2, j)
    g = np.random.RandomState(3).randn(*p.shape).astype(np.float32)
    tp, jp = torch.from_numpy(p), jnp.asarray(p)
    _check("", t.update(tp, torch.from_numpy(g), 0.7),
           j.update(jp, jnp.asarray(g), 0.7))
    _check("", t.project(tp * 3), j.project(jp * 3))
    _check("", t.prepare_train(tp), j.prepare_train(jp))


@pytest.mark.parametrize("padding", ["lowest", -0.25, "border",
                                     "reflection"])
def test_affine_padding_modes(padding):
    t, j = _pair("affine", image_padding_mode=padding)
    p = _params("affine", 4, j)
    x = _image(5, c=2)
    _check("affine", t.apply(torch.from_numpy(p), torch.from_numpy(x)),
           j.apply(jnp.asarray(p), jnp.asarray(x)))


def test_morph_padding_per_call():
    t, j = _pair("morph")
    p = _params("morph", 6, j)
    x = _image(7)
    _check("morph", t.apply(torch.from_numpy(p), torch.from_numpy(x),
                            padding_mode="border"),
           j.apply(jnp.asarray(p), jnp.asarray(x), padding_mode="border"))


def test_gradients_through_transforms():
    """Gradient of sum(apply(params, x)^2) with respect to the params of
    the two geometric transforms (through the sampler's backward)."""
    x = _image(8)
    for name in ("affine", "morph"):
        t, j = _pair(name)
        p = _params(name, 9, j)
        tp = torch.from_numpy(p).requires_grad_(True)
        t.apply(tp, torch.from_numpy(x)).pow(2).sum().backward()
        ref = jax.grad(lambda q: jnp.sum(
            j.apply(q, jnp.asarray(x)) ** 2))(jnp.asarray(p))
        np.testing.assert_allclose(
            tp.grad.numpy(), np.asarray(ref),
            rtol=1e-3 if name == "morph" else 1e-4,
            atol=1e-3 * float(np.abs(np.asarray(ref)).max()))


def test_init_parameters_needs_a_device_on_a_cpu_box():
    t, _ = _pair("noise")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        t.init_parameters()
    t.device = "cpu"
    assert tuple(t.init_parameters().shape) == tuple(SIZE)
