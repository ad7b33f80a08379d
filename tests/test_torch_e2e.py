"""The slice as a whole: one ``adversarial_training`` episode through the
JAX package and through the port, with the Flax UNet_16's weights carried
across and identical transform parameters injected with
``set_transformation`` + ``lazy_load=True`` (the packages' random streams
cannot match).  Each case runs against JAX's default dispatch (the
stencil for sub-2-px compositions, as the port takes its stencil for
every 2D composition) and against JAX built with ADVCHAIN_STENCIL=0
(every composition on the sampler).

DIVERGENCE (tests/test_reference_e2e.py, the note before
test_cardiac_2d_n_iter0_parity): morph composes a bilinear sample with
itself 8 times, so an f32 rounding difference occasionally flips a floor()
corner choice and steps the local flow by one pixel.  Chains with morph
are therefore held to the sparse criterion (n_iter=0) and to a relative
dist bound of 0.12 (n_iter=1); the morph-free chain to 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advchain_tpu import augmentor as jaug
from advchain_tpu.models import SegmentationModel as JaxModel
from advchain_tpu.models import UNet as FlaxUNet

from advchain_tpu_torch import augmentor as taug
from advchain_tpu_torch.models import (SegmentationModel, UNet,
                                       flax_unet_to_torch_state)
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
    "morph": {"epsilon": 1.5, "data_size": SIZE,
              "vector_size": [H // 16, W // 16]},
}
CLASSES = {"noise": "AdvNoise", "bias": "AdvBias", "affine": "AdvAffine",
           "morph": "AdvMorph"}
MORPH_FREE = ("noise", "bias", "affine")
FULL = ("noise", "bias", "affine", "morph")


@pytest.fixture(scope="module")
def models():
    jmodel = JaxModel.create(FlaxUNet(input_channel=1, num_classes=4,
                                      feature_scale=4), (N, 1, H, W),
                             rng=jax.random.PRNGKey(0))
    state = flax_unet_to_torch_state(
        jax.tree_util.tree_map(np.asarray, jmodel.params),
        jax.tree_util.tree_map(np.asarray, jmodel.batch_stats))
    module = UNet(input_channel=1, num_classes=4, feature_scale=4)
    module.load_state_dict(state)
    return jmodel, SegmentationModel(module)


def _image(seed=0):
    r = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                         indexing="ij")
    img = (np.exp(-((yy / 0.5) ** 2 + (xx / 0.4) ** 2))
           + 0.3 * np.exp(-(((yy + 0.4) / 0.25) ** 2
                            + ((xx - 0.3) / 0.2) ** 2)))
    return (img[None, None] + 0.05 * r.rand(N, 1, H, W)).astype(np.float32)


def _params(names, seed=42):
    """Parameters in the JAX package's layout, drawn with numpy."""
    r = np.random.RandomState(seed)
    out = []
    for name in names:
        if name == "noise":
            p = r.randn(*SIZE)
        elif name == "bias":
            spec = taug.AdvBias(config_dict=CONFIGS["bias"])
            p = r.uniform(spec.low, spec.high, spec.cp_grid)
        elif name == "affine":
            p = r.uniform(-1, 1, (N, 5))
        else:
            p = r.uniform(-1, 1, (N, 2) + tuple(CONFIGS["morph"]
                                                ["vector_size"]))
        if name in ("noise", "morph"):
            p = p / np.linalg.norm(p.reshape(N, -1), axis=1).reshape(
                (N,) + (1,) * (p.ndim - 1))
        out.append(p.astype(np.float32))
    return out


def _episode(pkg, model, names, n_iter, params, data):
    chain = [getattr(pkg, CLASSES[n])(config_dict=dict(CONFIGS[n]))
             for n in names]
    solver = pkg.ComposeAdversarialTransformSolver(
        chain_of_transforms=chain, divergence_types=["mse", "contour"],
        divergence_weights=[1.0, 0.5])
    solver.set_transformation(params)
    dist = solver.adversarial_training(
        data=data, model=model, n_iter=n_iter, lazy_load=True,
        optimize_flags=[True] * len(chain), power_iteration="smart",
        step_sizes=1.0)
    return (float(dist), np.asarray(solver.adv_data),
            [np.asarray(t.param) for t in chain])


def _both(models, names, n_iter, stencil, monkeypatch):
    if stencil == "sampler_only":
        monkeypatch.setenv("ADVCHAIN_STENCIL", "0")
    jmodel, tmodel = models
    params = _params(names)
    img = _image()
    ref = _episode(jaug, jmodel, names, n_iter,
                   [jnp.asarray(p) for p in params], jnp.asarray(img))
    ours = _episode(taug, tmodel, names, n_iter,
                    [torch.from_numpy(p) for p in params],
                    torch.from_numpy(img))
    return ref, ours


DISPATCH = ["default", "sampler_only"]


@pytest.mark.parametrize("stencil", DISPATCH)
def test_morph_free_chain_one_pgd_step(models, stencil, monkeypatch):
    ref, ours = _both(models, MORPH_FREE, 1, stencil, monkeypatch)
    assert abs(ours[0] - ref[0]) / abs(ref[0]) < 1e-3, (ours[0], ref[0])
    for i, (a, b) in enumerate(zip(ours[2], ref[2])):
        rel = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)
        assert rel < 1e-3, (i, rel)


@pytest.mark.parametrize("stencil", DISPATCH)
def test_full_chain_no_pgd(models, stencil, monkeypatch):
    ref, ours = _both(models, FULL, 0, stencil, monkeypatch)
    assert abs(ours[0] - ref[0]) < 1e-3, (ours[0], ref[0])
    d = np.abs(ours[1] - ref[1])
    assert d.mean() < 1e-4 and (d > 1e-3).mean() < 0.01, \
        (d.mean(), (d > 1e-3).mean())


@pytest.mark.parametrize("stencil", DISPATCH)
def test_full_chain_one_pgd_step(models, stencil, monkeypatch):
    ref, ours = _both(models, FULL, 1, stencil, monkeypatch)
    assert np.isfinite(ours[0])
    assert abs(ours[0] - ref[0]) / abs(ref[0]) < 0.12, (ours[0], ref[0])
