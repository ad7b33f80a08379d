"""The 3D slice: the four transforms, PseudoConv3dModel and one
``adversarial_training`` episode through the JAX package and through the
port, at the 3D episode's configuration rules (bench.py:349-382) cut to
batch 2, 1x8x32x32.  Flax weights are carried across, identical transform
parameters are injected with ``set_transformation`` + ``lazy_load=True``,
and dropout is 0 on both sides (the frameworks' random streams cannot
match); the JAX side is built with ADVCHAIN_STENCIL=0 (every composition on
the sampler, as in the port).

Morph composes a trilinear sample with itself 8 or more times, so, as in
tests/test_torch_transforms.py, its outputs are held to the sparse
criterion of tests/test_reference_e2e.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advchain_tpu import augmentor as jaug
from advchain_tpu.models import PseudoConv3dModel as FlaxPseudo3d
from advchain_tpu.models import SegmentationModel as JaxModel

from advchain_tpu_torch import augmentor as taug
from advchain_tpu_torch.models import (PseudoConv3dModel, SegmentationModel,
                                       flax_pseudo3d_to_torch_state)
from advchain_tpu_torch.models.unet import EpisodeDropout
import torch_threads  # noqa: F401  (one intra-op thread a process)

N = 2
SHAPE = (8, 32, 32)
SIZE = [N, 1, *SHAPE]
CONFIGS = {
    "noise": {"epsilon": 1.0, "xi": 1e-6, "data_size": SIZE},
    "bias": {"epsilon": 0.3,
             "control_point_spacing": [max(s // 2, 2) for s in SHAPE],
             "downscale": 4, "data_size": SIZE, "interpolation_order": 3,
             "init_mode": "random", "space": "log"},
    "affine": {"rot_x": 10.0 / 180, "rot_y": 10.0 / 180,
               "rot_z": 10.0 / 180, "scale_x": 0.1, "scale_y": 0.1,
               "scale_z": 0.1, "shift_x": 0.1, "shift_y": 0.1,
               "shift_z": 0.1, "data_size": SIZE},
    "morph": {"epsilon": 1.5, "data_size": SIZE,
              "vector_size": [max(SHAPE[0] // 2, 2), SHAPE[1] // 16,
                              SHAPE[2] // 16]},
}
CLASSES = {"noise": "AdvNoise", "bias": "AdvBias", "affine": "AdvAffine",
           "morph": "AdvMorph"}
MORPH_FREE = ("noise", "bias", "affine")
FULL = ("noise", "bias", "affine", "morph")


@pytest.fixture(autouse=True)
def _sampler_compositions(monkeypatch):
    monkeypatch.setenv("ADVCHAIN_STENCIL", "0")


def test_bias_stride_stays_positive():
    spec = taug.AdvBias(spatial_dims=3, config_dict=CONFIGS["bias"]).spec
    assert min(spec.stride) >= 1 and spec.stride[0] == 1


def _volume(seed=0, c=1):
    """bench.py make_volume at this size."""
    d, h, w = SHAPE
    ii, jj, kk = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    img = np.exp(-(((ii - d / 2) / (d / 3)) ** 2
                   + ((jj - h / 2) / (h / 4)) ** 2
                   + ((kk - w / 2) / (w / 4)) ** 2))
    r = np.random.RandomState(seed)
    return (img[None, None] + 0.05 * r.rand(N, c, *SHAPE)).astype(np.float32)


def _params(names, seed=42):
    """Parameters in the JAX package's layout, drawn with numpy."""
    r = np.random.RandomState(seed)
    out = []
    for name in names:
        if name == "noise":
            p = r.randn(*SIZE)
        elif name == "bias":
            spec = taug.AdvBias(spatial_dims=3, config_dict=CONFIGS["bias"])
            p = r.uniform(spec.low, spec.high, spec.cp_grid)
        elif name == "affine":
            p = r.uniform(-1, 1, (N, 9))
        else:
            p = r.uniform(-1, 1, (N, 3) + tuple(CONFIGS["morph"]
                                                ["vector_size"]))
        if name in ("noise", "morph"):
            p = p / np.linalg.norm(p.reshape(N, -1), axis=1).reshape(
                (N,) + (1,) * (p.ndim - 1))
        out.append(p.astype(np.float32))
    return out


def _close(name, ours, ref, atol=1e-5):
    ours = ours.detach().numpy()
    ref = np.asarray(ref)
    if name == "morph":
        d = np.abs(ours - ref)
        assert d.mean() < 1e-4 and (d > 1e-3).mean() < 0.01, \
            (d.mean(), (d > 1e-3).mean())
    else:
        np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("name", ["noise", "bias", "affine", "morph"])
def test_transform_apply_and_inverse_3d(name):
    cfg = dict(CONFIGS[name])
    ours = getattr(taug, CLASSES[name])(spatial_dims=3, config_dict=cfg)
    ref = getattr(jaug, CLASSES[name])(spatial_dims=3, config_dict=cfg)
    (p,) = _params([name], seed=3)
    img = _volume(1, c=2 if name in ("affine", "morph") else 1)
    x = ours.apply(torch.from_numpy(p), torch.from_numpy(img))
    # jitted: one compile instead of op-by-op dispatch of morph's ladder
    y = jax.jit(ref.apply)(jnp.asarray(p), jnp.asarray(img))
    _close(name, x, y)
    _close(name, ours.inverse(torch.from_numpy(p), x),
           jax.jit(ref.inverse)(jnp.asarray(p),
                                jnp.asarray(x.detach().numpy())))


def test_affine_matrix_3d_matches_jax():
    cfg = CONFIGS["affine"]
    (p,) = _params(["affine"], seed=4)
    p[0, :3] = (1.5, -2.0, 0.3)  # past Hardtanh's bounds
    ours = taug.AdvAffine(spatial_dims=3, config_dict=dict(cfg))
    ref = jaug.AdvAffine(spatial_dims=3, config_dict=dict(cfg))
    _close("affine", ours.gen_batch_affine_matrix(torch.from_numpy(p)),
           ref.gen_batch_affine_matrix(jnp.asarray(p)))
    assert ours.init_params(torch.Generator().manual_seed(0)).shape == (N, 9)


@pytest.mark.parametrize("padding", ["lowest", 0.25, "border"])
def test_affine_3d_padding_modes(padding):
    cfg = dict(CONFIGS["affine"])
    ours = taug.AdvAffine(spatial_dims=3, config_dict=cfg,
                          image_padding_mode=padding)
    ref = jaug.AdvAffine(spatial_dims=3, config_dict=cfg,
                         image_padding_mode=padding)
    (p,) = _params(["affine"], seed=5)
    img = _volume(2)
    _close("affine", ours.apply(torch.from_numpy(p), torch.from_numpy(img)),
           ref.apply(jnp.asarray(p), jnp.asarray(img)))


def _flax_model(dropout=0.0, seed=0):
    model = JaxModel.create(FlaxPseudo3d(num_classes=4, dropout=dropout),
                            tuple(SIZE), rng=jax.random.PRNGKey(seed))
    # running statistics away from their (0, 1) init so eval mode is tested
    r = np.random.RandomState(seed)
    model.batch_stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.uniform(0.5, 1.5, a.shape).astype(np.float32)
                              if a.ndim else a), model.batch_stats)
    return model


def _carried(jmodel, dropout=0.0):
    state = flax_pseudo3d_to_torch_state(
        jax.tree_util.tree_map(np.asarray, jmodel.params),
        jax.tree_util.tree_map(np.asarray, jmodel.batch_stats))
    module = PseudoConv3dModel(num_classes=4, dropout=dropout)
    module.load_state_dict(state)
    return SegmentationModel(module)


@pytest.fixture(scope="module")
def models():
    jmodel = _flax_model()
    return jmodel, _carried(jmodel)


@pytest.mark.parametrize("train", [True, False])
def test_pseudo3d_logits_match_flax(models, train):
    jmodel, tmodel = models
    x = np.random.RandomState(1).rand(*SIZE).astype(np.float32)
    ref = jmodel.apply_fixed(jnp.asarray(x), jmodel._episode_rng,
                             train=train)
    with torch.no_grad():
        ours = tmodel.apply_fixed(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


def test_dropout_mask_is_fixed_per_episode():
    """One mask in every forward of an episode; begin_episode redraws it.
    Kept values are scaled by 1 / (1 - p), as Flax's dropout does."""
    model = SegmentationModel.create(PseudoConv3dModel(dropout=0.5), seed=1,
                                     device="cpu")
    drop = model.module.drop
    x = torch.ones(1, 8, 2, 4, 4)
    a, b = drop(x), drop(x)
    assert torch.equal(a, b) and set(a.unique().tolist()) == {0.0, 2.0}
    y = torch.rand(*SIZE)
    with torch.no_grad():
        out = model(y)
        first = drop._mask.clone()
        assert torch.equal(model(y), out)
        model.begin_episode()
        assert not torch.equal(model(y), out)
        assert not torch.equal(drop._mask, first)
        model.begin_episode(seed=7)
        out7 = model(y)
        model.begin_episode(seed=7)
        assert torch.equal(model(y), out7)
    model.eval()
    with torch.no_grad():
        assert torch.equal(model.apply_fixed(y), model.apply_fixed(y))
    assert isinstance(drop, EpisodeDropout)


def test_solver_begins_an_episode_per_call():
    model = SegmentationModel.create(PseudoConv3dModel(dropout=0.5), seed=2,
                                     device="cpu")
    names = ("noise",)
    chain = [taug.AdvNoise(spatial_dims=3, config_dict=dict(
        CONFIGS["noise"]))]
    solver = taug.ComposeAdversarialTransformSolver(
        chain_of_transforms=chain, divergence_types=["mse"],
        divergence_weights=[1.0])
    seeds = []
    for _ in range(2):
        solver.set_transformation(_params(names))
        solver.adversarial_training(torch.from_numpy(_volume()), model,
                                    n_iter=0, lazy_load=True)
        seeds.append(model.module.drop.seed)
    assert seeds[0] != seeds[1]


def _episode(pkg, model, names, n_iter, params, data):
    chain = [getattr(pkg, CLASSES[n])(spatial_dims=3,
                                      config_dict=dict(CONFIGS[n]))
             for n in names]
    solver = pkg.ComposeAdversarialTransformSolver(
        chain_of_transforms=chain, divergence_types=["mse"],
        divergence_weights=[1.0])
    solver.set_transformation(params)
    dist = solver.adversarial_training(
        data=data, model=model, n_iter=n_iter, lazy_load=True,
        optimize_flags=[True] * len(chain), step_sizes=1.0)
    return (float(dist), np.asarray(solver.adv_data),
            [np.asarray(t.param) for t in chain])


def _both(models, names, n_iter):
    jmodel, tmodel = models
    params = _params(names)
    img = _volume()
    ref = _episode(jaug, jmodel, names, n_iter,
                   [jnp.asarray(p) for p in params], jnp.asarray(img))
    ours = _episode(taug, tmodel, names, n_iter,
                    [torch.from_numpy(p) for p in params],
                    torch.from_numpy(img))
    return ref, ours


def test_full_chain_no_pgd_3d(models):
    ref, ours = _both(models, FULL, 0)
    assert abs(ours[0] - ref[0]) <= 1e-4 * abs(ref[0]), (ours[0], ref[0])
    d = np.abs(ours[1] - ref[1])
    assert d.mean() < 1e-4 and (d > 1e-3).mean() < 0.01, \
        (d.mean(), (d > 1e-3).mean())


def test_morph_free_chain_one_pgd_step_3d(models):
    ref, ours = _both(models, MORPH_FREE, 1)
    assert abs(ours[0] - ref[0]) / abs(ref[0]) < 1e-3, (ours[0], ref[0])
    for i, (a, b) in enumerate(zip(ours[2], ref[2])):
        rel = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)
        assert rel < 1e-3, (i, rel)
