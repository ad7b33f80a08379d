"""The port's compose solver beyond the parity cases of test_torch_e2e.py:
random inits (lazy_load=False and partly lazy), the non-finite guard,
parameter accessors and argument checks.  CPU, tiny shapes."""

import numpy as np
import pytest
import torch

from advchain_tpu_torch import augmentor as taug
from advchain_tpu_torch.models import SegmentationModel, UNet
import torch_threads  # noqa: F401  (one intra-op thread a process)

N, H, W = 2, 32, 32
SIZE = [N, 1, H, W]


def _chain():
    return [
        taug.AdvNoise(config_dict={"epsilon": 1.0, "xi": 1e-6,
                                   "data_size": SIZE}),
        taug.AdvBias(config_dict={
            "epsilon": 0.3, "control_point_spacing": [16, 16],
            "downscale": 2, "data_size": SIZE, "interpolation_order": 3,
            "init_mode": "random", "space": "log"}),
        taug.AdvAffine(config_dict={
            "rot": 30.0 / 180.0, "scale_x": 0.2, "scale_y": 0.2,
            "shift_x": 0.1, "shift_y": 0.1, "data_size": SIZE}),
        taug.AdvMorph(config_dict={"epsilon": 1.5, "data_size": SIZE,
                                   "vector_size": [2, 2]}),
    ]


@pytest.fixture(scope="module")
def model():
    return SegmentationModel.create(UNet(1, 4, 4), seed=1, device="cpu")


def _data(seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).rand(*SIZE).astype(np.float32))


def _solver(chain=None):
    return taug.ComposeAdversarialTransformSolver(
        chain_of_transforms=chain or _chain(),
        divergence_types=["mse", "contour"], divergence_weights=[1.0, 0.5])


def test_random_init_episode(model):
    solver = _solver()
    dist = solver.adversarial_training(_data(), model, n_iter=1,
                                       power_iteration="smart",
                                       step_sizes=1.0)
    assert torch.isfinite(dist)
    assert solver.adv_data.shape == (N, 1, H, W)
    assert solver.warped_back_adv_output.shape == (N, 4, H, W)
    noise, bias, _, morph = solver.get_transformation_parameters()
    # projected: noise and morph on the unit sphere, bias inside its bounds
    for p in (noise, morph):
        norms = p.reshape(N, -1).norm(dim=1)
        torch.testing.assert_close(norms, torch.ones(N))
    t_bias = solver.chain_of_transforms[1]
    lo, hi = (np.float32(v) for v in (t_bias.low, t_bias.high))
    assert float(bias.min()) >= lo and float(bias.max()) <= hi


def test_lazy_load_keeps_given_params_and_draws_missing(model):
    chain = _chain()
    solver = _solver(chain)
    given = torch.full((N, 5), 0.25)
    chain[2].set_parameters(given)
    solver.adversarial_training(
        _data(1), model, n_iter=1, lazy_load=True,
        optimize_flags=[True, True, False, True], power_iteration=False)
    assert torch.equal(chain[2].get_parameters(), given)  # not optimised
    assert all(t.param is not None for t in chain)


def test_episodes_draw_fresh_params_without_lazy_load(model):
    solver = _solver()
    solver.adversarial_training(_data(), model, n_iter=0)
    first = [p.clone() for p in solver.get_transformation_parameters()]
    solver.adversarial_training(_data(), model, n_iter=0)
    second = solver.get_transformation_parameters()
    assert not any(torch.equal(a, b) for a, b in zip(first, second))


def test_non_finite_divergence_leaves_params_unchanged():
    chain = _chain()
    solver = _solver(chain)
    gen = torch.Generator().manual_seed(3)
    params = [t.init_params(gen) for t in chain]
    solver.set_transformation(params)

    def nan_model(x):
        return torch.full((x.shape[0], 4) + tuple(x.shape[2:]),
                          float("nan")) + 0 * x

    init = torch.zeros(N, 4, H, W)
    dist = solver.adversarial_training(
        _data(), nan_model, init_output=init, n_iter=1, lazy_load=True,
        power_iteration=False)
    assert not torch.isfinite(dist)
    for t, p in zip(chain, params):
        # unchanged by the guarded update; projection still applies
        torch.testing.assert_close(t.param, t.project(p))


def test_argument_checks(model):
    solver = _solver()
    with pytest.raises(ValueError):
        solver.adversarial_training(_data(), model, optimize_flags=[True])
    with pytest.raises(ValueError):
        solver.adversarial_training(_data(), model, step_sizes=[1.0])
    with pytest.raises(ValueError):
        solver.adversarial_training(_data(), model, power_iteration="x")
    # an anatomy mask is an argument like any other now
    dist = solver.adversarial_training(_data(), model, n_iter=1,
                                       anatomy_mask_images=torch.ones(SIZE))
    assert torch.isfinite(dist)


def test_power_iteration_settings():
    solver = _solver()
    solver._apply_power_iteration_setting("smart")
    assert [t.power_iteration for t in solver.chain_of_transforms] == \
        [True, False, False, False]
    solver._apply_power_iteration_setting([False, True, False, True])
    assert [t.power_iteration for t in solver.chain_of_transforms] == \
        [False, True, False, True]


def test_episode_seeds_are_per_solver(model):
    """Each solver counts its own episode seeds from 1, as the JAX
    package's ``_next_episode_seed`` does: a solver made after other
    solvers ran episodes draws the same first episode as a fresh one."""
    from advchain_tpu import augmentor as jaug

    def first_episode():
        solver = _solver()
        solver.adversarial_training(_data(), model, n_iter=0)
        return [p.clone() for p in solver.get_transformation_parameters()]

    fresh = first_episode()
    busy = _solver()
    for _ in range(2):  # episodes of another solver in between
        busy.adversarial_training(_data(), model, n_iter=0)
    for a, b in zip(first_episode(), fresh):
        assert torch.equal(a, b)
    jsolver = jaug.ComposeAdversarialTransformSolver(chain_of_transforms=[])
    tsolver = _solver()
    assert ([int(tsolver._generator("cpu").initial_seed())
             for _ in range(3)]
            == [jsolver._next_episode_seed() for _ in range(3)] == [1, 2, 3])
