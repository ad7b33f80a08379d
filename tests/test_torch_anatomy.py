"""The port's anatomy-constrained episode against the JAX package's: the
volume-preservation score, one anatomy-penalised PGD step with "lowest"
padding, the retry ladder's branches (the score scripted on both
packages), the fused first attempt end to end, and one constrained solve
with injected parameters.

Quirks held: the penalty's binarisation has zero gradient, so a penalised
step moves the parameters as the same step with weight 0 does and only its
divergence differs; with "lowest" padding the pad value is the minimum
over every channel of the tensor warped in one call, so the port warps
JAX's concatenations ([ones, anatomy] forward, [prediction, validity,
anatomy] backward).  The Flax UNet(1, 4, 4)'s weights are carried into the
port for the parity checks; the ladder's checks use a small closed-form
network in both packages, since they count steps, draws and warnings."""

import logging

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
    "morph": {"epsilon": 1.5, "data_size": SIZE, "vector_size": [2, 2]},
    # tests/test_solver.py's ladder chain: no init passes 1e-9
    "wide_affine": {"rot": 0.45, "scale_x": 0.4, "scale_y": 0.4,
                    "shift_x": 0.4, "shift_y": 0.4, "data_size": SIZE},
}
CLASSES = {"noise": "AdvNoise", "bias": "AdvBias", "affine": "AdvAffine",
           "morph": "AdvMorph", "wide_affine": "AdvAffine"}
MORPH_FREE = ("noise", "bias", "affine")
FULL = ("noise", "bias", "affine", "morph")
LOGGERS = ("advchain_tpu.augmentor.compose",
           "advchain_tpu_torch.augmentor.compose")
P, F = 0.0, 1.0        # scripted scores on either side of LADDER_TOL
LADDER_TOL = 0.5


@pytest.fixture(autouse=True)
def _sampler_compositions(monkeypatch):
    monkeypatch.setenv("ADVCHAIN_STENCIL", "0")


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


def _small_net(x):
    """Four logits in closed form, the same in both packages."""
    cat = jnp.concatenate if isinstance(x, jax.Array) else torch.cat
    return 3.0 * cat([x, 1.0 - x, x * x, 0.5 - 2.0 * x], 1)


def _image(seed=0):
    r = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                         indexing="ij")
    img = (np.exp(-((yy / 0.5) ** 2 + (xx / 0.4) ** 2))
           + 0.3 * np.exp(-(((yy + 0.4) / 0.25) ** 2
                            + ((xx - 0.3) / 0.2) ** 2)))
    return (img[None, None] + 0.05 * r.rand(N, 1, H, W)).astype(np.float32)


def _ellipse():
    """bench.py:317-321's ellipse, scaled to 32x32."""
    ii, jj = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    mask = (((ii - 16) / 6.7) ** 2 + ((jj - 16) / 5.7) ** 2) < 1.0
    return np.broadcast_to(mask, SIZE).astype(np.float32)


def _square(lo, hi):
    mask = np.zeros(SIZE, np.float32)
    mask[:, :, lo:hi, lo:hi] = 1.0
    return mask


def _params(names, seed=42):
    r = np.random.RandomState(seed)
    out = []
    for name in names:
        if name == "noise":
            p = r.randn(*SIZE)
        elif name == "bias":
            spec = taug.AdvBias(config_dict=CONFIGS["bias"])
            p = r.uniform(spec.low, spec.high, spec.cp_grid)
        elif name in ("affine", "wide_affine"):
            p = r.uniform(-1, 1, (N, 5))
        else:
            p = r.uniform(-1, 1, (N, 2, 2, 2))
        if name in ("noise", "morph"):
            p = p / np.linalg.norm(p.reshape(N, -1), axis=1).reshape(
                (N,) + (1,) * (p.ndim - 1))
        out.append(p.astype(np.float32))
    return out


def _solver(pkg, names, padding="zeros", params=None, mse_only=False):
    chain = []
    for i, n in enumerate(names):
        extra = {"image_padding_mode": padding} \
            if CLASSES[n] in ("AdvAffine", "AdvMorph") else {}
        if pkg is taug:
            extra["device"] = "cpu"
        chain.append(getattr(pkg, CLASSES[n])(config_dict=dict(CONFIGS[n]),
                                               seed=100 + i, **extra))
    kinds = (["mse"], [1.0]) if mse_only else (["mse", "contour"],
                                               [1.0, 0.5])
    solver = pkg.ComposeAdversarialTransformSolver(
        chain_of_transforms=chain, divergence_types=kinds[0],
        divergence_weights=kinds[1])
    if params is not None:
        _inject(solver, pkg, params)
    return solver


def _inject(solver, pkg, params):
    solver.set_transformation(
        [torch.from_numpy(p) if pkg is taug else jnp.asarray(p)
         for p in params])
    for t in solver.chain_of_transforms:
        t.is_training = False


def _to(pkg, x):
    return torch.from_numpy(x) if pkg is taug else jnp.asarray(x)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ------------------------------------------------------ the volume score
@pytest.mark.parametrize("padding", ["zeros", "lowest"])
@pytest.mark.parametrize("names", [MORPH_FREE, FULL], ids=["morph_free",
                                                           "full"])
def test_misoverlap_matches_jax(names, padding):
    """Equal up to k / numel, k the pixels whose roundtrip lies within
    1e-5 of the 0.5 threshold (either side may binarise them apart).  The
    square's corners leave the frame under the rotations, so the roundtrip
    loses part of it."""
    params = _params(names, seed=3)
    ours = _solver(taug, names, padding, params)
    ref = _solver(jaug, names, padding, params)
    mask = _square(2, 30)
    got = float(ours.compute_anatomy_misoverlapping_loss(_to(taug, mask)))
    want = float(ref.compute_anatomy_misoverlapping_loss(_to(jaug, mask)))
    rec = np.asarray(ref.predict_backward(ref.predict_forward(
        jnp.asarray(mask))))
    k = int((np.abs(rec - 0.5) <= 1e-5).sum())
    assert abs(got - want) <= k / mask.size + 1e-7, (got, want, k)
    assert want > 0  # the roundtrip loses some of the mask


def test_misoverlap_draws_missing_parameters():
    """A transform with no parameters is drawn by the stateful roundtrip,
    on the mask's device; the score then equals the one of the drawn
    chain."""
    solver = _solver(taug, MORPH_FREE)
    mask = _to(taug, _ellipse())
    first = float(solver.compute_anatomy_misoverlapping_loss(mask))
    assert all(t.param is not None and t.param.device == mask.device
               for t in solver.chain_of_transforms)
    assert float(solver.compute_anatomy_misoverlapping_loss(mask)) == first


def test_misoverlap_precomputes_only_geometric(monkeypatch):
    """The volume score's roundtrip touches the geometric transforms
    alone, so the noise and the bias field are not computed for it."""
    solver = _solver(taug, FULL, params=_params(FULL, seed=3))
    calls = []
    for t in solver.chain_of_transforms:
        real = t.precompute

        def counted(*a, t=t, real=real, **kw):
            calls.append(t.get_name())
            return real(*a, **kw)
        monkeypatch.setattr(t, "precompute", counted)
    score = solver.compute_anatomy_misoverlapping_loss(
        _to(taug, _square(2, 30)))
    assert torch.isfinite(score) and sorted(calls) == ["affine", "morph"]


# ------------------------------------------------ the penalised PGD step
def _pgd(pkg, net, padding, weight, use_anatomy=True):
    params = _params(MORPH_FREE, seed=5)
    solver = _solver(pkg, MORPH_FREE, padding, params)
    img, mask = _image(), _square(2, 30)
    flags, steps = (True,) * len(MORPH_FREE), (1.0,) * len(MORPH_FREE)
    init = net(_to(pkg, img))
    if pkg is taug:
        new, dist = solver.pgd_step(
            net, tuple(_to(taug, p) for p in params), _to(taug, img), init,
            flags, steps, _to(taug, mask) if use_anatomy else None, weight)
    else:
        step = jax.jit(solver.build_pgd_step_fn(
            net, flags, steps, use_anatomy=use_anatomy,
            anatomy_reg_weight=weight))
        new, dist = step(tuple(_to(jaug, p) for p in params),
                         _to(jaug, img), init, _to(jaug, mask))
    return [_np(p) for p in new], float(dist)


@pytest.mark.parametrize("padding,offset", [("zeros", 0.0), ("lowest", 0.0),
                                            ("lowest", 10.0)],
                         ids=["zeros", "lowest", "lowest_positive_logits"])
def test_penalised_pgd_step(padding, offset):
    """One step of build_pgd_step_fn(..., use_anatomy=True) on a mask
    whose roundtrip loses pixels: the updated parameters match JAX's
    within 1e-4 relative; they equal the same step's with weight 0 (the
    binarised penalty has zero gradient), whose divergence is lower by
    the penalty.  The step without the anatomy channel matches JAX's too;
    with zeros padding (each channel padded alike) it moves the
    parameters as the penalised one does, while with "lowest" and
    positive logits its divergence differs: the anatomy channel lowers the
    pad value of the one warp it shares with the prediction.  The
    closed-form network: under this chain the UNet's ReLU and max-pool
    switches flip on rounding-level differences of its input and move the
    step by ~1e-3 (the e2e bar); the constrained solve below runs the
    UNet."""
    def net(x):
        return _small_net(x) + offset
    ours, d_ours = _pgd(taug, net, padding, 50.0)
    ref, d_ref = _pgd(jaug, net, padding, 50.0)
    for name, a, b in zip(MORPH_FREE, ours, ref):
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < 1e-4, (name, rel)
    np.testing.assert_allclose(d_ours, d_ref, rtol=1e-5)
    zero, d_zero = _pgd(taug, net, padding, 0.0)
    _, d_zero_ref = _pgd(jaug, net, padding, 0.0)
    for a, b in zip(ours, zero):
        np.testing.assert_array_equal(a, b)
    penalty = d_ours - d_zero
    assert penalty > 0
    np.testing.assert_allclose(penalty, d_ref - d_zero_ref, rtol=1e-4)
    plain, d_plain = _pgd(taug, net, padding, 50.0, use_anatomy=False)
    _, d_plain_ref = _pgd(jaug, net, padding, 50.0, use_anatomy=False)
    np.testing.assert_allclose(d_plain, d_plain_ref, rtol=1e-5)
    if padding == "zeros":
        np.testing.assert_allclose(d_plain, d_zero, rtol=1e-6)
        for a, b in zip(ours, plain):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    elif offset > 0:
        assert abs(d_plain - d_zero) > 1e-3 * d_plain, (d_plain, d_zero)


# ------------------------------------------------------- the retry ladder
class _Recorder:
    """Scripted volume scores and the counts of one episode: PGD steps,
    chain inits, the geometric transform's stateful redraws."""

    def __init__(self, pkg, solver, script):
        self.steps = 0
        self.inits = 0
        self.redraws = 0
        self.script = list(script)
        self.calls = 0

        def score(mask):
            self.calls += 1
            return self.script.pop(0)
        solver.compute_anatomy_misoverlapping_loss = score
        init = type(solver).init_random_transformation

        def init_random(*a, **kw):
            self.inits += 1
            return init(solver, *a, **kw)
        solver.init_random_transformation = init_random
        geo = solver.chain_of_transforms[-1]
        redraw = type(geo).init_parameters

        def init_parameters(*a, **kw):
            self.redraws += 1
            return redraw(geo, *a, **kw)
        geo.init_parameters = init_parameters
        if pkg is taug:
            step = type(solver).pgd_step

            def pgd_step(*a, **kw):
                self.steps += 1
                return step(solver, *a, **kw)
            solver.pgd_step = pgd_step
        else:
            multi = type(solver)._get_pgd_multi

            def get_multi(*a, **kw):
                self.steps += a[-1]  # n_steps
                return multi(solver, *a, **kw)
            solver._get_pgd_multi = get_multi


def _warnings(caplog, logger):
    return [r.getMessage() for r in caplog.records if r.name == logger]


@pytest.fixture(scope="module")
def ladder_solvers():
    names = ("noise", "affine")
    return {pkg: _solver(pkg, names, mse_only=True) for pkg in (taug, jaug)}


LADDER = {
    # (n_iter, scripted scores: the init's then the decisions')
    "pass": (1, [P, P]),
    "fail_pass": (1, [P, F, P]),
    "fail_fail_pass": (1, [P, F, F, P]),
    "exhausted": (1, [P, F, F, F]),
    "init_retry": (1, [F, P, P]),
    "init_exhausted": (1, [F] * 11 + [P]),
    "n_iter2_reinit": (2, [P, F, F, F, P]),
}
# JAX's outcomes at n_iter=1: (PGD steps, chain inits, redraws, warnings)
EXPECTED = {
    "pass": (1, 1, 0, []),
    "fail_pass": (2, 1, 0, ["one more"]),
    "fail_fail_pass": (3, 2, 0, ["one more", "new initialization"]),
    "exhausted": (3, 3, 0, ["one more", "new initialization", "3X"]),
    "init_retry": (1, 1, 1, []),
    "init_exhausted": (1, 1, 11, ["random initialization"]),
}


@pytest.mark.parametrize("case", list(LADDER))
def test_ladder_branches(ladder_solvers, caplog, case):
    """lazy_load=True: the reference's stateful init, then the ladder.
    Both packages take the same PGD steps, inits and stateful redraws and
    log the same warnings in the same order; the scores are scripted (the
    ladder's fresh inits take the fused order, whose real scores pass
    LADDER_TOL)."""
    n_iter, script = LADDER[case]
    img, mask = _image(), _square(8, 24)
    params = _params(("noise", "affine"), seed=9)
    seen = {}
    for pkg, logger in zip((jaug, taug), LOGGERS):
        solver = ladder_solvers[pkg]
        _inject(solver, pkg, params)
        rec = _Recorder(pkg, solver, script)
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            dist = solver.adversarial_training(
                _to(pkg, img), _small_net, n_iter=n_iter, lazy_load=True,
                anatomy_mask_images=_to(pkg, mask),
                volume_preserve_tolerance=LADDER_TOL)
        assert np.isfinite(float(dist)) and not rec.script
        seen[pkg] = (rec.steps, rec.inits, rec.redraws,
                     _warnings(caplog, logger), rec.calls)
    assert seen[taug] == seen[jaug], seen
    if case in EXPECTED:
        steps, inits, redraws, warns = EXPECTED[case]
        assert seen[taug][:3] == (steps, inits, redraws)
        assert len(seen[taug][3]) == len(warns) and all(
            w in m for w, m in zip(warns, seen[taug][3])), seen[taug][3]


# --------------------------------------------- the fused first attempt
def _fused(pkg, tol, n_iter, caplog, logger):
    solver = _solver(pkg, ("wide_affine",), mse_only=True)
    rec = _Recorder(pkg, solver, [])
    del solver.compute_anatomy_misoverlapping_loss  # the real score
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        dist = solver.adversarial_training(
            _to(pkg, _image()), _small_net, n_iter=n_iter,
            anatomy_mask_images=_to(pkg, _square(4, 28)),
            anatomy_reg_weight=50, volume_preserve_tolerance=tol)
    return float(dist), rec.steps, _warnings(caplog, logger)


@pytest.mark.parametrize("tol", [1e-9, 1.0])
def test_fused_first_attempt(caplog, tol):
    """lazy_load=False end to end (tests/test_solver.py:193-262 for JAX):
    at 1e-9 no init passes and the ladder falls back to a random init
    after 3 x n_iter steps, with JAX's warnings in JAX's order; at 1.0 the
    first attempt's n_iter steps are all."""
    n_iter = 1 if tol < 1 else 2
    d_ref, multi_steps, w_ref = _fused(jaug, tol, n_iter, caplog,
                                       LOGGERS[0])
    d_ours, steps, w_ours = _fused(taug, tol, n_iter, caplog, LOGGERS[1])
    assert np.isfinite(d_ours) and np.isfinite(d_ref)
    assert w_ours == w_ref, (w_ours, w_ref)
    # JAX runs the first attempt's steps inside its episode program
    assert steps == n_iter + multi_steps
    if tol < 1:
        assert steps == 3 * n_iter
        starts = ["random initialization", "volume not preserved",
                  "random initialization", "volume not preserved",
                  "optimization time is 3X longer", "random initialization"]
        assert len(w_ours) == len(starts) and all(
            m.startswith(w) for w, m in zip(starts, w_ours)), w_ours
    else:
        assert steps == n_iter and not w_ours


# ------------------------------------------------ one constrained solve
def test_constrained_solve_with_injected_params(models):
    """lazy_load=True from the same parameters, a morph-free chain on
    "lowest" padding, n_iter=1, a tolerance the first decision meets:
    the divergence and the parameters as tests/test_torch_e2e.py holds a
    morph-free episode (1e-3 relative)."""
    jmodel, tmodel = models
    params = _params(MORPH_FREE, seed=11)
    out = {}
    for pkg, model in ((jaug, jmodel), (taug, tmodel)):
        solver = _solver(pkg, MORPH_FREE, "lowest", params)
        dist = solver.adversarial_training(
            _to(pkg, _image()), model, n_iter=1, lazy_load=True,
            anatomy_mask_images=_to(pkg, _ellipse()),
            anatomy_reg_weight=50, volume_preserve_tolerance=1.0,
            step_sizes=1.0)
        out[pkg] = (float(dist), [_np(t.param)
                                  for t in solver.chain_of_transforms])
    (d_ref, p_ref), (d_ours, p_ours) = out[jaug], out[taug]
    assert abs(d_ours - d_ref) / abs(d_ref) < 1e-3, (d_ours, d_ref)
    for name, a, b in zip(MORPH_FREE, p_ours, p_ref):
        rel = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)
        assert rel < 1e-3, (name, rel)
