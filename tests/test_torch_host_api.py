"""The port's stateful host API against the JAX package's, on identical
numpy inputs: the solver's forward / backward / predict_forward /
predict_backward with the transforms' diffs and debug stashes, the
consistency loss of the frozen chain, compute_transform_grads followed by
optimize_parameters() with no argument, get_adv_data's pseudo labels, and
the helpers they use (rescale_intensity, renorm_l2, the mse and kl
consistencies).

The Flax UNet(1, 4, 4)'s weights are carried into the port (no dropout);
transform parameters are injected with set_transformation, since the
packages' random streams cannot match.  The JAX side runs with
ADVCHAIN_STENCIL=0 (its compositions on the sampler; eager morph warps on
its stencil dispatch take seconds each on the CPU), and the port with
JAX's base grid.  Tolerances: 1e-5
absolute on morph-free chains; with the morph, max 1e-4 and mean 1e-5,
the budget of exponentiate_flow's 8 squarings
(tests/test_torch_ops.py::test_exponentiate_flow_eight_squarings)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advchain_tpu import augmentor as jaug
from advchain_tpu.losses import consistency as jloss
from advchain_tpu.models import SegmentationModel as JaxModel
from advchain_tpu.models import UNet as FlaxUNet
from advchain_tpu.ops import integrate as jint
from advchain_tpu.ops import norms as jnorms

from advchain_tpu_torch import augmentor as taug
from advchain_tpu_torch.augmentor import morph as tmorph
from advchain_tpu_torch.losses import consistency as tloss
from advchain_tpu_torch.models import (SegmentationModel, UNet,
                                       flax_unet_to_torch_state)
from advchain_tpu_torch.ops import integrate as tint
from advchain_tpu_torch.ops import norms as tnorms

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
MORPH_FREE = ("noise", "bias", "affine")
FULL = ("noise", "bias", "affine", "morph")
CHAINS = {"morph_free": MORPH_FREE, "full": FULL}
PADDINGS = ["zeros", "border", "reflection", "lowest", 0.25]


@pytest.fixture(autouse=True)
def _jax_dispatch_and_grid(monkeypatch):
    """JAX's compositions on the sampler, and JAX's base grid in the port
    (tests/test_torch_stencil.py::jax_base_grid): ``jnp.linspace`` differs
    from the port's correctly rounded one in ulps (ROADMAP queue 3), which
    the morph's 8 squarings amplify past the 1e-4 bar on its warps."""
    monkeypatch.setenv("ADVCHAIN_STENCIL", "0")

    def grid(batch_size, spatial_shape, dtype=torch.float32, device=None):
        g = np.array(jint.base_grid(batch_size, spatial_shape))
        return torch.from_numpy(g).to(dtype=dtype, device=device)
    monkeypatch.setattr(tint, "base_grid", grid)
    monkeypatch.setattr(tmorph, "base_grid", grid)


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


def _image(seed=0, c=1):
    r = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                         indexing="ij")
    img = (np.exp(-((yy / 0.5) ** 2 + (xx / 0.4) ** 2))
           + 0.3 * np.exp(-(((yy + 0.4) / 0.25) ** 2
                            + ((xx - 0.3) / 0.2) ** 2)))
    return (img[None, None] + 0.05 * r.rand(N, c, H, W)).astype(np.float32)


def _prediction(seed=1):
    """Four smooth unit-scale channels whose minima differ: "lowest" takes
    the minimum over all channels of the tensor warped in one call.  The
    two packages' sampling coordinates differ by f32 rounding (~4e-6 px
    for the affine, up to ~1e-3 px after the morph's 8 squarings), so a
    warp's error is that times the tensor's slope: the bars below hold for
    image-like tensors; the random network's logits (slopes of up to ~4
    per pixel) have their own bar."""
    r = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                         indexing="ij")
    chans = []
    for k, off in enumerate((-0.5, -0.25, 0.0, 0.25)):
        cy, cx = r.uniform(-0.4, 0.4, 2)
        chans.append(off + 0.75 * np.exp(-(((yy - cy) / 0.45) ** 2
                                           + ((xx - cx) / 0.35) ** 2)))
    pred = np.stack(chans)[None]
    return (pred + 0.05 * r.rand(N, 4, H, W)).astype(np.float32)


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
            p = r.uniform(-1, 1, (N, 2, 2, 2))
        if name in ("noise", "morph"):
            p = p / np.linalg.norm(p.reshape(N, -1), axis=1).reshape(
                (N,) + (1,) * (p.ndim - 1))
        out.append(p.astype(np.float32))
    return out


def _solver(pkg, names, padding="zeros", params=None, **kw):
    chain = []
    for n in names:
        extra = {"image_padding_mode": padding} \
            if n in ("affine", "morph") else {}
        if pkg is taug:
            extra["device"] = "cpu"
        chain.append(getattr(pkg, CLASSES[n])(config_dict=dict(CONFIGS[n]),
                                               **extra))
    solver = pkg.ComposeAdversarialTransformSolver(
        chain_of_transforms=chain, divergence_types=["mse", "contour"],
        divergence_weights=[1.0, 0.5], **kw)
    if params is not None:
        solver.set_transformation(
            [torch.from_numpy(p) if pkg is taug else jnp.asarray(p)
             for p in params])
    return solver


def _pair(names, padding="zeros", seed=42, **kw):
    params = _params(names, seed)
    return (_solver(taug, names, padding, params, **kw),
            _solver(jaug, names, padding, params, **kw))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(ours, ref, morph: bool, label=""):
    d = np.abs(_np(ours) - _np(ref))
    if morph:
        assert d.max() <= 1e-4 and d.mean() <= 1e-5, \
            (label, d.max(), d.mean())
    else:
        assert d.max() <= 1e-5, (label, d.max())


def _close_logits(ours, ref, morph: bool, label=""):
    """The network's logits and their warps: the carried UNet's own bar
    (1e-4, tests/test_torch_models.py) on morph-free chains; after the
    morph, the sparse criterion of tests/test_torch_transforms.py."""
    d = np.abs(_np(ours) - _np(ref))
    if morph:
        assert d.mean() < 1e-4 and (d > 1e-3).mean() < 0.01, \
            (label, d.mean(), (d > 1e-3).mean())
    else:
        assert d.max() <= 1e-4, (label, d.max())


# ------------------------------------------------------------ the helpers
@pytest.mark.parametrize("per_channel", [True, False])
def test_rescale_intensity(per_channel):
    x = np.random.RandomState(3).randn(3, 2, 7, 5).astype(np.float32)
    _close(tnorms.rescale_intensity(torch.from_numpy(x), -1.0, 2.0,
                                    per_channel=per_channel),
           jnorms.rescale_intensity(jnp.asarray(x), -1.0, 2.0,
                                    per_channel=per_channel), False)
    if not per_channel:
        solver = _solver(taug, ())
        _close(solver.rescale_intensity(torch.from_numpy(x)),
               _solver(jaug, ()).rescale_intensity(jnp.asarray(x)), False)


def test_renorm_l2():
    x = np.random.RandomState(4).randn(4, 3, 6).astype(np.float32)
    x[1] *= 1e-3  # a row inside the ball stays as it is
    ours = tnorms.renorm_l2(torch.from_numpy(x), 1.5)
    _close(ours, jnorms.renorm_l2(jnp.asarray(x), 1.5), False)
    torch.testing.assert_close(ours, torch.from_numpy(x).renorm(2, 0, 1.5))


@pytest.mark.parametrize("kind", ["mse", "kl"])
def test_segmentation_consistency_helpers(kind):
    a, b = _prediction(5), _prediction(6)
    ours = getattr(tloss, f"calc_segmentation_{kind}_consistency")(
        torch.from_numpy(a), torch.from_numpy(b))
    ref = getattr(jloss, f"calc_segmentation_{kind}_consistency")(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)


# ------------------------------------------------------ the stateful chain
@pytest.mark.parametrize("padding", PADDINGS)
@pytest.mark.parametrize("chain", ["morph_free", "full"])
def test_stateful_chain(chain, padding):
    """forward (with each transform's diff and the debug stashes),
    backward, predict_forward and predict_backward on a four-channel
    prediction whose channels have different minima."""
    names = CHAINS[chain]
    morph = "morph" in names
    ours, ref = _pair(names, padding)
    img, pred = _image(), _prediction()
    _close(ours.forward(torch.from_numpy(img)),
           ref.forward(jnp.asarray(img)), morph, "forward")
    for i, (a, b) in enumerate(zip(ours.diffs, ref.diffs)):
        _close(a, b, morph and names[i] == "morph", f"diff {names[i]}")
    t_ours = dict(zip(names, ours.chain_of_transforms))
    t_ref = dict(zip(names, ref.chain_of_transforms))
    _close(t_ours["bias"].bias_field, t_ref["bias"].bias_field, False)
    _close(t_ours["affine"].affine_matrix, t_ref["affine"].affine_matrix,
           False)
    if morph:
        _close(t_ours["morph"].displacement, t_ref["morph"].displacement,
               True)
    _close(ours.backward(torch.from_numpy(img)),
           ref.backward(jnp.asarray(img)), morph, "backward")
    fwd = ours.predict_forward(torch.from_numpy(pred))
    fwd_ref = ref.predict_forward(jnp.asarray(pred))
    _close(fwd, fwd_ref, morph, "predict_forward")
    _close(ours.predict_backward(fwd), ref.predict_backward(fwd_ref), morph,
           "predict_backward")


STASHES = ("bias_field", "affine_matrix", "displacement")


@pytest.mark.parametrize("debug", [False, True])
def test_stashes_only_in_stateful_api(models, debug):
    """The solver's episode records no debug stash (as JAX's jitted
    episode records none) unless a transform has ``debug``; the stateful
    forward records them all, detached."""
    _, tmodel = models
    solver = _solver(taug, FULL, params=_params(FULL))
    for t in solver.chain_of_transforms:
        t.debug = debug
    solver.adversarial_training(torch.from_numpy(_image()), tmodel,
                                n_iter=1, lazy_load=True)
    held = [hasattr(t, name) for t in solver.chain_of_transforms
            for name in STASHES]
    assert sum(held) == (3 if debug else 0), held
    fresh = _solver(taug, FULL, params=_params(FULL))
    fresh.forward(torch.from_numpy(_image()))
    for t, name in zip(fresh.chain_of_transforms[1:], STASHES):
        stash = getattr(t, name)
        assert torch.isfinite(stash).all() and not stash.requires_grad


@pytest.mark.parametrize("padding", ["border", "lowest"])
def test_per_call_padding(padding):
    """A per-call padding reaches the morph; the affine keeps its
    constructor's."""
    ours, ref = _pair(("affine", "morph"), "zeros")
    pred = _prediction(2)
    _close(ours.predict_forward(torch.from_numpy(pred), padding_mode=padding),
           ref.predict_forward(jnp.asarray(pred), padding_mode=padding),
           True)


def test_norm_image_clip():
    ours, ref = _pair(MORPH_FREE, if_norm_image=True, min_intensity=0.1,
                      max_intensity=0.9)
    img = _image()
    out = ours.forward(torch.from_numpy(img))
    _close(out, ref.forward(jnp.asarray(img)), False)
    assert float(out.min()) >= 0.1 and float(out.max()) <= 0.9


@pytest.mark.parametrize("padding", ["zeros", "lowest"])
@pytest.mark.parametrize("chain", ["morph_free", "full"])
def test_calc_adv_consistency_loss(models, chain, padding):
    jmodel, tmodel = models
    names = CHAINS[chain]
    ours, ref = _pair(names, padding)
    img = _image()
    init = np.array(jmodel(jnp.asarray(img)))
    got = ours.calc_adv_consistency_loss(torch.from_numpy(img), tmodel,
                                         torch.from_numpy(init))
    want = ref.calc_adv_consistency_loss(jnp.asarray(img), jmodel,
                                         jnp.asarray(init))
    morph = "morph" in names
    np.testing.assert_allclose(float(got[0].detach()), float(want[0]),
                               rtol=1e-3 if morph else 1e-4)
    _close(got[1], want[1], morph, "adv_data")
    if not morph:  # the network amplifies the morph's budget ~30-fold
        _close_logits(got[2], want[2], morph, "adv_output")
        _close_logits(got[3], want[3], morph, "warped")


# ------------------------------------------------- the manual-loop recipe
def test_compute_transform_grads_then_optimize(models):
    """Grads within 1e-4 of their largest entry on a morph-free chain;
    then optimize_parameters() with no argument, rescale_parameters() and
    eval() (README's manual loop), and the divergence ascends."""
    jmodel, tmodel = models
    ours, ref = _pair(MORPH_FREE)
    img = _image()
    init = np.array(jmodel(jnp.asarray(img)))
    d_ours, g_ours = ours.compute_transform_grads(
        torch.from_numpy(img), tmodel, init_output=torch.from_numpy(init))
    d_ref, g_ref = ref.compute_transform_grads(
        jnp.asarray(img), jmodel, init_output=jnp.asarray(init))
    np.testing.assert_allclose(float(d_ours), float(d_ref), rtol=1e-5)
    for name, a, b in zip(MORPH_FREE, g_ours, g_ref):
        scale = float(np.abs(np.asarray(b)).max())
        err = float(np.abs(_np(a) - np.asarray(b)).max())
        assert err <= 1e-4 * scale, (name, err, scale)
    for t in ours.chain_of_transforms:
        assert t.grad is not None and t.is_training
        t.optimize_parameters()
        t.rescale_parameters()
        t.eval()
    d_after, _ = ours.compute_transform_grads(
        torch.from_numpy(img), tmodel, init_output=torch.from_numpy(init))
    assert float(d_after) > float(d_ours), (float(d_ours), float(d_after))


def test_optimize_parameters_needs_a_gradient():
    t = taug.AdvNoise(config_dict=dict(CONFIGS["noise"]), device="cpu")
    t.init_parameters()
    with pytest.raises(ValueError):
        t.optimize_parameters(step_size=1.0)
    g = torch.ones(SIZE)
    t.set_step_size(0.5)
    assert t.get_step_size() == 0.5
    old = t.param
    new = t.optimize_parameters(grad=g)
    torch.testing.assert_close(new, t.update(old, g, 0.5))


# ------------------------------------------------------------ get_adv_data
def _inject_init(solver, params, pkg):
    """Replace each transform's random draw with the given parameters."""
    for t, p in zip(solver.chain_of_transforms, params):
        if pkg is taug:
            t.init_params = lambda gen, device=None, p=p: \
                torch.from_numpy(p).to(device)
        else:
            t.init_params = lambda key, p=p: jnp.asarray(p)


@pytest.mark.parametrize("chain", ["morph_free", "full"])
def test_get_adv_data_pseudo_labels(models, chain):
    """n_iter=0: the fresh chain is the given parameters; the augmented
    image and the pseudo label (the reference prediction through the
    geometric transforms) match JAX's, from the same reference
    prediction."""
    jmodel, tmodel = models
    names = CHAINS[chain]
    params = _params(names, seed=7)
    ours, ref = _solver(taug, names), _solver(jaug, names)
    _inject_init(ours, params, taug)
    _inject_init(ref, params, jaug)
    img = _image(3)
    init = np.array(jmodel(jnp.asarray(img)))
    a_ours, l_ours = ours.get_adv_data(torch.from_numpy(img), tmodel,
                                       init_output=torch.from_numpy(init))
    a_ref, l_ref = ref.get_adv_data(jnp.asarray(img), jmodel,
                                    init_output=jnp.asarray(init))
    morph = "morph" in names
    _close(a_ours, a_ref, morph, "augmented data")
    _close_logits(l_ours, l_ref, morph, "pseudo label")
    for t, p in zip(ours.chain_of_transforms, params):
        np.testing.assert_array_equal(_np(t.param), p)


# --------------------------------------------- random init and the modes
def test_init_random_transformation_lazy_and_reset():
    params = _params(FULL)
    solver = _solver(taug, FULL)
    chain = solver.chain_of_transforms
    chain[2].set_parameters(torch.from_numpy(params[2]))
    solver.init_random_transformation(lazy_load=True)
    assert torch.equal(chain[2].param, torch.from_numpy(params[2]))
    assert all(t.param is not None and t.param.device.type == "cpu"
               for t in chain)
    drawn = [t.param.clone() for t in chain]
    solver.init_random_transformation(lazy_load=True)
    assert all(torch.equal(a, t.param) for a, t in zip(drawn, chain))
    solver.reset_transformation()
    assert not any(torch.equal(a, t.param) for a, t in zip(drawn, chain))
    for t in chain:
        assert tuple(t.param.shape) == tuple(t.init_params(
            torch.Generator(), "cpu").shape)


def test_train_eval_and_learnable_flags():
    solver = _solver(taug, FULL, params=_params(FULL))
    solver._apply_power_iteration_setting("smart")
    noise = solver.chain_of_transforms[0]
    noise.set_parameters(3.0 * noise.param)
    solver.make_learnable_transformation([True, False, False, False])
    assert [t.is_training for t in solver.chain_of_transforms] == \
        [True, False, False, False]
    # power iteration renormalises on entering training
    norms = noise.param.reshape(N, -1).norm(dim=1)
    torch.testing.assert_close(norms, torch.ones(N))
    solver.train()
    assert all(t.is_training for t in solver.chain_of_transforms)
    solver.eval()
    assert not any(t.is_training for t in solver.chain_of_transforms)


# ---------------------------------------- the README's loop at step 1.0
@pytest.mark.parametrize("chain", ["morph_free", "full"])
def test_readme_manual_loop_at_step_one_like_jax(chain):
    """chip_smoke.py's phase 19 on both packages: the port's seeded UNet_16
    (carried into JAX by JAX's own ``torch_unet_state_to_flax``), config
    #3's chain ("lowest" padding) at 64x64, the same injected parameters,
    then the README's loop (``compute_transform_grads``, then
    ``optimize_parameters()``, ``rescale_parameters()`` and ``eval()`` on
    every transform at the default step 1.0).  The divergence before the
    step agrees to 1e-4 relative; after it, it moves the same way in both
    packages (both descend here: a step of 1.0 is not first order) and
    agrees to 1e-3 without the morph and to 3e-2 with it (measured 5e-4
    and 1.8e-2: the morph's squarings amplify f32 rounding, ROADMAP
    queue 3)."""
    import chip_smoke as cs
    from advchain_tpu.models.convert import torch_unet_state_to_flax
    names = CHAINS[chain]
    batch, shape = 2, (64, 64)
    tmodel = cs.build_model("cpu")
    jmodel = JaxModel(FlaxUNet(1, 4, 4), *torch_unet_state_to_flax(
        tmodel.module.state_dict()))
    img = cs.make_image(batch, shape)
    gen = torch.Generator().manual_seed(7)
    params = [t.init_params(gen) for t in cs.build_constrained_solver(
        batch, shape, names, device="cpu").chain_of_transforms]
    cfg = cs.chain_configs(batch, shape)
    seen = {}
    for pkg, model in ((jaug, jmodel), (taug, tmodel)):
        to = torch.from_numpy if pkg is taug else jnp.asarray
        if pkg is taug:
            solver = cs.build_constrained_solver(batch, shape, names,
                                                 device="cpu")
        else:
            solver = jaug.ComposeAdversarialTransformSolver(
                chain_of_transforms=[getattr(jaug, CLASSES[n])(
                    config_dict=cfg[n], **({"image_padding_mode": "lowest"}
                                           if n in ("affine", "morph")
                                           else {})) for n in names],
                divergence_types=["mse", "contour"],
                divergence_weights=[1.0, 0.5])
        solver.set_transformation([to(p.numpy()) for p in params])
        init = solver.get_init_output(model, to(img))
        before, _ = solver.compute_transform_grads(to(img), model, init)
        for t in solver.chain_of_transforms:
            t.optimize_parameters()
            t.rescale_parameters()
            t.eval()
        after, _ = solver.compute_transform_grads(to(img), model, init)
        seen[pkg.__name__] = (float(before), float(after))
    print(f"manual loop at step 1.0, {chain}: {seen}")
    (b_j, a_j), (b_t, a_t) = seen.values()
    assert abs(b_t - b_j) <= 1e-4 * b_j, seen
    assert abs(a_t - a_j) <= (3e-2 if chain == "full" else 1e-3) * a_j, seen
    assert (a_t - b_t) * (a_j - b_j) > 0, seen
