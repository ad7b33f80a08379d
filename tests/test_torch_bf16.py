"""The wrapper's bf16 compute mode against the JAX package's and against
the port's f32, on the Flax UNet_16's random weights carried across (batch
2, 64x64).

JAX's own quality bounds (tests/test_models.py::test_bf16_*, set on the
reference's trained checkpoint): logits within 5% of the f32 logits'
scale with argmax agreement above 0.99 (``predict``); an episode with
``n_iter=0`` leaves ``adv_data`` exactly f32's and dist within 2%; with
``n_iter=1`` dist within 10% and every transform's parameters at cosine
above 0.95.  On random weights JAX's own bf16 mode meets them with the
running statistics and misses them with batch statistics (logits ~13% of
scale apart, cosines 0.35-0.83 after one PGD step at this size: a random
network's batch-statistics BN in bf16 at 4x4x2 samples a channel), so the
bounds are held with the running statistics and, with batch statistics,
the port's bf16 error is held to JAX's own on the same weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advchain_tpu import augmentor as jaug
from advchain_tpu import models as jm

from advchain_tpu_torch import augmentor as taug
from advchain_tpu_torch import models as tm

from test_torch_model_zoo import _carry, _flax, _np_tree

N, H, W = 2, 64, 64
SIZE = [N, 1, H, W]
CONFIGS = {
    "noise": {"epsilon": 1.0, "xi": 1e-6, "data_size": SIZE},
    "bias": {"epsilon": 0.3, "control_point_spacing": [32, 32],
             "downscale": 2, "data_size": SIZE, "interpolation_order": 3,
             "init_mode": "random", "space": "log"},
    "affine": {"rot": 30.0 / 180.0, "scale_x": 0.2, "scale_y": 0.2,
               "shift_x": 0.1, "shift_y": 0.1, "data_size": SIZE},
    "morph": {"epsilon": 1.5, "data_size": SIZE,
              "vector_size": [H // 16, W // 16]},
}
CLASSES = {"noise": "AdvNoise", "bias": "AdvBias", "affine": "AdvAffine",
           "morph": "AdvMorph"}
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def models():
    """(JAX f32, JAX bf16, port f32, port bf16) on one set of weights."""
    j32 = _flax(jm.UNet(1, 4, 4), tuple(SIZE))
    j16 = jm.SegmentationModel(j32.module, j32.params, j32.batch_stats,
                               compute_dtype=jnp.bfloat16)
    return (j32, j16, _carry(j32, tm.UNet(1, 4, 4)),
            _carry(j32, tm.UNet(1, 4, 4), BF16))


def _image(seed=0):
    r = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                         indexing="ij")
    img = (np.exp(-((yy / 0.5) ** 2 + (xx / 0.4) ** 2))
           + 0.3 * np.exp(-(((yy + 0.4) / 0.25) ** 2
                            + ((xx - 0.3) / 0.2) ** 2)))
    return (img[None, None] + 0.05 * r.rand(N, 1, H, W)).astype(np.float32)


def _gap(ours, ref):
    """(max |ours - ref| over max |ref|, argmax agreement)."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    return (float(np.abs(ours - ref).max() / np.abs(ref).max()),
            float((ours.argmax(1) == ref.argmax(1)).mean()))


def test_bf16_predict_within_jax_bound(models):
    """``predict`` in bf16: f32 logits within JAX's bound of the port's and
    of JAX's f32 logits and of JAX's bf16 logits, with an error no larger
    than 1.25 times JAX's own bf16 error."""
    j32, j16, t32, t16 = models
    x = _image()
    with torch.no_grad():
        ours = t16.predict(torch.from_numpy(x))
        f32 = t32.predict(torch.from_numpy(x)).numpy()
    assert ours.dtype == torch.float32
    ref32 = np.asarray(j32.predict(jnp.asarray(x)))
    ref16 = np.asarray(j16.predict(jnp.asarray(x)))
    for against in (f32, ref32, ref16):
        scale, agree = _gap(ours.numpy(), against)
        assert scale < 0.05 and agree > 0.99, (scale, agree)
    theirs = _gap(ref16, ref32)
    assert _gap(ours.numpy(), f32)[0] <= 1.25 * theirs[0], theirs


def test_bf16_batch_statistics_error_no_worse_than_jax(models):
    """The solver's default mode: the port's bf16 error against its f32 at
    most 1.25 times JAX's bf16 error against JAX's f32, and its argmax
    agreement within 0.01 of JAX's."""
    j32, j16, t32, t16 = models
    x = _image()
    rng = jax.random.PRNGKey(0)
    ref32, ref16 = (np.asarray(m.apply_fixed(jnp.asarray(x), rng, train=True))
                    for m in (j32, j16))
    with torch.no_grad():
        f32, ours = (m.apply_fixed(torch.from_numpy(x), train=True)
                     for m in (t32, t16))
    assert ours.dtype == torch.float32
    mine, theirs = _gap(ours.numpy(), f32.numpy()), _gap(ref16, ref32)
    assert mine[0] <= 1.25 * theirs[0] and mine[1] >= theirs[1] - 0.01, \
        (mine, theirs)


def test_bf16_gradient_reaches_the_f32_parameters(models):
    _, _, t32, t16 = models
    x = torch.from_numpy(_image())
    grads = []
    for model in (t32, t16):
        model.module.zero_grad(set_to_none=True)
        model.predict(x).square().mean().backward()
        grads.append(torch.cat([p.grad.reshape(-1)
                                for p in model.module.parameters()]))
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in t16.module.parameters())
    assert bool(torch.isfinite(grads[1]).all())
    assert float(torch.nn.functional.cosine_similarity(*grads, dim=0)) > 0.99


def test_bf16_apply_train_keeps_f32_statistics_near_jax(models):
    """One bf16 ``apply_train``: every parameter and buffer still f32, the
    running statistics moved and within 1e-2 of JAX's bf16 update."""
    j32, j16, _, _ = models
    t16 = _carry(j32, tm.UNet(1, 4, 4), BF16)
    x = _image(1)
    before = {k: v.clone() for k, v in t16.module.state_dict().items()}
    logits = t16.apply_train(torch.from_numpy(x))
    logits.square().mean().backward()
    assert logits.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in
               [*t16.module.parameters(), *t16.module.buffers()]
               if t.is_floating_point())
    state = t16.module.state_dict()
    stats = [k for k in state if "running" in k]
    assert len(stats) == 36
    for k in stats:
        assert not torch.equal(state[k], before[k]), k
    _, new_stats = j16.apply_train(j16.params, j16.batch_stats,
                                   jnp.asarray(x), jax.random.PRNGKey(0))
    want = tm.flax_unet_to_torch_state(_np_tree(j16.params),
                                       _np_tree(new_stats))
    worst = 0.0
    for k in stats:
        assert want[k].dtype == torch.float32
        np.testing.assert_allclose(state[k].numpy(), want[k].numpy(),
                                   atol=1e-2, rtol=0, err_msg=k)
        worst = max(worst, float((state[k] - want[k]).abs().max()))
    print(f"bf16 apply_train: running statistics within {worst:.3e} of "
          f"JAX's bf16 update")


def _params(seed=42):
    r = np.random.RandomState(seed)
    out = []
    for name in CONFIGS:
        if name == "noise":
            p = r.randn(*SIZE)
        elif name == "bias":
            spec = taug.AdvBias(config_dict=CONFIGS["bias"])
            p = r.uniform(spec.low, spec.high, spec.cp_grid)
        elif name == "affine":
            p = r.uniform(-1, 1, (N, 5))
        else:
            p = r.uniform(-1, 1, (N, 2, H // 16, W // 16))
        if name in ("noise", "morph"):
            p = p / np.linalg.norm(p.reshape(N, -1), axis=1).reshape(
                (N,) + (1,) * (p.ndim - 1))
        out.append(p.astype(np.float32))
    return out


def _episode(pkg, model, n_iter):
    chain = [getattr(pkg, CLASSES[n])(config_dict=dict(CONFIGS[n]))
             for n in CONFIGS]
    solver = pkg.ComposeAdversarialTransformSolver(
        chain_of_transforms=chain, divergence_types=["mse", "contour"],
        divergence_weights=[1.0, 0.5])
    to = torch.from_numpy if pkg is taug else jnp.asarray
    solver.set_transformation([to(p) for p in _params()])
    dist = solver.adversarial_training(data=to(_image()), model=model,
                                       n_iter=n_iter, lazy_load=True,
                                       step_sizes=1.0)
    arr = (lambda t: t.numpy()) if pkg is taug else np.asarray
    return (float(dist), arr(solver.adv_data),
            [arr(t.param) for t in chain])


def _cosines(a, b):
    return [float((p * q).sum() / (np.linalg.norm(p) * np.linalg.norm(q)))
            for p, q in zip(a, b)]


@pytest.mark.parametrize("n_iter", [0, 1])
def test_bf16_episode_within_jax_bound(models, n_iter, monkeypatch):
    """JAX's episode bounds with the running statistics (JAX's test's
    settings otherwise: no power iteration, step 1.0): the port's bf16
    against its f32 and against JAX's bf16 on the same injected
    parameters (JAX's compositions on its sampler)."""
    monkeypatch.setenv("ADVCHAIN_STENCIL", "0")
    j32, j16, t32, t16 = models
    for m in models:
        m.eval()
    try:
        ours = _episode(taug, t16, n_iter)
        f32 = _episode(taug, t32, n_iter)
        ref = _episode(jaug, j16, n_iter)
    finally:
        for m in models:
            m.train()
    bound = 0.02 if n_iter == 0 else 0.10
    for other in (f32, ref):
        assert abs(ours[0] - other[0]) < bound * abs(other[0]), \
            (ours[0], other[0])
    if n_iter == 0:
        np.testing.assert_array_equal(ours[1], f32[1])
        np.testing.assert_allclose(ours[1], ref[1], atol=1e-3, rtol=0)
    else:
        for other in (f32, ref):
            cos = _cosines(ours[2], other[2])
            assert min(cos) > 0.95, cos
