"""The port's training steps (``advchain_tpu_torch.parallel``) and
supervised cross-entropy against the JAX package's
(``advchain_tpu/parallel/train.py``, ``losses.cross_entropy``) on identical
numpy inputs: batch 2 at 32x32, UNet ``feature_scale=16`` (as
tests/test_parallel.py), the Flax weights carried across, Adam.

The JAX step draws its transform initialisations from
``fold_in(rng, step)``; the frameworks' random streams cannot match, so the
test recomputes those draws with the JAX transforms' ``init_params`` and
hands them to the port's step by monkeypatching the port transforms'
``init_params``.

Tolerances, each with its reason:
  * cross-entropy: 1e-5 relative.
  * ``apply_train`` logits 1e-4 absolute and running statistics 1e-5
    relative (f32 convolutions and batch moments).
  * supervised step: loss 1e-5 relative at step 1; at step 2 the weights
    already differ (below), so 1e-4.  Running statistics after step 1 to
    1e-5 relative.
  * Weights after the first Adam step: Adam moves each weight by about
    ``lr * sign(g)``, so a weight whose gradient is near 0 can move the
    other way in the other framework: max abs error 2 lr (plus f32 eps),
    and the update's relative L2 error (the share of such weights) below
    0.1 on the supervised and morph-free steps.
  * Adversarial step, first step (identical weights and draws): the
    supervised loss to 1e-5 relative; the consistency loss to 1e-4 on the
    morph-free chain (measured 4.9e-6) and to 0.12 on the full chain, the
    morph DIVERGENCE bound of tests/test_torch_e2e.py (measured 1.6e-2:
    the PGD step's noise direction amplifies the ~2e-5 difference of the
    two packages' scaling-and-squaring fields, ROADMAP queue 3); the total
    loss to the larger of 1e-4 and a tenth of that (measured 1e-7 and
    7.8e-4).
  * Second step: the weights already differ by the first Adam step's
    flips (update relative L2 5.6e-2 morph-free, 0.74 with morph), and the
    PGD noise direction is sensitive to them: supervised and total losses
    to 1e-2 relative (measured <= 1.3e-3 and 2.4e-3), consistency to 0.12
    (measured 3.7e-2 and 3.3e-2).

The data-parallel steps (``mesh=``) run on 2 and 4 spawned CPU ranks over
gloo (``test_torch_mesh.run_ranks``), batch 8 at 32x32 split by rows,
against the port's single-process step on the whole batch, at the JAX
package's own bounds (tests/test_parallel.py:136-144, SGD 1e-2):
``total_loss`` rtol 1e-4, ``consistency_loss`` rtol 1e-3, weights and
running statistics rtol 1e-4 / atol 1e-5; every rank's weights equal. The
gradients the step applied are held too: each leaf within 1e-4 of its own
largest entry plus 1e-5 of the largest entry of any leaf. The chains: the
JAX test's noise + affine with mse; noise + bias + affine with mse +
contour and the intensity clamp; the full chain with mse; dropout 0.1 (each
rank keeps its rows of the global batch's mask, so the step equals the
single-process one); the JAX test's chain on a ('data', 'space') mesh whose
space is 1, and on one whose space is 2 (each rank a slab of the rows); the 3D volume episode's chain (mse) on PseudoConv3dModel at 4 x
1 x 8 x 16 x 16, whose adaptive step count and dispatch slope reduce over
the ranks; the headline chain (the full chain with mse + contour) with
n_iter 0, in float64; the JAX test's chain with a user's loss, a plain
torch mean (``F.cross_entropy``), which the step weights by the rank's
share of the global batch; the full chain with mse and that loss on ranks
of 3 + 5 and 1 + 2 + 2 + 3 rows. In float32 the headline chain's gradients
are not a continuous function of rounding at this size, even without a PGD
step. With n_iter 0 the 2-rank step leaves the gradient bound 17-fold, on
the encoder's first two levels alone (relative L2 3.4e-3), and float64
removes the gap (1.3e-6). Where a PGD step feeds the contour divergence
(the clamp chain, and the headline chain with n_iter 1) the binarised
validity mask (``mask != 0``) adds to it: the PGD step's f32 differences
(about 1e-6 in the drawn parameters) move pixels on the mask's edge, and
the Sobel terms there move a leaf's gradient by up to 1.9e-2 of its largest
entry (2 ranks); one process moves them as much, 1.6e-2 and 1.9e-2, when
its input is perturbed by 1e-7 relative. So the clamp chain's gradients are
not held, and the headline chain with its PGD step is held on its losses,
the weights' replication and its gradients' relative L2 gap against that of
the perturbed single-process step (under SGD its weights move by up to 3x
the weight bound). One morph-free case runs against JAX's mesh step on 2
ranks with JAX's draws injected, at this file's tolerances.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from advchain_tpu import augmentor as jaug
from advchain_tpu.losses import consistency as jloss
from advchain_tpu.models import SegmentationModel as JaxModel
from advchain_tpu.models import UNet as FlaxUNet
from advchain_tpu.parallel import TrainState as JaxState
from advchain_tpu.parallel import make_adversarial_train_step as jax_adv_step
from advchain_tpu.parallel import make_supervised_train_step as jax_sup_step

from advchain_tpu_torch import augmentor as taug
from advchain_tpu_torch.losses import consistency as tloss
from advchain_tpu_torch.models import (SegmentationModel, UNet,
                                       flax_unet_to_torch_state)
from advchain_tpu_torch.parallel import (TrainState,
                                         make_adversarial_train_step,
                                         make_supervised_train_step)

from test_torch_mesh import (TRAIN_CLASSES, TRAIN_CONFIGS, TRAIN_SIZE,
                             run_ranks, run_train_case, train_batch,
                             train_rank)
import torch_threads  # noqa: F401  (one intra-op thread a process)

N, H, W = 2, 32, 32
SIZE = [N, 1, H, W]
LR = 1e-3
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
LOSSES = ("total_loss", "supervised_loss", "consistency_loss")


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _models():
    """The Flax UNet (feature_scale 16) and the port's, same weights."""
    jmodel = JaxModel.create(FlaxUNet(input_channel=1, num_classes=4,
                                      feature_scale=16), tuple(SIZE),
                             rng=jax.random.PRNGKey(0))
    module = UNet(input_channel=1, num_classes=4, feature_scale=16)
    module.load_state_dict(_torch_state(jmodel.params, jmodel.batch_stats))
    return jmodel, SegmentationModel(module)


def _torch_state(params, batch_stats):
    return flax_unet_to_torch_state(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, batch_stats))


def _batch(seed=0):
    r = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                         indexing="ij")
    img = (np.exp(-((yy / 0.5) ** 2 + (xx / 0.4) ** 2))[None, None]
           + 0.05 * r.rand(N, 1, H, W)).astype(np.float32)
    label = r.randint(0, 4, (N, H, W)).astype(np.int32)
    return ({"image": jnp.asarray(img), "label": jnp.asarray(label)},
            {"image": torch.from_numpy(img),
             "label": torch.from_numpy(label).long()})


def _solver(pkg, names):
    chain = [getattr(pkg, CLASSES[n])(config_dict=dict(CONFIGS[n]))
             for n in names]
    return pkg.ComposeAdversarialTransformSolver(
        chain_of_transforms=chain, divergence_types=["mse", "contour"],
        divergence_weights=[1.0, 0.5])


def _weights(state_dict):
    return {k: v.detach().clone() for k, v in state_dict.items()
            if "running" not in k and "num_batches" not in k}


def _check_first_update(before, ours, ref):
    """Weights after one Adam step: max abs error 2 lr and the update's
    relative L2 error; returns the latter."""
    d_ours, d_ref = [], []
    for k, w0 in before.items():
        assert float((ours[k] - ref[k]).abs().max()) <= 2 * LR * (1 + 1e-4)
        d_ours.append((ours[k] - w0).flatten())
        d_ref.append((ref[k] - w0).flatten())
    d_ours, d_ref = torch.cat(d_ours), torch.cat(d_ref)
    return float((d_ours - d_ref).norm() / d_ref.norm())


def _check_running_stats(module, jax_state, rtol):
    ref = _torch_state(jax_state.params, jax_state.batch_stats)
    ours = module.state_dict()
    for k, v in ref.items():
        if "running" in k:
            assert float((ours[k] - v).abs().max()) <= \
                rtol * float(v.abs().max()), k


# -------------------------------------------------------------- the loss
@pytest.mark.parametrize("weight", [None, [1.0, 2.0, 0.5, 3.0]])
@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("spatial", [(6, 7), (3, 4, 5)])
def test_cross_entropy_matches_jax(weight, soft, spatial):
    r = np.random.RandomState(1)
    logits = (3 * r.randn(2, 4, *spatial)).astype(np.float32)
    if soft:
        t = r.rand(2, 4, *spatial).astype(np.float32)
        target = t / t.sum(1, keepdims=True)
    else:
        target = r.randint(0, 4, (2,) + spatial).astype(np.int32)
    for size_average in (True, False):
        ours = tloss.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(target), weight,
                                   size_average)
        ref = jloss.cross_entropy(jnp.asarray(logits), jnp.asarray(target),
                                  weight, size_average)
        assert _rel(ours, ref) < 1e-5, (float(ours), float(ref))


# ------------------------------------------------------------- the model
def test_apply_train_writes_running_stats_back():
    jmodel, tmodel = _models()
    jb, tb = _batch(2)
    logits, new_bs = jmodel.apply_train(jmodel.params, jmodel.batch_stats,
                                        jb["image"], jax.random.PRNGKey(0))
    before = {k: v.clone() for k, v in tmodel.module.state_dict().items()}
    tmodel.apply_fixed(tb["image"])  # the solver's passes never write back
    assert all(torch.equal(v, tmodel.module.state_dict()[k])
               for k, v in before.items())
    ours = tmodel.apply_train(tb["image"])
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(logits),
                               atol=1e-4, rtol=0)
    _check_running_stats(tmodel.module, jmodel.replace(batch_stats=new_bs),
                         1e-5)


# ------------------------------------------------------------ the steps
def test_supervised_step_matches_jax():
    jmodel, tmodel = _models()
    jb, tb = _batch(3)
    opt = optax.adam(LR)
    jstep = jax_sup_step(jmodel, opt, donate_state=False)
    jstate = JaxState.create(jmodel, opt)
    topt = torch.optim.Adam(tmodel.module.parameters(), lr=LR)
    tstep = make_supervised_train_step(tmodel, topt)
    tstate = TrainState.create(tmodel, topt)
    before = _weights(tmodel.module.state_dict())
    rng = jax.random.PRNGKey(4)
    for i, tol in enumerate((1e-5, 1e-4)):
        jstate, jm = jstep(jstate, jb, rng)
        tstate, tm = tstep(tstate, tb)
        assert _rel(tm["total_loss"], jm["total_loss"]) < tol, i
        if i == 0:
            _check_running_stats(tmodel.module, jstate, 1e-5)
            rel = _check_first_update(
                before, _weights(tmodel.module.state_dict()),
                _weights(_torch_state(jstate.params, jstate.batch_stats)))
            assert rel < 0.1, rel
    assert tstate.step == 2


def _adversarial_pair(names, monkeypatch, steps=2):
    """Run ``steps`` adversarial steps in both packages with the JAX
    step's draws injected; returns the per-step metrics of both and the
    first step's update check."""
    jmodel, tmodel = _models()
    jb, tb = _batch(5)
    jsolver, tsolver = _solver(jaug, names), _solver(taug, names)
    opt = optax.adam(LR)
    jstep = jax_adv_step(jmodel, jsolver, opt, n_iter=1,
                         power_iteration="smart", donate_state=False)
    jstate = JaxState.create(jmodel, opt)
    topt = torch.optim.Adam(tmodel.module.parameters(), lr=LR)
    tstep = make_adversarial_train_step(tmodel, tsolver, topt, n_iter=1,
                                        power_iteration="smart")
    tstate = TrainState.create(tmodel, topt)
    rng = jax.random.PRNGKey(42)
    before = _weights(tmodel.module.state_dict())
    metrics, update_rel = [], None
    for i in range(steps):
        # the JAX step's draws: fold_in(rng, step) -> (k_drop, k_init)
        _, k_init = jax.random.split(jax.random.fold_in(rng, i))
        keys = jax.random.split(k_init, len(names))
        for jt, tt, k in zip(jsolver.chain_of_transforms,
                             tsolver.chain_of_transforms, keys):
            draw = torch.from_numpy(np.array(jt.init_params(k)))
            monkeypatch.setattr(tt, "init_params",
                                lambda gen, device=None, _d=draw:
                                _d.to(device))
        jstate, jm = jstep(jstate, jb, rng)
        tstate, tm = tstep(tstate, tb, torch.Generator().manual_seed(i))
        metrics.append(({k: float(tm[k]) for k in LOSSES},
                        {k: float(jm[k]) for k in LOSSES}))
        if i == 0:
            update_rel = _check_first_update(
                before, _weights(tmodel.module.state_dict()),
                _weights(_torch_state(jstate.params, jstate.batch_stats)))
    assert tstate.step == steps
    return metrics, update_rel


@pytest.mark.parametrize("names,cons_tol", [(MORPH_FREE, 1e-4),
                                             (FULL, 0.12)],
                         ids=["morph_free", "full"])
def test_adversarial_step_matches_jax(names, cons_tol, monkeypatch):
    metrics, update_rel = _adversarial_pair(names, monkeypatch)
    (ours0, ref0), (ours1, ref1) = metrics
    # step 1: identical weights and draws
    assert _rel(ours0["supervised_loss"], ref0["supervised_loss"]) < 1e-5
    assert _rel(ours0["consistency_loss"], ref0["consistency_loss"]) \
        < cons_tol
    assert _rel(ours0["total_loss"], ref0["total_loss"]) < \
        max(1e-4, cons_tol / 10)
    if names == MORPH_FREE:
        assert update_rel < 0.1, update_rel
    # step 2: the weights differ by the first Adam step's flips
    assert _rel(ours1["supervised_loss"], ref1["supervised_loss"]) < 1e-2
    assert _rel(ours1["consistency_loss"], ref1["consistency_loss"]) < 0.12
    assert _rel(ours1["total_loss"], ref1["total_loss"]) < 1e-2


def test_adversarial_step_losses_fall():
    """Adam on a fixed batch (tests/test_parallel.py:42-55): four steps of
    the port's own step, with its own random draws."""
    _, tmodel = _models()
    _, tb = _batch(6)
    topt = torch.optim.Adam(tmodel.module.parameters(), lr=LR)
    step = make_adversarial_train_step(tmodel, _solver(taug, FULL), topt,
                                       n_iter=1, power_iteration="smart")
    state = TrainState.create(tmodel, topt)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(4):
        state, metrics = step(state, tb, gen)
        losses.append(float(metrics["total_loss"]))
    assert all(np.isfinite(losses)), losses
    assert state.step == 4
    assert losses[-1] < losses[0], losses


def test_mesh_is_not_ported_yet(dp_runs):
    """The spatially partitioned step runs: JAX's test chain on a ('data',
    'space') mesh whose space axis is 2 (1 x 2 and 2 x 2 ranks, each a
    slab of 16 of the 32 rows) exchanged halos, and its losses are the
    single-process step's at the JAX package's bounds
    (``test_data_parallel_step_matches_single_process[space_mesh]`` holds
    its weights).  Its applied gradients are within 1e-4 relative L2 of the
    single-process step's (measured 5.4e-6 and 4.3e-6 on 2 and 4 ranks).
    Per leaf, the first convolution's bias, which feeds a BatchNorm and
    whose exact gradient is 0, carries 1.1e-5 of the largest entry in
    rounding residue on 2 ranks, past the data-parallel cases' 1e-5
    yardstick, so the per-leaf test leaves this case out
    (tests/test_torch_space_train.py holds the space step's cases)."""
    runs, refs, _ = dp_runs
    for world in (2, 4):
        first = _dp_losses_close(runs[world], refs["space_mesh"],
                                 "space_mesh")
        assert first["collectives"]["neighbour_exchange"] > 0
        assert _rel_l2(first["grads"], refs["space_mesh"]["grads"]) <= 1e-4


# ------------------------------------------- the data-parallel train steps
DP_CASES = {
    "jax_chain": {"kind": "adversarial", "names": ("noise", "affine"),
                  "divergences": ("mse",)},
    "contour_clamp": {"kind": "adversarial",
                      "names": ("noise", "bias", "affine"),
                      "if_norm_image": True},
    "full_mse": {"kind": "adversarial", "names": FULL,
                 "divergences": ("mse",)},
    "dropout": {"kind": "adversarial", "names": FULL,
                "divergences": ("mse",), "dropout": 0.1},
    "supervised": {"kind": "supervised", "names": ()},
    "space1_mesh": {"kind": "adversarial", "names": ("noise", "affine"),
                    "divergences": ("mse",), "mesh": "2d"},
    # the same on a ('data', 'space') mesh whose space axis is 2
    "space_mesh": {"kind": "adversarial", "names": ("noise", "affine"),
                   "divergences": ("mse",), "mesh": "space"},
    "volume": {"kind": "adversarial", "names": FULL, "dims": 3,
               "divergences": ("mse",)},
    # the headline chain (mse + contour) without its PGD step, in float64
    "headline_no_pgd": {"kind": "adversarial", "names": FULL, "n_iter": 0,
                        "float64": True},
    # a user's loss: a plain torch mean over the rank's rows
    "custom_loss": {"kind": "adversarial", "names": ("noise", "affine"),
                    "divergences": ("mse",), "loss": "torch_ce"},
    # ranks with different numbers of rows, and the user's loss
    "uneven": {"kind": "adversarial", "names": FULL, "divergences": ("mse",),
               "loss": "torch_ce", "uneven": {2: [3, 5], 4: [1, 2, 2, 3]}},
}
# the headline chain with its PGD step: held on the losses (see above)
DP_HEADLINE = {"kind": "adversarial", "names": FULL}
# cases whose PGD step feeds the contour divergence over a binarised mask
DP_PGD_CONTOUR = ("contour_clamp",)
# the space-partitioned case: its gradients are held as a whole (below)
DP_SPACE = ("space_mesh",)
DP_JAX_NAMES = ("noise", "bias", "affine")


def _dp_jax_case():
    """The morph-free chain against JAX's mesh step: carried Flax weights,
    Adam ``LR``, and JAX's draws of step 0 (``fold_in(rng, 0)``), which
    are the global batch's."""
    size = tuple(TRAIN_SIZE)
    jmodel = JaxModel.create(FlaxUNet(input_channel=1, num_classes=4,
                                      feature_scale=16), size,
                             rng=jax.random.PRNGKey(0))
    chain = [getattr(jaug, TRAIN_CLASSES[n])(config_dict=dict(
        TRAIN_CONFIGS[n], data_size=list(size))) for n in DP_JAX_NAMES]
    jsolver = jaug.ComposeAdversarialTransformSolver(
        chain_of_transforms=chain, divergence_types=["mse", "contour"],
        divergence_weights=[1.0, 0.5])
    rng = jax.random.PRNGKey(42)
    _, k_init = jax.random.split(jax.random.fold_in(rng, 0))
    keys = jax.random.split(k_init, len(chain))
    draws = [np.array(t.init_params(k)) for t, k in zip(chain, keys)]
    case = {"kind": "adversarial", "names": DP_JAX_NAMES, "opt": "adam",
            "lr": LR, "draws": [draws],
            "state_dict": _torch_state(jmodel.params, jmodel.batch_stats)}
    return case, jmodel, jsolver, rng


@pytest.fixture(scope="module")
def dp_runs():
    """Each world's ranks on every case (one spawn per world), the JAX
    case on 2 ranks, and the single-process references."""
    jax_case, jmodel, jsolver, rng = _dp_jax_case()
    cases = dict(DP_CASES, headline=DP_HEADLINE)
    runs = {world: run_ranks(train_rank, world,
                             dict(cases, **({"jax": jax_case}
                                            if world == 2 else {})))
            for world in (2, 4)}
    refs = {name: run_train_case(case) for name, case in cases.items()}
    refs["headline_perturbed"] = run_train_case(dict(DP_HEADLINE,
                                                     perturb=1e-7))
    return runs, refs, (jax_case, jmodel, jsolver, rng)


def _dp_state_close(ours, ref):
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k].double().numpy(),
                                   v.double().numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def _dp_losses_close(runs, ref, name):
    """Every rank's metrics and weights equal; the losses at the JAX
    package's bounds.  Returns rank 0's run."""
    first = runs[0][name]
    for out in runs:
        got = out[name]
        assert got["metrics"] == first["metrics"]  # global on every rank
        for k, v in first["state"].items():
            assert torch.equal(got["state"][k], v), k  # replicated
    (ours,), (want,) = first["metrics"], ref["metrics"]
    assert _rel(ours["total_loss"], want["total_loss"]) < 1e-4
    if "consistency_loss" in want:
        assert _rel(ours["consistency_loss"], want["consistency_loss"]) \
            < 1e-3
        assert _rel(ours["supervised_loss"], want["supervised_loss"]) < 1e-4
    return first


@pytest.mark.parametrize("name", list(DP_CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_step_matches_single_process(dp_runs, world, name):
    runs, refs, _ = dp_runs
    first = _dp_losses_close(runs[world], refs[name], name)
    _dp_state_close(first["state"], refs[name]["state"])


@pytest.mark.parametrize("name", [n for n in DP_CASES
                                  if n not in DP_PGD_CONTOUR + DP_SPACE])
@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_gradients_match_single_process(dp_runs, world, name):
    """The gradients the step applied (summed over the ranks) against the
    single-process step's: each leaf within 1e-4 of its own largest entry
    plus 1e-5 of the largest entry of any leaf.  The second term is for
    the convolution biases that feed a BatchNorm, whose exact gradient is
    0 and whose computed one is rounding residue (measured up to 3.4e-6 of
    the largest entry on 2 and 4 ranks)."""
    runs, refs, _ = dp_runs
    ours, want = runs[world][0][name]["grads"], refs[name]["grads"]
    assert ours.keys() == want.keys()
    scale = max(float(g.abs().max()) for g in want.values())
    for k, g in want.items():
        gap = float((ours[k] - g).abs().max())
        assert gap <= 1e-4 * float(g.abs().max()) + 1e-5 * scale, (k, gap)


def _rel_l2(grads, ref):
    diff = torch.cat([(grads[k] - v).flatten() for k, v in ref.items()])
    return float(diff.norm() / torch.cat([v.flatten()
                                          for v in ref.values()]).norm())


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_headline_step(dp_runs, world):
    """The headline chain (noise, bias, affine, morph; mse + contour) with
    its PGD step: the losses at the JAX package's bounds, the weights
    replicated, and the applied gradients' relative L2 gap within 3x the
    single-process step's own gap when its input is perturbed by 1e-7
    relative (measured 0.91x on 2 ranks, 0.02x on 4; a dropped gradient
    all-reduce fails it)."""
    runs, refs, _ = dp_runs
    first = _dp_losses_close(runs[world], refs["headline"], "headline")
    want = refs["headline"]["grads"]
    floor = _rel_l2(refs["headline_perturbed"]["grads"], want)
    assert _rel_l2(first["grads"], want) <= 3 * floor


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_step_reduces_over_the_group(dp_runs, world):
    """The adversarial step's collectives: every BatchNorm pass, the
    gradient all-reduce and the global metrics ran (UNet feature_scale 16
    has 18 BatchNorm layers: 4 forwards of 2 reductions, 3 backwards of
    1, and the chain's global quantities on top)."""
    runs, _, _ = dp_runs
    for name in ("jax_chain", "full_mse"):
        assert runs[world][0][name]["collectives"]["calls"] > 18 * (8 + 3)
    assert runs[world][0]["supervised"]["collectives"]["calls"] >= 18 * 3


def test_data_parallel_step_matches_jax_mesh_step(dp_runs, cpu_devices):
    """2 ranks against JAX's mesh step on the same carried weights and
    draws: this file's first-step tolerances."""
    from advchain_tpu.parallel import make_mesh as jax_make_mesh
    from advchain_tpu.parallel import replicate_to_mesh as jax_replicate
    from advchain_tpu.parallel import shard_batch as jax_shard_batch
    runs, _, (case, jmodel, jsolver, rng) = dp_runs
    mesh = jax_make_mesh(2, devices=cpu_devices)
    opt = optax.adam(LR)
    jstep = jax_adv_step(jmodel, jsolver, opt, n_iter=1,
                         power_iteration="smart", mesh=mesh,
                         donate_state=False)
    jstate = jax_replicate(JaxState.create(jmodel, opt), mesh)
    batch = train_batch()
    jb = jax_shard_batch({"image": jnp.asarray(batch["image"]),
                          "label": jnp.asarray(batch["label"])}, mesh)
    jstate, jm = jstep(jstate, jb, jax_replicate(rng, mesh))
    got = runs[2][0]["jax"]
    (ours,) = got["metrics"]
    assert _rel(ours["supervised_loss"], jm["supervised_loss"]) < 1e-5
    assert _rel(ours["consistency_loss"], jm["consistency_loss"]) < 1e-4
    assert _rel(ours["total_loss"], jm["total_loss"]) < 1e-4
    rel = _check_first_update(
        _weights(case["state_dict"]), _weights(got["state"]),
        _weights(_torch_state(jstate.params, jstate.batch_stats)))
    assert rel < 0.1, rel
