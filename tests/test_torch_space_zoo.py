"""The space-mesh model zoo: UNet with self-attention, UNetv2 and
DeeplySupervisedUNet inside the spatially partitioned train step (a
``('data', 'space')`` mesh whose ``space`` axis is larger than 1), on 2
and 4 spawned CPU ranks over gloo, and ``ops.grid_sample.spatial_sampling``
outside the step.

One spawn per world size runs every case (``zoo_rank``, which imports
neither JAX nor the JAX package): on 2 ranks the ``(1, 2)`` mesh and
``spatial_sampling``, on 4 the ``(2, 2)`` mesh, the self-attention's
op-level case and the JAX case's port side.  The networks are narrow (UNet
and UNetv2 feature_scale 16, DeeplySupervisedUNet 4 base filters) at batch
4, 32x32 (slabs of 16 rows: every level halves); the self-attention's
``gamma`` is set to 0.5 so that it moves the output.  Each takes the
adversarial step on the full chain (noise, bias, affine, morph) with mse,
n_iter 1, and the supervised step, SGD 1e-2.

Against the port's single-process step with its compositions on the
sampler (``ops.integrate.sampler_compositions``, as
tests/test_torch_space_train.py explains), at that file's bounds: the
total loss rtol 1e-4, the consistency loss 1e-3, the weights and running
statistics rtol 1e-4 / atol 1e-5, every rank's metrics and weights equal,
the applied gradients within 1e-4 relative L2 (no PGD step feeds a
contour divergence here).  The self-attention on slabs against the dense
block: the output, the input gradient and each slab's attention rows
within 1e-6 of the largest entry, the parameter gradients summed over
the ranks within 1e-5 of the largest entry of any (the key convolution's
bias has an exact gradient of 0), ``gamma``'s within 1e-5 of its own.
Against JAX's own spatial-mesh step (advchain_tpu/parallel/train.py:
57-95, the virtual CPU devices of tests/conftest.py) on (2, 2): the
attention UNet with the Flax weights carried over (``gamma`` 0.7) and JAX's draws injected, Adam
1e-3, at test_torch_space_train's morph bounds (consistency 0.12, total
1.2e-2, the supervised loss 1e-5, each weight within 2 lr and the update
within 0.1 relative L2).  ``spatial_sampling`` routes ``grid_sample`` to
``parallel.spatial.sharded_grid_sample`` on both of its routes, bit for
bit, within 1e-5 of the dense call's largest entry, and off for
``None``.
"""

import numpy as np
import pytest
import torch

from test_torch_mesh import run_ranks
from test_torch_space_train import (FULL, _close, _losses_close, _rel,
                                    _rel_l2, _replicated, _state_close,
                                    run_space_case)
import torch_threads  # noqa: F401  (one intra-op thread a process)

SIZE = [4, 1, 32, 32]
GAMMA = 0.5
MESHES = {2: (1, 2), 4: (2, 2)}
CHAINS = {"adversarial": {"kind": "adversarial", "names": FULL,
                          "divergences": ("mse",)},
          "supervised": {"kind": "supervised", "names": ()}}


def attention_unet():
    from advchain_tpu_torch.models import UNet
    return UNet(1, 4, feature_scale=16, self_attention=True)


def unetv2():
    from advchain_tpu_torch.models import UNetv2
    return UNetv2(1, 4, feature_scale=16)


def deeply_supervised():
    from advchain_tpu_torch.models import DeeplySupervisedUNet
    return DeeplySupervisedUNet(1, 4, base_n_filters=4)


NETS = {"attention": attention_unet, "unetv2": unetv2,
        "deeply_supervised": deeply_supervised}


def _cases():
    return {f"{net}/{chain}": dict(CHAINS[chain], net=make, size=SIZE,
                                   gamma=GAMMA if net == "attention"
                                   else None)
            for net, make in NETS.items() for chain in CHAINS}


# ------------------------------------------- the self-attention on slabs
def attention_inputs():
    r = np.random.RandomState(21)
    return {"x": r.randn(4, 16, 8, 6).astype(np.float32),
            "ct": r.randn(4, 16, 8, 6).astype(np.float32)}


def attention_values(t):
    """SelfAttn2d(16) with seeded weights and gamma 0.5 on ``t["x"]``: the
    output, the attention map, the input's and the parameters' gradients
    of ``sum(out * ct)``."""
    from advchain_tpu_torch.models import SelfAttn2d
    torch.manual_seed(4)
    block = SelfAttn2d(16)
    with torch.no_grad():
        block.gamma.fill_(GAMMA)
    x = t["x"].clone().requires_grad_(True)
    y, weighted, attention = block(x)
    (y * t["ct"]).sum().backward()
    return {"y": y.detach(), "attention": attention.detach(),
            "dx": x.grad,
            "grads": {k: p.grad.clone() for k, p in
                      block.named_parameters()}}


def attention_rank(mesh):
    """:func:`attention_values` on this rank's rows and slab inside the
    mesh's data group with its space group."""
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.parallel.mesh import every_rank_group
    rows = 4 // mesh.size(0)
    d_idx, s_idx = mesh.get_local_rank("data"), mesh.get_local_rank("space")
    local = {}
    for k, v in attention_inputs().items():
        part = torch.from_numpy(v)[d_idx * rows:(d_idx + 1) * rows]
        step = v.shape[2] // mesh.size(1)
        local[k] = part.narrow(2, s_idx * step, step)
    space = collectives.SpaceGroup(mesh.get_group("space"), mesh.size(1),
                                   s_idx, mesh)
    collectives.reset_counts()
    with collectives.data_group(mesh.get_group("data"), rows, space=space,
                                reduce_group=every_rank_group(mesh)):
        out = attention_values(local)
    out["collectives"] = dict(collectives.COUNTS)
    return out


# ------------------------------------------------- spatial_sampling
def sampling_inputs():
    """A (2, 3, 16, 12) source and a grid within 0.1 of the identity."""
    r = np.random.RandomState(22)
    h, w = 16, 12
    base = np.stack(np.meshgrid(np.linspace(-1, 1, w), np.linspace(-1, 1, h),
                                indexing="xy"), -1)[None].repeat(2, 0)
    return {"x": r.randn(2, 3, h, w).astype(np.float32),
            "grid": (base + 0.1 * r.uniform(-1, 1, base.shape)).astype(
                np.float32)}


SAMPLING_BOUND = 0.2  # the halo route's: 3 planes of 16 (a slab is 8)


def sampling_rank(mesh):
    """``grid_sample`` inside ``spatial_sampling`` on this rank's slab of
    the source and the grid, both routes, against ``sharded_grid_sample``
    called directly; inside ``spatial_sampling(None)`` the local call."""
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.ops.grid_sample import (grid_sample,
                                                    local_grid_sample,
                                                    spatial_sampling)
    from advchain_tpu_torch.parallel.spatial import sharded_grid_sample
    idx, n = mesh.get_local_rank("space"), mesh.size(1)
    t = {k: torch.from_numpy(v) for k, v in sampling_inputs().items()}
    x = t["x"].narrow(2, idx * 8, 8)
    grid = t["grid"].narrow(1, idx * 8, 8)
    assert n == 2
    out = {}
    for route, bound in (("gather", None), ("halo", SAMPLING_BOUND)):
        collectives.reset_counts()
        with spatial_sampling(mesh, bound):
            routed = grid_sample(x, grid, padding_mode="border")
        out[route] = (routed, dict(collectives.COUNTS),
                      sharded_grid_sample(x, grid, mesh,
                                          padding_mode="border",
                                          max_disp=bound))
    with spatial_sampling(None):
        out["off"] = (grid_sample(x, grid, padding_mode="border"),
                      local_grid_sample(x, grid, padding_mode="border"))
    return out


# ------------------------------------------------------------ the ranks
def zoo_rank(rank, world, device, cases):
    """Every step case of this world on its mesh; on 2 ranks
    ``spatial_sampling``, on 4 the self-attention on slabs."""
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.parallel import make_spatial_mesh
    mesh = make_spatial_mesh(*MESHES[world], device_type=device)
    out = {}
    for name, case in cases.items():
        collectives.reset_counts()
        out[name] = run_space_case(case, mesh)
        out[name]["collectives"] = dict(collectives.COUNTS)
    if world == 2:
        out["sampling"] = sampling_rank(mesh)
    else:
        out["attention"] = attention_rank(mesh)
    return out


# ----------------------------------------------------------- the JAX case
def _jax_case():
    """The attention UNet's adversarial step on (2, 2) as the JAX
    package's spatial step runs it: carried Flax weights (gamma 0.7), JAX's
    draws of step 0 (``fold_in(rng, 0)``), Adam 1e-3.  Returns (port case,
    JAX model, JAX solver, rng)."""
    import jax
    import jax.numpy as jnp
    from advchain_tpu import augmentor as jaug
    from advchain_tpu.models import SegmentationModel as JaxModel
    from advchain_tpu.models import UNet as FlaxUNet
    from advchain_tpu_torch.models import flax_unet_to_torch_state
    from test_torch_mesh import TRAIN_CLASSES, TRAIN_CONFIGS
    case = dict(CHAINS["adversarial"], net=attention_unet, size=SIZE)
    jmodel = JaxModel.create(FlaxUNet(input_channel=1, num_classes=4,
                                      feature_scale=16, self_attention=True),
                             tuple(SIZE), rng=jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda a: a, jmodel.params)
    params["self_atn"]["gamma"] = jnp.full((1,), 0.7, jnp.float32)
    jmodel.params = params
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    state = flax_unet_to_torch_state(tree(jmodel.params),
                                     tree(jmodel.batch_stats))
    chain = [getattr(jaug, TRAIN_CLASSES[n])(
        spatial_dims=2, config_dict=dict(TRAIN_CONFIGS[n],
                                         data_size=list(SIZE)))
        for n in case["names"]]
    jsolver = jaug.ComposeAdversarialTransformSolver(
        chain_of_transforms=chain, divergence_types=["mse"],
        divergence_weights=[1.0])
    rng = jax.random.PRNGKey(42)
    _, k_init = jax.random.split(jax.random.fold_in(rng, 0))
    keys = jax.random.split(k_init, len(chain))
    draws = [np.array(t.init_params(k)) for t, k in zip(chain, keys)]
    case.update(opt="adam", state_dict=state, draws=draws)
    return case, jmodel, jsolver, rng


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def zoo_runs():
    """Each world's ranks on every case (the JAX case's port side on 4),
    and the single-process references."""
    jax_case = _jax_case()
    runs = {}
    for world in (2, 4):
        cases = _cases()
        if world == 4:
            cases["jax/attention"] = jax_case[0]
        runs[world] = run_ranks(zoo_rank, world, cases)
    from advchain_tpu_torch.ops.integrate import sampler_compositions
    with sampler_compositions():
        refs = {name: run_space_case(case) for name, case in _cases().items()}
    return runs, refs, jax_case


STEP_IDS = [(world, name) for world in (2, 4) for name in _cases()]


@pytest.mark.parametrize("world,name", STEP_IDS,
                         ids=[f"{MESHES[w][0]}x{MESHES[w][1]}/{n}"
                              for w, n in STEP_IDS])
def test_zoo_space_step_matches_single_process(zoo_runs, world, name):
    """Losses, weights and running statistics at the JAX package's bounds,
    every rank's equal, and the applied gradients within 1e-4 relative
    L2, against the single-process step with sampler compositions."""
    runs, refs, _ = zoo_runs
    first = _replicated(runs[world], name)
    want = refs[name]
    _losses_close(first["metrics"], want["metrics"])
    _state_close(first["state"], want["state"])
    ours = runs[world][0][name]["grads"]
    assert ours.keys() == want["grads"].keys()
    assert _rel_l2(ours, want["grads"]) <= 1e-4


@pytest.mark.parametrize("world,name", STEP_IDS,
                         ids=[f"{MESHES[w][0]}x{MESHES[w][1]}/{n}"
                              for w, n in STEP_IDS])
def test_zoo_space_step_holds_its_slab(zoo_runs, world, name):
    """No module's output on a rank is taller than the dense output's slab
    plus two halo planes; the attention UNet's step gathered its keys and
    values (more all-gathers than UNetv2's on the same chain)."""
    runs, refs, _ = zoo_runs
    dense = refs[name]["extents"]
    for out in runs[world]:
        got = out[name]["extents"]
        assert got.keys() == dense.keys()
        for k, v in got.items():
            assert v <= dense[k] // MESHES[world][1] + 2, (k, v, dense[k])
    if name.startswith("attention"):
        chain = name.split("/")[1]
        att = runs[world][0][name]["collectives"]["all_gather"]
        v2 = runs[world][0][f"unetv2/{chain}"]["collectives"]["all_gather"]
        assert att > v2, (att, v2)


ATTENTION_KEYS = ["y", "dx", "attention", "grads"]


@pytest.mark.parametrize("key", ATTENTION_KEYS)
def test_self_attention_on_slabs_matches_the_dense_block(zoo_runs, key):
    """(2, 2): each rank's rows and slab of the output and the input
    gradient, its query rows of the attention map (N, hw, HW), and the
    parameter gradients (gamma's among them) summed over the ranks,
    against the dense block on the whole input; one all-gather forward
    and its all-reduce backward."""
    outs = [o["attention"] for o in zoo_runs[0][4]]
    dense = attention_values({k: torch.from_numpy(v)
                              for k, v in attention_inputs().items()})
    if key == "grads":  # the key bias's exact gradient is 0: one scale
        ours = torch.cat([sum(o["grads"][k] for o in outs).flatten()
                          for k in dense["grads"]])
        _close(ours, torch.cat([v.flatten()
                                for v in dense["grads"].values()]), 1e-5)
        _close(sum(o["grads"]["gamma"] for o in outs),
               dense["grads"]["gamma"], 1e-5)
        return
    dim = 1 if key == "attention" else 2
    rows = [torch.cat([outs[2 * d + s][key] for s in range(2)], dim=dim)
            for d in range(2)]
    _close(torch.cat(rows, dim=0), dense[key], 1e-6)
    for o in outs:
        assert o["collectives"]["all_gather"] >= 1
        assert o["collectives"]["all_reduce"] >= 1


def test_zoo_space_step_matches_jax_space_step(zoo_runs, cpu_devices):
    """The attention UNet's adversarial step on (2, 2) against JAX's own
    spatial-mesh step, from the same carried weights and draws:
    tests/test_torch_train.py's first-step bounds, the morph's loss
    bounds."""
    from test_torch_space_train import _jax_step
    from test_torch_train import _check_first_update, _weights
    runs, _, (case, jmodel, jsolver, rng) = zoo_runs
    jm, jstate = _jax_step("attention", jmodel, jsolver, rng,
                           dict(case, mesh=(2, 2)), cpu_devices)
    first = _replicated(runs[4], "jax/attention")
    ours = first["metrics"]
    assert _rel(ours["supervised_loss"], jm["supervised_loss"]) < 1e-5
    assert _rel(ours["consistency_loss"], jm["consistency_loss"]) < 0.12
    assert _rel(ours["total_loss"], jm["total_loss"]) < 1.2e-2
    rel = _check_first_update(_weights(case["state_dict"]),
                              _weights(first["state"]), _weights(jstate))
    assert rel < 0.1, rel


@pytest.mark.parametrize("route", ["gather", "halo"])
def test_spatial_sampling_routes_grid_sample(zoo_runs, route):
    """Inside ``spatial_sampling(mesh, max_disp)`` ``grid_sample`` is
    ``sharded_grid_sample`` on the rank's slabs, bit for bit, on the route
    the bound picks (a neighbour exchange for the halo route, none for the
    gather), and the slabs assembled are the dense call's within 1e-5 of
    its largest entry; ``spatial_sampling(None)`` leaves the call
    local."""
    from advchain_tpu_torch.ops.grid_sample import grid_sample
    outs = [o["sampling"] for o in zoo_runs[0][2]]
    t = {k: torch.from_numpy(v) for k, v in sampling_inputs().items()}
    dense = grid_sample(t["x"], t["grid"], padding_mode="border")
    for o in outs:
        routed, counts, direct = o[route]
        assert torch.equal(routed, direct)
        assert (counts["neighbour_exchange"] > 0) == (route == "halo")
        assert torch.equal(*o["off"])
    _close(torch.cat([o[route][0] for o in outs], dim=2), dense, 1e-5)
