"""Space-mesh levels that a 2 x 2 max-pool cannot halve: the UNet family
inside a spatially partitioned step (or its training forward and backward
inside a space group) where inner levels split unevenly over the ``space``
axis, or leave a rank no row, on 2, 4 and 8 spawned CPU ranks over gloo.

One spawn per world size runs every case (``levels_rank``, which imports
neither JAX nor the JAX package):

* 8 ranks, the JAX package's own configuration (tests/test_spatial.py:
  245-300): a ``(2, 4)`` mesh at batch 4, 32 x 32 (slabs 8, 4, 2, 1, then
  a bottom level of 2 rows on ranks 0 and 2 alone), UNet feature_scale 16
  on JAX's chain (noise and affine, mse) and the supervised step, SGD
  1e-2; the same chain from carried Flax weights and JAX's draws with
  Adam 1e-3 (the JAX case's port side); and the model zoo (the attention
  UNet with gamma 0.5, UNetv2, DeeplySupervisedUNet with 4 base filters)
  on JAX's chain;
* 4 ranks, 224 x 224's pattern on a ``(1, 4)`` mesh at 112 x 112: slabs
  28, 14, 7, then (4, 3, 4, 3) and (2, 2, 2, 1) rows, JAX's chain; and the
  networks' training forward and backward at 56 x 56 (odd global levels
  from 7 rows on: (2, 2, 2, 1), then (1, 1, 1, 0); the decoder's skips
  cropped);
* 2 ranks, the networks' training forward and backward at 40 x 40 on
  ``(1, 2)`` (40, 20, 10, 5, 2: a floor pool of 5 rows, (2, 0) at the
  bottom, and each decoder level's skip cropped by one or more rows).

Bounds, each with its reason:
  * The steps against the single-process step with its compositions on
    the sampler (``ops.integrate.sampler_compositions``, JAX's
    ``ADVCHAIN_STENCIL=0``, as tests/test_torch_space_train.py explains),
    at the JAX package's bounds (tests/test_spatial.py:245-301): the total
    loss rtol 1e-4, the consistency loss 1e-3, the weights and running
    statistics rtol 1e-4 / atol 1e-5, every rank's metrics and weights
    equal; the applied gradients within 1e-4 relative L2 (no PGD step
    feeds a contour divergence here).
  * Against JAX's own step on the ``(2, 4)`` mesh of its 8 virtual CPU
    devices: test_torch_space_train's bounds for a morph-free chain (the
    supervised loss 1e-5, the consistency and total losses 1e-4, each
    weight within 2 lr, the update within 0.1 relative L2).
  * The training forward and backward inside a space group against the
    dense network: the output rows and input gradient assembled in rank
    order within 1e-5 of the largest entry (BatchNorm's global
    statistics compute in f32 over another reduction order), the weight
    gradients summed over the ranks within 1e-4 relative L2, the written
    running statistics within 1e-5 of the largest entry on every rank.
  * Every module's output on every rank holds exactly the rows the level
    rule names, computed here on its own: encoder level k's row j lies on
    the rank whose input slab holds row j * 2^k; a decoder level's rows
    are its skip's after the pad or crop (added rows on the first and
    last rank).
"""

import numpy as np
import pytest
import torch

from test_torch_mesh import TRAIN_CLASSES, TRAIN_CONFIGS, run_ranks
from test_torch_space_train import (CHAINS, LR_JAX, _losses_close,
                                    _rel, _rel_l2, _replicated, _state_close,
                                    run_space_case)
import torch_threads  # noqa: F401  (one intra-op thread a process)

JAX_MESH = (2, 4)
STEP_CASES = {
    "2x4/jax_chain": dict(CHAINS["jax_chain"], mesh=(2, 4),
                          size=[4, 1, 32, 32]),
    "2x4/supervised": dict(CHAINS["supervised"], mesh=(2, 4),
                           size=[4, 1, 32, 32]),
    "1x4/112/jax_chain": dict(CHAINS["jax_chain"], mesh=(1, 4),
                              size=[4, 1, 112, 112]),
}
ZOO_GAMMA = 0.5


def attention_unet():
    from advchain_tpu_torch.models import UNet
    return UNet(1, 4, feature_scale=16, self_attention=True)


def unet():
    from advchain_tpu_torch.models import UNet
    return UNet(1, 4, feature_scale=16)


def unetv2():
    from advchain_tpu_torch.models import UNetv2
    return UNetv2(1, 4, feature_scale=16)


def deeply_supervised():
    from advchain_tpu_torch.models import DeeplySupervisedUNet
    return DeeplySupervisedUNet(1, 4, base_n_filters=4)


NETS = {"unet": unet, "attention": attention_unet, "unetv2": unetv2,
        "deeply_supervised": deeply_supervised}
for _net in ("attention", "unetv2", "deeply_supervised"):
    STEP_CASES[f"2x4/{_net}"] = dict(
        CHAINS["jax_chain"], net=NETS[_net], mesh=(2, 4),
        size=[4, 1, 32, 32], gamma=ZOO_GAMMA if _net == "attention"
        else None)
# the networks' training forward and backward: (mesh, image size)
NET_MESHES = {"1x2/40": ((1, 2), 40), "1x4/56": ((1, 4), 56)}
NET_CASES = [(m, n) for m in NET_MESHES for n in NETS]


# ------------------------------------------ the level rule, on its own
# each top-level module of the UNet family: (encoder or decoder, level)
MODULE_LEVELS = {"inc": ("enc", 0), "drop": ("enc", 0),
                 "down1": ("enc", 1), "down2": ("enc", 2),
                 "down3": ("enc", 3), "down4": ("enc", 4),
                 "drop3": ("enc", 2), "drop4": ("enc", 3),
                 "drop5": ("enc", 4), "self_atn": ("enc", 4),
                 "up1": ("dec", 3), "up2": ("dec", 2), "up3": ("dec", 1),
                 "up4": ("dec", 0), "up2_conv1": ("dec", 2),
                 "up3_conv1": ("dec", 1), "outc": ("dec", 0)}


def expected_rows(height, n_space, levels=4):
    """{("enc" | "dec", level): each rank's row count} of the UNet family
    at ``height`` rows split into ``n_space`` equal input slabs."""
    slab = height // n_space
    heights = [height >> k for k in range(levels + 1)]
    out = {}
    owners = {}
    for k, h in enumerate(heights):
        owners[("enc", k)] = [j * 2 ** k // slab for j in range(h)]
    owners[("dec", levels)] = owners[("enc", levels)]
    for k in range(levels - 1, -1, -1):
        target = 2 * len(owners[("dec", k + 1)])
        skip = owners[("enc", k)]
        before = (target - len(skip)) // 2
        owners[("dec", k)] = [skip[j - before] if 0 <= j - before < len(skip)
                              else (0 if j < before else n_space - 1)
                              for j in range(target)]
    for key, rows in owners.items():
        out[key] = [rows.count(r) for r in range(n_space)]
    return out


def _check_extents(extents, height, n_space, rank):
    """Every recorded module output of the family holds the rule's rows
    on this rank (``extents``: module name -> its output's rows)."""
    want = expected_rows(height, n_space)
    checked = 0
    for name, rows in extents.items():
        level = MODULE_LEVELS.get(name.split(".")[0])
        if level is not None:
            assert rows == want[level][rank], (name, rows, want[level])
            checked += 1
    assert checked


# -------------------------------------------------- the networks' passes
def net_values(name, height, mesh=None):
    """The network's training forward (statistics written back; the
    attention's gamma 0.5) on a seeded batch of 2 at ``height`` squared,
    and the backward of ``sum(out * ct)``: its output, input gradient,
    weight gradients, buffers and each module's output rows; with a
    ``(1, n)`` mesh this rank's slab of the input and rows of all of
    them."""
    from advchain_tpu_torch.models.unet import _StatsWriter
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.parallel.mesh import every_rank_group
    r = np.random.RandomState(height)
    x = torch.from_numpy(r.randn(2, 1, height, height).astype(np.float32))
    torch.manual_seed(0)
    net = NETS[name]()
    if name == "attention":
        with torch.no_grad():
            net.self_atn.gamma.fill_(ZOO_GAMMA)
    for m in net.modules():
        if isinstance(m, _StatsWriter):
            m.write_back = True
    net.train()
    extents = {}

    def record(module_name):
        def hook(module, inputs, output):
            if isinstance(output, torch.Tensor) and output.dim() > 2:
                extents[module_name] = output.shape[2]
        return hook

    hooks = [m.register_forward_hook(record(n))
             for n, m in net.named_modules() if n]
    try:
        if mesh is None:
            x = x.requires_grad_(True)
            y = net(x)
            ct = torch.from_numpy(r.randn(*y.shape).astype(np.float32))
            (y * ct).sum().backward()
        else:
            space = collectives.SpaceGroup(
                mesh.get_group("space"), mesh.size(1),
                mesh.get_local_rank("space"), mesh)
            with collectives.data_group(mesh.get_group("data"), 2,
                                        space=space,
                                        reduce_group=every_rank_group(mesh)):
                sg = collectives.current_space()
                x = sg.slab(x).clone().requires_grad_(True)
                y = net(x)
                ct = torch.from_numpy(r.randn(
                    2, y.shape[1], sum(sg.level(y).extents),
                    y.shape[3]).astype(np.float32))
                (y * sg.take(ct, sg.level(y))).sum().backward()
    finally:
        for h in hooks:
            h.remove()
    return {"y": y.detach(), "dx": x.grad,
            "grads": {k: p.grad.clone() for k, p in net.named_parameters()},
            "bufs": {k: v.clone() for k, v in net.named_buffers()
                     if not k.endswith("num_batches_tracked")},
            "extents": extents}


# ------------------------------------------------------------ the ranks
def levels_rank(rank, world, device, cases):
    """Every step case of this world on its mesh, and the networks'
    passes on this world's (1, n) mesh."""
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.parallel import make_spatial_mesh
    meshes, out = {}, {}
    for name, case in cases.items():
        shape = case["mesh"]
        if shape not in meshes:
            meshes[shape] = make_spatial_mesh(*shape, device_type=device)
        collectives.reset_counts()
        out[name] = run_space_case(case, meshes[shape])
        out[name]["collectives"] = dict(collectives.COUNTS)
    for mesh_name, (shape, height) in NET_MESHES.items():
        if shape[0] * shape[1] != world:
            continue
        mesh = make_spatial_mesh(*shape, device_type=device)
        for net in NETS:
            out[(mesh_name, net)] = net_values(net, height, mesh)
    return out


# ----------------------------------------------------------- the JAX case
def _jax_case():
    """JAX's chain on (2, 4) at 32 x 32 as the JAX package's spatial step
    runs it: carried Flax weights, JAX's draws of step 0 (``fold_in(rng,
    0)``), Adam 1e-3.  Returns (port case, JAX model, JAX solver, rng)."""
    import jax
    from advchain_tpu import augmentor as jaug
    from advchain_tpu.models import SegmentationModel as JaxModel
    from advchain_tpu.models import UNet as FlaxUNet
    from advchain_tpu_torch.models import flax_unet_to_torch_state
    case = dict(STEP_CASES["2x4/jax_chain"])
    jmodel = JaxModel.create(FlaxUNet(input_channel=1, num_classes=4,
                                      feature_scale=16),
                             tuple(case["size"]), rng=jax.random.PRNGKey(0))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    state = flax_unet_to_torch_state(tree(jmodel.params),
                                     tree(jmodel.batch_stats))
    chain = [getattr(jaug, TRAIN_CLASSES[n])(
        spatial_dims=2, config_dict=dict(TRAIN_CONFIGS[n],
                                         data_size=list(case["size"])))
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
def level_runs():
    """Each world's ranks (the JAX case's port side among the 8), the
    single-process references and the dense networks' passes."""
    jax_case = _jax_case()
    runs = {}
    for world in (2, 4, 8):
        cases = {k: v for k, v in STEP_CASES.items()
                 if v["mesh"][0] * v["mesh"][1] == world}
        if world == 8:
            cases["jax/2x4"] = jax_case[0]
        runs[world] = run_ranks(levels_rank, world, cases)
    from advchain_tpu_torch.ops.integrate import sampler_compositions
    with sampler_compositions():
        refs = {name: run_space_case(case)
                for name, case in STEP_CASES.items()}
    dense = {(m, n): net_values(n, NET_MESHES[m][1]) for m, n in NET_CASES}
    return runs, refs, dense, jax_case


def _world(case):
    return case["mesh"][0] * case["mesh"][1]


# --------------------------------------------------------------- tests
@pytest.mark.parametrize("name", list(STEP_CASES))
def test_level_step_matches_single_process(level_runs, name):
    """Losses, weights and running statistics at the JAX package's
    bounds, every rank's equal, and the applied gradients within 1e-4
    relative L2, against the single-process step with sampler
    compositions."""
    runs, refs, _, _ = level_runs
    case = STEP_CASES[name]
    first = _replicated(runs[_world(case)], name)
    want = refs[name]
    _losses_close(first["metrics"], want["metrics"])
    _state_close(first["state"], want["state"])
    ours = first["grads"]
    assert ours.keys() == want["grads"].keys()
    assert _rel_l2(ours, want["grads"]) <= 1e-4


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_level_step_activations_lie_on_the_partition(level_runs, name):
    """Every module's output on every rank holds the rows the level rule
    names (uneven, and none on ranks 1 and 3 at (2, 4)'s bottom level)."""
    runs, _, _, _ = level_runs
    case = STEP_CASES[name]
    n_data, n_space = case["mesh"]
    for i, out in enumerate(runs[_world(case)]):
        _check_extents(out[name]["extents"], case["size"][2], n_space,
                       i % n_space)


def test_level_step_matches_jax_space_step(level_runs, cpu_devices):
    """JAX's own configuration: the port's step on (2, 4) at 32 x 32
    against JAX's spatial-mesh step on its 8 virtual CPU devices, from the
    same carried weights and draws, at test_torch_space_train's bounds for
    a morph-free chain."""
    from test_torch_space_train import _jax_step
    from test_torch_train import _check_first_update, _weights
    runs, _, _, (case, jmodel, jsolver, rng) = level_runs
    assert LR_JAX == 1e-3 and case["mesh"] == JAX_MESH
    jm, jstate = _jax_step("jax_chain", jmodel, jsolver, rng, case,
                           cpu_devices)
    first = _replicated(runs[8], "jax/2x4")
    ours = first["metrics"]
    assert _rel(ours["supervised_loss"], jm["supervised_loss"]) < 1e-5
    assert _rel(ours["consistency_loss"], jm["consistency_loss"]) < 1e-4
    assert _rel(ours["total_loss"], jm["total_loss"]) < 1e-4
    rel = _check_first_update(_weights(case["state_dict"]),
                              _weights(first["state"]), _weights(jstate))
    assert rel < 0.1, rel


def _close(ours, ref, tol):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(ours - ref).max() <= tol * scale, \
        (np.abs(ours - ref).max(), scale)


@pytest.mark.parametrize("mesh,net", NET_CASES,
                         ids=[f"{m}/{n}" for m, n in NET_CASES])
def test_network_on_uneven_levels_matches_dense(level_runs, mesh, net):
    """The training forward and backward inside a space group: output rows
    and input gradient in rank order, weight gradients summed over the
    ranks, every rank's written statistics, against the dense network;
    every module's output on the rule's rows."""
    runs, _, dense, _ = level_runs
    shape, height = NET_MESHES[mesh]
    outs = [o[(mesh, net)] for o in runs[shape[0] * shape[1]]]
    ref = dense[(mesh, net)]
    _close(torch.cat([o["y"] for o in outs], 2), ref["y"], 1e-5)
    _close(torch.cat([o["dx"] for o in outs], 2), ref["dx"], 1e-5)
    grads = torch.cat([sum(o["grads"][k] for o in outs).flatten()
                       for k in ref["grads"]])
    want = torch.cat([v.flatten() for v in ref["grads"].values()])
    assert float((grads - want).norm() / want.norm()) <= 1e-4
    for i, o in enumerate(outs):
        for k, v in ref["bufs"].items():
            _close(o["bufs"][k], v, 1e-5)
        _check_extents(o["extents"], height, shape[1], i)


# ----------------------------------------------- the partition, alone
@pytest.mark.parametrize("extents,kernel,stride,padding,want", [
    ((8, 8), 2, 2, 0, (4, 4)),
    ((7, 7, 7, 7), 2, 2, 0, (4, 3, 4, 3)),
    ((4, 3, 4, 3), 2, 2, 0, (2, 2, 2, 1)),
    ((2, 2, 2, 1), 2, 2, 0, (1, 1, 1, 0)),
    ((1, 1, 1, 1), 2, 2, 0, (1, 0, 1, 0)),
    ((3, 2), 2, 2, 0, (2, 0)),
    ((5, 0, 5), 3, 2, 1, (3, 0, 2)),
    ((5, 0, 5), 3, 1, 1, (5, 0, 5)),
])
def test_partition_window_rule(extents, kernel, stride, padding, want):
    """A window op's output row belongs to the rank holding its window's
    centre row (a 2 x 2 pool's first; an odd level drops its last row)."""
    from advchain_tpu_torch.ops.collectives import Partition
    assert Partition(extents).window(kernel, stride, padding).extents \
        == want


@pytest.mark.parametrize("extents,before,after,want", [
    ((3, 2), -1, 0, (2, 2)),
    ((5, 5), -1, -1, (4, 4)),
    ((1, 0, 2), -2, 0, (0, 0, 1)),
    ((2, 2), 1, 2, (3, 4)),
    ((0, 3), 1, 0, (1, 3)),
])
def test_partition_pad_and_crop(extents, before, after, want):
    """Added rows go to the first and last rank; a cropped row leaves its
    owner."""
    from advchain_tpu_torch.ops.collectives import Partition
    assert Partition(extents).padded(before, after).extents == want


def test_partition_resize_doubles_rows_and_pools_back():
    """An x2 resize doubles each rank's rows, and a pool gives the
    partition back."""
    from advchain_tpu_torch.ops.collectives import Partition
    part = Partition((4, 3, 0, 4, 3))
    up = part.resized(2 * part.height)
    assert up.extents == (8, 6, 0, 8, 6)
    assert up.window(2, 2).extents == part.extents
