"""The port's mesh helpers (``advchain_tpu_torch.parallel.mesh``) on
spawned CPU ranks over gloo, and the multi-rank harness the other
``test_torch_*`` files share.

``run_ranks(fn, world, *args)`` runs ``fn(rank, world, "cpu", *args)`` in
``world`` spawned processes on one gloo group (``chip_smoke.spawn_ranks``:
a file store in a fresh temporary directory, no fixed port, as test
workers run side by side) and returns every rank's result.  It joins with
a timeout, so a hung collective fails the test that waits on it; and it
holds a lock file in the temporary directory while its ranks run, so the
test workers start one spawn at a time (ranks of several spawns sharing
the CPU wait on each other's collectives past that timeout).  The rank
functions here import neither JAX nor the JAX package (a spawned rank
imports this module); the tests that compare with JAX import it inside the
test.

The data group's global quantities are held directly too: inside
``ops.collectives.data_group`` each rank's BatchNorm (forward, input
gradient, running statistics; its weight and bias gradients summed over
the ranks), flow composition (the dispatch slope at exact -1 entries),
3D step count and weighted losses against the same functions on the global
batch in one process (1e-5 relative for the gradients, 1e-6 for the loss
sums: f32 reduction order), on inputs where a rank's own batch would give
another slope and step count.

``train_rank`` runs the port's data-parallel train steps on each rank; the
data-parallel tests in ``test_torch_train.py`` drive it.
"""

import fcntl
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chip_smoke import spawn_ranks
import torch_threads  # noqa: F401  (one intra-op thread a process)

JOIN_TIMEOUT_S = 120.0


def run_ranks(fn, world, *args):
    """Every rank's ``fn(rank, world, "cpu", *args)``, one spawn at a time
    across the test processes."""
    parent = tempfile.gettempdir()
    with open(os.path.join(parent, "advchain_torch_ranks.lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)  # released when the file closes
        return spawn_ranks(fn, world, "cpu", *args, timeout=JOIN_TIMEOUT_S,
                           parent=parent)


# ------------------------------------------------------ the mesh helpers
def _batch(n=8, seed=0):
    r = np.random.RandomState(seed)
    return {"image": r.rand(n, 1, 6, 5).astype(np.float32),
            "label": r.randint(0, 4, (n, 6, 5))}


def mesh_rank(rank, world, device):
    """The helpers on one rank: its mesh, its batch rows, and replicated
    state after rank 1 perturbed its own copy."""
    from advchain_tpu_torch.models import SegmentationModel, UNet
    from advchain_tpu_torch.parallel import (TrainState, make_mesh,
                                             make_spatial_mesh,
                                             make_supervised_train_step,
                                             replicate_to_mesh, shard_batch,
                                             shard_process_local_batch)
    out = {}
    try:
        make_mesh(world + 1, device_type=device)
    except AssertionError as e:
        out["too_few"] = str(e)
    mesh = make_mesh(device_type=device)
    out["mesh"] = (mesh.mesh.tolist(), mesh.mesh_dim_names,
                   mesh.get_local_rank("data"))
    out["shard"] = shard_batch(_batch(), mesh)
    rows = 8 // world
    local = {k: v[rank * rows:(rank + 1) * rows]
             for k, v in _batch().items()}
    out["local"] = shard_process_local_batch(local, mesh)
    model = SegmentationModel.create(UNet(1, 4, feature_scale=16), seed=0,
                                     device="cpu")
    opt = torch.optim.Adam(model.module.parameters(), lr=1e-3)
    loss = model.apply_train(torch.ones(2, 1, 16, 16)).square().mean()
    loss.backward()
    opt.step()  # Adam's moments exist
    state = TrainState.create(model, opt)
    gen = torch.Generator().manual_seed(rank)
    t = torch.full((3,), float(rank))
    if rank == 1:
        with torch.no_grad():
            for p in model.module.parameters():
                p.add_(1.0)
            for b in model.module.buffers():
                b.add_(1)
        for s in opt.state.values():
            s["exp_avg"].add_(1.0)
    state, gen, t = replicate_to_mesh((state, gen, t), mesh)
    # the supervised step on a (1, world) space mesh: each rank a slab of
    # the leading spatial axis
    out["space_mesh"] = run_train_case(
        {"kind": "supervised", "names": (), "size": SPACE_SIZE[world]},
        make_spatial_mesh(1, world, device_type=device))
    out["replicated"] = {
        "state": {k: v.clone() for k, v in
                  model.module.state_dict().items()},
        "adam": [s["exp_avg"].clone() for s in opt.state.values()],
        "gen": torch.rand(4, generator=gen), "tensor": t}
    return out


# --------------------------------------- the data group's global quantities
GROUP_N = 4  # rows a rank


def _group_inputs(world):
    """Global-batch inputs of the data-group checks (numpy, seeded)."""
    r = np.random.RandomState(7)
    n = GROUP_N * world
    h = w = 12
    base = np.stack(np.meshgrid(np.linspace(-1, 1, w), np.linspace(-1, 1, h),
                                indexing="xy"), 0)[None].repeat(n, 0)
    # rank 0's flows stay within a pixel (JAX's stencil branch), the others
    # reach 3 px (its sampler branch); the border column stays exactly on -1
    px = np.where(np.arange(n) < GROUP_N, 0.8, 3.0)[:, None, None, None]
    u = (r.rand(n, 2, h, w) * 2 - 1) * px * 2 / (w - 1)
    u[:, 0, :, 0] = 0.0
    return {"x": r.randn(n, 3, 5, 6).astype(np.float32) * 2 + 1,
            "ct": r.randn(n, 3, 5, 6).astype(np.float32),
            "flow1": (base + 0.05 * r.randn(n, 2, h, w)).astype(np.float32),
            "flow2": (base + u).astype(np.float32),
            "flow_ct": r.randn(n, 2, h, w).astype(np.float32),
            # rank r's velocities scaled by 4^r: the step counts differ
            "duv": (r.randn(n, 3, 4, 6, 6) * np.repeat(
                4.0 ** np.arange(world), GROUP_N)[:, None, None, None,
                                                  None]).astype(np.float32),
            "logits": r.randn(n, 4, 7, 8).astype(np.float32),
            "ref": r.randn(n, 4, 7, 8).astype(np.float32),
            "mask": (r.rand(n, 1, 7, 8) > 0.2).astype(np.float32),
            "label": r.randint(0, 4, (n, 7, 8))}


def group_values(inputs, rows=slice(None)):
    """BatchNorm (forward, gradients, running statistics), a flow
    composition's grid gradient, the 3D step count, and the losses, on
    ``rows`` of the inputs: inside a data group, this rank's part."""
    from advchain_tpu_torch.losses import (calc_segmentation_consistency,
                                           cross_entropy)
    from advchain_tpu_torch.models.unet import FrozenStatsBN
    from advchain_tpu_torch.ops.integrate import (adaptive_step_count,
                                                  compose_flow)
    t = {k: torch.from_numpy(v[rows]) for k, v in inputs.items()}
    bn = FrozenStatsBN(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.5, 0.5, 2.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    bn.train()
    bn.write_back = True
    x = t["x"].requires_grad_(True)
    y = bn(x)
    (y * t["ct"]).sum().backward()
    flow2 = t["flow2"].requires_grad_(True)
    (compose_flow(t["flow1"], flow2) * t["flow_ct"]).sum().backward()
    out = {"bn_y": y.detach(), "bn_dx": x.grad,
           "bn_dw": bn.weight.grad, "bn_db": bn.bias.grad,
           "running": (bn.running_mean.clone(), bn.running_var.clone()),
           "d_flow2": flow2.grad,
           "steps": adaptive_step_count(t["duv"], 8)}
    for div in ("mse", "kl", "contour"):
        out[div] = float(calc_segmentation_consistency(
            t["logits"], t["ref"], divergence_types=[div],
            divergence_weights=[1.0], mask=t["mask"].expand(-1, 4, -1, -1)))
    out["ce"] = float(cross_entropy(t["logits"], t["label"]))
    return out


def group_rank(rank, world, device):
    """:func:`group_values` on this rank's rows inside its data group."""
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.parallel import make_mesh
    group = make_mesh(device_type=device).get_group("data")
    rows = slice(rank * GROUP_N, (rank + 1) * GROUP_N)
    with collectives.data_group(group, GROUP_N):
        return group_values(_group_inputs(world), rows)


def both_rank(rank, world, device):
    return {"mesh": mesh_rank(rank, world, device),
            "group": group_rank(rank, world, device)}


@pytest.fixture(scope="module")
def both_runs():
    return {world: run_ranks(both_rank, world) for world in (2, 4)}


@pytest.fixture(scope="module")
def mesh_runs(both_runs):
    return {w: [o["mesh"] for o in outs] for w, outs in both_runs.items()}


@pytest.fixture(scope="module")
def group_runs(both_runs):
    return {w: [o["group"] for o in outs] for w, outs in both_runs.items()}


@pytest.mark.parametrize("world", [2, 4])
def test_batch_norm_over_the_data_group(group_runs, world):
    """Two-pass global statistics: the forward, the input gradient and the
    running statistics of the global batch's BatchNorm; the weight and
    bias gradients sum over the ranks to the global ones."""
    ref = group_values(_group_inputs(world))
    outs = group_runs[world]
    for key in ("bn_y", "bn_dx"):
        np.testing.assert_allclose(torch.cat([o[key] for o in outs]).numpy(),
                                   ref[key].numpy(), rtol=1e-5, atol=1e-6)
    for key in ("bn_dw", "bn_db"):
        np.testing.assert_allclose(sum(o[key] for o in outs).numpy(),
                                   ref[key].numpy(), rtol=1e-5, atol=1e-6)
    for o in outs:
        for ours, want in zip(o["running"], ref["running"]):
            np.testing.assert_allclose(ours.numpy(), want.numpy(),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("world", [2, 4])
def test_dispatch_slope_and_step_count_over_the_data_group(group_runs,
                                                           world):
    """Rank 0's flows alone would take JAX's stencil branch (the whole
    slope at the border's exact -1 entries); the global batch takes the
    sampler's half, and so must each rank.  The 3D step count follows the
    global batch's norm, not the rank's."""
    ref = group_values(_group_inputs(world))
    outs = group_runs[world]
    ours = torch.cat([o["d_flow2"] for o in outs])
    np.testing.assert_allclose(ours.numpy(), ref["d_flow2"].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert [o["steps"] for o in outs] == [ref["steps"]] * world
    own = group_values(_group_inputs(world), slice(0, GROUP_N))
    assert own["steps"] != ref["steps"]  # the check can tell them apart
    assert not torch.allclose(own["d_flow2"], ref["d_flow2"][:GROUP_N])


@pytest.mark.parametrize("loss", ["mse", "kl", "contour", "ce"])
@pytest.mark.parametrize("world", [2, 4])
def test_loss_shares_sum_to_the_global_mean(group_runs, world, loss):
    """Each rank's loss is the mean over its rows (the mse quirk divides by
    the global batch's ``numel / C``); weighted by the rank's share of the
    global batch, as the train step weights it, the ranks' losses sum to
    the global batch's."""
    ref = group_values(_group_inputs(world))
    ours = sum(o[loss] / world for o in group_runs[world])
    assert ours == pytest.approx(ref[loss], rel=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_make_mesh_asserts_on_too_few_ranks(mesh_runs, world):
    for out in mesh_runs[world]:
        assert out["too_few"] == f"need {world + 1} devices, have {world}"


def test_make_mesh_without_a_group():
    from advchain_tpu_torch.parallel import make_mesh
    assert not dist.is_initialized()
    with pytest.raises(AssertionError, match="need 2 devices, have 1"):
        make_mesh(2, device_type="cpu")
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh(device_type="cpu")


@pytest.mark.parametrize("world", [2, 4])
def test_make_mesh_spans_the_ranks(mesh_runs, world):
    for rank, out in enumerate(mesh_runs[world]):
        assert out["mesh"] == (list(range(world)), ("data",), rank)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_rows(mesh_runs, world):
    full = _batch()
    rows = 8 // world
    for rank, out in enumerate(mesh_runs[world]):
        for key in ("image", "label"):
            want = torch.as_tensor(full[key][rank * rows:(rank + 1) * rows])
            assert torch.equal(out["shard"][key], want)
            assert torch.equal(out["local"][key], want)
            assert out["shard"][key].device.type == "cpu"


@pytest.mark.parametrize("world", [2, 4])
def test_replicate_to_mesh_after_a_perturbation(mesh_runs, world):
    ref = mesh_runs[world][0]["replicated"]
    for out in mesh_runs[world][1:]:
        got = out["replicated"]
        for k, v in ref["state"].items():
            assert torch.equal(got["state"][k], v), k
        for a, b in zip(got["adam"], ref["adam"]):
            assert torch.equal(a, b)
        assert torch.equal(got["gen"], ref["gen"])
        assert torch.equal(got["tensor"], torch.zeros(3))


@pytest.mark.parametrize("world", [2, 4])
def test_train_step_refuses_a_space_mesh(mesh_runs, world):
    """The step runs on a ('data', 'space') mesh whose space axis is every
    rank: the supervised step's loss and weights are the single-process
    step's at the JAX package's bounds, equal on every rank."""
    ref = run_train_case({"kind": "supervised", "names": (),
                          "size": SPACE_SIZE[world]})
    first = mesh_runs[world][0]["space_mesh"]
    for out in mesh_runs[world]:
        assert out["space_mesh"]["metrics"] == first["metrics"]
        for k, v in first["state"].items():
            assert torch.equal(out["space_mesh"]["state"][k], v), k
    assert first["metrics"][0]["total_loss"] == pytest.approx(
        ref["metrics"][0]["total_loss"], rel=1e-4)
    for k, v in ref["state"].items():
        np.testing.assert_allclose(first["state"][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_initialize_distributed_single_process(monkeypatch):
    from advchain_tpu_torch.parallel import initialize_distributed
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() == 0
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert initialize_distributed(backend="gloo") == 0
    assert not dist.is_initialized()


def test_parallel_all_matches_jax():
    import advchain_tpu.parallel as jpar
    import advchain_tpu_torch.parallel as tpar
    assert tpar.__all__ == jpar.__all__
    for name in tpar.__all__:
        assert callable(getattr(tpar, name)), name


# --------------------------------------------- the data-parallel train step
TRAIN_SIZE = [8, 1, 32, 32]
TRAIN_CONFIGS = {
    "noise": {"epsilon": 0.2, "xi": 1e-6},
    "bias": {"epsilon": 0.3, "control_point_spacing": [16, 16],
             "downscale": 2, "interpolation_order": 3, "init_mode": "random",
             "space": "log"},
    "affine": {"rot": 0.1, "scale_x": 0.1, "scale_y": 0.1, "shift_x": 0.1,
               "shift_y": 0.1},
    "morph": {"epsilon": 1.5, "vector_size": [2, 2]},
}
# the supervised step's image on a (1, world) space mesh: 16 planes a rank
SPACE_SIZE = {2: [4, 1, 32, 16], 4: [4, 1, 64, 16]}
# the 3D volume episode's chain (bench.py:363-382) at 4 x 1 x 8 x 16 x 16
TRAIN_SIZE_3D = [4, 1, 8, 16, 16]
TRAIN_CONFIGS_3D = {
    "noise": {"epsilon": 1.0, "xi": 1e-6},
    "bias": {"epsilon": 0.3, "control_point_spacing": [4, 8, 8],
             "downscale": 2, "interpolation_order": 3, "init_mode": "random",
             "space": "log"},
    "affine": {"rot_x": 10.0 / 180, "rot_y": 10.0 / 180, "rot_z": 10.0 / 180,
               "scale_x": 0.1, "scale_y": 0.1, "scale_z": 0.1,
               "shift_x": 0.1, "shift_y": 0.1, "shift_z": 0.1},
    "morph": {"epsilon": 1.5, "vector_size": [4, 2, 2]},
}
TRAIN_CLASSES = {"noise": "AdvNoise", "bias": "AdvBias",
                 "affine": "AdvAffine", "morph": "AdvMorph"}


def train_batch(size=TRAIN_SIZE, seed=0):
    """A smooth blob with noise, and random labels (numpy)."""
    r = np.random.RandomState(seed)
    n, spatial = size[0], tuple(size[2:])
    axes = np.meshgrid(*[np.linspace(-1, 1, s) for s in spatial],
                       indexing="ij")
    blob = np.exp(-sum((a / w) ** 2 for a, w in zip(axes, (0.5, 0.4, 0.6))))
    img = (blob[None, None] + 0.05 * r.rand(n, 1, *spatial)).astype(
        np.float32)
    return {"image": img, "label": r.randint(0, 4, (n,) + spatial)}


def train_parts(names, state_dict=None, opt="sgd", lr=1e-2,
                divergences=("mse", "contour"), if_norm_image=False,
                dropout=None, dims=2):
    """(model, solver, optimizer) of a test step: UNet feature_scale 16
    (``dims`` 2) or PseudoConv3dModel (3), seeded weights (or
    ``state_dict``), ``dropout`` in the encoder and decoder (None: none),
    the chain ``names``."""
    from advchain_tpu_torch import augmentor as taug
    from advchain_tpu_torch.models import (PseudoConv3dModel,
                                           SegmentationModel, UNet)
    if dims == 3:
        module = PseudoConv3dModel(num_classes=4, dropout=dropout or 0.0)
        size, configs = TRAIN_SIZE_3D, TRAIN_CONFIGS_3D
    else:
        module = UNet(input_channel=1, num_classes=4, feature_scale=16,
                      encoder_dropout=dropout, decoder_dropout=dropout)
        size, configs = TRAIN_SIZE, TRAIN_CONFIGS
    model = SegmentationModel.create(module, seed=3, device="cpu")
    if state_dict is not None:
        model.module.load_state_dict(state_dict)
    chain = [getattr(taug, TRAIN_CLASSES[n])(
        spatial_dims=dims, config_dict=dict(configs[n], data_size=size))
        for n in names]
    solver = taug.ComposeAdversarialTransformSolver(
        chain_of_transforms=chain, divergence_types=list(divergences),
        divergence_weights=[1.0, 0.5][:len(divergences)],
        if_norm_image=if_norm_image)
    optim = (torch.optim.SGD if opt == "sgd" else torch.optim.Adam)(
        model.module.parameters(), lr=lr)
    return model, solver, optim


def run_train_case(case, mesh=None, rows=slice(None)):
    """One case's steps: on the whole batch without a mesh, or on ``rows``
    with one (on a mesh whose space axis is larger than 1, on this rank's
    block, ``shard_batch_spatial``).  ``case["size"]`` overrides the
    batch's size.  Returns per-step metrics, the weights and buffers after the
    last step and the gradients that step applied.  ``case["float64"]``
    runs the case with float64 as the default dtype; ``case["perturb"]``
    scales the image by ``1 + perturb * randn`` (seeded)."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64 if case.get("float64")
                            else torch.float32)
    try:
        return _run_train_case(case, mesh, rows)
    finally:
        torch.set_default_dtype(prev)


def _run_train_case(case, mesh, rows):
    from advchain_tpu_torch.parallel import (TrainState,
                                             make_adversarial_train_step,
                                             make_supervised_train_step,
                                             shard_batch_spatial)
    model, solver, opt = train_parts(
        case["names"], case.get("state_dict"), case.get("opt", "sgd"),
        case.get("lr", 1e-2), case.get("divergences", ("mse", "contour")),
        case.get("if_norm_image", False), case.get("dropout"),
        case.get("dims", 2))
    # "torch_ce": a plain torch mean over the batch, as a user would write
    loss_fn = (torch.nn.functional.cross_entropy
               if case.get("loss") == "torch_ce" else None)
    if case["kind"] == "supervised":
        step = make_supervised_train_step(model, opt, loss_fn, mesh=mesh)
    else:
        step = make_adversarial_train_step(
            model, solver, opt, n_iter=case.get("n_iter", 1),
            power_iteration="smart", supervised_loss_fn=loss_fn, mesh=mesh)
    draws = case.get("draws")
    batch = train_batch(case.get("size") or (
        TRAIN_SIZE_3D if case.get("dims") == 3 else TRAIN_SIZE))
    image = batch["image"]
    if case.get("perturb"):
        image = image * (1 + case["perturb"] * np.random.RandomState(
            5).randn(*image.shape))
    names = () if mesh is None else tuple(mesh.mesh_dim_names)
    if "space" in names and mesh.size(names.index("space")) > 1:
        batch = shard_batch_spatial(
            {"image": torch.from_numpy(image).to(torch.get_default_dtype()),
             "label": torch.from_numpy(batch["label"]).long()}, mesh)
    else:
        batch = {"image": torch.from_numpy(image[rows]).to(
                     torch.get_default_dtype()),
                 "label": torch.from_numpy(batch["label"][rows]).long()}
    state = TrainState.create(model, opt)
    metrics = []
    for i in range(case.get("steps", 1)):
        if draws is not None:  # the JAX step's draws, injected
            for t, d in zip(solver.chain_of_transforms, draws[i]):
                t.init_params = (lambda gen, device=None,
                                 _d=torch.from_numpy(d): _d.to(device))
        state, m = step(state, batch, torch.Generator().manual_seed(7 + i))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "state": {k: v.detach().clone() for k, v in
                      model.module.state_dict().items()},
            # the last step's gradients, summed over the ranks with a mesh
            "grads": {k: p.grad.detach().clone() for k, p in
                      model.module.named_parameters() if p.grad is not None}}


def train_rank(rank, world, device, cases):
    """Every case's data-parallel steps on this rank's rows."""
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.parallel import make_mesh, make_spatial_mesh
    meshes = {"1d": make_mesh(device_type=device),
              # ('data', 'space') with space 1: the data axis is every rank
              "2d": make_spatial_mesh(world, 1, device_type=device),
              # and with space 2: each rank a slab of half the height
              "space": make_spatial_mesh(world // 2, 2, device_type=device)}
    out = {}
    for name, case in cases.items():
        n = (TRAIN_SIZE_3D if case.get("dims") == 3 else TRAIN_SIZE)[0]
        # rows per rank: even, or ``case["uneven"]`` (one list per world)
        counts = case.get("uneven", {}).get(world, [n // world] * world)
        start = sum(counts[:rank])
        collectives.reset_counts()
        out[name] = run_train_case(case, meshes[case.get("mesh", "1d")],
                                   slice(start, start + counts[rank]))
        out[name]["collectives"] = dict(collectives.COUNTS)
    return out
