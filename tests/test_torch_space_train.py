"""The port's spatially partitioned train step (``parallel.train`` on a
``('data', 'space')`` mesh whose ``space`` axis is larger than 1) on 2 and
4 spawned CPU ranks over gloo, against the port's single-process step and
the JAX package's own spatial-mesh step (``advchain_tpu/parallel/
train.py:57-95``, on the virtual CPU devices of tests/conftest.py).

One spawn per world size runs every case (``space_rank``, which imports
neither JAX nor the JAX package): on 2 ranks the ``(1, 2)`` mesh at batch 4,
32x32, and the 3D chain on PseudoConv3dModel at 2 x 1 x 8 x 16 x 16; on 4
ranks the ``(2, 2)`` mesh at 32x32 and the ``(1, 4)`` mesh at 64x64, the
op-level cases, and a level that a max-pool cannot halve.  The 2D chains
(UNet feature_scale 16, SGD 1e-2): JAX's test chain (noise + affine, mse); noise + bias + affine
with mse + contour; the full chain with mse + contour; the full chain
without its PGD step in float64; the full chain with mse and dropout 0.1;
the supervised step.

The reference is the single-process step with its compositions on the
sampler (``ops.integrate.sampler_compositions``: border padding, no
stencil), JAX's ``ADVCHAIN_STENCIL=0``, which the JAX package's spatial
step is too (integrate.py:52-64).  The port's default single-process step
composes on the stencil kernel, whose f32 rounding differs from the
sampler's (by up to 1.5 ulp); where the validity mask is binarised
(``mask != 0``) under the contour divergence, that moves pixels on the
mask's edge, and the full chain's consistency loss on (2, 2) then differs
by 4.2e-3 (the gradients by 0.23 relative L2) from the stencil step,
against 4e-7 from the sampler step.  The morph-free chains are also held
against the default step.

Tolerances, each with its reason:
  * Against the single-process step, the JAX package's bounds
    (tests/test_spatial.py:245-301): ``total_loss`` rtol 1e-4,
    ``consistency_loss`` rtol 1e-3, the weights and running statistics
    rtol 1e-4 / atol 1e-5; every rank's metrics and weights equal.
  * The applied gradients (summed over the ranks): relative L2 within 1e-4
    (measured at most 7.2e-6), except where a PGD step feeds the contour
    divergence over the binarised mask (the contour and full chains,
    measured 1.0e-5 to 1.5e-2): there, as in tests/test_torch_train.py's
    headline step, within 3x the single-process step's own gap under a
    1e-7 relative input perturbation, and the weights are not held (their
    update is 10^-2 of those gradients).
  * Against JAX's spatial-mesh step, every 2D chain on (2, 2) and the 3D
    chain on (1, 2), with the Flax weights carried over and JAX's draws
    injected (Adam 1e-3; the dropout chain replays JAX's dropout masks,
    each rank its rows and slab; JAX runs the float64 chain in float32):
    tests/test_torch_train.py's first-step tolerances.  The supervised
    loss within 1e-5.  The consistency loss within 1e-4 and the total
    within 1e-4 on the morph-free chains; with the morph, whose fields
    differ from JAX's by f32 rounding over its squarings (ROADMAP §3),
    that file's morph bounds, 0.12 and 1.2e-2 (measured at most 3.7e-2
    and 1.8e-3, on the full chain).  Each weight within 2 lr, and the
    update's relative L2 error below 0.1 (measured 0.019 to 0.071), but
    0.2 on the 3D chain (measured 0.091, within a tenth of 0.1) and none
    where the PGD step feeds the contour divergence (the contour and full
    chains: 0.15 and 0.59 measured, the mask's edge again).
  * Op-level cases on the (2, 2) mesh, each rank's slab against the dense
    op's: 1e-6 of the largest entry (halo convolution and its input
    gradient, ``Up``, BatchNorm over data x space with its gradients and
    running statistics, the dropout mask, the per-sample l2 norm over
    space, the B-spline and resize rows, the affine and base grid rows),
    and ``compose_flow`` under the space group against JAX's sampler route
    (``ADVCHAIN_STENCIL=0``) on both of the sharded sampler's routes, with
    both gradients, 1e-5 of the largest entry (the sampler's own bound
    against JAX, tests/test_torch_spatial.py).  ``unit_normalize(...,
    sharded=True)`` refuses the l1 and infinity norms and an input that
    requires a gradient.
  * No UNet activation on a rank holds more than its slab plus two halo
    planes (a forward hook on every module).
"""


import numpy as np
import pytest
import torch

from test_torch_mesh import (TRAIN_CLASSES, TRAIN_CONFIGS, TRAIN_CONFIGS_3D,
                             run_ranks, train_batch)
import torch_threads  # noqa: F401  (one intra-op thread a process)

FULL = ("noise", "bias", "affine", "morph")
SIZE = {32: [4, 1, 32, 32], 64: [4, 1, 64, 64], 3: [2, 1, 8, 16, 16]}
CHAINS = {
    "jax_chain": {"kind": "adversarial", "names": ("noise", "affine"),
                  "divergences": ("mse",)},
    "contour": {"kind": "adversarial", "names": ("noise", "bias", "affine")},
    "full": {"kind": "adversarial", "names": FULL},
    "full_no_pgd_f64": {"kind": "adversarial", "names": FULL, "n_iter": 0,
                        "float64": True},
    "dropout": {"kind": "adversarial", "names": FULL,
                "divergences": ("mse",), "dropout": 0.1},
    "supervised": {"kind": "supervised", "names": ()},
}
# the meshes (n_data, n_space) and image sizes each world runs the chains on
MESHES = {2: {"1x2": ((1, 2), 32)}, 4: {"2x2": ((2, 2), 32),
                                        "1x4": ((1, 4), 64)}}
VOLUME = {"kind": "adversarial", "names": FULL, "dims": 3,
          "divergences": ("mse",), "dropout": 0.1, "mesh": (1, 2),
          "size": SIZE[3]}
# a PGD step feeds the contour divergence over the binarised mask
PGD_CONTOUR = ("contour", "full")
MORPH_FREE = ("jax_chain", "contour", "supervised")
JAX_CHAINS = ("jax_chain", "contour", "full", "full_no_pgd_f64", "dropout",
              "supervised")
LR_JAX = 1e-3
PERTURB = 1e-7


def _cases(world):
    """Every train case of a world: the chains on its meshes, and on 2
    ranks the volume."""
    out = {}
    for mesh_name, (shape, size) in MESHES[world].items():
        for name, chain in CHAINS.items():
            out[f"{mesh_name}/{name}"] = dict(chain, mesh=shape,
                                              size=SIZE[size])
    if world == 2:
        out["1x2/volume"] = dict(VOLUME)
    return out


# ------------------------------------------------------- one train case
def space_parts(case, state_dict=None):
    """(model, solver, optimizer): UNet feature_scale 16,
    PseudoConv3dModel (``case["dims"]`` 3) or ``case["net"]()``, seeded
    weights (a self-attention's ``gamma`` set to ``case["gamma"]``) or
    ``state_dict``, the chain at ``case["size"]``, SGD 1e-2 or Adam."""
    from advchain_tpu_torch import augmentor as taug
    from advchain_tpu_torch.models import (PseudoConv3dModel,
                                           SegmentationModel, UNet)
    dims = case.get("dims", 2)
    if dims == 3:
        module = PseudoConv3dModel(num_classes=4,
                                   dropout=case.get("dropout") or 0.0)
        configs = TRAIN_CONFIGS_3D
    elif case.get("net") is not None:  # a picklable factory of the network
        module = case["net"]()
        configs = TRAIN_CONFIGS
    else:
        module = UNet(input_channel=1, num_classes=4, feature_scale=16,
                      encoder_dropout=case.get("dropout"),
                      decoder_dropout=case.get("dropout"))
        configs = TRAIN_CONFIGS
    model = SegmentationModel.create(module, seed=3, device="cpu")
    if case.get("gamma") is not None:  # the self-attention's, off its 0
        with torch.no_grad():
            model.module.self_atn.gamma.fill_(case["gamma"])
    if state_dict is not None:
        model.module.load_state_dict(state_dict)
    chain = [getattr(taug, TRAIN_CLASSES[n])(
        spatial_dims=dims, config_dict=dict(configs[n],
                                            data_size=case["size"]))
        for n in case["names"]]
    divs = case.get("divergences", ("mse", "contour"))
    solver = taug.ComposeAdversarialTransformSolver(
        chain_of_transforms=chain, divergence_types=list(divs),
        divergence_weights=[1.0, 0.5][:len(divs)])
    opt = (torch.optim.Adam(model.module.parameters(), lr=LR_JAX)
           if case.get("opt") == "adam"
           else torch.optim.SGD(model.module.parameters(), lr=1e-2))
    return model, solver, opt


def run_space_case(case, mesh=None):
    """One step of ``case``: on the whole batch without a mesh, or on this
    rank's block (``shard_batch_spatial``) with one.  Returns the metrics,
    the weights and buffers after it, the gradients it applied, and each
    module's largest output extent on the leading spatial axis."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64 if case.get("float64")
                            else torch.float32)
    try:
        return _run_space_case(case, mesh)
    finally:
        torch.set_default_dtype(prev)


def _run_space_case(case, mesh):
    from advchain_tpu_torch.parallel import (TrainState,
                                             make_adversarial_train_step,
                                             make_supervised_train_step,
                                             shard_batch_spatial)
    model, solver, opt = space_parts(case, case.get("state_dict"))
    if case["kind"] == "supervised":
        step = make_supervised_train_step(model, opt, mesh=mesh)
    else:
        step = make_adversarial_train_step(
            model, solver, opt, n_iter=case.get("n_iter", 1),
            power_iteration="smart", mesh=mesh)
    if case.get("draws") is not None:  # JAX's draws, injected
        for t, d in zip(solver.chain_of_transforms, case["draws"]):
            t.init_params = (lambda gen, device=None,
                             _d=torch.from_numpy(d): _d.to(
                                 device, torch.get_default_dtype()))
    raw = train_batch(case["size"])
    image = raw["image"]
    if case.get("perturb"):
        image = image * (1 + case["perturb"] * np.random.RandomState(
            5).randn(*image.shape))
    batch = {"image": torch.from_numpy(image).to(torch.get_default_dtype()),
             "label": torch.from_numpy(raw["label"]).long()}
    if mesh is not None:
        batch = shard_batch_spatial(batch, mesh)
    extents = {}

    def record(name):
        def hook(module, inputs, output):
            if isinstance(output, torch.Tensor) and output.dim() > 2:
                extents[name] = max(extents.get(name, 0), output.shape[2])
        return hook

    hooks = [m.register_forward_hook(record(name))
             for name, m in model.module.named_modules() if name]
    replayed = {}
    if case.get("masks") is not None:  # JAX's dropout masks, replayed
        hooks += _replay_masks(model.module, case["masks"], replayed)
    try:
        state, metrics = step(TrainState.create(model, opt), batch,
                              torch.Generator().manual_seed(7))
    finally:
        for h in hooks:
            h.remove()
    if case.get("masks") is not None:
        assert len(replayed) == len(case["masks"]), len(replayed)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.detach().clone() for k, v in
                      model.module.state_dict().items()},
            "grads": {k: p.grad.detach().clone() for k, p in
                      model.module.named_parameters() if p.grad is not None},
            "extents": extents}


def _replay_masks(module, masks, order):
    """Forward pre-hooks that hand each active ``EpisodeDropout`` of
    ``module`` its mask of ``masks`` (the global batch's, in the order of
    the dropouts' first calls, which ``order`` records), or inside a data
    group this rank's rows and slab of it."""
    from advchain_tpu_torch.models.unet import EpisodeDropout
    from advchain_tpu_torch.ops import collectives

    def take(m, args):
        mask = torch.from_numpy(masks[order.setdefault(m, len(order))])
        dg = collectives.current_data_group()
        if dg is not None:
            mask = dg.rows(mask)
            if dg.space is not None:
                mask = dg.space.slab(mask)
        m._mask = mask

    return [m.register_forward_pre_hook(take) for m in module.modules()
            if isinstance(m, EpisodeDropout) and m.p > 0]


# ---------------------------------------------------- the op-level cases
OP_SEED = 17


def op_inputs():
    """Global inputs of the op-level cases (numpy, seeded): 4 rows at
    16 x 12, split (2, 2) into 2 rows x 8 planes a rank."""
    r = np.random.RandomState(OP_SEED)
    h, w = 16, 12
    base = np.stack(np.meshgrid(np.linspace(-1, 1, w), np.linspace(-1, 1, h),
                                indexing="xy"), 0)[None].repeat(4, 0)
    flow = lambda amp: (base + amp * (r.rand(4, 2, h, w) * 2 - 1)) \
        .astype(np.float32)  # noqa: E731
    return {"x": r.randn(4, 3, h, w).astype(np.float32),
            "ct": r.randn(4, 5, h, w).astype(np.float32),
            "w": (0.3 * r.randn(5, 3, 3, 3)).astype(np.float32),
            "low": r.randn(4, 8, h // 2, w // 2).astype(np.float32),
            "skip": r.randn(4, 8, h, w).astype(np.float32),
            "up_ct": r.randn(4, 4, h, w).astype(np.float32),
            "bn_ct": r.randn(4, 3, h, w).astype(np.float32),
            "vel": r.randn(4, 2, 3, 4).astype(np.float32),
            "cp": (0.3 * r.randn(4, 1, *_bspline_spec().cp_grid)).astype(
                np.float32),
            "theta": (np.eye(2, 3)[None] + 0.2 * r.randn(4, 2, 3)).astype(
                np.float32),
            "theta3": (np.eye(3, 4)[None] + 0.2 * r.randn(4, 3, 4)).astype(
                np.float32),
            "flow1": flow(0.3), "flow2": np.clip(flow(0.08), -1, 1),
            "flow_ct": r.randn(4, 2, h, w).astype(np.float32)}


OP_BSPLINE = {"image_size": (16, 12), "control_point_spacing": (8, 8),
              "downscale": 2}
OP_MAX_DISP = 0.2   # the halo route's bound: 3 planes of 16 (a slab is 8)


def _bspline_spec():
    from advchain_tpu_torch.ops import make_bspline_field_spec
    return make_bspline_field_spec(**OP_BSPLINE)


def op_values(t):
    """Every op-level case but the compositions on ``t`` (global tensors,
    or this rank's rows and slab inside a data group with a space
    group)."""
    from advchain_tpu_torch.models.unet import (EpisodeDropout,
                                                FrozenStatsBN, Up)
    from advchain_tpu_torch.ops import (affine_grid, base_grid, conv_same,
                                        evaluate_bspline_field, interpolate,
                                        norms)
    out = {}
    x = t["x"].clone().requires_grad_(True)
    y = conv_same(x, t["w"])
    (y * t["ct"]).sum().backward()
    out.update(conv=y.detach(), conv_dx=x.grad)
    torch.manual_seed(0)
    up = Up(16, 4)
    up.train()
    low = t["low"].clone().requires_grad_(True)
    y = up(low, t["skip"])
    (y * t["up_ct"]).sum().backward()
    out.update(up=y.detach(), up_dlow=low.grad)
    bn = FrozenStatsBN(3)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.5, 0.5, 2.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    bn.train()
    bn.write_back = True
    x = t["x"].clone().requires_grad_(True)
    y = bn(x)
    (y * t["bn_ct"]).sum().backward()
    out.update(bn=y.detach(), bn_dx=x.grad, bn_dw=bn.weight.grad,
               bn_db=bn.bias.grad, bn_mean=bn.running_mean.clone(),
               bn_var=bn.running_var.clone())
    drop = EpisodeDropout(0.3)
    drop.train()
    drop.redraw(5)
    out["dropout"] = drop(torch.ones_like(t["x"]))
    out["unit_l2"] = norms.unit_normalize(t["x"], "l2", sharded=True)
    out["bspline"] = evaluate_bspline_field(t["cp"], _bspline_spec())
    out["resize"] = interpolate(t["vel"], size=(16, 12), mode="bilinear",
                                align_corners=False)
    n, _, h, w = t["x"].shape
    out["affine"] = affine_grid(t["theta"], (n, 1, h, w))
    out["affine3"] = affine_grid(t["theta3"], (n, 1, h, 3, w))
    out["base"] = base_grid(n, (h, w))
    return out


def compose_values(t):
    """``compose_flow`` and both its gradients."""
    from advchain_tpu_torch.ops.integrate import compose_flow
    f1 = t["flow1"].clone().requires_grad_(True)
    f2 = t["flow2"].clone().requires_grad_(True)
    y = compose_flow(f1, f2)
    (y * t["flow_ct"]).sum().backward()
    return y.detach(), f1.grad, f2.grad


def op_rank(mesh):
    """:func:`op_values` on this rank's rows and slab inside the mesh's
    data group with its space group, and :func:`compose_values` on both of
    the sharded sampler's routes: no bound (the source gathered) and
    ``OP_MAX_DISP`` (halos exchanged)."""
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.parallel.mesh import every_rank_group
    data_idx = mesh.get_local_rank("data")
    n_data = mesh.size(0)
    glob = {k: torch.from_numpy(v) for k, v in op_inputs().items()}
    rows = 4 // n_data
    local = {}
    for k, v in glob.items():
        part = v[data_idx * rows:(data_idx + 1) * rows]
        if k == "w":
            local[k] = v
        elif k in ("theta", "theta3", "vel", "cp"):  # replicated over space
            local[k] = part
        else:
            s_idx, n_space = mesh.get_local_rank("space"), mesh.size(1)
            step = v.shape[2] // n_space
            local[k] = part.narrow(2, s_idx * step, step)
    out = {}
    for route, bound in (("gather", None), ("halo", OP_MAX_DISP)):
        space = collectives.SpaceGroup(
            mesh.get_group("space"), mesh.size(1),
            mesh.get_local_rank("space"), mesh, bound)
        with collectives.data_group(mesh.get_group("data"), rows,
                                    space=space,
                                    reduce_group=every_rank_group(mesh)):
            if route == "gather":
                out.update(op_values(local))
                out["norm_refusals"] = norm_refusals(local["x"])
            out[f"compose_{route}"] = compose_values(local)
    return out


def norm_refusals(x):
    """What ``unit_normalize(..., sharded=True)`` refuses inside a space
    group: the l1 and infinity norms, and an input that requires a
    gradient (its reduction carries none)."""
    from advchain_tpu_torch.ops import norms
    out = {}
    for name, args in (("l1", (x, "l1")), ("infinity", (x, "infinity")),
                       ("requires_grad", (x.clone().requires_grad_(True),
                                          "l2"))):
        try:
            norms.unit_normalize(*args, sharded=True)
        except ValueError as e:
            out[name] = str(e)
    return out


# ------------------------------------------------------------ the ranks
LEVEL_SIZE = [4, 1, 40, 32]  # 40 rows: slabs of 20, 10, 5, then a pool


def level_values(mesh=None):
    """UNet feature_scale 16 (seeded) in training mode on a 40 x 32 image,
    whose third level a 2 x 2 max-pool cannot halve on (2, 2) (its skip
    is cropped too): the output and the input gradient of ``sum(out *
    ct)``; with a mesh, this rank's rows and slab of them."""
    from advchain_tpu_torch.models import UNet
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.parallel.mesh import every_rank_group
    torch.manual_seed(0)
    net = UNet(1, 4, feature_scale=16)
    net.train()
    image = torch.from_numpy(train_batch(LEVEL_SIZE)["image"])
    ct = torch.from_numpy(np.random.RandomState(3).randn(4, 4, 32, 32)
                          .astype(np.float32))
    if mesh is None:
        x = image.requires_grad_(True)
        y = net(x)
        (y * ct).sum().backward()
        return y.detach(), x.grad
    rows = 4 // mesh.size(0)
    lo = mesh.get_local_rank("data") * rows
    space = collectives.SpaceGroup(mesh.get_group("space"), mesh.size(1),
                                   mesh.get_local_rank("space"), mesh)
    with collectives.data_group(mesh.get_group("data"), rows, space=space,
                                reduce_group=every_rank_group(mesh)):
        sg = collectives.current_space()
        x = sg.slab(image[lo:lo + rows]).clone().requires_grad_(True)
        y = net(x)
        (y * sg.take(ct[lo:lo + rows], sg.level(y))).sum().backward()
    return y.detach(), x.grad


def refusals(mesh):
    """The step on a space mesh: a UNet level that a max-pool cannot halve
    (:func:`level_values`), and the self-attention, UNetv2 and
    DeeplySupervisedUNet (each one supervised step, its total loss)."""
    from advchain_tpu_torch.models import (DeeplySupervisedUNet,
                                           SegmentationModel, UNet, UNetv2)
    from advchain_tpu_torch.parallel import (TrainState,
                                             make_supervised_train_step,
                                             shard_batch_spatial)
    nets = {"self_attention": (UNet(1, 4, feature_scale=16,
                                    self_attention=True), 32),
            "unetv2": (UNetv2(1, 4, feature_scale=16), 32),
            "deeply_supervised": (DeeplySupervisedUNet(1, 4,
                                                       base_n_filters=4),
                                  32)}
    out = {}
    for name, (module, h) in nets.items():
        model = SegmentationModel.create(module, seed=0, device="cpu")
        opt = torch.optim.SGD(model.module.parameters(), lr=1e-2)
        step = make_supervised_train_step(model, opt, mesh=mesh)
        raw = train_batch([4, 1, h, 32])
        batch = shard_batch_spatial(
            {"image": torch.from_numpy(raw["image"]),
             "label": torch.from_numpy(raw["label"]).long()}, mesh)
        try:
            _, metrics = step(TrainState.create(model, opt), batch)
        except (ValueError, NotImplementedError) as e:
            out[name] = (type(e).__name__, str(e))
        else:
            out[name] = ("ran", float(metrics["total_loss"]))
    out["level"] = level_values(mesh)
    return out


def space_rank(rank, world, device, cases):
    """Every train case of this world on its mesh, and on 4 ranks the
    op-level cases and the refusals on (2, 2)."""
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.parallel import make_spatial_mesh
    meshes = {}
    out = {}
    for name, case in cases.items():
        shape = case["mesh"]
        if shape not in meshes:
            meshes[shape] = make_spatial_mesh(*shape, device_type=device)
        collectives.reset_counts()
        out[name] = run_space_case(case, meshes[shape])
        out[name]["collectives"] = dict(collectives.COUNTS)
    if world == 4:
        out["ops"] = op_rank(meshes[(2, 2)])
        out["refusals"] = refusals(meshes[(2, 2)])
    return out


# ----------------------------------------------------- the JAX cases
def _jax_masks(jmodel, image, key):
    """The masks of JAX's dropout calls in a training forward under the
    dropout key ``key``, in call order, NCHW (each drawn on ones: a mask
    depends on the key and the shape alone)."""
    import flax.linen as fnn
    import jax.numpy as jnp
    masks = []

    def record(next_fun, args, kw, context):
        if not isinstance(context.module, fnn.Dropout):
            return next_fun(*args, **kw)
        out = next_fun(jnp.ones_like(args[0]), *args[1:], **kw)
        masks.append(np.moveaxis(np.asarray(out != 0), -1, 1))
        return out

    with fnn.intercept_methods(record):
        jmodel.module.apply(jmodel._variables(), jnp.asarray(image),
                            train=True, rngs={"dropout": key},
                            mutable=["batch_stats"])
    return masks


def _jax_cases():
    """The 2D chains and the supervised step on (2, 2) at 32x32, and the 3D
    chain (dropout 0) on (1, 2), as the JAX package's spatial step runs
    them: carried Flax weights, JAX's draws of step 0 (``fold_in(rng,
    0)``) and, on the dropout chain, its dropout masks, Adam 1e-3.  JAX
    runs the float64 chain in float32.  Returns {name: (port case, JAX
    model, JAX solver or None, rng)}."""
    import jax
    from advchain_tpu import augmentor as jaug
    from advchain_tpu.models import PseudoConv3dModel as FlaxPseudo3d
    from advchain_tpu.models import SegmentationModel as JaxModel
    from advchain_tpu.models import UNet as FlaxUNet
    from advchain_tpu_torch.models import (flax_pseudo3d_to_torch_state,
                                           flax_unet_to_torch_state)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    rng = jax.random.PRNGKey(42)
    out = {}
    for name in JAX_CHAINS + ("volume",):
        if name == "volume":
            case = dict(VOLUME, dropout=0.0)
            jmodel = JaxModel.create(FlaxPseudo3d(num_classes=4, dropout=0.0),
                                     tuple(case["size"]),
                                     rng=jax.random.PRNGKey(0))
            state = flax_pseudo3d_to_torch_state(tree(jmodel.params),
                                                 tree(jmodel.batch_stats))
            configs, dims = TRAIN_CONFIGS_3D, 3
        else:
            case = dict(CHAINS[name], mesh=(2, 2), size=SIZE[32])
            jmodel = JaxModel.create(FlaxUNet(
                input_channel=1, num_classes=4, feature_scale=16,
                encoder_dropout=case.get("dropout"),
                decoder_dropout=case.get("dropout")),
                tuple(case["size"]), rng=jax.random.PRNGKey(0))
            state = flax_unet_to_torch_state(tree(jmodel.params),
                                             tree(jmodel.batch_stats))
            configs, dims = TRAIN_CONFIGS, 2
        jsolver, draws = None, None
        if case["kind"] == "adversarial":
            chain = [getattr(jaug, TRAIN_CLASSES[n])(
                spatial_dims=dims, config_dict=dict(
                    configs[n], data_size=list(case["size"])))
                for n in case["names"]]
            divs = list(case.get("divergences", ("mse", "contour")))
            jsolver = jaug.ComposeAdversarialTransformSolver(
                chain_of_transforms=chain, divergence_types=divs,
                divergence_weights=[1.0, 0.5][:len(divs)])
            k_drop, k_init = jax.random.split(jax.random.fold_in(rng, 0))
            keys = jax.random.split(k_init, len(chain))
            draws = [np.array(t.init_params(k)) for t, k in zip(chain, keys)]
            if case.get("dropout"):
                case["masks"] = _jax_masks(
                    jmodel, train_batch(case["size"])["image"], k_drop)
        case.update(opt="adam", state_dict=state, draws=draws)
        out[name] = (case, jmodel, jsolver, rng)
    return out


def _jax_step(name, jmodel, jsolver, rng, case, cpu_devices):
    """JAX's spatial-mesh step on the case's mesh: (metrics, the carried
    weights after it)."""
    import jax.numpy as jnp
    import optax
    from advchain_tpu.parallel import (TrainState,
                                       make_adversarial_train_step,
                                       make_spatial_mesh, replicate_to_mesh,
                                       shard_batch_spatial)
    from advchain_tpu.parallel import make_supervised_train_step
    from advchain_tpu_torch.models import (flax_pseudo3d_to_torch_state,
                                           flax_unet_to_torch_state)
    import jax
    mesh = make_spatial_mesh(*case["mesh"], devices=cpu_devices)
    opt = optax.adam(LR_JAX)
    if jsolver is None:
        step = make_supervised_train_step(jmodel, opt, mesh=mesh,
                                          donate_state=False)
    else:
        step = make_adversarial_train_step(jmodel, jsolver, opt,
                                           n_iter=case.get("n_iter", 1),
                                           power_iteration="smart",
                                           mesh=mesh, donate_state=False)
    raw = train_batch(case["size"])
    batch = shard_batch_spatial({"image": jnp.asarray(raw["image"]),
                                 "label": jnp.asarray(raw["label"])}, mesh)
    state = replicate_to_mesh(TrainState.create(jmodel, opt), mesh)
    state, metrics = step(state, batch, replicate_to_mesh(rng, mesh))
    convert = (flax_pseudo3d_to_torch_state if name == "volume"
               else flax_unet_to_torch_state)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return ({k: float(v) for k, v in metrics.items()},
            convert(tree(state.params), tree(state.batch_stats)))


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def space_runs():
    """Each world's ranks on every case (one spawn per world, the JAX
    cases' port sides among them), and the single-process references."""
    jax_cases = _jax_cases()
    runs = {}
    for world in (2, 4):
        cases = _cases(world)
        for name, (case, *_) in jax_cases.items():
            if (name == "volume") == (world == 2):
                cases[f"jax/{name}"] = case
        runs[world] = run_ranks(space_rank, world, cases)
    from advchain_tpu_torch.ops.integrate import sampler_compositions
    refs = {}
    with sampler_compositions():
        for world in (2, 4):
            for name, case in _cases(world).items():
                key = (tuple(case["size"]), name.split("/")[1])
                if key in refs:
                    continue
                refs[key] = run_space_case(case)
                if key[1] in PGD_CONTOUR:
                    refs[key + ("perturbed",)] = run_space_case(
                        dict(case, perturb=PERTURB))
    defaults = {(32, name): run_space_case(dict(CHAINS[name], size=SIZE[32]))
                for name in MORPH_FREE}
    return runs, refs, defaults, jax_cases


TRAIN_IDS = [(world, f"{m}/{c}") for world in (2, 4)
             for m in MESHES[world] for c in CHAINS] + [(2, "1x2/volume")]


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _rel_l2(grads, ref):
    diff = torch.cat([(grads[k] - v).double().flatten()
                      for k, v in ref.items()])
    return float(diff.norm() / torch.cat([v.double().flatten()
                                          for v in ref.values()]).norm())


def _ref(refs, case_name, runs_case):
    return refs[(tuple(runs_case["size"]), case_name.split("/")[1])]


def _replicated(outs, name):
    """Every rank's metrics and weights equal; returns rank 0's run."""
    first = outs[0][name]
    for out in outs[1:]:
        assert out[name]["metrics"] == first["metrics"], name
        for k, v in first["state"].items():
            assert torch.equal(out[name]["state"][k], v), (name, k)
    return first


def _losses_close(ours, want):
    assert _rel(ours["total_loss"], want["total_loss"]) < 1e-4
    if "consistency_loss" in want:
        assert _rel(ours["consistency_loss"],
                    want["consistency_loss"]) < 1e-3
        assert _rel(ours["supervised_loss"], want["supervised_loss"]) < 1e-4


def _state_close(ours, ref):
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k].double().numpy(),
                                   v.double().numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


# --------------------------------------------------------------- tests
@pytest.mark.parametrize("world,name", TRAIN_IDS,
                         ids=[n for _, n in TRAIN_IDS])
def test_space_step_matches_single_process(space_runs, world, name):
    """Losses at the JAX package's bounds, every rank's weights equal, the
    weights (but where a PGD step feeds the contour divergence) at its
    bounds too, against the single-process step with its compositions on
    the sampler."""
    runs, refs, _, _ = space_runs
    case = _cases(world)[name]
    first = _replicated(runs[world], name)
    want = _ref(refs, name, case)
    _losses_close(first["metrics"], want["metrics"])
    if name.split("/")[1] not in PGD_CONTOUR:
        _state_close(first["state"], want["state"])


@pytest.mark.parametrize("world,name", TRAIN_IDS,
                         ids=[n for _, n in TRAIN_IDS])
def test_space_step_gradients(space_runs, world, name):
    """The applied gradients (summed over the ranks) within 1e-4 relative
    L2 of the single-process step's; where a PGD step feeds the contour
    divergence, within 3x that step's own gap under a 1e-7 input
    perturbation."""
    runs, refs, _, _ = space_runs
    case = _cases(world)[name]
    ours = runs[world][0][name]["grads"]
    want = _ref(refs, name, case)
    assert ours.keys() == want["grads"].keys()
    gap = _rel_l2(ours, want["grads"])
    if name.split("/")[1] in PGD_CONTOUR:
        key = (tuple(case["size"]), name.split("/")[1], "perturbed")
        assert gap <= 3 * _rel_l2(refs[key]["grads"], want["grads"]), gap
    else:
        assert gap <= 1e-4, gap


@pytest.mark.parametrize("world,name", TRAIN_IDS,
                         ids=[n for _, n in TRAIN_IDS])
def test_space_step_activations_hold_their_slab(space_runs, world, name):
    """No module's output on a rank is taller than the dense output's
    slab plus two halo planes; the step exchanged halos and ran no stencil
    or dispatch predicate (on the CPU, no composition reached the stencil
    wrapper's plain version)."""
    runs, refs, _, _ = space_runs
    case = _cases(world)[name]
    dense = _ref(refs, name, case)["extents"]
    n_space = case["mesh"][1]
    for out in runs[world]:
        got = out[name]["extents"]
        assert got.keys() == dense.keys()
        for k, v in got.items():
            assert v <= dense[k] // n_space + 2, (k, v, dense[k])
        assert out[name]["collectives"]["neighbour_exchange"] > 0


@pytest.mark.parametrize("name", MORPH_FREE)
def test_space_step_matches_default_step_without_morph(space_runs, name):
    """Without the morph there is no composition: the (2, 2) step against
    the port's default single-process step at the JAX package's bounds."""
    runs, _, defaults, _ = space_runs
    first = _replicated(runs[4], f"2x2/{name}")
    want = defaults[(32, name)]
    _losses_close(first["metrics"], want["metrics"])
    if name not in PGD_CONTOUR:
        _state_close(first["state"], want["state"])


@pytest.mark.parametrize("name", JAX_CHAINS + ("volume",))
def test_space_step_matches_jax_space_step(space_runs, cpu_devices, name):
    """Against JAX's own step on its spatial mesh, from the same carried
    weights, draws and dropout masks: tests/test_torch_train.py's
    first-step bounds."""
    from test_torch_train import _check_first_update, _weights
    runs, _, _, jax_cases = space_runs
    case, jmodel, jsolver, rng = jax_cases[name]
    jm, jstate = _jax_step(name, jmodel, jsolver, rng, case, cpu_devices)
    world = 2 if name == "volume" else 4
    first = _replicated(runs[world], f"jax/{name}")
    ours = first["metrics"]
    cons_tol = 0.12 if "morph" in case["names"] else 1e-4
    assert _rel(ours["total_loss"], jm["total_loss"]) < max(1e-4,
                                                            cons_tol / 10)
    if jsolver is not None:
        assert _rel(ours["supervised_loss"], jm["supervised_loss"]) < 1e-5
        assert _rel(ours["consistency_loss"], jm["consistency_loss"]) \
            < cons_tol
    rel = _check_first_update(_weights(case["state_dict"]),
                              _weights(first["state"]), _weights(jstate))
    if name not in PGD_CONTOUR:
        assert rel < (0.2 if name == "volume" else 0.1), rel


# ------------------------------------------------------ op-level cases
def _assemble(outs, key, part=None):
    """The global tensor from the 4 ranks' slabs on (2, 2): rows over
    'data', the leading spatial axis over 'space'."""
    def get(o):
        v = o["ops"][key]
        return v if part is None else v[part]
    rows = [torch.cat([get(outs[2 * d + s]) for s in range(2)], dim=2)
            for d in range(2)]
    return torch.cat(rows, dim=0)


def _close(ours, ref, tol=1e-6):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(ours - ref).max() <= tol * scale, \
        (np.abs(ours - ref).max(), scale)


@pytest.fixture(scope="module")
def op_dense():
    return op_values({k: torch.from_numpy(v)
                      for k, v in op_inputs().items()})


SLAB_OPS = ["conv", "conv_dx", "up", "up_dlow", "bn", "bn_dx", "dropout",
            "unit_l2", "bspline", "resize", "base"]


@pytest.mark.parametrize("key", SLAB_OPS)
def test_op_slabs_match_the_dense_op(space_runs, op_dense, key):
    outs = space_runs[0][4]
    ours = _assemble(outs, key)
    if key == "dropout":  # the mask itself: exact
        assert torch.equal(ours, op_dense[key])
    _close(ours, op_dense[key].detach())


@pytest.mark.parametrize("name", ["l1", "infinity", "requires_grad"])
def test_sharded_unit_normalize_refuses(space_runs, name):
    """Inside a space group ``unit_normalize(..., sharded=True)`` takes the
    l2 norm of a tensor that requires no gradient, and nothing else."""
    for out in space_runs[0][4]:
        assert name in out["ops"]["norm_refusals"], name


@pytest.mark.parametrize("key", ["affine", "affine3"])
def test_affine_grid_rows_match_the_dense_grid(space_runs, op_dense, key):
    outs = space_runs[0][4]
    # the grid's leading output axis is dim 1
    rows = [torch.cat([outs[2 * d + s]["ops"][key] for s in range(2)], 1)
            for d in range(2)]
    assert torch.equal(torch.cat(rows, 0), op_dense[key])


def test_batch_norm_over_data_and_space(space_runs, op_dense):
    """The weight and bias gradients sum over every rank to the dense
    ones; the running statistics are the global batch's on every rank."""
    outs = space_runs[0][4]
    for key in ("bn_dw", "bn_db"):
        _close(sum(o["ops"][key] for o in outs), op_dense[key])
    for o in outs:
        for key in ("bn_mean", "bn_var"):
            _close(o["ops"][key], op_dense[key])


@pytest.mark.parametrize("route", ["gather", "halo"])
def test_compose_flow_under_the_space_group_matches_jax_sampler(
        space_runs, monkeypatch, route):
    """``compose_flow`` on each rank's slab, forward and both gradients,
    against JAX's composition on its sampler (``ADVCHAIN_STENCIL=0``) on
    the whole flows."""
    import jax
    import jax.numpy as jnp
    from advchain_tpu.ops.integrate import compose_flow as jcompose
    monkeypatch.setenv("ADVCHAIN_STENCIL", "0")
    jax.clear_caches()
    t = op_inputs()

    def loss(f1, f2):
        return jnp.sum(jcompose(f1, f2) * t["flow_ct"])

    y = jcompose(jnp.asarray(t["flow1"]), jnp.asarray(t["flow2"]))
    d1, d2 = jax.grad(loss, argnums=(0, 1))(jnp.asarray(t["flow1"]),
                                            jnp.asarray(t["flow2"]))
    outs = space_runs[0][4]
    for part, ref in enumerate((y, d1, d2)):
        _close(_assemble(outs, f"compose_{route}", part), np.asarray(ref),
               tol=1e-5)


def test_refusals_on_a_space_mesh(space_runs):
    """Nothing is refused any more: a UNet level that a max-pool cannot
    halve (40 rows over space 2: slabs of 20, 10, then 5 at down3, and the
    skips cropped) runs, its output and input gradient assembled from the
    (2, 2) ranks within 1e-5 of the dense network's largest entry
    (tests/test_torch_space_levels.py holds such levels through whole
    steps); the self-attention, UNetv2 and DeeplySupervisedUNet are
    partitioned and take a step with a finite loss
    (tests/test_torch_space_zoo.py holds them against the single-process
    step)."""
    y, dx = level_values()
    outs = space_runs[0][4]
    for part, ref in enumerate((y, dx)):
        rows = [torch.cat([outs[2 * d + s]["refusals"]["level"][part]
                           for s in range(2)], dim=2) for d in range(2)]
        _close(torch.cat(rows, dim=0), ref, 1e-5)
    for out in outs:
        got = out["refusals"]
        for name in ("self_attention", "unetv2", "deeply_supervised"):
            kind, loss = got[name]
            assert kind == "ran" and np.isfinite(loss), (name, got[name])
