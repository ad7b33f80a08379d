"""The fused adversarial training step and the plain supervised step, on one
GPU or data-parallel over a mesh of ranks (port of
advchain_tpu/parallel/train.py).

``train_step(state, batch, generator) -> (state, metrics)`` follows the JAX
step's order (train.py:149-200) on the batch's device:

  1. the reference prediction ``init_output`` from the frozen network
     (batch statistics, not written back, no gradient);
  2. every transform's parameters drawn from ``generator``, then
     ``prepare_train`` on the flagged ones;
  3. ``n_iter`` PGD steps through the frozen network, then ``project``;
  4. the parameters detached;
  5. the supervised pass (``SegmentationModel.apply_train``: batch
     statistics written back into the running ones) and the final
     consistency pass (batch statistics, no write-back), the weights'
     gradient coming from both, the consistency pass's through the
     warp-back of the prediction;
  6. one optimiser step.

The JAX package compiles all of it into one XLA program; here it runs
eagerly, and the warps run on the port's CUDA kernels.  With a ``mesh``
each rank runs the step on its rows of the batch inside a data group
(``ops.collectives.data_group``), which makes BatchNorm and the solver's
batch-wide quantities global, weights its loss by its share of the global
batch and sums the gradients over the ranks: the same step as on one
device, up to f32 reduction order, as the JAX package's GSPMD step is.

On a 2-D ``('data', 'space')`` mesh whose ``space`` axis is larger than 1
(the JAX package's ``_mesh_shardings``, train.py:57-95) each rank also
holds one slab of the leading spatial axis (H of NCHW, D of NCDHW), as
``parallel.spatial.shard_batch_spatial`` places it, and the data group
carries the space group (``ops.collectives.SpaceGroup``): the network's
convolutions, pools and upsamplings act on each level's partition of the
rows (uneven below the input, or empty on some ranks), every
warp and composition samples through the sharded sampler with the chain's
``chain_displacement_bound`` (the stencil is off, as in JAX), and
BatchNorm, the solver's quantities, the gradients and the metrics reduce
over every rank of the mesh, each rank's loss weighted by its share of the
global elements (rows x planes).  The result is the single-device step's
with the sampler in place of the stencil (JAX's ``ADVCHAIN_STENCIL=0``),
up to f32 reduction order.
The state's model and optimiser are updated in place; the returned state
carries the step count.  The anatomy-preserving retries and rejection
sampling are host-side control flow and stay out of the step, as in JAX.

While a torch profiler records, the step records its phases as
``advchain.*`` spans (``advchain_tpu_torch._trace.trace``):
``advchain.step`` around the whole step, ``.step.clean_pass``,
``.solver.episode`` (the draws, the PGD steps, ``.solver.project``),
``.step.supervised_pass``, ``.step.consistency_pass``, ``.step.backward``
(with the gradient all-reduce) and ``.step.optimizer``; the solver and the
model's wrapper record theirs inside them.  With no profiler each costs a
flag check.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch

from advchain_tpu_torch._trace import host_value, to_device, trace
from advchain_tpu_torch.losses import cross_entropy
from advchain_tpu_torch.ops import collectives
from advchain_tpu_torch.parallel.mesh import every_rank_group
from advchain_tpu_torch.parallel.spatial import chain_displacement_bound

__all__ = ["TrainState", "make_adversarial_train_step",
           "make_supervised_train_step"]


@dataclasses.dataclass
class TrainState:
    """The model (a ``SegmentationModel``), a ``torch.optim`` optimiser over
    its module's parameters, and the number of steps taken."""

    model: object
    optimizer: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, model, optimizer):
        return cls(model=model, optimizer=optimizer, step=0)


def _step_groups(mesh, axis_name: str, max_disp=None):
    """(the data group, the space group or None, the group the step
    reduces over) of a mesh, or None without a mesh.  On a mesh whose
    ``space`` axis is larger than 1 the space group is a
    ``collectives.SpaceGroup`` carrying the chain's bound ``max_disp``,
    and the step reduces over every rank of the mesh."""
    if mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"the mesh has no {axis_name!r} axis: {names}")
    data = mesh.get_group(axis_name)
    if "space" not in names or mesh.size(names.index("space")) == 1:
        return data, None, data
    space = collectives.SpaceGroup(
        mesh.get_group("space"), mesh.size(names.index("space")),
        mesh.get_local_rank("space"), mesh, max_disp)
    return data, space, every_rank_group(mesh)


@contextlib.contextmanager
def _data_group(groups, batch):
    """The step's data group (``ops.collectives``), with its space group on
    a spatially partitioned mesh, or nothing.  There the batch must be
    exactly ``{'image', 'label'}``, every rank's slab of one extent (one
    all-gather over the space group) and the label's slab the image's."""
    if groups is None:
        yield None
        return
    data, space, every = groups
    image = batch["image"]
    if space is not None:
        if set(batch) != {"image", "label"}:
            raise ValueError(f"a spatially partitioned step takes a batch "
                             f"of exactly 'image' and 'label', got "
                             f"{sorted(batch)}")
        extents = host_value(collectives.all_gather(
            to_device([image.shape[2]], device=image.device),
            group=space.group))
        label = batch["label"]
        lead = label.shape[1] if label.dim() == image.dim() - 1 \
            else label.shape[2]
        if len(set(extents)) != 1 or lead != image.shape[2]:
            raise ValueError(f"the slabs of the leading spatial axis differ "
                             f"over 'space': image {extents}, this rank's "
                             f"label {lead}")
    with collectives.data_group(data, image.shape[0], device=image.device,
                                space=space, reduce_group=every) as dg:
        if space is not None:  # the input level, known without a collective
            dg.space.register(image, collectives.Partition(tuple(extents)))
        yield dg


def _check_state(state, model, optimizer):
    if state.model is not model or state.optimizer is not optimizer:
        raise ValueError("the state must hold the model and optimizer the "
                         "step was built for")


def _optimizer_step(optimizer, loss, dg=None):
    """Backward, then the update.  With a data group, the backward runs on
    this rank's mean loss weighted by its share of the global batch's
    elements, and the parameter gradients are summed over the group (every
    rank of the mesh) in one all-reduce: the global batch's gradient on
    every rank."""
    with trace("advchain.step.backward"):
        optimizer.zero_grad(set_to_none=True)
        if dg is None:
            loss.backward()
        else:
            (loss * dg.share).backward()
            grads = [p.grad for g in optimizer.param_groups
                     for p in g["params"] if p.grad is not None]
            flat = collectives.all_reduce(
                torch.cat([g.reshape(-1) for g in grads]), group=dg.group)
            for g, v in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(v.view_as(g))
    with trace("advchain.step.optimizer"):
        optimizer.step()


def _global_metrics(metrics, dg):
    """Each rank's mean metrics weighted by its share of the global batch's
    elements and summed over the group: the global batch's values, equal
    on every rank."""
    if dg is None:
        return metrics
    total = collectives.all_reduce(
        torch.stack(list(metrics.values())) * dg.share, group=dg.group)
    return dict(zip(metrics, total.unbind()))


def make_adversarial_train_step(
        model, solver, optimizer,
        n_iter: int = 1,
        step_sizes=None,
        optimize_flags=None,
        power_iteration=False,
        consistency_weight: float = 1.0,
        supervised_loss_fn: Optional[Callable] = None,
        mesh=None,
        axis_name: str = "data",
        donate_state: bool = True):
    """Build ``train_step(state, batch, generator) -> (state, metrics)``.

    ``model``: a ``SegmentationModel``; ``solver``: a
    ``ComposeAdversarialTransformSolver`` carrying the transform chain and
    the divergences; ``optimizer``: a ``torch.optim`` optimiser over
    ``model.module``'s parameters.  ``batch`` is a dict with ``image``
    (N, C, *spatial) and ``label`` (N, *spatial) integer or (N, C,
    *spatial) soft; ``generator`` (a ``torch.Generator``) draws the
    transforms' initial parameters.  ``metrics`` holds ``total_loss``,
    ``supervised_loss`` and ``consistency_loss`` (0-d tensors on the
    device).

    ``mesh`` (``parallel.make_mesh``, or a 2-D ``make_spatial_mesh``):
    data parallelism over its ``axis_name`` axis.  Every
    rank passes its own rows of the global batch (``shard_batch``), the
    same replicated state (``replicate_to_mesh``) and a generator in the
    same state; each draws the global batch's transform parameters (the
    chain's ``data_size[0]`` rows) and keeps its own, so the draws are the
    single-process step's.  Inside the step's data group
    (``ops.collectives``) BatchNorm normalises by the global batch in every
    pass and writes back the global running statistics, and the solver's
    batch-wide quantities are global.  The losses are means over this
    rank's rows (a custom ``supervised_loss_fn`` is the one-device loss, a
    mean over the batch's samples); the step weights them by the rank's
    share of the global batch and sums the parameter gradients over the
    group before the update, so the model and optimiser stay replicated,
    and the returned metrics are the global values on every rank.  A mesh
    whose ``space`` axis is larger than 1 also splits the leading spatial
    axis: each rank passes its block of the batch
    (``shard_batch_spatial``), holds its slab of every activation and
    field, and the losses and gradients are the global batch's (see the
    module's docstring); the noise keeps its slab of the global draw, the
    other transforms' parameters their rows; the network's inner levels
    may split unevenly, or leave a rank no row (``ops.collectives.
    Partition``).  ``donate_state`` is a JAX buffer-donation hint, accepted
    and ignored.
    """
    del donate_state
    transforms = tuple(solver.chain_of_transforms)
    groups = _step_groups(mesh, axis_name,
                          chain_displacement_bound(transforms))
    solver._apply_power_iteration_setting(power_iteration)
    flags = tuple(bool(f) for f in solver._normalize_flags(optimize_flags,
                                                           n_iter))
    steps = tuple(solver._normalize_step_sizes(step_sizes))
    loss_fn = cross_entropy if supervised_loss_fn is None \
        else supervised_loss_fn

    def step_body(state, batch, generator):
        _check_state(state, model, optimizer)
        image = batch["image"].detach()
        label = batch["label"]
        with _data_group(groups, batch) as dg:
            model.begin_episode()  # one dropout mask for the whole step

            def frozen(x):
                return model.apply_fixed(x, train=True)

            with trace("advchain.step.clean_pass"), torch.no_grad():
                init_output = frozen(image)
            with trace("advchain.solver.episode"):
                params = tuple(t.init_params(generator, image.device)
                               for t in transforms)
                if dg is not None:  # the global batch's draws, this rank's
                    params = tuple(t.local_params(p, dg)
                                   for t, p in zip(transforms, params))
                params = tuple(t.prepare_train(p) if f else p
                               for t, p, f in zip(transforms, params, flags))
                if n_iter > 0:
                    for _ in range(n_iter):
                        params, _ = solver.pgd_step(frozen, params, image,
                                                    init_output, flags, steps)
                    with trace("advchain.solver.project"):
                        params = tuple(t.project(p) if f else p for t, p, f
                                       in zip(transforms, params, flags))
                params = tuple(p.detach() for p in params)

            with trace("advchain.step.supervised_pass"):
                sup = loss_fn(model.apply_train(image), label)
            with trace("advchain.step.consistency_pass"):
                cons = solver._final_loss(frozen, params, image,
                                          init_output)[0]
            total = sup + consistency_weight * cons
            _optimizer_step(optimizer, total, dg)
            metrics = _global_metrics(
                {"total_loss": total.detach(),
                 "supervised_loss": sup.detach(),
                 "consistency_loss": cons.detach()}, dg)
        return dataclasses.replace(state, step=state.step + 1), metrics

    def train_step(state: TrainState, batch, generator: torch.Generator):
        with trace("advchain.step"):
            return step_body(state, batch, generator)

    return train_step


def make_supervised_train_step(model, optimizer,
                               supervised_loss_fn: Optional[Callable] = None,
                               mesh=None, axis_name: str = "data",
                               donate_state: bool = True):
    """The plain supervised baseline step, ``train_step(state, batch,
    generator=None) -> (state, {"total_loss": ...})``: one ``apply_train``
    forward, the loss, one optimiser step.  ``generator`` stands where the
    JAX step takes its rng; dropout masks come from the model's own
    generator (``begin_episode``).  ``mesh`` and ``axis_name`` as in
    :func:`make_adversarial_train_step`: global BatchNorm statistics, the
    loss weighted by this rank's share of the global batch, the gradients
    summed over the group; on a spatially partitioned mesh the network's
    layers as there."""
    del donate_state
    groups = _step_groups(mesh, axis_name)
    loss_fn = cross_entropy if supervised_loss_fn is None \
        else supervised_loss_fn

    def train_step(state: TrainState, batch, generator=None):
        del generator
        with trace("advchain.step"):
            _check_state(state, model, optimizer)
            image = batch["image"].detach()
            with _data_group(groups, batch) as dg:
                model.begin_episode()
                with trace("advchain.step.supervised_pass"):
                    loss = loss_fn(model.apply_train(image), batch["label"])
                _optimizer_step(optimizer, loss, dg)
                metrics = _global_metrics({"total_loss": loss.detach()}, dg)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step
