"""The fused adversarial training step and the plain supervised step on one
GPU (port of advchain_tpu/parallel/train.py).

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
eagerly, and the warps run on the port's CUDA kernels.  The state's model
and optimiser are updated in place; the returned state carries the step
count.  The anatomy-preserving retries and rejection sampling are host-side
control flow and stay out of the step, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from advchain_tpu_torch.losses import cross_entropy

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


def _no_mesh(mesh, donate_state):
    del donate_state  # a JAX buffer-donation hint; PyTorch updates in place
    if mesh is not None:
        raise NotImplementedError(
            "the multi-device train step is not ported yet (ROADMAP item "
            "13: data parallelism across GPUs with torch.distributed)")


def _check_state(state, model, optimizer):
    if state.model is not model or state.optimizer is not optimizer:
        raise ValueError("the state must hold the model and optimizer the "
                         "step was built for")


def _optimizer_step(optimizer, loss):
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()


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
    device).  ``mesh`` raises (not ported yet); ``axis_name`` and
    ``donate_state`` are accepted and ignored."""
    del axis_name
    _no_mesh(mesh, donate_state)
    transforms = tuple(solver.chain_of_transforms)
    solver._apply_power_iteration_setting(power_iteration)
    flags = tuple(bool(f) for f in solver._normalize_flags(optimize_flags,
                                                           n_iter))
    steps = tuple(solver._normalize_step_sizes(step_sizes))
    loss_fn = cross_entropy if supervised_loss_fn is None \
        else supervised_loss_fn

    def train_step(state: TrainState, batch, generator: torch.Generator):
        _check_state(state, model, optimizer)
        image = batch["image"].detach()
        label = batch["label"]
        model.begin_episode()  # one dropout mask for the whole step

        def frozen(x):
            return model.apply_fixed(x, train=True)

        with torch.no_grad():
            init_output = frozen(image)
        params = tuple(t.init_params(generator, image.device)
                       for t in transforms)
        params = tuple(t.prepare_train(p) if f else p
                       for t, p, f in zip(transforms, params, flags))
        if n_iter > 0:
            for _ in range(n_iter):
                params, _ = solver.pgd_step(frozen, params, image,
                                            init_output, flags, steps)
            params = tuple(t.project(p) if f else p
                           for t, p, f in zip(transforms, params, flags))
        params = tuple(p.detach() for p in params)

        sup = loss_fn(model.apply_train(image), label)
        cons = solver._final_loss(frozen, params, image, init_output)[0]
        total = sup + consistency_weight * cons
        _optimizer_step(optimizer, total)
        metrics = {"total_loss": total.detach(),
                   "supervised_loss": sup.detach(),
                   "consistency_loss": cons.detach()}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step


def make_supervised_train_step(model, optimizer,
                               supervised_loss_fn: Optional[Callable] = None,
                               mesh=None, axis_name: str = "data",
                               donate_state: bool = True):
    """The plain supervised baseline step, ``train_step(state, batch,
    generator=None) -> (state, {"total_loss": ...})``: one ``apply_train``
    forward, the loss, one optimiser step.  ``generator`` stands where the
    JAX step takes its rng; dropout masks come from the model's own
    generator (``begin_episode``)."""
    del axis_name
    _no_mesh(mesh, donate_state)
    loss_fn = cross_entropy if supervised_loss_fn is None \
        else supervised_loss_fn

    def train_step(state: TrainState, batch, generator=None):
        del generator
        _check_state(state, model, optimizer)
        model.begin_episode()
        loss = loss_fn(model.apply_train(batch["image"].detach()),
                       batch["label"])
        _optimizer_step(optimizer, loss)
        return (dataclasses.replace(state, step=state.step + 1),
                {"total_loss": loss.detach()})

    return train_step
