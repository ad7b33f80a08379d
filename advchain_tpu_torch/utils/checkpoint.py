"""Checkpoint / resume with ``torch.save`` (port of
advchain_tpu/utils/checkpoint.py, where orbax saves pytrees).

The reference checkpoints only model state dicts (torch .pth); here the full
training state and the transform-chain parameters are saved, giving the
training-loop resume the reference never had.  A checkpoint holds plain
containers only (dicts, lists, numbers, strings, None and CPU tensors), so
``torch.load(path, weights_only=True)`` reads it and no class is pickled:

- a :class:`~advchain_tpu_torch.parallel.TrainState` is saved as
  ``{"model", "optimizer", "step"}``;
- a :class:`~advchain_tpu_torch.models.SegmentationModel` as its module's
  ``state_dict`` (BatchNorm's running statistics and spectral norm's ``u``
  and ``sigma`` among its buffers) with what a resumed step reads beside
  it: the episode seed stream's state, the current episode seed (the
  dropout masks derive from it), the BatchNorm mode flags and
  ``compute_dtype`` by name;
- a tensor as itself (a ``torch.Generator``'s ``get_state()`` is one),
  dicts, lists and tuples element by element.
"""

from __future__ import annotations

import os

import torch

from advchain_tpu_torch import resolve_device
from advchain_tpu_torch.models.wrapper import SegmentationModel
from advchain_tpu_torch.parallel.train import TrainState

__all__ = ["save_checkpoint", "restore_checkpoint",
           "save_transform_state", "restore_transform_state"]


def _plain(obj):
    """``obj`` as plain containers and CPU tensors."""
    if isinstance(obj, TrainState):
        return {"model": _plain(obj.model),
                "optimizer": _plain(obj.optimizer.state_dict()),
                "step": int(obj.step)}
    if isinstance(obj, SegmentationModel):
        dtype = obj.compute_dtype
        return {"module": _plain(obj.module.state_dict()),
                "episodes": obj._episodes.get_state(),
                "episode_seed": int(obj.episode_seed),
                "training": bool(obj.training),
                "adaptive_bn": bool(obj._adaptive_bn),
                "compute_dtype": None if dtype is None
                else str(dtype).removeprefix("torch.")}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_plain(v) for v in obj)
    return obj


def _restore(target, saved):
    """Load ``saved`` into ``target`` in place where it holds state; returns
    the restored value."""
    if isinstance(target, TrainState):
        _restore(target.model, saved["model"])
        target.optimizer.load_state_dict(saved["optimizer"])
        target.step = int(saved["step"])
        return target
    if isinstance(target, SegmentationModel):
        target.module.load_state_dict(saved["module"])
        target._episodes.set_state(saved["episodes"])
        target.training = saved["training"]
        target._adaptive_bn = saved["adaptive_bn"]
        name = saved["compute_dtype"]
        target.compute_dtype = None if name is None else getattr(torch, name)
        target.begin_episode(saved["episode_seed"])
        return target
    if isinstance(target, torch.Tensor):
        with torch.no_grad():
            target.copy_(saved)
        return target
    if isinstance(target, dict):
        for k in target:
            target[k] = _restore(target[k], saved[k])
        return target
    return saved


def save_checkpoint(path: str, state) -> str:
    """Save ``state`` (a ``TrainState``, a ``SegmentationModel``, a tensor,
    or dicts, lists and tuples of them) to the file ``path``, replacing it
    whole; returns the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(_plain(state), tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, target=None):
    """Read the checkpoint at ``path``.  Without ``target``: the saved
    plain containers, tensors on the CPU.  With ``target`` (of the saved
    structure: a freshly created ``TrainState``, a ``SegmentationModel``, a
    tensor, or a dict of them): the saved values loaded into it on its own
    devices, and ``target`` returned.  The target is restored in place (its
    model, optimiser and tensors are written; a dict's other entries
    replaced), where the JAX package returns a new tree."""
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    return saved if target is None else _restore(target, saved)


def save_transform_state(path: str, solver) -> str:
    """Persist a solver's transform-chain parameters, keyed
    ``"{i}_{name}"`` (the augmentation-state save/restore surface:
    reference set_parameters/get_parameters,
    adv_transformation_base.py:53-57)."""
    params = {f"{i}_{t.get_name()}": t.get_parameters()
              for i, t in enumerate(solver.chain_of_transforms)}
    return save_checkpoint(path, params)


def restore_transform_state(path: str, solver) -> None:
    """Set each transform's saved parameters (skipping those saved as
    None) on the device of its current parameters, or, where it has none,
    its own ``device`` (None: the GPU)."""
    params = restore_checkpoint(path)
    for i, t in enumerate(solver.chain_of_transforms):
        key = f"{i}_{t.get_name()}"
        if params.get(key) is not None:
            device = t.param.device if t.param is not None \
                else resolve_device(t.device)
            t.set_parameters(params[key].to(device))
