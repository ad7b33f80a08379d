"""Process groups, device meshes and batch placement over
``torch.distributed`` (port of advchain_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a ``Mesh(('data',))`` of devices
and lets XLA insert the gradient reductions.  Here each rank is a process
with its own device (``cuda:LOCAL_RANK``), a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks, and the
data-parallel train step (``parallel/train.py``) reduces explicitly over the
mesh's ``data`` group.  Each rank holds its own rows of a batch: the
placement helpers return this rank's tensors on its device.

Launch one process per GPU with ``torchrun --nproc_per_node=<GPUs>``, which
sets ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` /
``LOCAL_RANK``, and call :func:`initialize_distributed` first (NCCL unless
another backend is named).
"""

from __future__ import annotations

import os
import weakref
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from advchain_tpu_torch.ops import collectives

__all__ = ["make_mesh", "shard_batch", "replicate_to_mesh",
           "initialize_distributed", "shard_process_local_batch"]


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None, **kwargs) -> int:
    """Join this process to a ``torch.distributed`` job and return its rank.

    Arguments default to torchrun's variables: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``init_method="env://"``), ``WORLD_SIZE``, ``RANK``;
    with ``LOCAL_RANK`` set and a GPU present, this process's device
    becomes ``cuda:LOCAL_RANK``.  A single process (no ``init_method`` and
    no world size, or a world size of 1) creates no process group and
    returns 0, so the call is safe at the start of any program.  The
    backend is ``"nccl"`` unless ``backend`` names another (``"gloo"``
    moves host tensors; see ``ops.collectives``); it is never switched on
    an error.  ``kwargs`` go to ``init_process_group``."""
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if init_method is None and env.get("MASTER_ADDR") \
            and env.get("MASTER_PORT"):
        init_method = "env://"
    if init_method is None and world_size is None:
        return 0
    if world_size == 1:
        return 0
    if env.get("LOCAL_RANK") and torch.cuda.is_available():
        torch.cuda.set_device(int(env["LOCAL_RANK"]))
    dist.init_process_group("nccl" if backend is None else backend,
                            init_method=init_method, world_size=world_size,
                            rank=rank, **kwargs)
    return dist.get_rank()


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


# the group of every rank of each multi-axis mesh, made with the mesh: like
# the mesh's own groups, a collective call on every rank of the job
_EVERY_RANK: "weakref.WeakKeyDictionary[DeviceMesh, object]" = \
    weakref.WeakKeyDictionary()


def _mesh(device_type: str, shape, names) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "initialize_distributed (or torchrun) first")
    ranks = torch.arange(int(np.prod(shape))).reshape(shape)
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=tuple(names))
    if len(shape) > 1:
        _EVERY_RANK[mesh] = dist.new_group(ranks.flatten().tolist())
    return mesh


def every_rank_group(mesh: DeviceMesh):
    """The process group of every rank of ``mesh``: what a spatially
    partitioned step's BatchNorm statistics and gradients reduce over."""
    if mesh.ndim == 1:
        return mesh.get_group()
    return _EVERY_RANK[mesh]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device_type: str = "cuda") -> DeviceMesh:
    """1-D data-parallel mesh over the first ``n_devices`` ranks (all of
    them by default), one ``device_type`` device each."""
    have = _world_size()
    if n_devices is None:
        n_devices = have
    assert have >= n_devices, f"need {n_devices} devices, have {have}"
    return _mesh(device_type, (n_devices,), (axis_name,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its current CUDA device, or the
    CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis(mesh: DeviceMesh, axis_name: str):
    """(group, size, this rank's index) of a named mesh axis; an axis the
    mesh lacks has size 1."""
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        return None, 1, 0
    return (mesh.get_group(axis_name), mesh.size(names.index(axis_name)),
            mesh.get_local_rank(axis_name))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _block(x, dim: int, index: int, count: int, what: str):
    size = x.shape[dim]
    assert size % count == 0, (f"{what} {size} not divisible by "
                               f"{count} shards")
    step = size // count
    return x.narrow(dim, index * step, step)


def shard_batch(batch, mesh: DeviceMesh, axis_name: str = "data"):
    """This rank's rows of a (tree of) global batch tensors or arrays,
    dim 0 split evenly over ``axis_name``, on this rank's device."""
    _, n, idx = _axis(mesh, axis_name)
    dev = mesh_device(mesh)
    return _tree_map(lambda x: _block(torch.as_tensor(x), 0, idx, n,
                                      "batch").to(dev), batch)


def shard_process_local_batch(local_batch, mesh: DeviceMesh,
                              axis_name: str = "data"):
    """The rows this process loaded (its shard of the global batch, dim 0
    = global batch / data ranks), as tensors on this rank's device.  In a
    single process it equals :func:`shard_batch`."""
    del axis_name
    dev = mesh_device(mesh)
    return _tree_map(lambda x: torch.as_tensor(x).to(dev), local_batch)


def _mesh_groups(mesh: DeviceMesh):
    return [mesh.get_group(name) for name in (mesh.mesh_dim_names or ())]


def _broadcast_tensors(tensors, mesh: DeviceMesh) -> None:
    """Rank (0, ..., 0)'s values into ``tensors`` on every rank: one
    broadcast from index 0 along each mesh axis in turn."""
    for group in _mesh_groups(mesh):
        for t in tensors:
            collectives.broadcast_(t, group=group)


def replicate_to_mesh(tree, mesh: DeviceMesh):
    """The same values on every rank of ``mesh``, broadcast from its first
    rank: a tensor or array (returned on this rank's device), an
    ``nn.Module`` (parameters and buffers, in place), a
    ``SegmentationModel``, a ``torch.optim`` optimiser's state, a
    ``TrainState`` (its model and optimiser), a ``torch.Generator`` (its
    state), or a dict / list / tuple of those."""
    from advchain_tpu_torch.parallel.train import TrainState

    dev = mesh_device(mesh)

    def one(x):
        if isinstance(x, TrainState):
            one(x.model)
            one(x.optimizer)
            return x
        if isinstance(x, torch.nn.Module):
            _broadcast_tensors(list(x.parameters()) + list(x.buffers()),
                               mesh)
            return x
        if hasattr(x, "module") and isinstance(x.module, torch.nn.Module):
            one(x.module)
            return x
        if isinstance(x, torch.optim.Optimizer):
            _broadcast_tensors([v for state in x.state.values()
                                for v in state.values()
                                if isinstance(v, torch.Tensor)], mesh)
            return x
        if isinstance(x, torch.Generator):
            state = x.get_state()
            _broadcast_tensors([state], mesh)
            x.set_state(state)
            return x
        t = torch.as_tensor(x).to(dev).clone()
        _broadcast_tensors([t], mesh)
        return t

    return _tree_map(one, tree)
