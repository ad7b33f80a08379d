"""Collectives over ``torch.distributed`` groups, the halo exchange, and
the data and space groups of a running parallel step.

Transport.  A ``gloo`` group moves host tensors: a CUDA tensor is copied to
the host, reduced or exchanged there and copied back.  An ``nccl`` group
moves device tensors (a host tensor, such as a generator's state, is
staged through the current device).  The choice is made by the group's
backend (:func:`transport`), never by catching an error.  ``COUNTS`` tallies
the calls, the bytes they sent and the calls of each collective, so a run
can report what a step cost in communication and which collectives it ran
(``parallel.spatial.sharded_grid_sample``'s halo route is the one that
runs a ``neighbour_exchange``).

The data group.  The JAX package's data-parallel step is one GSPMD program,
so every batch-wide quantity in it is global by construction.  Here each
rank holds its rows of the batch, and :func:`data_group` marks the block in
which the port's batch-wide quantities reduce over the data group:

* ``FrozenStatsBN`` / ``FrozenStatsBN3d`` normalise by the global batch
  statistics, and their backward all-reduces the two per-channel gradient
  sums (``models/unet.py``);
* ``EpisodeDropout`` draws the global batch's mask and keeps its rows;
* the mse divergence's divisor counts the global batch
  (``losses/consistency.py``); the other losses stay means over this
  rank's rows, which the train step weights by ``n_local / n_global``;
* the solver's intensity clamp takes the global minimum and maximum, and
  its PGD step checks the global divergence for finiteness
  (``augmentor/compose.py``);
* the flow compositions' dispatch slope and the 3D adaptive step count see
  the whole batch (``ops/integrate.py``).

The space group.  On a ``('data', 'space')`` mesh whose ``space`` axis is
larger than 1 each rank also holds one slab of the leading spatial axis (H
of NCHW, D of NCDHW): at the input, block ``index`` of ``n`` equal blocks.
The step opens its data group with a :class:`SpaceGroup` and with the group
of every rank of the mesh, over which each batch-wide quantity above then
reduces (the BatchNorm sums, the clamp, the divergence, the 3D step count,
the weight gradients).

Levels.  A network's inner activations are levels of other heights, and
each level is split by a :class:`Partition`: every rank's ``(offset,
extent)`` on the leading axis, contiguous in rank order, uneven, and on a
small level empty on some ranks.  The op that makes a level derives its
partition from its input's with no collective (a pooling or strided
window's output row belongs to the rank holding its input anchor row, an
upsampling's to its skip's or to the rank of ``floor(i * in / out)``, a pad
or crop shifts the rows) and registers it under the level's trailing shape
(:meth:`SpaceGroup.register`); the ops after it look it up
(:meth:`SpaceGroup.level`).  A trailing shape that no op registered, or
that two levels of different partitions share, costs one all-gather of the
extents.  :meth:`SpaceGroup.fetch` gives a rank any window of rows of a
level: from the neighbours' halos when every rank holds enough rows, else
from the gathered level (:func:`gather_slabs`, uneven slabs padded on the
wire).  Inside the space group the readers of :func:`current_space` are
partition-aware:

* ``ops.grid_sample.grid_sample`` samples through
  ``parallel.spatial``'s sharded sampler, and ``compose_flow`` takes that
  sampler with border padding (no stencil, no dispatch slope);
* ``ops.integrate.base_grid`` and ``ops.affine.affine_grid`` give this
  slab's rows of the global grid, ``ops.resize.interpolate`` and
  ``ops.bspline.evaluate_bspline_field`` this slab's rows of a replicated
  field resized to the image;
* ``ops.conv.conv_same`` reads a halo from the neighbours
  (:func:`exchange_halo`); the models' convolutions, pools, upsamplings,
  pads and crops act on each level's partition (``models/unet.py``,
  ``models/blocks.py``);
* two ops take either kind of field, so their call sites say which:
  ``ops.conv.gaussian_smooth(..., sharded=True)`` smooths a slab with
  halos (the morph's second smoothing; its first acts on the replicated
  velocity), and ``ops.norms.unit_normalize(..., sharded=True)`` takes
  each sample's l2 norm over the space group (the noise's updates and
  projections; the other transforms' parameters are replicated);
* BatchNorm, dropout's mask and the mse divisor count every plane of the
  level (:meth:`DataGroup.global_numel`); the blocks' channel gates and
  instance statistics sum over the space group (:func:`space_sum`).

Outside the block all of these are the single-process computations, and no
collective runs.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from advchain_tpu_torch._trace import count, host_value, to_device

__all__ = ["transport", "all_reduce", "all_gather", "broadcast_",
           "neighbour_exchange", "gather_slabs", "exchange_halo",
           "space_sum", "Partition", "DataGroup", "SpaceGroup", "data_group",
           "current_data_group", "current_space", "global_numel",
           "reset_counts", "COUNTS"]

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}
_NAMES = ("all_reduce", "all_gather", "broadcast_", "neighbour_exchange")

# since the last reset: calls, bytes sent, and the calls of each collective
COUNTS = dict.fromkeys(("calls", "bytes") + _NAMES, 0)


def reset_counts() -> None:
    COUNTS.update(dict.fromkeys(COUNTS, 0))


def _count(name: str, *sent) -> None:
    COUNTS["calls"] += 1
    COUNTS[name] += 1
    COUNTS["bytes"] += sum(t.numel() * t.element_size() for t in sent)


def _wire_device(group) -> torch.device:
    """Where ``group``'s backend takes its tensors: the host for gloo, the
    current CUDA device otherwise (NCCL)."""
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _wire(t, group):
    """``t`` detached, contiguous and on the wire device: a copy when it
    moves, else ``t`` itself."""
    t = t.detach().contiguous()
    dev = _wire_device(group)
    if t.device == dev:
        return t
    if t.is_cuda and dev.type == "cpu":  # gloo reads the tensor on the host
        count("host_syncs")
    return to_device(t, device=dev)


def transport(group=None, device_type: str = "cuda") -> str:
    """How this module moves ``device_type`` tensors over ``group``."""
    wire = _wire_device(group).type
    backend = dist.get_backend(group)
    if wire != device_type:
        return f"{backend}, {device_type} tensors staged through {wire}"
    return f"{backend}, {device_type} tensors in place"


def all_reduce(t, op: str = "sum", group=None):
    """A new tensor: ``t`` reduced over ``group`` with ``op`` ('sum',
    'min' or 'max'); ``t`` is left as it was."""
    _count("all_reduce", t)
    out = _wire(t, group)
    if out.data_ptr() == t.data_ptr():
        out = out.clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    return to_device(out, device=t.device)


def all_gather(t, dim: int = 0, group=None):
    """Every rank's ``t`` (all of one shape) concatenated along ``dim`` in
    group-rank order."""
    _count("all_gather", t)
    src = _wire(t, group)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return to_device(torch.cat(parts, dim=dim), device=t.device)


def broadcast_(t, group=None, src: int = 0):
    """Overwrite ``t`` with group rank ``src``'s value, in place."""
    _count("broadcast_", t)
    peer = src if group is None else dist.get_global_rank(group, src)
    wire = _wire(t, group)
    if wire.data_ptr() == t.data_ptr():
        wire = wire.clone()
    dist.broadcast(wire, src=peer, group=group)
    if t.is_cuda and not wire.is_cuda:  # a pageable copy onto the device
        count("host_syncs")
    with torch.no_grad():
        t.copy_(wire)
    return t


def neighbour_exchange(to_left, to_right, group):
    """Non-cyclic exchange along the group's ranks: send ``to_left`` to
    group rank ``r - 1`` and ``to_right`` to ``r + 1``; returns (what the
    left neighbour sent right, what the right neighbour sent left), zeros
    at the two ends.  Point-to-point ``batch_isend_irecv``."""
    n = dist.get_world_size(group)
    r = dist.get_group_rank(group, dist.get_rank())
    send_l, send_r = _wire(to_left, group), _wire(to_right, group)
    from_left = torch.zeros_like(send_r)
    from_right = torch.zeros_like(send_l)
    ops, sent = [], []
    if r > 0:
        peer = dist.get_global_rank(group, r - 1)
        ops += [dist.P2POp(dist.isend, send_l, peer, group),
                dist.P2POp(dist.irecv, from_left, peer, group)]
        sent.append(send_l)
    if r + 1 < n:
        peer = dist.get_global_rank(group, r + 1)
        ops += [dist.P2POp(dist.isend, send_r, peer, group),
                dist.P2POp(dist.irecv, from_right, peer, group)]
        sent.append(send_r)
    _count("neighbour_exchange", *sent)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return (to_device(from_left, device=to_right.device),
            to_device(from_right, device=to_left.device))


class _HaloExchange(torch.autograd.Function):
    """[left neighbour's last ``halo`` planes, x, right neighbour's first
    ``halo``] along ``axis``; zeros past the two ends."""

    @staticmethod
    def forward(ctx, x, halo, axis, group):
        size = x.shape[axis]
        from_left, from_right = neighbour_exchange(
            x.narrow(axis, 0, halo), x.narrow(axis, size - halo, halo),
            group)
        ctx.halo, ctx.axis, ctx.group = halo, axis, group
        return torch.cat([from_left, x, from_right], dim=axis)

    @staticmethod
    def backward(ctx, g):
        halo, axis = ctx.halo, ctx.axis
        size = g.shape[axis] - 2 * halo
        # the halo slabs' gradients go back to their owners: my left slab
        # is my left neighbour's last planes, my right slab my right
        # neighbour's first
        to_first, to_last = neighbour_exchange(
            g.narrow(axis, 0, halo), g.narrow(axis, size + halo, halo),
            ctx.group)
        dx = g.narrow(axis, halo, size).clone()
        dx.narrow(axis, 0, halo).add_(to_first)
        dx.narrow(axis, size - halo, halo).add_(to_last)
        return dx, None, None, None


class _GatherSlabs(torch.autograd.Function):
    """Every rank's ``x`` along ``dim`` in group-rank order, rank ``r``'s
    of ``extents[r]`` planes (each padded to the largest on the wire); the
    backward sums the gathered gradient over the group and keeps this
    rank's part (a reduce-scatter written as an all-reduce and a
    slice)."""

    @staticmethod
    def forward(ctx, x, dim, group, extents):
        idx = dist.get_group_rank(group, dist.get_rank())
        ctx.dim, ctx.group = dim, group
        ctx.offset, ctx.size = sum(extents[:idx]), extents[idx]
        most = max(extents)
        if x.shape[dim] < most:
            shape = list(x.shape)
            shape[dim] = most - x.shape[dim]
            x = torch.cat([x, x.new_zeros(shape)], dim)
        out = all_gather(x, dim=dim, group=group)
        if min(extents) == most:
            return out
        return torch.cat([out.narrow(dim, r * most, e)
                          for r, e in enumerate(extents)], dim)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g.contiguous(), group=ctx.group)
        return total.narrow(ctx.dim, ctx.offset, ctx.size), None, None, \
            None


def gather_slabs(x, group, dim: int = 2, extents=None):
    """Every rank's slab ``x`` concatenated along ``dim`` in group-rank
    order, differentiably: the whole source of a global warp, the
    self-attention's keys and values over the space group, or a level too
    small for halos (:meth:`SpaceGroup.fetch`).  ``extents``: every rank's
    extent along ``dim`` (None: all ``x``'s)."""
    if extents is None:
        extents = (x.shape[dim],) * dist.get_world_size(group)
    return _GatherSlabs.apply(x, dim, group, tuple(int(e) for e in extents))


class _SpaceSum(torch.autograd.Function):
    """``t`` summed over ``group``; the backward sums the gradient over the
    group too, since each rank's cotangent of the replicated sum is that
    rank's part of it."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t, group=group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), group=ctx.group), None


def space_sum(t, group):
    """``t`` (this rank's partial sums) summed over ``group``,
    differentiably: the replicated result's gradient on each rank is that
    rank's part, so the backward sums it over the group as well."""
    return _SpaceSum.apply(t, group)


def exchange_halo(x, halo: int, axis: int, group):
    """``x`` with ``halo`` planes from each neighbour along ``axis`` of the
    group's ranks concatenated on either side, zeros past the group's two
    ends (the dense ops' zero padding).  Differentiable: the backward sends
    each halo's gradient back to its owner, which adds it.  ``halo == 0``
    returns ``x``."""
    if halo == 0:
        return x
    if x.shape[axis] < halo:
        raise ValueError(f"local extent {x.shape[axis]} < halo {halo}")
    return _HaloExchange.apply(x, halo, axis, group)


def _rows_or_zeros(t, lo: int, hi: int, axis: int):
    """Rows ``lo : hi`` of ``t`` along ``axis``, zeros where they fall
    outside it."""
    before, after = max(0, -lo), max(0, hi - t.shape[axis])
    pads = [0, 0] * (t.dim() - 1 - axis) + [before, after]
    return F.pad(t, pads).narrow(axis, lo + before, hi - lo)


@dataclasses.dataclass(frozen=True)
class Partition:
    """Each rank's rows of one level's leading spatial axis: group rank
    ``r`` holds global rows ``offsets[r] : offsets[r] + extents[r]``,
    contiguous and in rank order; an extent may be 0."""

    extents: tuple

    @classmethod
    def equal(cls, height: int, n: int) -> "Partition":
        if height % n:
            raise ValueError(f"an extent of {height} does not split into "
                             f"{n} equal slabs over 'space'")
        return cls((height // n,) * n)

    @property
    def height(self) -> int:
        return sum(self.extents)

    @property
    def offsets(self) -> tuple:
        return tuple(itertools.accumulate((0,) + self.extents[:-1]))

    def rows(self, rank: int):
        """(offset, extent) of group rank ``rank``."""
        return self.offsets[rank], self.extents[rank]

    def derive(self, anchors) -> "Partition":
        """The partition of a level whose row ``j`` belongs to the rank
        holding row ``anchors[j]`` of this one (an anchor before the first
        row to rank 0, one past the last row to the last rank)."""
        n = len(self.extents)
        owners = np.minimum(np.searchsorted(np.cumsum(self.extents),
                                            np.asarray(anchors, np.int64),
                                            side="right"), n - 1)
        return Partition(tuple(int(c) for c in
                               np.bincount(owners, minlength=n)))

    def window(self, kernel: int, stride: int = 1, padding: int = 0,
               dilation: int = 1) -> "Partition":
        """The output of a convolution or pooling window along this axis:
        row ``j`` belongs to the rank holding its window's centre row
        ``j * stride - padding + dilation * (kernel - 1) // 2`` (a 2 x 2 /
        2 pool's first row; a 'same' convolution keeps the partition)."""
        span = dilation * (kernel - 1)
        n_out = max((self.height + 2 * padding - span - 1) // stride + 1, 0)
        return self.derive(np.arange(n_out) * stride - padding + span // 2)

    def resized(self, n_out: int) -> "Partition":
        """A resize to ``n_out`` rows: row ``i`` belongs to the rank
        holding row ``floor(i * height / n_out)`` (an x2 upsampling
        doubles each rank's rows, so a pool gives this partition back)."""
        return self.derive(np.arange(n_out) * self.height // n_out)

    def padded(self, before: int, after: int) -> "Partition":
        """Rows added (positive) or cropped (negative) at the two ends:
        added rows go to the first and last rank, cropped ones leave their
        owners."""
        total = self.height + before + after
        starts = [0] + [min(max(o + before, 0), total)
                        for o in self.offsets[1:]]
        return Partition(tuple(b - a for a, b in
                               zip(starts, starts[1:] + [total])))


@dataclasses.dataclass(frozen=True)
class SpaceGroup:
    """This rank's slab of the leading spatial axis in a spatially
    partitioned step: at the input, block ``index`` of ``n`` equal blocks
    over ``group`` (the mesh's ``space`` group).  ``mesh`` is the
    ``DeviceMesh`` that ``parallel.spatial``'s sharded ops take,
    ``max_disp`` the chain's static displacement bound
    (``parallel.spatial.chain_displacement_bound``; None: every warp
    gathers its source).  ``levels`` maps a level's trailing shape to its
    :class:`Partition` (None: two levels share it); :func:`data_group`
    starts each step with an empty map."""

    group: object
    n: int
    index: int
    mesh: object = None
    max_disp: Optional[float] = None
    levels: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    def slab(self, t, axis: int = 2):
        """This rank's block of a tensor whose ``axis`` holds the global
        extent, split into equal blocks."""
        o, e = Partition.equal(t.shape[axis], self.n).rows(self.index)
        return t.narrow(axis, o, e)

    def level(self, x, axis: int = 2) -> Partition:
        """The partition of the level ``x`` (this rank's rows along
        ``axis``) lies on: the registered one for its trailing shape, else
        every rank's extent (one all-gather)."""
        key = tuple(x.shape[axis + 1:])
        part = self.levels.get(key)
        if part is None:
            part = Partition(tuple(all_gather(
                torch.tensor([x.shape[axis]]), group=self.group).tolist()))
            self.levels.setdefault(key, part)
        if part.extents[self.index] != x.shape[axis]:
            raise RuntimeError(f"this rank holds {x.shape[axis]} rows of a "
                               f"level registered as {part.extents}")
        return part

    def register(self, x, part: Partition, axis: int = 2):
        """Record that ``x`` lies on a level split as ``part``; returns
        ``x``."""
        key = tuple(x.shape[axis + 1:])
        self.levels[key] = part if self.levels.get(key, part) == part \
            else None
        return x

    def take(self, t, part: Partition, axis: int = 2):
        """This rank's rows of a global tensor on a level split as
        ``part``."""
        return t.narrow(axis, *part.rows(self.index))

    def fetch(self, x, part: Partition, windows, axis: int = 2):
        """Global rows ``windows[index]`` = (lo, hi) of the level split as
        ``part`` (``x``: this rank's rows), zeros outside the level;
        ``windows`` holds every rank's (hi <= lo: none), so that every rank
        takes the same route.  Differentiable.  When every rank holds as
        many rows as the farthest window reaches past its own, the
        neighbours' halos (:func:`exchange_halo`; no collective when no
        window leaves its rows), else the gathered level
        (:func:`gather_slabs`)."""
        halo = 0
        for (o, e), (lo, hi) in zip(zip(part.offsets, part.extents),
                                    windows):
            if hi > lo:
                halo = max(halo, o - lo, hi - o - e)
        o, e = part.rows(self.index)
        lo, hi = windows[self.index]
        if hi <= lo:
            lo = hi = o
        if min(part.extents) >= halo:
            xh = exchange_halo(x, halo, axis, self.group)
            return xh.narrow(axis, lo - o + halo, hi - lo)
        whole = gather_slabs(x, self.group, axis, part.extents)
        return _rows_or_zeros(whole, lo, hi, axis)


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """This rank's place in the global batch of a parallel step: rows
    ``offset : offset + n_local`` of ``n_global``, and with a ``space``
    group one slab of each.  ``group`` is the group every batch-wide
    quantity reduces over: the data group, or every rank of a ``('data',
    'space')`` mesh."""

    group: object
    n_local: int
    n_global: int
    offset: int
    space: Optional[SpaceGroup] = None

    def rows(self, t):
        """This rank's rows of a global-batch tensor."""
        if t.shape[0] != self.n_global:
            raise ValueError(f"expected the global batch of "
                             f"{self.n_global} rows, got {t.shape[0]}")
        return t[self.offset:self.offset + self.n_local]

    @property
    def planes(self) -> int:
        """The slabs a sample is split into (1 without a space group)."""
        return 1 if self.space is None else self.space.n

    @property
    def share(self) -> float:
        """This rank's share of the global batch's elements at the input
        level: its rows over the global rows, over the slabs of each."""
        return self.n_local / (self.n_global * self.planes)

    def global_numel(self, x) -> int:
        """``x.numel()`` of the global batch tensor that ``x`` (this rank's
        rows and, with a space group, its rows of the level) is part
        of."""
        if x.dim() < 3:
            return math.prod(x.shape[1:]) * self.n_global
        lead = x.shape[2] if self.space is None \
            else self.space.level(x).height
        return math.prod(x.shape[1:2] + x.shape[3:]) * lead * self.n_global


_DATA_GROUP: contextvars.ContextVar[Optional[DataGroup]] = \
    contextvars.ContextVar("data_group", default=None)


@contextlib.contextmanager
def data_group(group, n_local: int, device=None, space=None,
               reduce_group=None):
    """Open the data group of one step: every rank passes its own batch
    rows' count (one all-gather of the counts over ``group``, the data
    group, on ``device``).  With ``space`` (a :class:`SpaceGroup`) the
    step is also spatially partitioned, and ``reduce_group`` is the group
    of every rank of the mesh, which the batch-wide quantities reduce
    over (default: ``group``)."""
    if n_local < 1:
        raise ValueError("every rank needs at least one row of the batch")
    if space is not None:  # each step maps its own levels
        space = dataclasses.replace(space, levels={})
    counts = host_value(all_gather(to_device([n_local], torch.int64, device),
                                   group=group))
    r = dist.get_group_rank(group, dist.get_rank())
    dg = DataGroup(group if reduce_group is None else reduce_group, n_local,
                   int(sum(counts)), int(sum(counts[:r])), space)
    token = _DATA_GROUP.set(dg)
    try:
        yield dg
    finally:
        _DATA_GROUP.reset(token)


def current_data_group() -> Optional[DataGroup]:
    return _DATA_GROUP.get()


def current_space() -> Optional[SpaceGroup]:
    """The running step's space group, or None."""
    dg = _DATA_GROUP.get()
    return None if dg is None else dg.space


def global_numel(x) -> int:
    """``x.numel()`` of the global batch tensor inside :func:`data_group`
    (every row and, with a space group, every slab), else
    ``x.numel()``."""
    dg = _DATA_GROUP.get()
    return x.numel() if dg is None else dg.global_numel(x)

