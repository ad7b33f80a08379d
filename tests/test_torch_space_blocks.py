"""Every block of ``advchain_tpu_torch.models.blocks`` inside a space group
(a ``('data', 'space')`` mesh whose ``space`` axis is larger than 1), on 2
and 4 spawned CPU ranks over gloo, against the same dense port block on
the whole input (which tests/test_torch_blocks.py holds against Flax).

The inputs are split three ways over the leading spatial axis (H, or D for
the 3D blocks): ``1x2`` and ``1x4`` in near-equal slabs (40 rows: 20 or
10 a rank, so every pool or strided window below meets an odd slab), and
``1x4_uneven`` in slabs of 30%, none, 40% and the rest, so that every
block also runs on uneven slabs and on a rank that holds no row.  Each
rank runs the block in training mode with the statistics written back,
then the backward of ``sum(out * ct)`` over its rows of the output (a
replicated output's: its share, ``ct / n``, as the train step weights each
rank's loss).

Bounds: the output rows assembled in rank order, and the input gradients
likewise, within 1e-5 of the dense block's largest entry (the global
BatchNorm computes in f32 over a different reduction order); the written
running statistics (and a spectral convolution's ``u`` / ``sigma``) on
every rank within 1e-5 of the largest entry; the parameter gradients
summed over the ranks within 1e-4 relative L2, as tests/test_torch_blocks.py
holds the dense block against ``jax.grad``.  ``spatial_pyramid_pool``'s
gradient where a bin's maximum ties across a seam goes to the first
occurrence, as the dense pool's does, exactly.
"""

import numpy as np
import pytest
import torch

from test_torch_mesh import run_ranks
import torch_threads  # noqa: F401  (one intra-op thread a process)

N = 2
TOL_OUT = 1e-5
TOL_GRAD = 1e-4
LAYOUTS = {"1x2": 2, "1x4": 4, "1x4_uneven": 4}


def _fn(fn, arg):
    """A function of ``models.blocks`` with its static argument as a
    block."""
    return lambda x: fn(x, arg)


def block_cases():
    """name: (factory, the inputs' shapes (NCHW or NCDHW; "w4" / "b4" an
    affine weight / bias of 4 channels), the int arguments after them)."""
    from advchain_tpu_torch.models import blocks as b
    x40 = (N, 4, 40, 12)
    up = [(N, 6, 20, 6), (N, 4, 40, 12)]
    odd_up = [(N, 4, 20, 6), (N, 4, 41, 13)]  # the skip cropped
    return {
        "ConvDown": (lambda: b.ConvDown(4, 6), [x40], ()),
        "ConvDown_spectral_dropout": (
            lambda: b.ConvDown(4, 6, dropout=0.3, spectral=True), [x40], ()),
        "ResConvDown": (lambda: b.ResConvDown(4, 6), [x40], ()),
        "ResConvDown_spectral": (lambda: b.ResConvDown(4, 6, spectral=True),
                                 [x40], ()),
        "ResConv": (lambda: b.ResConv(4, 5, 0.2), [x40], ()),
        "ResConv_spectral": (lambda: b.ResConv(4, 5, spectral=True), [x40],
                             ()),
        "ResBilinearUp": (lambda: b.ResBilinearUp(6, 4, 5), up, ()),
        "ResBilinearUp_spectral": (
            lambda: b.ResBilinearUp(6, 4, 5, spectral=True), up, ()),
        "ResConvUp": (lambda: b.ResConvUp(6, 4, 5), up, ()),
        "ResConvUp_spectral": (lambda: b.ResConvUp(6, 4, 5, spectral=True),
                               up, ()),
        "DilationConv": (lambda: b.DilationConv(4, 6, dilation=2,
                                                dropout=0.25), [x40], ()),
        # a halo of 6 rows: more than some slabs hold
        "DilationConv_k5_d3": (lambda: b.DilationConv(4, 6, kernel_size=5,
                                                      dilation=3), [x40], ()),
        "OutConvRelu": (lambda: b.OutConvRelu(4, 3), [x40], ()),
        "OutConvRelu_linear": (lambda: b.OutConvRelu(4, 3, activation=None),
                               [x40], ()),
        "SELayer": (lambda: b.SELayer(32), [(N, 32, 40, 6)], ()),
        "CSELayer": (lambda: b.CSELayer(6), [(N, 6, 40, 12)], ()),
        "ChannelSELayer": (lambda: b.ChannelSELayer(6), [(N, 6, 40, 12)],
                           ()),
        "SpatialSELayer": (lambda: b.SpatialSELayer(6), [(N, 6, 40, 12)],
                           ()),
        "ChannelSpatialSELayer": (lambda: b.ChannelSpatialSELayer(6),
                                  [(N, 6, 40, 12)], ()),
        "SqeUp": (lambda: b.SqeUp(4, 4, 6, 0.2), odd_up, ()),
        "BatchInstanceNorm": (lambda: b.BatchInstanceNorm(5),
                              [(N + 1, 5, 40, 12)], ()),
        "BatchInstanceNorm_3d": (lambda: b.BatchInstanceNorm(3),
                                 [(N, 3, 6, 5, 6)], ()),
        "AdaptiveInstanceNorm": (lambda: b.AdaptiveInstanceNorm(),
                                 [x40, "w4", "b4"], ()),
        "AdaptiveBatchNorm": (lambda: b.AdaptiveBatchNorm(),
                              [x40, "w4", "b4"], ()),
        "bilinear_additive_upsampling": (
            lambda: _fn(b.bilinear_additive_upsampling, 2),
            [(N, 8, 20, 6)], ()),
        "spatial_pyramid_pool": (lambda: _fn(b.spatial_pyramid_pool,
                                             (1, 2, 4, 7)), [x40], ()),
        "UnetConv3": (lambda: b.UnetConv3(2, 4), [(N, 2, 6, 6, 5)], ()),
        "UnetConv3_no_bn": (lambda: b.UnetConv3(2, 4, use_batchnorm=False),
                            [(N, 2, 6, 6, 5)], ()),
        "UnetUp3": (lambda: b.UnetUp3(3, 2, 4, z_scale_factor=2),
                    [(N, 2, 6, 8, 10), (N, 3, 3, 4, 5)], ()),
        "UnetUp3_pad": (lambda: b.UnetUp3(3, 2, 4),
                        [(N, 2, 3, 5, 6), (N, 3, 4, 6, 8)], ()),
        "DomainDoubleConv": (lambda: b.DomainDoubleConv(3, 5, 3),
                             [(N, 3, 40, 12)], (1,)),
        "DomainInConv": (lambda: b.DomainInConv(3, 5, 2, 0.3),
                         [(N, 3, 40, 12)], (0,)),
        "DomainPoolDown": (lambda: b.DomainPoolDown(3, 5, 3),
                           [(N, 3, 40, 12)], (2,)),
        "DomainUp": (lambda: b.DomainUp(5, 3, 4, 2, 0.2),
                     [(N, 5, 20, 6), (N, 3, 41, 13)], (1,)),
        "UnetConv2": (lambda: b.UnetConv2(3, 5), [(N, 3, 40, 12)], ()),
        "UnetConv2_n3_stride2": (
            lambda: b.UnetConv2(3, 5, use_batchnorm=False, n=3, stride=2),
            [(N, 3, 40, 12)], ()),
        "Conv2DBatchNorm": (lambda: b.Conv2DBatchNorm(3, 5, kernel_size=5,
                                                      padding=2),
                            [(N, 3, 40, 12)], ()),
        "Conv2DBatchNormRelu": (lambda: b.Conv2DBatchNormRelu(3, 5,
                                                              stride=2),
                                [(N, 3, 40, 12)], ()),
    }


def split(rows: int, layout: str):
    """Each rank's extent of ``rows`` in a layout."""
    n = LAYOUTS[layout]
    if layout.endswith("uneven"):
        a, c = round(0.3 * rows), round(0.4 * rows)
        return (a, 0, c, rows - a - c)
    q, r = divmod(rows, n)
    return (q + 1,) * r + (q,) * (n - r)


def inputs(name):
    """The array inputs of a case (numpy draws) and its int arguments."""
    arrays = []
    for i, spec in enumerate(block_cases()[name][1]):
        if isinstance(spec, str):  # an affine vector passed to forward
            v = np.random.RandomState(20 + i).randn(int(spec[1:]))
            arrays.append((1.0 + 0.5 * v if spec[0] == "w" else v)
                          .astype(np.float32))
        else:
            arrays.append(np.random.RandomState(10 + i).randn(*spec)
                          .astype(np.float32))
    return arrays, block_cases()[name][2]


def block_values(name, ct=None, layout=None, sg=None):
    """The block's training forward (statistics written back) and the
    backward of ``sum(out * ct)``: its output, input gradients, parameter
    gradients and buffers.  With a space group ``sg`` on this rank's rows
    of ``layout``: its rows of the output, and ``ct``'s rows (or a
    replicated output's share)."""
    from advchain_tpu_torch.models.unet import _StatsWriter
    arrays, ints = inputs(name)
    torch.manual_seed(0)
    block = block_cases()[name][0]()
    modules = block.modules() if hasattr(block, "modules") else []
    for m in modules:
        if isinstance(m, _StatsWriter):
            m.write_back = True
    if hasattr(block, "train"):
        block.train()
    xs = []
    for a in arrays:
        t = torch.from_numpy(a)
        if sg is not None and t.dim() > 1:
            ext = split(t.shape[2], layout)
            t = t.narrow(2, sum(ext[:sg.index]), ext[sg.index])
        xs.append(t.clone().requires_grad_(True))
    y = block(*xs, *ints)
    if ct is None:
        ct = torch.from_numpy(np.random.RandomState(30).randn(*y.shape)
                              .astype(np.float32))
    if sg is not None:
        ct = ct / sg.n if y.dim() == 2 else sg.take(ct, sg.level(y))
    (y * ct).sum().backward()
    params = dict(block.named_parameters()) \
        if hasattr(block, "named_parameters") else {}
    return {"y": y.detach(), "dx": [x.grad for x in xs],
            "grads": {k: (torch.zeros_like(p) if p.grad is None
                          else p.grad.clone()) for k, p in params.items()},
            "bufs": {k: v.clone() for k, v in block.named_buffers()
                     if not k.endswith("num_batches_tracked")}
            if hasattr(block, "named_buffers") else {}}


def spp_tie_input():
    """One sample whose bins' maxima tie across the seams of every layout:
    rows 8 and 16 of 40 (1x4_uneven's first seam sits at 12, 1x2's at 20,
    1x4's at 10, 20 and 30) and rows 18 to 21 hold the same largest value
    in every column."""
    x = np.random.RandomState(40).rand(1, 2, 40, 6).astype(np.float32)
    x[:, :, [8, 9, 10, 11, 12, 13, 16, 18, 19, 20, 21, 29, 30], :] = 5.0
    return x


def spp_tie_values(sg=None, layout=None):
    """``spatial_pyramid_pool`` over bins (1, 2, 3, 4) of the tie input:
    output and the input gradient of ``sum(out * ct)``."""
    from advchain_tpu_torch.models.blocks import spatial_pyramid_pool
    x = torch.from_numpy(spp_tie_input())
    if sg is not None:
        ext = split(40, layout)
        x = x.narrow(2, sum(ext[:sg.index]), ext[sg.index])
    x = x.clone().requires_grad_(True)
    y = spatial_pyramid_pool(x, (1, 2, 3, 4))
    ct = torch.from_numpy(np.random.RandomState(41).rand(*y.shape)
                          .astype(np.float32))
    (y * (ct if sg is None else ct / sg.n)).sum().backward()
    return y.detach(), x.grad


def blocks_rank(rank, world, device):
    """Every case in every layout of this world inside a (1, world) mesh's
    data group with its space group: the block's values on this rank's
    rows, the dense output's cotangent drawn as the dense run draws it."""
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.parallel import make_spatial_mesh
    from advchain_tpu_torch.parallel.mesh import every_rank_group
    mesh = make_spatial_mesh(1, world, device_type=device)
    space = collectives.SpaceGroup(mesh.get_group("space"), world,
                                   mesh.get_local_rank("space"), mesh)
    out = {}
    for layout, n in LAYOUTS.items():
        if n != world:
            continue
        for name in block_cases():
            dense_shape = DENSE_SHAPES[name]
            ct = torch.from_numpy(np.random.RandomState(30).randn(
                *dense_shape).astype(np.float32))
            with collectives.data_group(mesh.get_group("data"),
                                        inputs(name)[0][0].shape[0],
                                        space=space,
                                        reduce_group=every_rank_group(mesh)):
                out[(layout, name)] = block_values(
                    name, ct, layout, collectives.current_space())
        with collectives.data_group(mesh.get_group("data"), 1, space=space,
                                    reduce_group=every_rank_group(mesh)):
            out[(layout, "spp_tie")] = spp_tie_values(
                collectives.current_space(), layout)
    return out


def _dense_shapes():
    """Each case's dense output shape (the ranks draw its cotangent)."""
    shapes = {}
    for name in block_cases():
        arrays, ints = inputs(name)
        torch.manual_seed(0)
        block = block_cases()[name][0]()
        with torch.no_grad():
            shapes[name] = tuple(block(*[torch.from_numpy(a)
                                         for a in arrays], *ints).shape)
    return shapes


DENSE_SHAPES = _dense_shapes()


@pytest.fixture(scope="module")
def block_runs():
    runs = {world: run_ranks(blocks_rank, world) for world in (2, 4)}
    dense = {name: block_values(name) for name in block_cases()}
    dense["spp_tie"] = spp_tie_values()
    return runs, dense


IDS = [(layout, name) for layout in LAYOUTS for name in block_cases()]


def _close(ours, ref, tol):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(ours - ref).max() <= tol * scale, \
        (np.abs(ours - ref).max(), scale)


def _rel_l2(ours, ref):
    ref = np.asarray(ref, np.float64).ravel()
    diff = np.asarray(ours, np.float64).ravel() - ref
    return np.linalg.norm(diff) / max(np.linalg.norm(ref), 1e-30)


@pytest.mark.parametrize("layout,name", IDS,
                         ids=[f"{lay}/{n}" for lay, n in IDS])
def test_block_on_a_space_group_matches_the_dense_block(block_runs, layout,
                                                        name):
    """The output rows and the input gradients assembled in rank order
    (a replicated output: every rank's), and every rank's written
    statistics, against the dense block."""
    runs, dense = block_runs
    outs = [o[(layout, name)] for o in runs[LAYOUTS[layout]]]
    ref = dense[name]
    if ref["y"].dim() == 2:  # spatial_pyramid_pool: replicated
        for o in outs:
            _close(o["y"], ref["y"], TOL_OUT)
    else:
        _close(torch.cat([o["y"] for o in outs], 2), ref["y"], TOL_OUT)
    for i, dx in enumerate(ref["dx"]):
        if dx.dim() > 1:
            _close(torch.cat([o["dx"][i] for o in outs], 2), dx, TOL_OUT)
    for o in outs:
        for k, v in ref["bufs"].items():
            _close(o["bufs"][k], v, TOL_OUT)


@pytest.mark.parametrize("layout,name", IDS,
                         ids=[f"{lay}/{n}" for lay, n in IDS])
def test_block_gradients_on_a_space_group(block_runs, layout, name):
    """The parameter gradients (all leaves together: a bias before a
    BatchNorm has an exact gradient of 0) and an affine vector's passed to
    the forward, summed over the ranks against the dense block's."""
    runs, dense = block_runs
    outs = [o[(layout, name)] for o in runs[LAYOUTS[layout]]]
    ref = dense[name]
    assert outs[0]["grads"].keys() == ref["grads"].keys()
    if ref["grads"]:
        ours = torch.cat([sum(o["grads"][k] for o in outs).flatten()
                          for k in ref["grads"]])
        assert _rel_l2(ours, torch.cat([v.flatten() for v in
                                        ref["grads"].values()])) <= TOL_GRAD
    for i, dx in enumerate(ref["dx"]):
        if dx.dim() == 1:
            assert _rel_l2(sum(o["dx"][i] for o in outs), dx) <= TOL_GRAD


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spatial_pyramid_pool_ties_across_a_seam(block_runs, layout):
    """Where a bin's maximum ties across a seam, the gradient goes to the
    first occurrence (the lowest rank's), once: the assembled input
    gradient is nonzero exactly where the dense pool's is, and within 1e-6
    of it (the ranks' shares summed); the output is every rank's,
    exactly."""
    runs, dense = block_runs
    outs = [o[(layout, "spp_tie")] for o in runs[LAYOUTS[layout]]]
    y, dx = dense["spp_tie"]
    for o in outs:
        assert torch.equal(o[0], y)
    ours = torch.cat([o[1] for o in outs], 2)
    assert torch.equal(ours != 0, dx != 0)
    _close(ours, dx, 1e-6)
