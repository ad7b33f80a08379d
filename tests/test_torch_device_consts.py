"""The step's device constants (``advchain_tpu_torch._consts``): clip
bounds, ``linspace`` and the grids built on it, resize matrices, Sobel
kernels, B-spline matrices and the stencil's base coordinates, each built
once per key and shared after.

On CPU tensors, which take the same cache: each cached tensor is bit for
bit what a fresh build from ``np`` gives, at the benchmark's shapes and at
odd ones; a second call returns the same tensor and fills nothing; a clip
still passes half the gradient at an exact bound; the inverse without
``linalg.inv``'s check is ``linalg.inv``'s; after a tiny 2D and 3D
adversarial train step every cached tensor still equals a fresh build, so
nothing wrote into one.  No JAX."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from advchain_tpu_torch import _consts, _trace, models, parallel
from advchain_tpu_torch.kernels._coords import clip
from advchain_tpu_torch.losses import consistency
from advchain_tpu_torch.ops import affine, integrate, resize
import torch_threads  # noqa: F401  (one intra-op thread a process)

FILL = "device_consts.fill"
CPU = torch.device("cpu")
# the benchmark's 2D slice and 3D volumes, and odd sizes
SHAPES = [(192, 192), (12, 192, 192), (16, 192, 192), (13, 29), (5, 7, 11)]


def _np_axis(n, dtype=torch.float32):
    return torch.as_tensor(np.linspace(-1.0, 1.0, n), dtype=dtype)


def _fills():
    return _trace.COUNTS.get(FILL, 0)


def _equal(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _twice(fn, *args):
    """``fn(*args)`` twice: the first result, after asserting that the
    second is the same tensor and filled nothing."""
    first = fn(*args)
    fills = _fills()
    again = fn(*args)
    assert again is first and _fills() == fills
    return first


def test_cache_is_bounded_and_counts_each_fill(monkeypatch):
    monkeypatch.setattr(_consts, "_CACHE", {})
    monkeypatch.setattr(_consts, "MAX_ENTRIES", 2)
    zeros = _consts.device_const(lambda n: torch.zeros(n))
    fills = _fills()
    for n in (1, 2, 3, 3):
        zeros(n)
    assert _fills() == fills + 3 and len(_consts._CACHE) == 2
    zeros(1)  # dropped as the oldest: built again
    assert _fills() == fills + 4 and len(_consts._CACHE) == 2


@pytest.mark.parametrize("shape", SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_grids_are_the_np_built_ones(shape):
    for n in shape:
        assert _equal(_twice(affine.linspace, -1.0, 1.0, n, torch.float32,
                             CPU), _np_axis(n))
    # base_grid: channel 0 ('x') along the last axis
    axes = torch.meshgrid(*[_np_axis(n) for n in shape], indexing="ij")
    want = torch.stack(axes[::-1], dim=0)[None].expand((2, len(shape))
                                                       + shape)
    assert _equal(integrate.base_grid(2, shape, torch.float32, CPU), want)
    fills = _fills()
    integrate.base_grid(2, shape, torch.float32, CPU)
    assert _fills() == fills
    # the affine grid on both corner conventions
    dims = len(shape)
    theta = torch.eye(dims, dims + 1)[None] + 0.1 * torch.randn(
        2, dims, dims + 1, generator=torch.Generator().manual_seed(0))
    for align in (True, False):
        coords = []
        for n in shape:
            xs = _np_axis(n)
            coords.append(xs if align or n == 1 else xs * (n - 1) / n)
        mesh = torch.meshgrid(*coords, indexing="ij")
        base = torch.stack(mesh[::-1] + (torch.ones_like(mesh[0]),), dim=-1)
        eq = "hwk,njk->nhwj" if dims == 2 else "dhwk,njk->ndhwj"
        got = affine.affine_grid(theta, (2, 1) + shape, align)
        assert _equal(got, torch.einsum(eq, base, theta))


@pytest.mark.parametrize("in_size,out_size", [(24, 192), (6, 12), (7, 29),
                                              (192, 96)])
def test_interp_matrix_is_the_np_built_one(in_size, out_size):
    for align in (True, False):
        want = torch.as_tensor(resize._interp_matrix_np(in_size, out_size,
                                                        align))
        assert _equal(_twice(resize.interp_matrix, in_size, out_size, align,
                             CPU), want)


@pytest.mark.parametrize("classes,ndim", [(3, 2), (1, 3), (2, 3)])
def test_sobel_kernels_are_the_np_built_ones(classes, ndim):
    build = (consistency._sobel_kernels_2d if ndim == 2
             else consistency._sobel_kernels_3d)
    want = tuple(torch.as_tensor(k) for k in build(classes))
    assert _equal(_twice(consistency._sobel_kernels, classes, ndim,
                         torch.float32, CPU), want)


def test_clip_passes_half_the_gradient_at_an_exact_bound():
    x = torch.tensor([-2.0, 0.0, 0.5, 1.0, 3.0], requires_grad=True)
    clip(x, 0.0, 1.0).sum().backward()
    assert x.grad.tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]
    # a tensor bound (a batch's range) is taken as it is, not cached
    fills = _fills()
    y = clip(x.detach(), torch.tensor(0.5), 1)
    assert y.tolist() == [0.5, 0.5, 0.5, 1.0, 1.0] and _fills() == fills


@pytest.mark.parametrize("dims", [2, 3])
def test_inverse_is_linalg_inv_bit_for_bit(dims):
    gen = torch.Generator().manual_seed(dims)
    theta = torch.eye(dims, dims + 1)[None] + 0.3 * torch.randn(
        64, dims, dims + 1, generator=gen)
    homo = torch.cat([theta, torch.eye(dims + 1)[dims:].expand(64, 1, -1)],
                     dim=1)
    assert torch.equal(affine.invert_affine_matrix(theta),
                       torch.linalg.inv(homo)[:, :dims])


@pytest.mark.parametrize("shape", [(32, 32), (8, 16, 16)],
                         ids=["2d", "3d"])
def test_cached_tensors_survive_a_train_step(shape):
    """Two adversarial train steps; the second fills nothing, and every
    cached tensor then equals a fresh build."""
    dims = len(shape)
    batch = 2 if dims == 2 else 1
    module = (models.UNet(1, 4, feature_scale=16) if dims == 2
              else models.PseudoConv3dModel(4, 0.1))
    model = models.SegmentationModel(module, seed=0)
    opt = torch.optim.Adam(model.module.parameters(), lr=cs.LR)
    step = parallel.make_adversarial_train_step(
        model, cs.build_solver(batch, shape), opt, n_iter=1,
        power_iteration=cs.POWER_ITERATION[dims])
    state = parallel.TrainState.create(model, opt)
    data = {"image": torch.as_tensor(cs.make_input(batch, shape)),
            "label": torch.as_tensor(cs.make_labels(batch, shape))}
    gen = torch.Generator().manual_seed(1)
    state, _ = step(state, data, gen)
    fills = _fills()
    state, metrics = step(state, data, gen)
    assert _fills() == fills and torch.isfinite(metrics["total_loss"])
    assert _consts._CACHE
    for (build, args, kwargs), value in list(_consts._CACHE.items()):
        assert _equal(value, build(*args, **dict(kwargs))), build.__name__
