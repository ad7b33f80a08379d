"""The 3x3x3 Conv3d's weight and bias gradients (kernels/conv3d_wgrad.py):
the plain twin against ``torch.nn.grad.conv3d_weight`` and a float64 sum,
the autograd function against ``F.conv3d``'s own (first and second
order), the engine check that keeps weight gradients out of
``torch.autograd.grad`` to an upstream tensor and answers for the leaves
it asks for, and the routing of ``ZDecomposedConv3d`` (the space group's slab
call and other dtypes keep the library's convolution).  The CUDA kernels
themselves are held in ``tests/test_torch_kernels_gpu.py``."""

import math

import pytest
import torch
import torch.nn.functional as F

from advchain_tpu_torch.kernels import conv3d_wgrad as cw
from advchain_tpu_torch.models import SegmentationModel, unet
import torch_threads  # noqa: F401  (one intra-op thread a process)

# (N, Cin, Cout, D, H, W): the model's two layers (1 -> 8, 8 -> 4), a
# single plane, and H and W that no tile divides
SHAPES = [(2, 1, 8, 1, 5, 7), (1, 8, 4, 3, 9, 37), (2, 8, 4, 4, 17, 33),
          (1, 3, 5, 2, 6, 11), (3, 1, 1, 2, 3, 3)]


def _inputs(shape, dtype=torch.float32, seed=0):
    n, cin, cout, d, h, w = shape
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, cin, d, h, w, generator=gen, dtype=dtype)
    dy = torch.randn(n, cout, d, h, w, generator=gen, dtype=dtype)
    return x, dy


def _wgrad_float64(x, dy):
    """dW and db as a float64 sum over each tap's overlap of the volume,
    with no padding: the taps that read outside the volume add nothing."""
    x, dy = x.double(), dy.double()
    d, h, w = x.shape[2:]
    dw = torch.zeros(dy.shape[1], x.shape[1], 3, 3, 3, dtype=torch.float64)

    def span(k, size):  # output positions whose tap k lies inside [0, size)
        lo, hi = max(0, 1 - k), min(size, size + 1 - k)
        return slice(lo, hi), slice(lo + k - 1, hi + k - 1)

    for kz in range(3):
        oz, iz = span(kz, d)
        for ky in range(3):
            oy, iy = span(ky, h)
            for kx in range(3):
                ox, ix = span(kx, w)
                dw[:, :, kz, ky, kx] = torch.einsum(
                    "nodhw,nidhw->oi", dy[:, :, oz, oy, ox],
                    x[:, :, iz, iy, ix])
    return dw, dy.sum(dim=(0, 2, 3, 4))


@pytest.mark.parametrize("shape", SHAPES)
def test_twin_matches_the_library_and_a_float64_sum(shape):
    x, dy = _inputs(shape)
    dw, db = cw.conv3d_wgrad_plain(x, dy)
    assert dw.shape == (shape[2], shape[1], 3, 3, 3) and db.shape == (
        shape[2],)
    ref_w, ref_b = _wgrad_float64(x, dy)
    scale_w = float(ref_w.abs().max())
    lib = torch.nn.grad.conv3d_weight(x, (shape[2], shape[1], 3, 3, 3), dy,
                                      padding=1)
    # f32 sums of up to ~3000 products, held at the scale of the largest
    torch.testing.assert_close(dw.double(), ref_w, atol=1e-5 * scale_w,
                               rtol=0)
    torch.testing.assert_close(dw, lib, atol=1e-5 * scale_w, rtol=0)
    torch.testing.assert_close(db.double(), ref_b,
                               atol=1e-5 * float(ref_b.abs().max()), rtol=0)
    # in float64 the twin is the float64 sum up to reassociation
    dw64, db64 = cw.conv3d_wgrad_plain(x.double(), dy.double())
    torch.testing.assert_close(dw64, ref_w, atol=1e-12 * scale_w, rtol=0)
    torch.testing.assert_close(db64, ref_b, atol=1e-12 * scale_w, rtol=0)


def test_cpu_call_takes_the_twin_and_launches_nothing():
    x, dy = _inputs(SHAPES[1])
    before = cw.LAUNCHES
    dw, db = cw.conv3d_wgrad(x, dy)
    ref_w, ref_b = cw.conv3d_wgrad_plain(x, dy)
    assert torch.equal(dw, ref_w) and torch.equal(db, ref_b)
    assert cw.LAUNCHES == before


@pytest.mark.parametrize("x_shape,dy_shape", [
    ((2, 1, 4, 5, 6), (2, 8, 4, 5, 7)),   # spatial sizes differ
    ((2, 1, 4, 5, 6), (3, 8, 4, 5, 6)),   # batch differs
    ((2, 1, 5, 6), (2, 8, 5, 6)),         # not 3D
])
def test_call_refuses_mismatched_shapes(x_shape, dy_shape):
    with pytest.raises(ValueError):
        cw.conv3d_wgrad(torch.zeros(x_shape), torch.zeros(dy_shape))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bias", [True, False])
def test_function_matches_the_library_autograd(shape, bias):
    n, cin, cout, d, h, w = shape
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(n, cin, d, h, w, generator=gen)
    weight = torch.randn(cout, cin, 3, 3, 3, generator=gen)
    b = torch.randn(cout, generator=gen) if bias else None
    cot = torch.randn(n, cout, d, h, w, generator=gen)
    grads = []
    for fn in (cw.conv3d_same, lambda *a: F.conv3d(*a, padding=1)):
        leaves = [t.clone().requires_grad_(True) for t in (x, weight)]
        lb = None if b is None else b.clone().requires_grad_(True)
        out = fn(*leaves, lb)
        (out * cot).sum().backward()
        grads.append((out.detach(), *(t.grad for t in leaves),
                      None if lb is None else lb.grad))
    ours, lib = grads
    assert torch.equal(ours[0], lib[0])  # the forward is the library's
    assert torch.equal(ours[1], lib[1])  # so is the data gradient
    for a, r in zip(ours[2:], lib[2:]):
        if r is None:
            assert a is None
            continue
        torch.testing.assert_close(a, r, atol=1e-5 * float(r.abs().max()),
                                   rtol=0)


def _model(dropout=0.0, seed=0):
    module = unet.PseudoConv3dModel(num_classes=4, dropout=dropout)
    module.init_weights_(torch.Generator().manual_seed(seed))
    return module


def _recording_twin(monkeypatch, calls, refuse=False):
    plain = cw.conv3d_wgrad_plain

    def twin(x, dy):
        if refuse:
            raise AssertionError("the weight gradient was computed")
        calls.append((tuple(x.shape), tuple(dy.shape)))
        return plain(x, dy)

    monkeypatch.setattr(cw, "conv3d_wgrad_plain", twin)


def test_grad_to_an_upstream_tensor_computes_no_weight_gradient(monkeypatch):
    """The episode's ``torch.autograd.grad(dist, opt)``: the transforms'
    parameters take gradients through both convolutions, the weights none,
    although the function sees ``needs_input_grad`` true for them."""
    module = _model()
    gen = torch.Generator().manual_seed(3)
    image = torch.randn(2, 1, 3, 8, 10, generator=gen)
    noise = torch.zeros_like(image).requires_grad_(True)
    _recording_twin(monkeypatch, [], refuse=True)
    out = module(image + noise)
    (g,) = torch.autograd.grad(out.square().mean(), [noise])
    assert g.abs().sum() > 0
    assert all(p.grad is None for p in module.parameters())


def test_backward_computes_each_weight_gradient_once(monkeypatch):
    module = _model()
    gen = torch.Generator().manual_seed(4)
    image = torch.randn(2, 1, 3, 8, 10, generator=gen)
    calls = []
    _recording_twin(monkeypatch, calls)
    module(image).square().mean().backward()
    assert sorted(calls) == sorted([((2, 1, 3, 8, 10), (2, 8, 3, 8, 10)),
                                    ((2, 8, 3, 8, 10), (2, 4, 3, 8, 10))])
    # the same step on the library's convolutions
    ref = _library_model()
    ref(image).square().mean().backward()
    # each layer's gradients at the scale of its largest: conv1's bias
    # gradient is zero but for rounding, BatchNorm removing any shift
    for name in ("conv1", "conv2", "bn1"):
        ours = [p.grad for p in getattr(module, name).parameters()]
        lib = [p.grad for p in getattr(ref, name).parameters()]
        scale = max(float(g.abs().max()) for g in lib)
        for a, r in zip(ours, lib):
            torch.testing.assert_close(a, r, atol=1e-5 * scale, rtol=0,
                                       msg=name)


def _library_model(seed=0):
    """The same model with the library's convolutions in both layers."""
    ref = _model(seed=seed)
    for m in (ref.conv1, ref.conv2):
        m._conv_forward = lambda x, w, b: F.conv3d(x, w, b, padding=1)
    return ref


def _close_by_layer(ours, lib):
    """Each gradient within 1e-5 of the largest of its layer's: conv1's
    bias gradient is zero but for rounding, BatchNorm removing any
    shift."""
    assert ours.keys() == lib.keys()
    for name, r in lib.items():
        layer = name.rsplit(".", 1)[0]
        scale = max(float(g.abs().max()) for k, g in lib.items()
                    if k.rsplit(".", 1)[0] == layer)
        torch.testing.assert_close(ours[name], r, atol=1e-5 * scale, rtol=0,
                                   msg=name)


@pytest.mark.parametrize("asked", ["all", "conv1.weight", "conv2.bias"])
def test_grad_to_the_parameters_matches_the_library(asked):
    """``torch.autograd.grad(loss, params)`` captures the leaves it asks
    for, which the engine's node check refuses to answer: those run."""
    gen = torch.Generator().manual_seed(5)
    image = torch.randn(2, 1, 3, 8, 10, generator=gen)
    grads = []
    for module in (_model(), _library_model()):
        params = dict(module.named_parameters())
        names = list(params) if asked == "all" else [asked]
        grads.append(dict(zip(names, torch.autograd.grad(
            module(image).square().mean(), [params[k] for k in names]))))
    _close_by_layer(*grads)


def test_double_backward_matches_the_library():
    """A gradient penalty (``create_graph=True``) takes the library's
    differentiable backward, as ``nn.Conv3d`` does."""
    gen = torch.Generator().manual_seed(6)
    image = torch.randn(2, 1, 3, 8, 10, generator=gen)
    grads = []
    for module in (_model(), _library_model()):
        x = image.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(module(x).square().mean(), [x],
                                    create_graph=True)
        gx.square().sum().backward()
        grads.append({k: p.grad for k, p in module.named_parameters()})
    _close_by_layer(*grads)


def test_function_passes_gradcheck_and_gradgradcheck():
    gen = torch.Generator().manual_seed(7)
    args = [torch.randn(s, generator=gen, dtype=torch.float64,
                        requires_grad=True)
            for s in ((2, 3, 3, 4, 5), (2, 3, 3, 3, 3), (2,))]
    assert torch.autograd.gradcheck(cw.conv3d_same, args)
    assert torch.autograd.gradgradcheck(cw.conv3d_same, args)


def test_frozen_weights_take_no_weight_gradient(monkeypatch):
    module = _model()
    for p in module.parameters():
        p.requires_grad_(False)
    _recording_twin(monkeypatch, [], refuse=True)
    image = torch.randn(1, 1, 2, 6, 6, requires_grad=True)
    module(image).sum().backward()
    assert image.grad is not None


def test_space_group_takes_the_slab_call(monkeypatch):
    """Inside a space group the layer keeps the halo'd slab convolution."""
    slab = []

    def slab_call(self, x, weight, bias):
        slab.append(self)
        return F.conv3d(x, weight, bias, padding=1)

    def refuse(*a, **k):
        raise AssertionError("the space group's call took the kernel path")

    monkeypatch.setattr(unet.collectives, "current_space", lambda: object())
    monkeypatch.setattr(unet._HaloConv, "_conv_forward", slab_call)
    monkeypatch.setattr(unet, "conv3d_same", refuse)
    module = _model()
    module(torch.randn(1, 1, 2, 6, 6)).sum().backward()
    assert slab == [module.conv1, module.conv2]


def test_bf16_takes_the_library_convolution(monkeypatch):
    """The wrapper's bf16 mode and a bf16 module both bypass the
    function."""
    def refuse(*a, **k):
        raise AssertionError("a bf16 call took the kernel path")

    monkeypatch.setattr(unet, "conv3d_same", refuse)
    x = torch.randn(2, 1, 3, 8, 8)
    model = SegmentationModel(_model(), compute_dtype=torch.bfloat16)
    out = model.apply_fixed(x)
    assert out.dtype == torch.float32
    out.sum().backward()
    assert model.module.conv1.weight.grad is not None
    low = _model().to(torch.bfloat16)
    low(x.to(torch.bfloat16)).float().sum().backward()
    assert low.conv2.weight.grad.dtype == torch.bfloat16


def test_f32_model_takes_the_function(monkeypatch):
    calls = []
    real = unet.conv3d_same

    def record(x, weight, bias):
        calls.append(weight.shape)
        return real(x, weight, bias)

    monkeypatch.setattr(unet, "conv3d_same", record)
    _model()(torch.randn(1, 1, 2, 6, 6))
    assert calls == [(8, 1, 3, 3, 3), (4, 8, 3, 3, 3)]


@pytest.mark.parametrize("shape", [(2, 1, 8, 12, 192, 192),
                                   (2, 8, 4, 12, 192, 192),
                                   (16, 8, 4, 64, 256, 256),
                                   (1, 3, 5, 1, 7, 9)])
def test_rows_cover_every_plane_within_the_scratch(shape):
    """The rows a warp walks tile H, and the partial sums stay under
    ``SCRATCH_BYTES`` unless one block a plane already passes it."""
    n, cin, cout, d, h, w = shape
    rows = cw.rows_per_warp(n, cin, cout, d, h, w)
    row_blocks = math.ceil(h / (cw.WARPS * rows))
    assert row_blocks * cw.WARPS * rows >= h
    assert (row_blocks - 1) * cw.WARPS * rows < h
    segs = n * d * row_blocks * math.ceil(w / 32)
    scratch = segs * (cout * cin * 27 + cout) * 4
    assert scratch <= cw.SCRATCH_BYTES or row_blocks == 1
