"""The 2D models' training BatchNorm (kernels/batch_norm.py: the library's
forward, the hand-written backward pair): the function's forward and
write-back against ``F.batch_norm(training=True)``, the backward's plain
twin against a float64 sum and the library's backward (with and without
the affine), the autograd function (the engine check for the affine's
gradients, a double backward, gradcheck), the route (which inputs take the
pair; eval, bf16, 5D, CPU and data-group inputs keep today's call) and
``BatchInstanceNorm``'s gradients through it.  The CUDA kernels themselves
are held in ``tests/test_torch_kernels_gpu.py``."""

import types

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from advchain_tpu_torch import _trace
from advchain_tpu_torch.kernels import batch_norm as bn
from advchain_tpu_torch.models import SegmentationModel, blocks, unet
import torch_threads  # noqa: F401  (one intra-op thread a process)

EPS = 1e-5
MOMENTUM = 0.1
# (N, C, H, W): H * W a multiple of 4 and not, a single image, one row
SHAPES = [(4, 3, 6, 8), (3, 5, 7, 9), (1, 2, 5, 6), (6, 4, 1, 3)]


def _inputs(shape, seed=0, dtype=torch.float32):
    n, c, h, w = shape
    gen = torch.Generator().manual_seed(seed)
    shift = 3 * torch.randn(c, generator=gen)
    x = torch.randn(shape, generator=gen) + shift.view(1, -1, 1, 1)
    weight, bias = torch.randn(c, generator=gen), torch.randn(c, generator=gen)
    running = (torch.randn(c, generator=gen), 1 + torch.rand(c, generator=gen))
    dy = torch.randn(shape, generator=gen)
    return tuple(t.to(dtype) for t in (x, weight, bias, *running, dy))


def _float64_reference(x, weight, bias, running, dy):
    """y, the batch mean and biased variance, the written running
    statistics and (dx, dw, db), as float64 sums over each channel."""
    x, dy = x.double(), dy.double()
    m = x.numel() // x.shape[1]
    mean = x.sum((0, 2, 3)) / m
    xc = x - mean.view(1, -1, 1, 1)
    var = (xc * xc).sum((0, 2, 3)) / m
    invstd = 1 / torch.sqrt(var + EPS)
    xhat = xc * invstd.view(1, -1, 1, 1)
    w = torch.ones_like(mean) if weight is None else weight.double()
    b = torch.zeros_like(mean) if bias is None else bias.double()
    y = xhat * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)
    rm = (1 - MOMENTUM) * running[0].double() + MOMENTUM * mean
    rv = (1 - MOMENTUM) * running[1].double() + MOMENTUM * var * m / (m - 1)
    sum_dy, sum_dy_xhat = dy.sum((0, 2, 3)), (dy * xhat).sum((0, 2, 3))
    dx = (w * invstd).view(1, -1, 1, 1) * (
        dy - (sum_dy / m).view(1, -1, 1, 1)
        - xhat * (sum_dy_xhat / m).view(1, -1, 1, 1))
    return y, mean, invstd, rm, rv, (dx, sum_dy_xhat, sum_dy)


def _close(a, ref, tol=2e-6):
    """Within ``tol`` of the largest float64 entry."""
    a, ref = a.detach().double(), ref.detach().double()
    scale = max(float(ref.abs().max()), 1e-12)
    torch.testing.assert_close(a, ref, atol=tol * scale, rtol=0)


def _forward(x, weight, bias, stats=None):
    """The function's forward (the library's), its saved mean and invstd,
    and the running statistics written back in ``stats``."""
    y = bn.batch_norm_train(x, weight, bias, EPS, stats)
    _, mean, invstd, _, _ = torch._batch_norm_impl_index(
        x, weight, bias, None, None, True, MOMENTUM, EPS,
        torch.backends.cudnn.enabled)
    return y, mean, invstd


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("affine", [True, False])
def test_twin_matches_the_library_and_a_float64_sum(shape, affine):
    """The function's forward and write-back are the library's, and the
    twin's backward from the saved statistics matches a float64 sum and
    the library's own backward."""
    x, weight, bias, rm, rv, dy = _inputs(shape)
    if not affine:
        weight = bias = None
    stats = (rm.clone(), rv.clone(), MOMENTUM)
    y, mean, invstd = _forward(x, weight, bias, stats)
    ref = _float64_reference(x, weight, bias, (rm, rv), dy)
    for a, r in zip((y, mean, invstd, *stats[:2]), ref[:5]):
        _close(a, r)
    lib_stats = (rm.clone(), rv.clone())
    lib_y = F.batch_norm(x, *lib_stats, weight, bias, training=True,
                         momentum=MOMENTUM, eps=EPS)
    assert torch.equal(y, lib_y)
    for a, r in zip(stats[:2], lib_stats):
        assert torch.equal(a, r)
    grads = bn.batch_norm_bwd_plain(x, dy, mean, invstd, weight)
    for a, r in zip(grads, ref[5]):
        _close(a, r)
    leaves = [t.clone().requires_grad_(True) for t in (x, weight, bias)
              if t is not None]
    out = F.batch_norm(leaves[0], None, None, *(leaves[1:] or [None, None]),
                       training=True, eps=EPS)
    lib = torch.autograd.grad(out, leaves, dy)
    for a, r in zip(grads, lib):
        _close(a, r)


def test_twin_in_float64_is_the_float64_sum():
    x, weight, bias, rm, rv, dy = _inputs(SHAPES[1], dtype=torch.float64)
    stats = (rm.clone(), rv.clone(), MOMENTUM)
    y, mean, invstd = _forward(x, weight, bias, stats)
    ref = _float64_reference(x, weight, bias, (rm, rv), dy)
    grads = bn.batch_norm_bwd_plain(x, dy, mean, invstd, weight)
    for a, r in zip((y, mean, invstd, *stats[:2], *grads),
                    (*ref[:5], *ref[5])):
        _close(a, r, tol=1e-12)


def test_backward_skips_what_it_is_not_asked_for():
    x, weight, _, _, _, dy = _inputs(SHAPES[0])
    mean = x.mean((0, 2, 3))
    invstd = 1 / torch.sqrt(x.var((0, 2, 3), unbiased=False) + EPS)
    assert bn.batch_norm_bwd_plain(x, dy, mean, invstd, weight,
                                   (False, True, False))[::2] == (None, None)
    assert bn.batch_norm_bwd(x, dy, mean, invstd, weight,
                             (True, False, False))[1:] == (None, None)


def test_cpu_call_takes_the_twin_and_launches_nothing():
    x, weight, bias, rm, rv, dy = _inputs(SHAPES[0])
    counted = _trace.COUNTS.get("batchnorm.pair")
    _, mean, invstd = _forward(x, weight, bias)
    grads = bn.batch_norm_bwd(x, dy, mean, invstd, weight)
    ref = bn.batch_norm_bwd_plain(x, dy, mean, invstd, weight)
    assert all(torch.equal(a, r) for a, r in zip(grads, ref))
    assert _trace.COUNTS.get("batchnorm.pair") == counted


@pytest.mark.parametrize("x_shape,dy_shape", [
    ((2, 3, 4, 5), (2, 3, 4, 6)),      # shapes differ
    ((2, 3, 4, 5, 6), (2, 3, 4, 5, 6)),  # not 2D
])
def test_call_refuses_mismatched_shapes(x_shape, dy_shape):
    x, dy = torch.zeros(x_shape), torch.zeros(dy_shape)
    c = torch.ones(x_shape[1])
    with pytest.raises(ValueError):
        bn.batch_norm_bwd(x, dy, c, c, None)


@pytest.mark.parametrize("resident,shape,chunks", [
    (1056, (128, 16, 192, 192), 66), (1056, (128, 256, 12, 12), 4),
    (792, (128, 64, 48, 48), 12), (792, (2, 1024, 4, 4), 1),
    (792, (1, 3, 2, 2), 1), (792, (2, 1, 8, 9), 1)])
def test_chunks_fill_one_wave(resident, shape, chunks):
    """A channel's chunks keep the grid within one resident wave, at least
    one a channel, and give every thread a vector."""
    n, c, h, w = shape
    vec = 4 if h * w % 4 == 0 else 1
    got = bn.chunks_for(resident, n, c, h * w, vec)
    assert got == chunks
    assert got * c <= resident or got == 1
    assert got == 1 or (got - 1) * bn.THREADS < n * h * w // vec


# --------------------------------------------------------------- autograd
@pytest.mark.parametrize("affine", [True, False])
def test_function_passes_gradcheck_and_gradgradcheck(affine):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(3, 2, 3, 4, generator=gen, dtype=torch.float64)
    x = x.requires_grad_(True)
    params = [torch.randn(2, generator=gen, dtype=torch.float64,
                          requires_grad=True) for _ in range(2)]
    if not affine:
        params = [None, None]

    def fn(x, *p):
        return bn.batch_norm_train(x, *(p or params), EPS)

    args = [x] + [p for p in params if p is not None]
    assert torch.autograd.gradcheck(fn, args)
    assert torch.autograd.gradgradcheck(fn, args)


def test_double_backward_matches_the_library():
    """A gradient penalty (``create_graph=True``) takes the differentiable
    plain formula, which sees the statistics' dependence on ``x``."""
    x, weight, bias, _, _, dy = _inputs(SHAPES[1], dtype=torch.float64)
    grads = []
    for fn in (bn.batch_norm_train,
               lambda x, w, b, eps: F.batch_norm(x, None, None, w, b,
                                                 training=True, eps=eps)):
        leaves = [t.clone().requires_grad_(True) for t in (x, weight, bias)]
        out = fn(*leaves, EPS)
        (gx,) = torch.autograd.grad((out * dy).sum(), [leaves[0]],
                                    create_graph=True)
        gx.square().sum().backward()
        grads.append([t.grad for t in leaves])
    assert grads[0][2] is None and grads[1][2] is None  # gx has no bias
    for a, r in zip(grads[0][:2], grads[1][:2]):
        _close(a, r, tol=1e-12)


def _recording_bwd(monkeypatch, calls):
    plain = bn.batch_norm_bwd_plain

    def record(x, dy, mean, invstd, weight, needs=(True,) * 3):
        calls.append(tuple(needs))
        return plain(x, dy, mean, invstd, weight, needs)

    monkeypatch.setattr(bn, "batch_norm_bwd_plain", record)


def test_grad_to_an_upstream_tensor_computes_no_affine_gradient(monkeypatch):
    """The episode's ``torch.autograd.grad(dist, opt)``: the input takes a
    gradient, the weight and bias none, although ``needs_input_grad`` is
    true for them."""
    x, weight, bias, _, _, dy = _inputs(SHAPES[0])
    w, b = (t.clone().requires_grad_(True) for t in (weight, bias))
    noise = torch.zeros_like(x).requires_grad_(True)
    calls = []
    _recording_bwd(monkeypatch, calls)
    (g,) = torch.autograd.grad(
        (bn.batch_norm_train(x + noise, w, b, EPS) * dy).sum(), [noise])
    assert calls == [(True, False, False)]
    assert g.abs().sum() > 0 and w.grad is None and b.grad is None


@pytest.mark.parametrize("asked", ["weight", "bias", "all"])
def test_grad_to_the_parameters_computes_what_it_asks(monkeypatch, asked):
    x, weight, bias, _, _, dy = _inputs(SHAPES[0])
    leaves = dict(zip(("x", "weight", "bias"),
                      (t.clone().requires_grad_(True)
                       for t in (x, weight, bias))))
    names = list(leaves) if asked == "all" else [asked]
    calls = []
    _recording_bwd(monkeypatch, calls)
    out = bn.batch_norm_train(*leaves.values(), EPS)
    got = torch.autograd.grad((out * dy).sum(), [leaves[k] for k in names])
    lib_leaves = {k: t.detach().clone().requires_grad_(True)
                  for k, t in leaves.items()}
    lib_out = F.batch_norm(lib_leaves["x"], None, None,
                           lib_leaves["weight"], lib_leaves["bias"],
                           training=True, eps=EPS)
    lib = torch.autograd.grad((lib_out * dy).sum(),
                              [lib_leaves[k] for k in names])
    # the input's gradient is taken wherever it requires one
    assert calls == [(True, "weight" in names or asked == "all",
                      "bias" in names or asked == "all")]
    for a, r in zip(got, lib):
        _close(a, r)


# ------------------------------------------------------------------ route
def _fits_anywhere(monkeypatch):
    """The route as it would be on the card, for CPU tensors (which take
    the plain twin inside the function)."""
    monkeypatch.setattr(bn, "takes_pair", bn.fits_pair)


def _recording_pair(monkeypatch, calls):
    real = bn.batch_norm_train

    def record(x, weight, bias, eps, stats=None):
        calls.append((tuple(x.shape), stats is not None))
        return real(x, weight, bias, eps, stats)

    monkeypatch.setattr(bn, "batch_norm_train", record)


def _refuse_pair(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the call took the pair")

    monkeypatch.setattr(bn, "batch_norm_train", refuse)


def test_takes_pair_needs_a_cuda_tensor():
    x, weight, bias, rm, rv, _ = _inputs(SHAPES[0])
    assert bn.fits_pair(x, weight, bias, (rm, rv, MOMENTUM))
    assert not bn.takes_pair(x, weight, bias, (rm, rv, MOMENTUM))


@pytest.mark.parametrize("case", [
    "bf16", "float64", "5d", "3d", "channels_last", "transposed",
    "one_value", "momentum_none", "momentum_bool", "running_none",
    "weight_f64", "weight_len", "running_f64"])
def test_fits_pair_refuses_what_the_kernels_do_not_take(case):
    x, weight, bias, rm, rv, _ = _inputs(SHAPES[0])
    stats = (rm, rv, MOMENTUM)
    if case == "bf16":
        x = x.to(torch.bfloat16)
    elif case == "float64":
        x = x.double()
    elif case == "5d":
        x = x.unsqueeze(2)
    elif case == "3d":
        x = x[0]
    elif case == "channels_last":
        x = x.to(memory_format=torch.channels_last)
    elif case == "transposed":
        x = x.transpose(2, 3)
    elif case == "one_value":
        x = x[:1, :, :1, :1]
    elif case == "momentum_none":
        stats = (rm, rv, None)
    elif case == "momentum_bool":
        stats = (rm, rv, True)
    elif case == "running_none":
        stats = (None, rv, MOMENTUM)
    elif case == "weight_f64":
        weight = weight.double()
    elif case == "weight_len":
        weight = torch.ones(x.shape[1] + 1)
    elif case == "running_f64":
        stats = (rm.double(), rv, MOMENTUM)
    assert not bn.fits_pair(x, weight, bias, stats)


def _unet(seed=0):
    module = unet.UNet(input_channel=1, num_classes=4, feature_scale=16)
    module.init_weights_(torch.Generator().manual_seed(seed))
    return module


def test_training_forward_routes_every_2d_batch_norm(monkeypatch):
    """UNet's 18 BatchNorm layers take the pair in training mode, with the
    write-back only under ``write_back``; its gradients match the
    library's BatchNorm."""
    _fits_anywhere(monkeypatch)
    calls = []
    _recording_pair(monkeypatch, calls)
    x = torch.randn(2, 1, 32, 32, generator=torch.Generator().manual_seed(1))
    grads = []
    for take in (True, False):
        module = _unet()
        if not take:
            monkeypatch.setattr(bn, "takes_pair", lambda *a: False)
        module(x).square().mean().backward()
        grads.append({k: p.grad for k, p in module.named_parameters()})
    assert len(calls) == 18 and not any(wb for _, wb in calls)
    # at the scale of the largest gradient: the convolutions' biases before
    # a BatchNorm take gradients that are zero but for rounding
    scale = max(float(g.abs().max()) for g in grads[1].values())
    for k, r in grads[1].items():
        torch.testing.assert_close(grads[0][k], r, atol=1e-5 * scale,
                                   rtol=0, msg=k)
    calls.clear()
    monkeypatch.setattr(bn, "takes_pair", bn.fits_pair)
    model = SegmentationModel(_unet())
    model.apply_train(x)
    assert len(calls) == 18 and all(wb for _, wb in calls)


def test_write_back_matches_the_library(monkeypatch):
    _fits_anywhere(monkeypatch)
    x, weight, bias, rm, rv, _ = _inputs(SHAPES[1])
    states = []
    for take in (True, False):
        if not take:
            monkeypatch.setattr(bn, "takes_pair", lambda *a: False)
        norm = unet.FrozenStatsBN(x.shape[1]).train()
        with torch.no_grad():
            for dst, src in ((norm.weight, weight), (norm.bias, bias),
                             (norm.running_mean, rm),
                             (norm.running_var, rv)):
                dst.copy_(src)
        norm.write_back = True
        y = norm(x)
        states.append((y, norm.running_mean.clone(),
                       norm.running_var.clone(), norm.num_batches_tracked))
    for a, r in zip(*states):
        _close(a, r)


def test_in_place_relu_after_the_pair_keeps_the_backward(monkeypatch):
    """The function saves its input: the ReLU that overwrites its output
    leaves the gradients the library's BatchNorm gives."""
    _fits_anywhere(monkeypatch)
    x, weight, bias, _, _, dy = _inputs(SHAPES[0])
    grads = []
    for take in (True, False):
        if not take:
            monkeypatch.setattr(bn, "takes_pair", lambda *a: False)
        norm = unet.FrozenStatsBN(x.shape[1]).train()
        with torch.no_grad():
            norm.weight.copy_(weight)
            norm.bias.copy_(bias)
        leaf = x.clone().requires_grad_(True)
        (nn.ReLU(inplace=True)(norm(leaf)) * dy).sum().backward()
        grads.append((leaf.grad, norm.weight.grad, norm.bias.grad))
    for a, r in zip(*grads):
        _close(a, r)


@pytest.mark.parametrize("case", ["eval", "bf16", "5d", "cpu",
                                  "data_group"])
def test_other_inputs_keep_todays_call(monkeypatch, case):
    """Eval mode, the bf16 compute mode, 5D volumes, CPU tensors and a
    data group never reach the pair; the data group keeps
    ``_GlobalBatchNorm``."""
    if case != "cpu":  # else the route itself, which needs CUDA
        _fits_anywhere(monkeypatch)
    _refuse_pair(monkeypatch)
    gen = torch.Generator().manual_seed(2)
    if case == "eval":
        _unet().eval()(torch.randn(2, 1, 32, 32, generator=gen))
    elif case == "bf16":
        model = SegmentationModel(_unet(), compute_dtype=torch.bfloat16)
        model.apply_fixed(torch.randn(2, 1, 32, 32, generator=gen),
                          train=True).sum().backward()
    elif case == "5d":
        module = unet.PseudoConv3dModel(num_classes=4, dropout=0.0)
        module.init_weights_(gen)
        module(torch.randn(2, 1, 2, 8, 8, generator=gen)).sum().backward()
    elif case == "cpu":
        monkeypatch.undo()
        _refuse_pair(monkeypatch)
        _unet()(torch.randn(2, 1, 32, 32, generator=gen)).sum().backward()
    else:
        applied = []

        class Global:
            @staticmethod
            def apply(x, weight, bias, eps, group, count):
                applied.append(count)
                dims = (0, 2, 3)
                y = F.batch_norm(x, None, None, weight, bias, training=True,
                                 eps=eps)
                return y, x.mean(dims), x.var(dims, unbiased=False)

        group = types.SimpleNamespace(global_numel=lambda t: t.numel(),
                                      group=None)
        monkeypatch.setattr(unet.collectives, "current_data_group",
                            lambda: group)
        monkeypatch.setattr(unet, "_GlobalBatchNorm", Global)
        norm = unet.FrozenStatsBN(3).train()
        norm(torch.randn(2, 3, 4, 4, generator=gen))
        assert applied == [32]


def test_batch_instance_norm_gradients_through_the_route(monkeypatch):
    """``BatchInstanceNorm`` hands ``_normalize`` a derived affine (``weight
    * gate``): its weight, bias and gate take their gradients through the
    function's ``dw`` and ``db``; the write-back matches too."""
    _fits_anywhere(monkeypatch)
    calls = []
    _recording_pair(monkeypatch, calls)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(3, 4, 6, 5, generator=gen) * 2 + 1
    dy = torch.randn(3, 4, 6, 5, generator=gen)
    affine = [torch.randn(4, generator=gen) for _ in range(3)]
    grads = []
    for take in (True, False):
        if not take:
            monkeypatch.setattr(bn, "takes_pair", lambda *a: False)
        norm = blocks.BatchInstanceNorm(4).train()
        with torch.no_grad():
            for p, v in zip((norm.weight, norm.bias, norm.gate), affine):
                p.copy_(v)
        norm.write_back = True
        leaf = x.clone().requires_grad_(True)
        (norm(leaf) * dy).sum().backward()
        grads.append((leaf.grad, norm.weight.grad, norm.bias.grad,
                      norm.gate.grad, norm.running_mean.clone(),
                      norm.running_var.clone()))
    assert calls == [((3, 4, 6, 5), True)]
    for a, r in zip(*grads):
        _close(a, r)


def test_chip_smoke_gates_run_on_the_cpu():
    """Phase 42's gates (``tests/batch_norm_gates.py``) on the CPU, where
    the function takes the twin, at their ragged shapes."""
    import batch_norm_gates as gates
    gaps = gates.check_pair("cpu", gates.RAGGED)
    assert set(gaps) == set(gates.RAGGED)
