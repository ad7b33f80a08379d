"""The 2D training BatchNorm's gates on the card (``kernels/batch_norm.py``:
the library's forward, the hand-written backward pair), shared by
``chip_smoke.py``'s phase 42 and ``tests/test_torch_kernels_gpu.py``:
UNet_16's BatchNorm shapes, their inputs, and the checks of the function
and of the module route against float64."""

import torch
import torch.nn.functional as F
from torch import nn

from advchain_tpu_torch import _trace
from advchain_tpu_torch.kernels import batch_norm as bn

# UNet_16's BatchNorm shapes at the 2D cells' batch of 128 192 x 192
# images (N, C, H, W), widest first
SHAPES = {"c16": (128, 16, 192, 192), "c32": (128, 32, 96, 96),
          "c64": (128, 64, 48, 48), "c128": (128, 128, 24, 24),
          "c256": (128, 256, 12, 12)}
# ragged shapes: H * W not a multiple of 4 (4-byte loads), one value a row
# short of a vector, a single image
RAGGED = {"odd": (3, 5, 7, 9), "row3": (5, 2, 1, 3), "n1": (1, 7, 6, 10)}
# the pair's gap to the float64 twin, of the largest float64 entry: sums of
# up to 4.7 M f32 values in a fixed tree
TOL = 1e-5
EPS = 1e-5
MOMENTUM = 0.1
# BatchNorm layers in UNet_16 (two a DoubleConv, nine DoubleConvs)
LAYERS_UNET16 = 18
COUNTER = "batchnorm.pair"


def lead_in(n=2048):
    """Launch ``n`` one-element kernels at the start of a profiled region:
    a torch.profiler profile drops its earliest kernel records, more in
    each later profile of a process (on an H100 under torch 2.11, 30, 28,
    26, ... 10 of a profile's 30 records over 11 profiles, whatever the
    time between them), and these take the loss."""
    t = torch.zeros(1, device="cuda")
    for _ in range(n):
        t.add_(1)


def inputs(shape, device, seed=0):
    """x (per-channel shifts up to +-4 and scales 0.5-2, so the mean lies
    off 0), w, b, running mean and variance, dy: f32."""
    n, c, h, w = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*size):
        return torch.randn(size, generator=gen, device=device)

    shift = 4 * (2 * torch.rand(c, generator=gen, device=device) - 1)
    scale = 0.5 + 1.5 * torch.rand(c, generator=gen, device=device)
    x = draw(n, c, h, w) * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
    running = (draw(c), 1 + torch.rand(c, generator=gen, device=device))
    return x, draw(c), draw(c), running, draw(n, c, h, w)


def rel_gap(a, ref):
    """The largest gap of ``a`` to ``ref`` over ``ref``'s largest entry."""
    return float((a.double() - ref).abs().max()) / max(
        float(ref.abs().max()), 1e-30)


def saved_statistics(x, w, b):
    """The mean and invstd that ``F.batch_norm``'s training forward saves,
    as the function runs it."""
    _, mean, invstd, _, _ = torch._batch_norm_impl_index(
        x, w, b, None, None, True, MOMENTUM, EPS,
        torch.backends.cudnn.enabled)
    return mean, invstd


def check_pair(device, cases=None):
    """Each case through the function: its forward and write-back equal to
    ``F.batch_norm``'s bit for bit; its backward (dx, dw, db: one launch of
    the pair on the card) against the plain twin in float64 from the
    library's saved statistics, each within TOL of the largest float64
    entry, cuDNN's autograd backward beside it; the same bits over two
    runs.  Returns {case: {quantity: gap, "cudnn_" + quantity: gap}}."""
    cases = cases or {**SHAPES, **RAGGED}
    out = {}
    for name, shape in cases.items():
        x, w, b, running, dy = inputs(shape, device, seed=len(out))
        lib_stats = [t.clone() for t in running]
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        y_lib = F.batch_norm(leaves[0], *lib_stats, leaves[1], leaves[2],
                             training=True, momentum=MOMENTUM, eps=EPS)
        lib_grads = torch.autograd.grad(y_lib, leaves, dy)
        runs = []
        for _ in range(2):
            stats = (running[0].clone(), running[1].clone(), MOMENTUM)
            leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
            y = bn.batch_norm_train(*leaves, EPS, stats)
            grads = torch.autograd.grad(y, leaves, dy)
            runs.append((y.detach(), *stats[:2], *grads))
        mean, invstd = saved_statistics(x, w, b)
        for a, r in zip(*runs):
            if not torch.equal(a, r):
                raise AssertionError(f"batch_norm {name} {shape}: two runs "
                                     f"differ")
        for a, r, what in zip(runs[0][:3], (y_lib, *lib_stats),
                              ("y", "running_mean", "running_var")):
            if not torch.equal(a, r.detach()):
                raise AssertionError(f"batch_norm {name} {shape}: the "
                                     f"forward's {what} is not the "
                                     f"library's")
        ref = bn.batch_norm_bwd_plain(x.double(), dy.double(), mean.double(),
                                      invstd.double(), w.double())
        keys = ("dx", "dw", "db")
        gaps = {k: rel_gap(a, r) for k, a, r in zip(keys, runs[0][3:], ref)}
        gaps.update({"cudnn_" + k: rel_gap(a, r)
                     for k, a, r in zip(keys, lib_grads, ref)})
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        worst = max(v for k, v in gaps.items() if not k.startswith("cudnn"))
        if worst > TOL:
            raise AssertionError(f"batch_norm {name} {shape}: gaps {gaps} "
                                 f"against float64")
        out[name] = gaps
    return out


def check_module(device, shape=(8, 16, 48, 40)):
    """``FrozenStatsBN`` with ``write_back`` and an in-place ReLU after it,
    trained on the card: one launch of the pair, and the output, the
    written running statistics and the input, weight and bias gradients
    within TOL of the same module in float64 (which keeps PyTorch's own
    kernels).  Returns the gaps."""
    from advchain_tpu_torch.models.unet import FrozenStatsBN
    x, w, b, running, dy = inputs(shape, device, seed=7)
    results = []
    for dtype in (torch.float32, torch.float64):
        norm = FrozenStatsBN(shape[1]).to(device, dtype)
        with torch.no_grad():
            for dst, src in ((norm.weight, w), (norm.bias, b),
                             (norm.running_mean, running[0]),
                             (norm.running_var, running[1])):
                dst.copy_(src)
        norm.write_back = True
        block = nn.Sequential(norm, nn.ReLU(inplace=True)).train()
        leaf = x.to(dtype).detach().clone().requires_grad_(True)
        before = _trace.COUNTS.get(COUNTER, 0)
        out = block(leaf)
        (out * dy.to(dtype)).sum().backward()
        launched = _trace.COUNTS.get(COUNTER, 0) - before
        results.append((out.detach(), norm.running_mean, norm.running_var,
                        leaf.grad, norm.weight.grad, norm.bias.grad))
        want = int(dtype == torch.float32)
        if launched != want:
            raise AssertionError(f"batch_norm module in {dtype}: launched "
                                 f"the pair {launched} times, not {want}")
    keys = ("y", "running_mean", "running_var", "dx", "dw", "db")
    gaps = {k: rel_gap(a, r) for k, a, r in zip(keys, *results)}
    if max(gaps.values()) > TOL:
        raise AssertionError(f"batch_norm module with an in-place ReLU: "
                             f"gaps {gaps} against float64")
    return gaps
