"""The 3D U-Net (``models.UNet3D``, Cicek et al. 2016) against the
benchmark's plain reference (``cudabench/reference/model_UNet3D.py``, plain
``torch.nn.functional``): logits, the cross-entropy, every parameter's
gradient and the BatchNorm running statistics a training forward writes
back, from the same weights.  Then its parameter count at the published
widths, its refusals, the spans of its forward, the Conv3d width rule at
the shapes it was timed at, and a whole run of the benchmark's cell on the
CPU at a small size."""

import math
import statistics
import time

import pytest
import torch
import torch.nn.functional as F

from advchain_tpu_torch import _trace
from advchain_tpu_torch.kernels import conv3d_wgrad as cw
from advchain_tpu_torch.models import SegmentationModel, UNet3D, unet
from cudabench import harness, inputs
from cudabench.reference import model_UNet3D as ref
from cudabench.tests.tiny import TinyManifest
import torch_threads  # noqa: F401  (one intra-op thread a process)

ARGS = {"input_channel": 1, "num_classes": 4, "base_filters": 4}
CELL = "unet3d_cardiac3d.adv_b2_t3"
SEED = 2 ** 33 + 11
BN_EPS, BN_MOMENTUM = 1e-5, 0.1


def _weights(args, seed=0):
    """The benchmark's draw of the model's parameters (``make_weights``)."""
    return inputs.make_weights({"model": {"name": "UNet3D", "args": args,
                                          "init": {"bn_weight_std": 0.02}}},
                               seed, "cpu")


def _port(weights, args=ARGS):
    module = UNet3D(**args)
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(weights[n])
    return module


def _reference_pass(weights, x, label):
    """The reference's logits, loss, gradients and the running statistics
    torch's BatchNorm would write back, BN layers in the spec's order (the
    forward's)."""
    p = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    stats = [(torch.zeros(s[0]), torch.ones(s[0]))
             for _, s, kind in ref.param_spec(ARGS) if kind == "bn_weight"]
    calls = iter(stats)

    def bn(y, w, b):
        mean, var = next(calls)
        return F.batch_norm(y, mean, var, w, b, training=True,
                            momentum=BN_MOMENTUM, eps=BN_EPS)

    logits = ref.forward(p, x, ARGS, bn)
    loss = F.cross_entropy(logits, label)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    return logits, loss.detach(), grads, stats


def test_unet3d_matches_the_plain_reference():
    """Batch 2 of 8 x 32 x 32 at ``base_filters`` 4.  The forward runs the
    same torch calls on both sides, so the logits and the loss agree to
    a few ulps (1e-6 relative).  The gradients differ by reassociation
    alone: on the CPU the layers the width rule gives to the pair (at
    most 1024 products: all but 32 -> 64 and 96 -> 32) take the twin's
    per-tap sums where the reference takes autograd's (seeds 5-7 read at
    most 1e-5 of the leaf's largest entry: 1e-4).  A convolution's bias
    under BatchNorm has a gradient that is zero in exact arithmetic, so
    its rounding residue is measured against the median leaf's largest
    entry.  The running statistics are one write
    of the same batch statistics (1e-6)."""
    gen = torch.Generator().manual_seed(5)
    x = torch.rand(2, 1, 8, 32, 32, generator=gen)
    label = torch.randint(0, 4, (2, 8, 32, 32), generator=gen)
    weights = _weights(ARGS, seed=7)
    model = SegmentationModel(_port(weights))
    logits = model.apply_train(x)
    loss = F.cross_entropy(logits, label)
    loss.backward()
    loss = loss.detach()
    r_logits, r_loss, r_grads, r_stats = _reference_pass(weights, x, label)
    torch.testing.assert_close(logits, r_logits, rtol=1e-6, atol=1e-6)
    assert abs(float(loss) - float(r_loss)) <= 1e-6 * float(r_loss)
    params = dict(model.module.named_parameters())
    assert set(params) == set(r_grads)
    scales = {n: float(g.abs().max()) for n, g in r_grads.items()}
    median = statistics.median(scales.values())
    for name, g in r_grads.items():
        gap = float((params[name].grad - g).abs().max())
        assert gap <= 1e-4 * max(scales[name], median), (name, gap)
    bns = [m for m in model.module.modules()
           if isinstance(m, unet.FrozenStatsBN3d)]
    assert len(bns) == len(r_stats) == 14
    for m, (mean, var) in zip(bns, r_stats):
        torch.testing.assert_close(m.running_mean, mean, rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(m.running_var, var, rtol=1e-6, atol=1e-6)


def test_unet3d_published_widths_and_the_reference_names():
    """At ``base_filters`` 32 with 3 classes the convolutions and
    up-convolutions hold 19,069,123 parameters and the BatchNorm affines
    4,672 (the paper's 19,069,955, within 0.01%); the names and shapes are
    the reference's ``param_spec``, which the benchmark fills."""
    with torch.device("meta"):
        module = UNet3D(1, 3, 32)
    conv = sum(p.numel() for m in module.modules()
               if isinstance(m, torch.nn.modules.conv._ConvNd)
               for p in m.parameters(recurse=False))
    norm = sum(p.numel() for m in module.modules()
               if isinstance(m, unet.FrozenStatsBN3d)
               for p in m.parameters(recurse=False))
    assert (conv, norm) == (19_069_123, 4_672)
    assert sum(p.numel() for p in module.parameters()) == conv + norm
    spec = {n: tuple(s) for n, s, _ in ref.param_spec(
        {"input_channel": 1, "num_classes": 3, "base_filters": 32})}
    assert {n: tuple(p.shape) for n, p in module.named_parameters()} == spec
    widths = [(m.in_channels, m.out_channels) for m in module.modules()
              if isinstance(m, unet.ZDecomposedConv3d)]
    assert widths == [(1, 32), (32, 64), (64, 64), (64, 128), (128, 128),
                      (128, 256), (256, 256), (256, 512), (768, 256),
                      (256, 256), (384, 128), (128, 128), (192, 64),
                      (64, 64)]
    ups = [(m.in_channels, m.kernel_size, m.stride) for m in module.modules()
           if isinstance(m, torch.nn.ConvTranspose3d)]
    assert ups == [(c, (2, 2, 2), (2, 2, 2)) for c in (512, 256, 128)]


def test_unet3d_init_covers_the_up_convolutions():
    """``init_weights_``: kaiming normal on fan-in as torch counts it
    (a transposed kernel's output channels times its taps), zero biases,
    BatchNorm weights 1 + 0.02 N(0, 1)."""
    module = UNet3D(1, 4, 8)
    module.init_weights_(torch.Generator().manual_seed(0))
    for m in module.modules():
        if isinstance(m, torch.nn.ConvTranspose3d):
            std = math.sqrt(2.0 / m.weight[0].numel())
            assert abs(float(m.weight.std()) / std - 1) < 0.05
            assert not m.bias.any()
        elif isinstance(m, unet.FrozenStatsBN3d):
            assert abs(float(m.weight.mean()) - 1) < 0.02
            assert 0 < float(m.weight.std()) < 0.05 and not m.bias.any()


@pytest.mark.parametrize("shape", [(1, 1, 12, 32, 32), (1, 1, 8, 36, 32),
                                   (1, 1, 8, 32, 20), (1, 8, 32, 32)])
def test_unet3d_refuses_a_shape_three_pools_do_not_divide(shape):
    with pytest.raises(ValueError, match=r"\(" + ", ".join(map(str, shape))):
        UNet3D(**ARGS)(torch.zeros(shape))


def test_unet3d_refuses_a_space_group(monkeypatch):
    monkeypatch.setattr(unet.collectives, "current_space", lambda: object())
    with pytest.raises(NotImplementedError):
        UNet3D(**ARGS)(torch.zeros(1, 1, 8, 16, 16))


def test_unet3d_forward_spans():
    """``advchain.model.encoder`` and ``.decoder`` are profiler regions of
    each forward while a profiler records."""
    from torch.profiler import ProfilerActivity, profile
    module = UNet3D(**ARGS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        module(torch.zeros(1, 1, 8, 16, 16))
    names = [e.name for e in prof.events()]
    assert names.count("advchain.model.encoder") == 1
    assert names.count("advchain.model.decoder") == 1


# (Cin, Cout, N, D, W) of the timed shapes (scripts/conv3d_width_table.py):
# UNet3D's 14 3x3x3 layers at 2 x 16 x 192 x 192, PseudoConv3dModel's two
# at 2 x 12 x 192 x 192, and the widths between them at 2 x 16 x 192 x 192;
# True where the rule gives the layer to the pair
RULE = [((1, 32, 2, 16, 192), True), ((32, 64, 2, 16, 192), False),
        ((64, 64, 2, 8, 96), False), ((64, 128, 2, 8, 96), False),
        ((128, 128, 2, 4, 48), False), ((128, 256, 2, 4, 48), False),
        ((256, 256, 2, 2, 24), False), ((256, 512, 2, 2, 24), False),
        ((768, 256, 2, 4, 48), False), ((256, 256, 2, 4, 48), False),
        ((384, 128, 2, 8, 96), False), ((128, 128, 2, 8, 96), False),
        ((192, 64, 2, 16, 192), False), ((64, 64, 2, 16, 192), False),
        ((1, 8, 2, 12, 192), True), ((8, 4, 2, 12, 192), True),
        ((1, 16, 2, 16, 192), True), ((4, 8, 2, 16, 192), True),
        ((8, 8, 2, 16, 192), True), ((8, 16, 2, 16, 192), True),
        ((16, 16, 2, 16, 192), True), ((16, 32, 2, 16, 192), True),
        ((32, 32, 2, 16, 192), True)]


@pytest.mark.parametrize("shape,pair", RULE,
                         ids=[f"{c[0]}x{c[1]}" for c, _ in RULE])
def test_width_rule_at_the_timed_shapes(shape, pair):
    cin, cout, n, d, w = shape
    assert (cw.takes_pair(cin, cout) and cw.scratch_fits(n, cin, cout, d, w)
            ) is pair


def test_width_rule_routes_the_layer_and_counts_cudnn(monkeypatch):
    """A layer the rule gives to cuDNN skips the pair's function and counts
    ``conv3d_wgrad.cudnn`` once a forward; a narrow one takes it; a call
    whose scratch would pass ``SCRATCH_CAP`` keeps cuDNN's."""
    taken = []
    real = unet.conv3d_same
    monkeypatch.setattr(unet, "conv3d_same",
                        lambda *a: taken.append(a[1].shape) or real(*a))
    _trace.reset_counts()
    x = torch.randn(1, 32, 2, 6, 6)
    unet.ZDecomposedConv3d(32, 32)(x)
    unet.ZDecomposedConv3d(32, 64)(x)
    assert taken == [(32, 32, 3, 3, 3)]
    assert _trace.COUNTS == {"conv3d_wgrad.cudnn": 1}
    monkeypatch.setattr(cw, "SCRATCH_CAP", 100)
    unet.ZDecomposedConv3d(32, 32)(x)
    assert len(taken) == 1 and _trace.COUNTS["conv3d_wgrad.cudnn"] == 2


class _Small(TinyManifest):
    """The new cell at 8 x 32 x 32, batch 2, with ``base_filters`` 4."""

    def config(self, name):
        c = super().config(name)
        if c["model"]["name"] == "UNet3D":
            c["model"]["args"]["base_filters"] = 4
        return c


def test_the_cell_runs_correct_on_the_cpu():
    result = harness.run_cell(_Small(), CELL, SEED, 0.1, False, "cpu",
                              time.time(), log=lambda s: None)
    assert result["correct"], result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_vol_s", "peak_mem_gib",
                                      "setup_s"}
