"""Swin-Unet (``models.SwinUNet``, Cao et al. 2021) against the benchmark's
plain reference (``cudabench/reference/model_SwinUNet.py``: plain
``torch.nn.functional``, the attention written out as matmul, softmax,
matmul): logits, every parameter's gradient and the input's, from the same
weights; the relative-position index and the shift mask against ones
written by hand; the port's train steps against the reference trainer;
the parameter count at the published widths, the refusals, the spans and
the counter of the window attention, the init, one network in train and
eval mode, the cell's FLOPs and a whole run of the benchmark's cell on the
CPU at a small size.

The small configuration: 64 x 64 inputs, 4 x 4 patches (16 x 16 tokens),
windows of 4, ``embed_dim`` 12, heads (1, 2, 2, 4).  Stages 1-2 (16 and 8
tokens a side) shift every second block; stages 3-4 (4 and 2) clamp the
window to the stage and do not shift."""

import math
import time

import pytest
import torch
import torch.nn.functional as F

from advchain_tpu_torch import _consts, _trace
from advchain_tpu_torch.models import SegmentationModel, SwinUNet, swin
from cudabench import check, costs, harness, inputs, sut
from cudabench.reference import model_SwinUNet as ref
from cudabench.reference.step import ReferenceTrainer
from cudabench.tests.tiny import ROOT, TinyManifest
import torch_threads  # noqa: F401  (one intra-op thread a process)

CELL = "swinunet_acdc2d.adv_b64"
SEED = 2 ** 33 + 5
TINY = {"img_size": 64, "embed_dim": 12, "num_heads": [1, 2, 2, 4],
        "window_size": 4}
# every stage clamped but the first: 8, 4, 2 and 1 tokens a side
CLAMPED = {"img_size": 32, "embed_dim": 8, "num_heads": [1, 1, 2, 2],
           "window_size": 4, "qkv_bias": False, "mlp_ratio": 2}


def _weights(args, seed):
    """The benchmark's draw (``make_weights``: biases and the
    relative-position tables zero), then the zero leaves drawn too, so that
    a wrong bias index or an unread bias shows."""
    w = inputs.make_weights({"model": {"name": "SwinUNet", "args": args,
                                       "init": {"bn_weight_std": 0.02}}},
                            seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    return {k: v if v.any() else 0.1 * torch.randn(v.shape, generator=gen)
            for k, v in w.items()}


def _grads(forward, params, x, cot):
    """The logits of ``forward(params, x)`` and the gradients of
    ``sum(logits * cot)`` with respect to every parameter and ``x``."""
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    x = x.clone().requires_grad_(True)
    logits = forward(p, x)
    grads = torch.autograd.grad((logits * cot).sum(), [*p.values(), x])
    return logits.detach(), dict(zip([*p, "input"], grads))


def _port_forward(args, dtype):
    module = SwinUNet(**args).to(dtype)
    return lambda p, x: torch.func.functional_call(module, p, (x,))


@pytest.mark.parametrize("args", [TINY, CLAMPED], ids=["shifted", "clamped"])
@pytest.mark.parametrize("seed", [3, 4])
def test_swin_unet_matches_the_plain_reference(args, seed):
    """Batch 2, against the reference in float64.  In float64 the port
    (``F.scaled_dot_product_attention``) and the reference (the product
    written out) are the same equations: logits and every gradient agree
    within 1e-11 of the largest entry (seeds 3-10 read at most 8.3e-14 and
    2.2e-13).  The port in f32 against them: the logits within 1e-4 of the
    largest entry, each gradient within 5e-4 of its leaf's largest entry,
    the input's included.  Seeds 3-10 read at most 2.1e-5 and 5.6e-5, both
    at seed 4 of the clamped network, whose 8-channel LayerNorms round the
    most (its float64 gap is also the largest); the others at most 3.6e-6
    and 1.9e-5."""
    gen = torch.Generator().manual_seed(seed)
    size = args["img_size"]
    x = torch.rand(2, 1, size, size, generator=gen, dtype=torch.float64)
    weights = {k: v.double() for k, v in _weights(args, seed).items()}
    cot = torch.randn(2, 4, size, size, generator=gen, dtype=torch.float64)
    with torch.device("meta"):
        names = {n for n, _ in SwinUNet(**args).named_parameters()}
    assert names == set(weights)
    want, r_grads = _grads(lambda p, y: ref.forward(p, y, args, None),
                           weights, x, cot)
    for dtype, tol, g_tol in ((torch.float64, 1e-11, 1e-11),
                              (torch.float32, 1e-4, 5e-4)):
        got, grads = _grads(_port_forward(args, dtype),
                            {k: v.to(dtype) for k, v in weights.items()},
                            x.to(dtype), cot.to(dtype))
        gap = float((got.double() - want).abs().max())
        assert gap <= tol * float(want.abs().max()), (dtype, gap)
        for name, g in r_grads.items():
            gap = float((grads[name].double() - g).abs().max())
            assert gap <= g_tol * float(g.abs().max()), (dtype, name, gap)


def test_relative_position_index_and_shift_mask_by_hand():
    """w = 2: the index of tokens (0,0), (0,1), (1,0), (1,1) is (dy + 1) *
    3 + dx + 1.  A 4 x 4 stage rolled by 1 has regions rows {0, 1}, {2},
    {3} by the same columns; its four 2 x 2 windows: the first in one
    region, the second split by columns, the third by rows, the fourth in
    four.  Both are built once per key and shared."""
    index = swin.relative_position_index(2, torch.device("cpu"))
    assert index.tolist() == [[4, 3, 1, 0], [5, 4, 2, 1], [7, 6, 4, 3],
                              [8, 7, 5, 4]]
    assert torch.equal(index, ref._relative_index(2, "cpu"))
    m = swin.shift_mask(4, 2, 1, torch.device("cpu"))
    o, x = 0.0, -100.0
    by_cols = [[o, x, o, x], [x, o, x, o], [o, x, o, x], [x, o, x, o]]
    by_rows = [[o, o, x, x], [o, o, x, x], [x, x, o, o], [x, x, o, o]]
    apart = [[o if i == j else x for j in range(4)] for i in range(4)]
    assert m.tolist() == [[[o] * 4] * 4, by_cols, by_rows, apart]
    assert torch.equal(m, ref._region_mask(4, 2, 1, "cpu"))
    _trace.reset_counts()
    assert swin.shift_mask(4, 2, 1, torch.device("cpu")) is m
    assert swin.relative_position_index(2, torch.device("cpu")) is index
    assert "device_consts.fill" not in _trace.COUNTS
    _consts._CACHE.clear()
    swin.shift_mask(4, 2, 1, torch.device("cpu"))
    assert _trace.COUNTS["device_consts.fill"] == 1


def _tiny_manifest():
    class Small(TinyManifest):
        """The cell at 64 x 64, batch 2, with the small Swin-Unet."""

        def __init__(self):
            super().__init__(shape2=(64, 64))

        def config(self, name):
            c = super().config(name)
            if c["model"]["name"] == "SwinUNet":
                c["model"]["args"].update(TINY)
            return c
    return Small()


# kind -> (the first step's supervised loss, every other loss, the worst
# leaf's gap of the two steps' change, ``check._worst_leaf``)
STEP_LIMITS = {"adversarial": (1e-5, 2e-2, 0.25),
               "supervised": (1e-5, 1e-5, 1e-3)}


@pytest.mark.parametrize("kind", sorted(STEP_LIMITS))
def test_two_train_steps_match_the_reference_trainer(kind):
    """The port's step (``make_adversarial_train_step`` or
    ``make_supervised_train_step`` through ``SegmentationModel``) and the
    reference's, two steps from the same weights, batches and seeds.  The
    first supervised loss is the model's forward alone (seeds read <= 1.2e-7).
    The adversarial step's PGD takes the sign of the affine latents'
    gradient, which rounding flips, so its consistency losses and the
    second step read up to 5.1e-3 and its change 0.092 (the cell's own
    limit is 0.25); the supervised step's change differs where Adam's first
    update takes the sign of a gradient entry near 0 (<= 1.2e-4)."""
    first, rest, change = STEP_LIMITS[kind]
    config = _tiny_manifest().config("swinunet_acdc2d")
    seeds = inputs.subseeds(SEED)
    weights = inputs.make_weights(config, seeds["weights"], "cpu")
    images, labels = inputs.make_pool(config, 2, 2, seeds["data"], "cpu")
    system = sut.System(config, kind, 2, weights, seeds["wrapper"], "cpu")
    gen = torch.Generator().manual_seed(seeds["chain"])
    trainer = ReferenceTrainer(config, kind, 2, weights, seeds["chain"],
                               seeds["wrapper"], "cpu")
    for s in range(2):
        got = system.step(images[s], labels[s], gen)
        want, _ = trainer.step(images[s], labels[s])
        for name, v in want.items():
            gap = abs(float(got.get(name, got["total_loss"])) - v) / abs(v)
            assert gap <= (first if (s, name) == (0, "supervised_loss")
                           else rest), (s, name, gap)
    with torch.no_grad():
        theirs = check._norms({k: v - weights[k]
                               for k, v in trainer.params().items()})
        ours = check._norms({k: v - weights[k]
                             for k, v in system.parameters().items()})
    assert check._worst_leaf(ours, theirs) <= change


def test_the_cell_runs_correct_on_the_cpu():
    result = harness.run_cell(_tiny_manifest(), CELL, SEED, 0.1, False,
                              "cpu", time.time(), log=lambda s: None)
    assert result["correct"], result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"train_img_s", "peak_mem_gib",
                                      "setup_s"}


def test_published_widths_and_the_reference_names():
    """The defaults are the published Swin-T encoder with 4 classes:
    27,168,420 parameters (the paper's 27.17 M); the names and shapes are
    the reference's ``param_spec``, which the benchmark fills."""
    with torch.device("meta"):
        module = SwinUNet()
    assert sum(p.numel() for p in module.parameters()) == 27_168_420
    spec = {n: tuple(s) for n, s, _ in ref.param_spec({})}
    assert {n: tuple(p.shape) for n, p in module.named_parameters()} == spec
    blocks = [(b.resolution, b.window, b.shift) for layer in module.layers
              for b in layer.blocks]
    assert blocks == [(56, 7, 0), (56, 7, 3), (28, 7, 0), (28, 7, 3),
                      (14, 7, 0), (14, 7, 3), (7, 7, 0), (7, 7, 0)]


def test_the_step_flops_of_the_cell():
    """6.0857 GMAC a forward (the linear layers, the patch embedding, the
    head and both attention products); a step of one image 109.48 GFLOP:
    the clean forward, the PGD step's forward and data gradient, and two
    train passes (the patch embedding's data gradient left out)."""
    config = harness.Manifest(ROOT).config("swinunet_acdc2d")
    fwd = sum(m for m, _ in costs.forward_macs(config))
    assert fwd == 6_085_696_512
    first = 3 * 96 * 16 * 56 * 56
    assert costs.step_model_flops(config, "adversarial") == \
        2.0 * (3 * fwd + 2 * (3 * fwd - first))
    assert round(costs.step_model_flops(config, "adversarial") / 1e9, 2) \
        == 109.48


@pytest.mark.parametrize("shape", [(1, 1, 32, 64), (1, 1, 64, 32),
                                   (1, 1, 48, 48), (1, 64, 64)])
def test_swin_unet_refuses_another_size(shape):
    with pytest.raises(ValueError, match=r"\(" + ", ".join(map(str, shape))):
        SwinUNet(**TINY)(torch.zeros(shape))


def test_swin_unet_refuses_windows_that_do_not_tile():
    with pytest.raises(ValueError, match="windows"):
        SwinUNet(img_size=96, window_size=5)


def test_swin_unet_refuses_a_space_group(monkeypatch):
    monkeypatch.setattr(swin.collectives, "current_space", lambda: object())
    with pytest.raises(NotImplementedError):
        SwinUNet(**TINY)(torch.zeros(1, 1, 64, 64))


def test_swin_unet_spans_and_counter():
    """A forward is one ``advchain.model.encoder`` and one ``.decoder``
    region and 14 ``advchain.model.window_attn`` regions (8 encoder and 6
    decoder blocks); ``swin.window_attn`` counts each attention, and only
    those made while a profiler records go to ``TRACED_COUNTS``."""
    from torch.profiler import ProfilerActivity, profile
    module = SwinUNet(**TINY)
    x = torch.zeros(1, 1, 64, 64)
    _trace.reset_counts()
    module(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        module(x)
    names = [e.name for e in prof.events()]
    assert names.count("advchain.model.encoder") == 1
    assert names.count("advchain.model.decoder") == 1
    assert names.count("advchain.model.window_attn") == 14
    assert _trace.COUNTS["swin.window_attn"] == 28
    assert _trace.TRACED_COUNTS["swin.window_attn"] == 14


def test_swin_unet_init_is_the_published_one():
    """``init_weights_`` (``SegmentationModel.create``): Linear weights and
    the tables ~ N(0, 0.02), Linear biases 0, LayerNorm (1, 0), the
    convolutions torch's U(+-1/sqrt(fan_in))."""
    model = SegmentationModel.create(SwinUNet(**TINY), seed=0, device="cpu")
    normal = []
    for name, p in model.module.named_parameters():
        if p.dim() == 2:  # the Linear weights and the tables
            normal.append(p.flatten())
        elif "norm" in name.split(".")[-2]:
            assert bool((p == (1.0 if name.endswith("weight") else 0.0))
                        .all()), name
        elif p.dim() == 4:
            bound = 1 / math.sqrt(p[0].numel())
            assert 0.5 * bound < float(p.abs().max()) <= bound, name
        elif not name.startswith("patch_embed.proj"):
            assert not p.any(), name
    normal = torch.cat(normal)
    assert abs(float(normal.std()) / 0.02 - 1) < 0.02
    assert abs(float(normal.mean())) < 1e-3


def test_train_and_eval_are_one_network():
    """No stochastic depth, dropout or batch statistics: ``train()`` and
    ``eval()`` give the same logits, so every pass of a train step sees one
    network."""
    module = SwinUNet(**TINY)
    x = torch.rand(2, 1, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        trained = module.train()(x)
        evaluated = module.eval()(x)
    torch.testing.assert_close(trained, evaluated, rtol=0, atol=0)
