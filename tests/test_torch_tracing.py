"""The port's spans and host-sync counter (``advchain_tpu_torch._trace``,
exported by ``utils.profiling``).

With no torch profiler recording, ``trace`` returns one shared no-op and
never enters ``record_function``.  Under ``torch.profiler`` (CPU activity)
a tiny 2D and 3D adversarial train step and a supervised step record the
documented ``advchain.*`` spans, each nested in its documented parent and
with its documented count a step.  ``COUNTS`` / ``TRACED_COUNTS`` are
cleared by ``reset_counts`` and untouched by CPU tensors; the card test
holds that each helper counts one sync on a CUDA device.  The ops and
parallel layers import alone in a fresh process."""

import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from advchain_tpu_torch import _trace, augmentor, models, parallel
from advchain_tpu_torch.utils import profiling
import torch_threads  # noqa: F401  (one intra-op thread a process)

# span -> (the spans it may be directly nested in, its count a step as a
# function of n_iter)
ADVERSARIAL = {
    "advchain.step": ((None,), lambda n: 1),
    "advchain.step.clean_pass": (("advchain.step",), lambda n: 1),
    "advchain.solver.episode": (("advchain.step",), lambda n: 1),
    "advchain.solver.pgd_step": (("advchain.solver.episode",), lambda n: n),
    "advchain.chain.precompute": (("advchain.solver.pgd_step",
                                   "advchain.step.consistency_pass"),
                                  lambda n: n + 1),
    "advchain.chain.apply": (("advchain.solver.pgd_step",
                              "advchain.step.consistency_pass"),
                             lambda n: n + 1),
    "advchain.model.forward": (("advchain.step.clean_pass",
                                "advchain.solver.pgd_step",
                                "advchain.step.supervised_pass",
                                "advchain.step.consistency_pass"),
                               lambda n: n + 3),
    "advchain.chain.warp_back": (("advchain.solver.pgd_step",
                                  "advchain.step.consistency_pass"),
                                 lambda n: n + 1),
    "advchain.loss.divergence": (("advchain.solver.pgd_step",
                                  "advchain.step.consistency_pass"),
                                 lambda n: n + 1),
    "advchain.solver.grad": (("advchain.solver.pgd_step",), lambda n: n),
    "advchain.solver.update": (("advchain.solver.pgd_step",), lambda n: n),
    "advchain.solver.project": (("advchain.solver.episode",),
                                lambda n: int(n > 0)),
    "advchain.step.supervised_pass": (("advchain.step",), lambda n: 1),
    "advchain.step.consistency_pass": (("advchain.step",), lambda n: 1),
    "advchain.step.backward": (("advchain.step",), lambda n: 1),
    "advchain.step.optimizer": (("advchain.step",), lambda n: 1),
}
SUPERVISED = {
    "advchain.step": ((None,), lambda n: 1),
    "advchain.step.supervised_pass": (("advchain.step",), lambda n: 1),
    "advchain.model.forward": (("advchain.step.supervised_pass",),
                               lambda n: 1),
    "advchain.step.backward": (("advchain.step",), lambda n: 1),
    "advchain.step.optimizer": (("advchain.step",), lambda n: 1),
}
# (model, image shape, the chain's bias spacing and morph grid)
CASES = {
    "2d": (lambda: models.UNet(1, 4, feature_scale=16), (32, 32),
           [8, 8], [2, 2]),
    "3d": (lambda: models.PseudoConv3dModel(4, 0.1), (4, 32, 32),
           [2, 16, 16], [2, 2, 2]),
}


def _chain(shape, spacing, grid, batch):
    dims = len(shape)
    size = [batch, 1, *shape]
    affine = ({"rot": 1 / 6, "scale_x": 0.2, "scale_y": 0.2,
               "shift_x": 0.1, "shift_y": 0.1} if dims == 2 else
              {f"{k}_{a}": v for k, v in (("rot", 1 / 18), ("scale", 0.1),
                                          ("shift", 0.1)) for a in "xyz"})
    configs = [
        (augmentor.AdvNoise, {"epsilon": 1.0, "xi": 1e-6}),
        (augmentor.AdvBias, {"epsilon": 0.3, "control_point_spacing": spacing,
                             "downscale": 2, "interpolation_order": 3,
                             "init_mode": "random", "space": "log"}),
        (augmentor.AdvAffine, affine),
        (augmentor.AdvMorph, {"epsilon": 1.5, "vector_size": grid}),
    ]
    return [cls(spatial_dims=dims, config_dict=dict(c, data_size=size),
                seed=i) for i, (cls, c) in enumerate(configs)]


def _step(kind, n_iter=1, batch=2):
    """(train_step, state, batch, generator) of a tiny step on the CPU."""
    make, shape, spacing, grid = CASES["3d" if kind == "3d" else "2d"]
    torch.manual_seed(0)
    model = models.SegmentationModel(make(), seed=0)
    opt = torch.optim.Adam(model.module.parameters(), lr=1e-4)
    if kind == "supervised":
        step = parallel.make_supervised_train_step(model, opt)
    else:
        solver = augmentor.ComposeAdversarialTransformSolver(
            chain_of_transforms=_chain(shape, spacing, grid, batch),
            divergence_types=["mse", "contour"] if kind == "2d" else ["mse"],
            divergence_weights=[1.0, 0.5] if kind == "2d" else [1.0])
        step = parallel.make_adversarial_train_step(
            model, solver, opt, n_iter=n_iter,
            power_iteration="smart" if kind == "2d" else False)
    gen = torch.Generator().manual_seed(1)
    image = torch.rand((batch, 1) + shape, generator=gen)
    label = torch.randint(0, 4, (batch,) + shape, generator=gen)
    return (step, parallel.TrainState.create(model, opt),
            {"image": image, "label": label}, gen)


def _profiled(step, state, batch, gen, steps):
    """The ``advchain.*`` spans of ``steps`` profiled steps: [(name, start
    ns, end ns)]."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            state, _ = step(state, batch, gen)
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("advchain.")]


def _parent(span, spans):
    """The name of the shortest other span holding ``span``, or None."""
    _, s, e = span
    holders = [o for o in spans if o is not span and o[1] <= s
               and e <= o[2]]
    return min(holders, key=lambda o: o[2] - o[1])[0] if holders else None


def test_trace_is_a_shared_noop_with_no_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.trace is _trace.trace
    a, b = profiling.trace("advchain.a"), profiling.trace("advchain.b")
    assert a is b
    with a, b:
        pass
    step, state, batch, gen = _step("2d", batch=1)
    state, metrics = step(state, batch, gen)
    assert torch.isfinite(metrics["total_loss"])


@pytest.mark.parametrize("kind,n_iter", [("2d", 1), ("2d", 2), ("3d", 1),
                                         ("supervised", 0)])
def test_step_records_the_documented_spans(kind, n_iter):
    step, state, batch, gen = _step(kind, n_iter, batch=1)
    spans = _profiled(step, state, batch, gen, steps=2)
    counts = {}
    for name, _, _ in spans:
        counts[name] = counts.get(name, 0) + 1
    table = SUPERVISED if kind == "supervised" else ADVERSARIAL
    assert counts == {k: 2 * c(n_iter) for k, (_, c) in table.items()}
    for span in spans:
        assert _parent(span, spans) in table[span[0]][0], span


def test_counters_reset_and_ignore_the_cpu():
    _trace.reset_counts()
    assert profiling.COUNTS is _trace.COUNTS and not profiling.COUNTS
    profiling.count("host_syncs", 2)
    assert profiling.COUNTS == {"host_syncs": 2}
    assert not profiling.TRACED_COUNTS  # no profiler recorded it
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("host_syncs")
    assert profiling.COUNTS == {"host_syncs": 3}
    assert profiling.TRACED_COUNTS == {"host_syncs": 1}
    profiling.reset_counts()
    assert not profiling.COUNTS and not profiling.TRACED_COUNTS

    t = profiling.to_device(np.arange(3.0), torch.float32, "cpu")
    assert t.dtype == torch.float32 and t.tolist() == [0.0, 1.0, 2.0]
    assert profiling.host_value(torch.tensor(2.5)) == 2.5
    for kind in ("2d", "3d"):
        step, state, batch, gen = _step(kind, batch=1)
        step(state, batch, gen)
    assert "host_syncs" not in profiling.COUNTS


@pytest.mark.parametrize("module", ["advchain_tpu_torch.ops",
                                    "advchain_tpu_torch.parallel"])
def test_layers_import_alone(module):
    out = subprocess.run([sys.executable, "-c", f"import {module}"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.gpu
def test_helpers_count_each_sync_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    profiling.reset_counts()
    t = profiling.to_device(np.arange(4.0), torch.float32, "cuda")
    assert profiling.COUNTS == {"host_syncs": 1}
    profiling.to_device(t, torch.float32, "cuda")  # already there
    assert profiling.COUNTS == {"host_syncs": 1}
    assert profiling.host_value(t.sum()) == 6.0
    assert profiling.COUNTS == {"host_syncs": 2}
