"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped, the rest of a run is driven on the
CPU at a tiny size, once for each fault a training cell can have (the
step returns its state unchanged; half of the batch left out, the mean
taken over the rest).  And, on the card, the control (the reference in
TF32, the nearest precision below the configuration's float32) fails
the cells' limits."""

import time

import pytest
import torch

from cudabench import check, harness
from cudabench.tests.tiny import TinyManifest

SEED = 2 ** 32 + 5
CELLS = ["unet16_cardiac2d.sup_b128", "pseudo3d_cardiac3d.adv_b2",
         "unet16_cardiac2d.adv_b128"]


def state_unchanged(system):
    """The optimiser takes no step: the state comes back as it went in."""
    system.optimizer.step = lambda *a, **k: None


def half_batch(system):
    """Every step sees only the first half of its batch's rows (and of the
    chain's draws)."""
    step = system.step

    def halved(image, label, generator):
        n = image.shape[0] // 2
        return step(image[:n], label[:n], generator)
    system.step = halved
    for t in getattr(system.solver, "chain_of_transforms", []):
        def draw(generator, device=None, full=t.init_params):
            p = full(generator, device)
            return p[:p.shape[0] // 2]
        t.init_params = draw


@pytest.fixture(scope="module")
def tiny():
    return TinyManifest(batch=4)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_is_not_correct(tiny, cell, fault):
    sound = harness.run_cell(tiny, cell, SEED, 0.05, False, "cpu",
                             time.time(), log=lambda s: None)
    assert sound["correct"], sound["check"]
    broken = harness.run_cell(tiny, cell, SEED, 0.05, False, "cpu",
                              time.time(), fault=fault, log=lambda s: None)
    assert not broken["correct"], broken["check"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell):
    """The reference with TF32 on in the program's place, at batch 16 of
    the cell's image size, against the reference in float32."""
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 runs only on an NVIDIA GPU")
    m = TinyManifest(batch=16)
    m.config = harness.Manifest.config.__get__(m)  # the cell's own sizes
    run = harness.Run(m, cell, SEED, "cuda")
    run.release()
    ref = run.reference()
    values = check.numbers(run.reference(tf32=True), ref)
    ok, lines, _ = check.judge(values, m.limits(cell))
    assert not ok, lines
