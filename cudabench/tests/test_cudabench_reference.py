"""The plain reference against the port's CPU path at a tiny size: each
transform's forward and inverse, the consistency divergence, the
network, and whole runs of each cell's harness, which must come out
correct under the cells' limits."""

import time

import pytest
import torch

from cudabench import harness, inputs, sut
from cudabench.reference import chain as ref_chain
from cudabench.reference.step import ReferenceTrainer
from cudabench.tests.tiny import TinyManifest

SEED = 2 ** 31 + 11
TOL = {"noise": 1e-6, "bias": 1e-6, "affine": 1e-5, "morph": 1e-4}


@pytest.fixture(scope="module")
def tiny():
    return TinyManifest()


def _port_chain(config, size):
    from advchain_tpu_torch import augmentor
    cls = {"noise": augmentor.AdvNoise, "bias": augmentor.AdvBias,
           "affine": augmentor.AdvAffine, "morph": augmentor.AdvMorph}
    dims = len(size) - 2
    return [cls[e["name"]](spatial_dims=dims,
                           config_dict=dict(e["config"], data_size=size),
                           seed=i) for i, e in enumerate(config["chain"])]


@pytest.mark.parametrize("name", ["unet16_cardiac2d", "pseudo3d_cardiac3d"])
def test_each_transform_forward_and_inverse(tiny, name):
    config = tiny.config(name)
    size = [2, 1, *config["image"]["shape"]]
    port = _port_chain(config, size)
    ref = ref_chain.build_chain(config["chain"], size, False)
    gen = torch.Generator().manual_seed(3)
    params = [t.draw(gen) for t in ref]
    gen = torch.Generator().manual_seed(3)
    drawn = [t.init_params(gen, "cpu") for t in port]
    x, _ = inputs.make_pool(config, 2, 1, 4, "cpu")
    x = x[0]
    for t, r, p, q in zip(port, ref, params, drawn):
        assert (p - q).abs().max() <= 1e-7, t.get_name()  # norms round
        for training in (False, True):
            a = t.apply_precomputed(t.precompute(p, training), p, x,
                                    training=training)
            b = r.apply(r.aux(p, training), p, x, training)
            # a sampling coordinate rounded in another order moves a tap by
            # an ulp times the image's size; the morph's squarings grow it
            tol = TOL[t.get_name()]
            assert (a - b).abs().max() <= tol, t.get_name()
            if t.is_geometric():
                a = t.inverse_precomputed(t.precompute(p, training), p, x,
                                          training=training)
                b = r.inverse(r.aux(p, training), p, x, training)
                assert (a - b).abs().max() <= tol, t.get_name()


def test_network_and_divergence(tiny):
    config = tiny.config("unet16_cardiac2d")
    seeds = inputs.subseeds(SEED)
    weights = inputs.make_weights(config, seeds["weights"], "cpu")
    x, _ = inputs.make_pool(config, 2, 1, seeds["data"], "cpu")
    system = sut.System(config, "supervised", 2, weights, 0, "cpu")
    trainer = ReferenceTrainer(config, "supervised", 2, weights, 0, 0, "cpu")
    a = system.model.apply_fixed(x[0], train=True)
    b = trainer._net(None)(x[0])
    assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    from advchain_tpu_torch.losses import calc_segmentation_consistency
    mask = (torch.rand(2, 1, 32, 32) > 0.2).float()
    s = config["solver"]
    ours = calc_segmentation_consistency(
        a, b.detach() * 0.9, s["divergence_types"], s["divergence_weights"],
        mask=mask)
    from cudabench.reference.losses import consistency
    theirs = consistency(a, b.detach() * 0.9, mask, s["divergence_types"],
                         s["divergence_weights"])
    assert abs(float(ours) - float(theirs)) <= 1e-6 * abs(float(theirs))


@pytest.mark.parametrize("cell", ["unet16_cardiac2d.sup_b128",
                                  "pseudo3d_cardiac3d.adv_b2",
                                  "unet16_cardiac2d.adv_b128"])
def test_a_whole_run_is_correct(tiny, cell):
    result = harness.run_cell(tiny, cell, SEED, 0.1, False, "cpu",
                              time.time(), log=lambda s: None)
    assert result["correct"], result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
