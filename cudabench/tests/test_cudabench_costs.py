"""The FLOP and byte functions against counts made by hand at tiny
shapes."""

import copy

from cudabench import costs
from cudabench.tests.tiny import TinyManifest


def _unet(scale, shape):
    cfg = copy.deepcopy(TinyManifest().config("unet16_cardiac2d"))
    cfg["model"]["args"]["feature_scale"] = scale
    cfg["image"]["shape"] = list(shape)
    return cfg


def test_unet_forward_macs_by_hand():
    # widths 4, 8, 16, 32, 32 at 16 x 16, 8 x 8, 4 x 4, 2 x 2, 1 x 1
    cfg = _unet(16, (16, 16))
    macs = sum(m for m, _ in costs.forward_macs(cfg))
    hand = (256 * 9 * (1 * 4 + 4 * 4)          # inc
            + 64 * 9 * (4 * 8 + 8 * 8)         # down1
            + 16 * 9 * (8 * 16 + 16 * 16)      # down2
            + 4 * 9 * (16 * 32 + 32 * 32)      # down3
            + 1 * 9 * (32 * 32 + 32 * 32)      # down4
            + 4 * 9 * (64 * 16 + 16 * 16)      # up1
            + 16 * 9 * (32 * 8 + 8 * 8)        # up2
            + 64 * 9 * (16 * 4 + 4 * 4)        # up3
            + 256 * 9 * (8 * 4 + 4 * 4)        # up4
            + 256 * 4 * 4)                     # outc
    assert macs == hand


def test_step_flops_by_hand():
    cfg = _unet(16, (16, 16))
    layers = costs.forward_macs(cfg)
    fwd = sum(m for m, _ in layers)
    first = layers[0][0]
    train = 3 * fwd - first
    assert costs.step_model_flops(cfg, "supervised") == 2 * train
    assert costs.step_model_flops(cfg, "adversarial") == 2 * (
        fwd + 2 * fwd + 2 * train)


def test_pseudo3d_macs_by_hand():
    cfg = copy.deepcopy(TinyManifest().config("pseudo3d_cardiac3d"))
    cfg["image"]["shape"] = [2, 4, 4]
    assert [m for m, _ in costs.forward_macs(cfg)] == [32 * 8 * 27,
                                                         32 * 4 * 8 * 27]


def test_warp_bytes_by_hand():
    cfg = _unet(16, (4, 4))
    pix = 3 * 16  # batch 3 of 4 x 4
    b = costs.warp_bytes(cfg, 3, "adversarial")
    f32 = 4
    # two geometric transforms; image 1 channel, mask 1, prediction 4 + 1
    fwd = 2 * ((2 + 2) + (2 + 2) + (10 + 2)) * f32
    assert b["warp.fwd"] == pix * fwd * 2
    bwd = 2 * ((3 + 4) + (2 + 4) + (15 + 4)) * f32 + 2 * (10 + 2) * f32
    assert b["warp.bwd"] == pix * bwd
    assert b["compose.fwd"] == pix * 2 * 8 * 2 * 2 * f32 * 2
    assert b["compose.bwd"] == pix * 2 * 8 * 3 * 2 * f32
    assert sum(costs.warp_bytes(cfg, 3, "supervised").values()) == 0
